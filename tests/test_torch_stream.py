"""The port's streaming batch backend on the CPU against the JAX package's:
the key folds (``band_keys_wide``, ``candidate_keys``,
``fused_keys_epilogue``), the engine's ``signatures_and_keys``, the Bloom
stream index (``utils/bloom.py``), ``TpuBatchBackend`` across several
batches in the exact and bloom modes (annotations and stats equal), its npz
checkpoint read in either direction, its quarantine of a torn checkpoint,
and the torn-write-safe commit (``storage/fsio.py``).  Exact equality
throughout; batches of 64 records."""

from __future__ import annotations

import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

from advanced_scrapper_tpu.config import DedupConfig as RefConfig
from advanced_scrapper_tpu.core.hashing import make_params as ref_make_params
from advanced_scrapper_tpu.extractors import tpu_batch as ref_tb
from advanced_scrapper_tpu.ops import lsh as ref_lsh
from advanced_scrapper_tpu.pipeline.dedup import NearDupEngine as RefEngine
from advanced_scrapper_tpu.utils import bloom as ref_bloom
from advanced_scrapper_tpu_torch.config import DedupConfig
from advanced_scrapper_tpu_torch.core.hashing import make_params
from advanced_scrapper_tpu_torch.extractors import tpu_batch
from advanced_scrapper_tpu_torch.ops import lsh
from advanced_scrapper_tpu_torch.pipeline.dedup import NearDupEngine
from advanced_scrapper_tpu_torch.storage import fsio
from advanced_scrapper_tpu_torch.utils import bloom

#: small batches, and filters small enough that a few hundred records set
#: a visible share of their bits
SMALL = dict(batch_size=64, bloom_bits=1 << 14)
N_RECORDS = 320  # 5 batches of 64


def _u32(t: torch.Tensor) -> np.ndarray:
    """``int64`` values in ``[0, 2³²)`` → ``uint32`` numpy."""
    return t.numpy().astype(np.uint32)


def _sig_tensor(sigs: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(sigs).view(np.int32)).view(torch.uint32)


def _mutate(rng: np.random.RandomState, text: str, edits: int) -> str:
    chars = list(text)
    for _ in range(edits):
        chars[rng.randint(len(chars))] = chr(rng.randint(97, 123))
    return "".join(chars)


def stream_records(seed: int, n: int = N_RECORDS) -> list[dict]:
    """Records with urls: mutated near-dups of earlier texts (around the
    0.7 bar), exact copies, short (< k bytes), empty and
    non-ASCII texts, urls repeated within and across batches, missing and
    empty urls."""
    rng = np.random.RandomState(seed)
    texts: list[str] = []
    recs: list[dict] = []
    for i in range(n):
        u = rng.rand()
        if i > 8 and u < 0.22:
            src = texts[rng.randint(i)]
            # 1.5-6% of the characters edited: Jaccard ~0.86 down to ~0.54
            edits = max(1, int(len(src) * rng.uniform(0.015, 0.06)))
            text = _mutate(rng, src, edits) if len(src) > 40 else src
        elif i > 8 and u < 0.30:
            text = texts[rng.randint(i)]
        elif u < 0.33:
            text = "abc"
        elif u < 0.35:
            text = ""
        elif u < 0.38:
            text = "é€ü" * int(rng.randint(2, 60))
        else:
            words = rng.randint(97, 123, size=(int(rng.randint(15, 120)), 6))
            text = " ".join("".join(map(chr, w[: rng.randint(2, 7)])) for w in words)
        texts.append(text)
        v = rng.rand()
        if v < 0.03:
            url = None
        elif v < 0.05:
            url = ""
        elif v < 0.13 and i:
            url = f"https://news.example/{rng.randint(i)}.html"  # an earlier record's url
        else:
            url = f"https://news.example/{i}.html"
        recs.append({"url": url, "article": text, "i": i})
    return recs


def run_stream(backend, records) -> list[tuple]:
    out = []
    for rec in copy.deepcopy(records):
        out += backend.submit(rec)
    out += backend.flush()
    return [(r["i"], r["dup_of"], r["near_dup_of"]) for r in out]


@pytest.fixture(scope="module")
def records():
    return stream_records(21)


@pytest.fixture(scope="module")
def ref_engine():
    """One JAX engine for the module's engine-level tests."""
    return RefEngine(RefConfig(rerank=False))


# -- keys ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sigs(ref_engine, records):
    return ref_engine.signatures([r["article"] for r in records[:130]])


def test_band_keys_wide_equals_reference(sigs):
    params = make_params(128, 16, 5, 1)
    want = np.asarray(ref_lsh.band_keys_wide(sigs, ref_make_params(128, 16, 5, 1).band_salt))
    got = lsh.band_keys_wide(_sig_tensor(sigs), params.band_salt)
    assert got.shape == want.shape == (len(sigs), 16, 2)
    assert np.array_equal(_u32(got), want)
    # lane 0 is band_keys; packing puts lane 1 in the high word
    assert np.array_equal(_u32(got[..., 0]), _u32(lsh.band_keys(_sig_tensor(sigs), params.band_salt)))
    assert np.array_equal(bloom.pack_keys64(_u32(got)), ref_bloom.pack_keys64(want))


@pytest.mark.parametrize("cs", [0, 8, 32])
def test_candidate_keys_equal_reference(sigs, cs):
    salt = make_params(128, 16, 5, 1).band_salt
    want = np.asarray(ref_lsh.candidate_keys(sigs, salt, cs))
    got = lsh.candidate_keys(_sig_tensor(sigs), salt, cs)
    assert got.shape == want.shape == (len(sigs), 16 + cs)
    assert np.array_equal(_u32(got), want)


def test_candidate_keys_need_subbands_that_divide_num_perm(sigs):
    with pytest.raises(ValueError, match="must divide"):
        lsh.candidate_keys(_sig_tensor(sigs), make_params(128, 16, 5, 1).band_salt, 7)


@pytest.mark.parametrize("wide", [False, True])
def test_fused_keys_epilogue_equals_reference(sigs, wide):
    salt = make_params(128, 16, 5, 1).band_salt
    fine = lsh.subband_salt(32)
    want_sig, want_keys = ref_lsh.fused_keys_epilogue(
        sigs, salt, fine, densify_oph=False, wide=wide)
    got_sig, got_keys = lsh.fused_keys_epilogue(
        _sig_tensor(sigs), salt, fine, densify_oph=False, wide=wide)
    assert np.array_equal(got_sig.view(torch.int32).numpy().view(np.uint32), np.asarray(want_sig))
    assert np.array_equal(_u32(got_keys), np.asarray(want_keys))


def test_fused_keys_epilogue_oph_densify_raises(sigs):
    with pytest.raises(NotImplementedError, match="item 12"):
        lsh.fused_keys_epilogue(_sig_tensor(sigs), make_params(128, 16, 5, 1).band_salt,
                                lsh.subband_salt(32), densify_oph=True, wide=False)


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("sync_sigs", [True, False])
def test_signatures_and_keys_equal_reference(ref_engine, records, wide, sync_sigs):
    texts = [r["article"] for r in records[:150]]
    eng = NearDupEngine(DedupConfig(rerank=False), device="cpu")
    want_sigs, want_keys = ref_engine.signatures_and_keys(texts, wide=wide, sync_sigs=sync_sigs)
    got_sigs, got_keys = eng.signatures_and_keys(texts, wide=wide, sync_sigs=sync_sigs)
    assert got_keys.dtype == np.uint32 and np.array_equal(got_keys, want_keys)
    if sync_sigs:
        assert got_sigs.dtype == np.uint32 and np.array_equal(got_sigs, want_sigs)
    else:
        assert got_sigs is None and want_sigs is None
    assert {"encode", "copy", "fold", "keys_epilogue", "readback"} <= set(eng.last_clock.seconds)
    assert eng.last_chunks == 1


@pytest.mark.parametrize("wide", [False, True])
def test_signatures_and_keys_of_an_empty_corpus(ref_engine, wide):
    eng = NearDupEngine(DedupConfig(rerank=False), device="cpu")
    for sync in (True, False):
        want = ref_engine.signatures_and_keys([], wide=wide, sync_sigs=sync)
        got = eng.signatures_and_keys([], wide=wide, sync_sigs=sync)
        assert got[1].shape == want[1].shape and got[1].dtype == np.uint32
        assert (got[0] is None) == (want[0] is None)
        if sync:
            assert got[0].shape == want[0].shape == (0, 128) and got[0].dtype == np.uint32


# -- the Bloom stream index ----------------------------------------------------------


def test_hash_key64_and_pack_keys64_equal_reference():
    for key in ["", "https://news.example/1.html", "é€", "a" * 5000, b"bytes\x00"]:
        assert bloom.hash_key64(key) == ref_bloom.hash_key64(key)
    rng = np.random.RandomState(2)
    wide = rng.randint(0, 1 << 32, size=(9, 16, 2), dtype=np.uint64).astype(np.uint32)
    got = bloom.pack_keys64(wide)
    assert got.dtype == np.uint64 and np.array_equal(got, ref_bloom.pack_keys64(wide))
    assert int(got[0, 0]) == int(wide[0, 0, 1]) << 32 | int(wide[0, 0, 0])
    with pytest.raises(ValueError, match="lane"):
        bloom.pack_keys64(wide[..., :1])


@pytest.mark.parametrize("dtype", [np.uint64, np.uint32])
def test_bloom_band_index_decisions_and_state_equal_reference(dtype):
    """Batches whose rows repeat keys of earlier batches and of earlier rows
    of the batch (including rows that are themselves dups)."""
    rng = np.random.RandomState(5)
    got_idx = bloom.BloomBandIndex(8, bits=1 << 12, num_hashes=3, seed=4)
    ref_idx = ref_bloom.BloomBandIndex(8, bits=1 << 12, num_hashes=3, seed=4)
    history = np.zeros((0, 8), dtype)
    for _ in range(4):
        keys = rng.randint(0, 1 << 31, size=(50, 8)).astype(dtype)
        if len(history):
            keys[:10] = history[rng.randint(len(history), size=10)]
        keys[20:25] = keys[10:15]  # intra-batch repeats
        keys[30, 3] = keys[21, 3]  # one shared band with an intra-batch dup
        got, want = got_idx.check_and_add_batch(keys), ref_idx.check_and_add_batch(keys)
        assert got.dtype == bool and np.array_equal(got, want)
        assert got[20:25].all() and got[30]
        history = np.concatenate([history, keys])
    for k, v in ref_idx.state().items():
        assert np.array_equal(got_idx.state()[k], v), k
    assert got_idx.predicted_row_fp() == ref_idx.predicted_row_fp()
    assert got_idx.fill_ratio() == ref_idx.fill_ratio()
    other = bloom.BloomBandIndex(8, bits=1 << 12, num_hashes=3, seed=4)
    other.restore(*(ref_idx.state()[k] for k in ("words", "inserted", "key_bits")))
    assert np.array_equal(other.contains_batch(history), ref_idx.contains_batch(history))
    got_idx.merge(other)
    assert got_idx.inserted == 2 * ref_idx.inserted
    with pytest.raises(ValueError, match="mixed widths"):
        got_idx.check_and_add_batch(history.astype(np.uint64 if dtype == np.uint32 else np.uint32))


def test_bloom_for_capacity_equals_reference():
    for cap, fp in [(1000, 1e-3), (10_000_000, 1e-3), (50, 0.5)]:
        got = bloom.BloomBandIndex.for_capacity(cap, row_fp=fp)
        want = ref_bloom.BloomBandIndex.for_capacity(cap, row_fp=fp)
        assert (got.bits, got.num_bands, got.num_hashes) == (want.bits, want.num_bands, want.num_hashes)


# -- the backend ----------------------------------------------------------------------

CONFIGS = {
    "exact": dict(stream_index="exact"),
    "exact-fine-margin": dict(stream_index="exact", fine_margin=0.05),
    "exact-coarse-only": dict(stream_index="exact", cand_subbands=0),
    "bloom": dict(stream_index="bloom"),
}


def _backends(overrides: dict, **kw):
    ref = ref_tb.TpuBatchBackend(RefConfig(**SMALL, **overrides), **kw)
    port = tpu_batch.TpuBatchBackend(DedupConfig(**SMALL, **overrides), device="cpu", **kw)
    return ref, port


def _stats(b) -> tuple:
    return dataclasses.astuple(b.stats)


@pytest.fixture(scope="module")
def ref_runs(records):
    """The JAX backend's annotations and stats per configuration."""
    out = {}
    for name, overrides in CONFIGS.items():
        ref = ref_tb.TpuBatchBackend(RefConfig(**SMALL, **overrides))
        out[name] = (run_stream(ref, records), _stats(ref))
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_backend_equals_reference(records, ref_runs, name):
    port = tpu_batch.TpuBatchBackend(DedupConfig(**SMALL, **CONFIGS[name]), device="cpu")
    got = run_stream(port, records)
    want, want_stats = ref_runs[name]
    assert got == want
    assert _stats(port) == want_stats
    assert port.stats.batches == N_RECORDS // 64
    last = "bloom" if name == "bloom" else "join"
    assert set(port.last_clock.seconds) == {"exact_stage", "signatures_and_keys", last}
    dups = [a for a in got if a[1] is not None]
    near = [a for a in got if a[2] is not None]
    assert len(dups) > 10 and len(near) > 20  # the stream exercises both stages
    if name.startswith("exact"):
        assert all(isinstance(a[2], str) and a[2] != tpu_batch.BLOOM_SENTINEL for a in near)
    else:
        assert {a[1] for a in dups} == {a[2] for a in near} == {tpu_batch.BLOOM_SENTINEL}


def test_stream_reaches_the_fine_bar(ref_runs):
    """The mutated near-dups sit near the bar: the fine keys and the fine
    margin each change some verdicts of the exact index."""
    base = ref_runs["exact"][0]
    assert ref_runs["exact-fine-margin"][0] != base
    assert ref_runs["exact-coarse-only"][0] != base


@pytest.mark.parametrize("mode", ["exact", "bloom"])
def test_backend_without_exact_stage_and_with_a_sink(records, mode):
    ref_seen, port_seen = [], []
    ref, _ = _backends(CONFIGS[mode], exact_stage=False, sink=ref_seen.append)
    port = tpu_batch.TpuBatchBackend(DedupConfig(**SMALL, **CONFIGS[mode]), device="cpu",
                                     exact_stage=False, sink=port_seen.append)
    got, want = run_stream(port, records), run_stream(ref, records)
    assert got == want and _stats(port) == _stats(ref)
    assert all(a[1] is None for a in got)
    assert [r["i"] for r in port_seen] == [r["i"] for r in ref_seen] == list(range(N_RECORDS))


def test_bloom_fill_warning_once(records, capsys):
    cfg = dict(stream_index="bloom", batch_size=64, bloom_bits=1 << 10)
    ref = ref_tb.TpuBatchBackend(RefConfig(**cfg))
    port = tpu_batch.TpuBatchBackend(DedupConfig(**cfg), device="cpu")
    capsys.readouterr()
    assert run_stream(port, records) == run_stream(ref, records)
    err = capsys.readouterr().err.splitlines()
    warn = [ln for ln in err if "predicted false-drop" in ln]
    assert len(warn) == 2 and warn[0] == warn[1]  # once each, word for word


def test_unported_modes_raise():
    """The index fleet raises, in every mode and in the engine; the
    persist mode itself is ported (``tests/test_torch_persist.py``)."""
    fleet = dict(index_fleet="h:1", index_dir="x")
    for mode in ("exact", "bloom", "persist"):
        with pytest.raises(NotImplementedError, match="9c"):
            tpu_batch.TpuBatchBackend(DedupConfig(stream_index=mode, **fleet), device="cpu")
    with pytest.raises(ValueError, match="unknown stream_index"):
        tpu_batch.TpuBatchBackend(DedupConfig(stream_index="lsm"), device="cpu")
    with pytest.raises(ValueError, match="index directory"):
        tpu_batch.TpuBatchBackend(DedupConfig(stream_index="persist"), device="cpu")
    eng = NearDupEngine(DedupConfig(rerank=False, **fleet), device="cpu")
    with pytest.raises(NotImplementedError, match="9c"):
        eng.open_stream_index("x")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpu_batch.TpuBatchBackend(DedupConfig(**SMALL))


# -- the checkpoint ---------------------------------------------------------------------

SPLIT = 192  # three batches before the checkpoint


@pytest.mark.parametrize("mode", ["exact", "bloom"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_packages(records, ref_runs, tmp_path, mode, writer):
    """A checkpoint written after three batches by one package, loaded
    into a fresh backend of the other, finishes the stream with the
    annotations and stats of an unbroken run."""
    ref, port = _backends(CONFIGS[mode])
    first, second = (ref, port) if writer == "jax" else (port, ref)
    path = str(tmp_path / "index.npz")
    head = run_stream(first, records[:SPLIT])
    first.save_index(path)
    assert second.load_index_if_valid(path)
    tail = run_stream(second, records[SPLIT:])
    want, want_stats = ref_runs[mode]
    assert head + tail == want
    assert _stats(second) == want_stats
    with np.load(path) as data:
        assert data["fingerprint"].dtype == np.int64
        if mode == "exact":
            assert data["kept_sigs"].dtype == np.uint32
            assert data["seen_keys"].dtype.kind == data["kept_keys"].dtype.kind == "U"
        else:
            assert data["bloom_words"].dtype == np.uint64


def test_checkpoint_files_hold_the_same_arrays(records, tmp_path):
    for mode in ("exact", "bloom"):
        ref, port = _backends(CONFIGS[mode])
        run_stream(ref, records[:SPLIT])
        run_stream(port, records[:SPLIT])
        ref.save_index(str(tmp_path / "ref.npz"))
        port.save_index(str(tmp_path / "port.npz"))
        with np.load(tmp_path / "ref.npz") as a, np.load(tmp_path / "port.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_fingerprint_mismatch_raises(records, tmp_path):
    _ref, port = _backends(CONFIGS["exact"])
    run_stream(port, records[:64])
    path = str(tmp_path / "index.npz")
    port.save_index(path)
    other = tpu_batch.TpuBatchBackend(DedupConfig(**SMALL, seed=2), device="cpu")
    with pytest.raises(tpu_batch.IndexFingerprintError, match="different dedup config"):
        other.load_index_if_valid(path)
    bloom_cfg = tpu_batch.TpuBatchBackend(
        DedupConfig(**SMALL, stream_index="bloom", bloom_hashes=3), device="cpu")
    with pytest.raises(tpu_batch.IndexFingerprintError):
        bloom_cfg.load_index(path)
    assert os.path.exists(path)  # a mismatch is never quarantined


def test_save_with_buffered_records_raises():
    port = tpu_batch.TpuBatchBackend(DedupConfig(**SMALL), device="cpu")
    port.submit({"url": "u", "article": "hello world"})
    with pytest.raises(ValueError, match="flush"):
        port.save_index("never-written.npz")


@pytest.mark.parametrize("package", ["jax", "port"])
def test_truncated_checkpoint_is_quarantined(records, tmp_path, capsys, package):
    """A torn npz goes to ``<path>.quarantine-<pid>`` with a line on
    stderr, and the backend resumes from an empty index."""
    ref, port = _backends(CONFIGS["exact"])
    backend = ref if package == "jax" else port
    run_stream(port, records[:SPLIT])
    path = str(tmp_path / "index.npz")
    port.save_index(path)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    assert backend.load_index_if_valid(path) is False
    assert not os.path.exists(path)
    assert os.path.exists(f"{path}.quarantine-{os.getpid()}")
    assert "quarantined to" in capsys.readouterr().err
    assert _stats(backend) == (0, 0, 0, 0, 0)
    assert not backend._seen_keys and not backend._kept_sigs and not backend._buckets
    assert backend.load_index_if_valid(path) is False  # nothing left to load


@pytest.mark.parametrize("package", ["jax", "port"])
def test_partly_loaded_checkpoint_is_discarded(records, tmp_path, package):
    """A checkpoint whose keys load but whose signatures are missing leaves
    no half-loaded state behind."""
    ref, port = _backends(CONFIGS["exact"])
    backend = ref if package == "jax" else port
    run_stream(port, records[:SPLIT])
    full = str(tmp_path / "full.npz")
    port.save_index(full)
    with np.load(full) as data:
        parts = {k: data[k] for k in data.files if k != "kept_sigs"}
    path = str(tmp_path / "index.npz")
    np.savez(path, **parts)
    assert backend.load_index_if_valid(path) is False
    assert not backend._seen_keys and not backend._kept_keys and _stats(backend)[0] == 0


def test_missing_checkpoint_loads_nothing(tmp_path):
    port = tpu_batch.TpuBatchBackend(DedupConfig(**SMALL), device="cpu")
    assert port.load_index_if_valid(str(tmp_path / "absent.npz")) is False


# -- the torn-write-safe commit ------------------------------------------------------------


def test_atomic_write_commits_whole_or_leaves_the_old_file(tmp_path):
    path = str(tmp_path / "f.bin")
    fsio.atomic_replace(path, b"first")
    assert open(path, "rb").read() == b"first"

    def torn(fh):
        fh.write(b"half")
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        fsio.atomic_write(path, torn)
    assert open(path, "rb").read() == b"first"
    assert [p.name for p in tmp_path.iterdir()] == ["f.bin"]  # no tmp left


def test_atomic_write_sweeps_a_crashed_writers_tmp(tmp_path, monkeypatch):
    monkeypatch.setattr(fsio, "_stale_tmps", {})
    path = tmp_path / "g.npz"
    (tmp_path / "g.npz.tmp-999999").write_bytes(b"torn")
    (tmp_path / "other.tmp-1").write_bytes(b"not ours")
    fsio.atomic_replace(str(path), b"new")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["g.npz", "other.tmp-1"]


def test_default_fs_and_the_unported_chaos_spec(monkeypatch):
    monkeypatch.setattr(fsio, "_default_fs", None)
    assert isinstance(fsio.default_fs(), fsio.OsFs)
    fsio.set_default_fs(None)
    monkeypatch.setenv("ASTPU_CHAOS_FS", "seed=1,crash=1")
    with pytest.raises(NotImplementedError, match="item 18"):
        fsio.default_fs()
    fsio.set_default_fs(None)
