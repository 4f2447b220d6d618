"""The port's decision provenance (``obs/decisions.py`` and its producers)
against the JAX package's: the journal's lines, sampling, rotation and
torn-tail reads in both directions, and ``astpu_decision_total{tier,
verdict}`` with the journal rows of the default engine (tiers ``rerank``,
``margin``, ``band``), the certified path without the tier (``margin``,
``band``), ``ExactDedup`` (``exact``), ``dedup_against_index`` and the
stream backend's exact, bloom and persist modes (``exact``, ``band``,
``index``), on the same seeded inputs.  With the journal off, no row is
built and nothing extra is read back.  Everything on the CPU."""

from __future__ import annotations

import copy
import gc
import json
import os

import numpy as np
import pytest

from advanced_scrapper_tpu.config import DedupConfig as RefConfig
from advanced_scrapper_tpu.extractors import tpu_batch as ref_tb
from advanced_scrapper_tpu.index import PersistentIndex as RefIndex
from advanced_scrapper_tpu.obs import decisions as ref_decisions
from advanced_scrapper_tpu.obs import telemetry as ref_telemetry
from advanced_scrapper_tpu.pipeline.dedup import ExactDedup as RefExact
from advanced_scrapper_tpu.pipeline.dedup import NearDupEngine as RefEngine
from advanced_scrapper_tpu_torch.config import DedupConfig
from advanced_scrapper_tpu_torch.cpu.oracle import build_certification_corpus
from advanced_scrapper_tpu_torch.extractors import tpu_batch
from advanced_scrapper_tpu_torch.index import PersistentIndex
from advanced_scrapper_tpu_torch.obs import decisions, telemetry
from advanced_scrapper_tpu_torch.pipeline.dedup import ExactDedup, NearDupEngine
from test_torch_stream import run_stream, stream_records

PACKAGES = (decisions, ref_decisions)


@pytest.fixture(autouse=True)
def fresh_state():
    # a stopped stack sampler another module left in a reference cycle
    # re-registers its series at every reset until it is collected
    gc.collect()
    for reg in (telemetry.REGISTRY, ref_telemetry.REGISTRY):
        reg.reset()
    yield
    for mod in PACKAGES:
        mod.set_recorder(None)
    for reg in (telemetry.REGISTRY, ref_telemetry.REGISTRY):
        reg.reset()


def journals(tmp_path, tag: str, **kw) -> tuple[str, str]:
    """Install a journal on both packages' recorders; ``(port, jax)`` paths."""
    paths = []
    for name, mod in (("port", decisions), ("jax", ref_decisions)):
        path = str(tmp_path / f"{tag}-{name}.jsonl")
        mod.configure(path, **{"sample": 1.0, **kw})
        paths.append(path)
    return paths[0], paths[1]


def rows(mod, path: str) -> list[dict]:
    """The journal's records without their wall-clock stamp."""
    return [{k: v for k, v in r.items() if k != "ts"} for r in mod.DecisionJournal.read(path)]


def mixes() -> tuple[dict, dict]:
    return decisions.decision_mix_snapshot(), ref_decisions.decision_mix_snapshot()


def corpus(seed: int = 31) -> list[bytes]:
    """A certification corpus at test size: 96 documents, two long."""
    return build_certification_corpus(np.random.RandomState(seed), 24, max_len=4000,
                                      n_long=2, long_len=8000)


# -- the journal ---------------------------------------------------------------

ROWS = [
    {"doc": 7, "verdict": "dup", "tier": "band", "attr": 3, "band_key": 99, "regime": "oneshot"},
    {"doc": 8, "verdict": "unique", "tier": "band", "attr": -1, "band_key": None},
    {"doc": 9, "name": "https://a/é\"q", "verdict": "dup", "tier": "index", "attr": 2,
     "band_key": (1 << 63) + 5, "regime": "stream"},
]


def test_constants_equal_reference():
    assert decisions.TIERS == ref_decisions.TIERS
    assert decisions.VERDICTS == ref_decisions.VERDICTS
    for name in ("JOURNAL_ENV", "SAMPLE_ENV", "MAX_BYTES_ENV", "DEFAULT_SAMPLE",
                 "DEFAULT_MAX_BYTES"):
        assert getattr(decisions, name) == getattr(ref_decisions, name)


def test_journal_lines_equal_reference(tmp_path):
    """Both packages write the same lines (the stamp aside) and each reads
    the other's file."""
    files = {}
    for name, mod in (("port", decisions), ("jax", ref_decisions)):
        j = mod.DecisionJournal(str(tmp_path / f"{name}.jsonl"), sample=1.0)
        assert j.append(ROWS) == 3 and j.append(ROWS[:1]) == 1
        files[name] = j.path
    lines = {n: open(p, "rb").read().splitlines() for n, p in files.items()}
    strip = [[{k: v for k, v in json.loads(ln).items() if k != "ts"} for ln in lines[n]]
             for n in ("port", "jax")]
    assert strip[0] == strip[1] and [r["seq"] for r in strip[0]] == [0, 1, 2, 3]
    for path in files.values():
        assert rows(decisions, path) == rows(ref_decisions, path) == strip[0]
    # the JSON keys sorted, no spaces: the reference's exact line layout
    rec = json.loads(lines["port"][0])
    assert lines["port"][0] == json.dumps(rec, separators=(",", ":"), sort_keys=True).encode()


@pytest.mark.parametrize("tail", [b'{"doc": 10, "verdict": "du', b"\xff\xfe garbage\n",
                                  b"[1, 2]\n", b"\n\n"])
def test_torn_tail_reads_equal_reference(tmp_path, tail):
    path = str(tmp_path / "torn.jsonl")
    decisions.DecisionJournal(path, sample=1.0).append(ROWS)
    with open(path, "ab") as f:
        f.write(tail)
    want = rows(ref_decisions, path)
    assert rows(decisions, path) == want and [r["doc"] for r in want] == [7, 8, 9]


@pytest.mark.parametrize("sample", [0.0, 0.25, 0.5, 1.0])
def test_sampling_equals_reference(tmp_path, sample):
    """Unique records are sampled by (seed, seq), dup records always kept."""
    kept = []
    for name, mod in (("port", decisions), ("jax", ref_decisions)):
        j = mod.DecisionJournal(str(tmp_path / f"{name}.jsonl"), sample=sample, seed=3)
        j.append({"doc": i, "verdict": "unique", "tier": "band"} for i in range(400))
        j.append([{"doc": 1000, "verdict": "dup", "tier": "band", "attr": 0}])
        kept.append(([r["doc"] for r in mod.DecisionJournal.read(j.path)], j.sampled_out))
    assert kept[0] == kept[1]
    assert 1000 in kept[0][0]
    if 0 < sample < 1:
        assert 0 < len(kept[0][0]) - 1 < 400


def test_rotation_equals_reference(tmp_path):
    """Each package rotates at its cap (where depends on the stamps'
    widths), and each reads the other's two generations oldest first."""
    for name, mod in (("port", decisions), ("jax", ref_decisions)):
        path = str(tmp_path / f"{name}.jsonl")
        j = mod.DecisionJournal(path, sample=1.0, max_bytes=2048)
        for i in range(200):
            j.append([{"doc": i, "verdict": "dup", "tier": "band", "attr": 0}])
        assert os.path.getsize(path) <= 2048 and os.path.getsize(path + ".old") <= 2048
        got = rows(decisions, path)
        assert got == rows(ref_decisions, path)
        docs = [r["doc"] for r in got]
        assert docs == list(range(docs[0], 200)) and len(docs) > 20


class _FailingFs:
    """A file system whose appends fail ``fail`` times, then write."""

    def __init__(self, fail: int):
        self.fail = fail

    def open(self, path, mode="r", **kw):
        if "a" in mode and self.fail:
            self.fail -= 1
            raise OSError("injected")
        return open(path, mode, **kw)

    def exists(self, path):
        return os.path.exists(path)

    def size(self, path):
        return os.path.getsize(path)

    def replace(self, a, b):
        os.replace(a, b)

    def remove(self, path):
        os.remove(path)


def test_write_errors_are_contained_and_counted(tmp_path):
    telemetry.REGISTRY.set_enabled(True)
    try:
        path = str(tmp_path / "e.jsonl")
        j = decisions.DecisionJournal(path, fs=_FailingFs(1), sample=1.0)
        assert j.append(ROWS[:1]) == 0 and j.write_errors == 1
        assert j.append(ROWS[1:2]) == 1
        assert open(path, "rb").read().startswith(b"\n"), "the next append leads with \\n"
        assert [r["doc"] for r in rows(ref_decisions, path)] == [8]
        (c,) = telemetry.REGISTRY.find("astpu_decision_journal_errors_total")
        assert c.value == 1
    finally:
        telemetry.REGISTRY.set_enabled(None)


def test_recorder_env_wiring_and_disabled_journal(tmp_path, monkeypatch):
    decisions.set_recorder(None)
    monkeypatch.setenv("ASTPU_DECISION_JOURNAL", str(tmp_path / "env.jsonl"))
    monkeypatch.setenv("ASTPU_DECISION_SAMPLE", "1.0")
    monkeypatch.setenv("ASTPU_DECISION_JOURNAL_MAX_BYTES", "4096")
    rec = decisions.get_recorder()
    assert rec.journal is not None and rec.journal.sample == 1.0
    assert rec.journal.max_bytes == 4096 and decisions.get_recorder() is rec
    rec.record("exact", "dup", doc=1, attr=0)
    assert rows(ref_decisions, str(tmp_path / "env.jsonl")) == [
        {"seq": 0, "tier": "exact", "verdict": "dup", "doc": 1, "attr": 0}]
    decisions.set_recorder(None)
    monkeypatch.delenv("ASTPU_DECISION_JOURNAL")
    off = decisions.get_recorder()
    assert off.journal is None

    def exploding_rows():
        raise AssertionError("a row was built with the journal off")
        yield  # pragma: no cover

    assert off.journal_rows(exploding_rows()) == 0


def test_counters_mix_and_generation_equal_reference():
    for mod, reg in ((decisions, telemetry.REGISTRY), (ref_decisions, ref_telemetry.REGISTRY)):
        rec = mod.DecisionRecorder(None)
        rec.count("band", "dup", 2)
        rec.count("band", "dup", 0)
        before = mod.decision_mix_snapshot()
        rec.count("band", "dup")
        rec.count("rerank", "unique", 4)
        reg.reset()  # a reset registry: the recorder re-registers its handles
        rec.count("margin", "dup", 3)
        assert mod.decision_mix_snapshot() == {"margin:dup": 3.0}
        assert mod.decision_mix_delta(before) == {"margin:dup": 3.0}
    assert telemetry.REGISTRY.prometheus_text() == ref_telemetry.REGISTRY.prometheus_text()


# -- the producers -------------------------------------------------------------


@pytest.mark.parametrize("overrides", [dict(), dict(rerank=False)], ids=["default", "certified"])
def test_engine_decisions_equal_reference(tmp_path, overrides):
    texts = corpus()
    port_path, ref_path = journals(tmp_path, "eng")
    eng = NearDupEngine(DedupConfig(**overrides), device="cpu")
    got = eng.dedup_reps(texts)
    want = np.asarray(RefEngine(RefConfig(**overrides)).dedup_reps(texts))
    assert np.array_equal(got, want)
    mix, ref_mix = mixes()
    assert mix == ref_mix and sum(mix.values()) == len(texts)
    tiers = {k.split(":")[0] for k in mix}
    assert tiers == ({"rerank", "margin", "band"} if not overrides else {"margin", "band"})
    assert rows(decisions, port_path) == rows(ref_decisions, ref_path)
    recs = rows(decisions, port_path)
    assert len(recs) == len(texts)
    for i, r in enumerate(recs):
        assert r["doc"] == i and r["regime"] == "oneshot"
        assert r["attr"] == (int(got[i]) if got[i] != i else -1)


def test_exact_dedup_decisions_equal_reference():
    items = ["a", "b", "a", "c", "b", "a", "", "é", "é"]
    assert ExactDedup(device="cpu").keep_indices(items) == RefExact().keep_indices(items)
    mix, ref_mix = mixes()
    assert mix == ref_mix == {"exact:unique": 5.0, "exact:dup": 4.0}
    assert ExactDedup(device="cpu").keep_indices([]) == []
    assert mixes()[0] == mix


def test_dedup_against_index_decisions_equal_reference(tmp_path):
    texts = [t.decode("latin-1") for t in corpus(7)] + ["abc", ""]
    port_path, ref_path = journals(tmp_path, "idx")
    got_ix = PersistentIndex(str(tmp_path / "port-ix"))
    want_ix = RefIndex(str(tmp_path / "jax-ix"))
    eng = NearDupEngine(DedupConfig(), device="cpu")
    ref = RefEngine(RefConfig())
    for part in (texts[:50], texts[50:]):
        got = eng.dedup_against_index(part, got_ix)
        assert np.array_equal(got, ref.dedup_against_index(part, want_ix))
    mix, ref_mix = mixes()
    assert mix == ref_mix and set(mix) == {"index:dup", "index:unique"}
    assert rows(decisions, port_path) == rows(ref_decisions, ref_path)
    assert any(r["band_key"] is not None for r in rows(decisions, port_path))


STREAM = dict(batch_size=64, bloom_bits=1 << 14)


@pytest.mark.parametrize("mode", ["exact", "bloom", "persist"])
def test_stream_decisions_equal_reference(tmp_path, mode):
    records = stream_records(21, 256)
    port_path, ref_path = journals(tmp_path, mode)
    kw = {"index_dir": str(tmp_path / "ix")} if mode == "persist" else {}
    port = tpu_batch.TpuBatchBackend(DedupConfig(**STREAM, stream_index=mode), device="cpu",
                                     **({"index_dir": str(tmp_path / "port")} if kw else {}))
    ref = ref_tb.TpuBatchBackend(RefConfig(**STREAM, stream_index=mode),
                                 **({"index_dir": str(tmp_path / "jax")} if kw else {}))
    assert run_stream(port, copy.deepcopy(records)) == run_stream(ref, records)
    mix, ref_mix = mixes()
    assert mix == ref_mix
    near_tier = "band" if mode == "exact" else "index"
    assert {k.split(":")[0] for k in mix} == {"exact", near_tier}
    assert mix[f"{near_tier}:dup"] > 0 and mix["exact:dup"] > 0
    got = rows(decisions, port_path)
    assert got == rows(ref_decisions, ref_path)
    assert bool(got) == (mode == "persist"), "only the persist mode journals stream rows"
    if mode == "persist":
        assert {r["tier"] for r in got} == {"exact", "index"}
        port.close()
        ref.close()


def test_journal_off_reads_nothing_back(tmp_path, monkeypatch):
    """With the journal off the counters move, and no row is built: the
    engine reads no key matrix back and the index path probes nothing
    beyond its own check-and-add; with it on, each happens once."""
    reads, probes = [], []
    real_read = NearDupEngine._read_keys

    def counted_read(self, keys, n):
        reads.append(n)
        return real_read(self, keys, n)

    monkeypatch.setattr(NearDupEngine, "_read_keys", counted_read)
    texts = corpus()
    ix = PersistentIndex(str(tmp_path / "ix"))
    real_probe, real_add = ix.probe_batch, ix.check_and_add_batch
    adding = []

    def add(keys, ids):  # its own probes are not the journal's
        adding.append(True)
        try:
            return real_add(keys, ids)
        finally:
            adding.pop()

    def probe(keys):
        if not adding:
            probes.append(len(keys))
        return real_probe(keys)

    ix.probe_batch, ix.check_and_add_batch = probe, add
    eng = NearDupEngine(DedupConfig(rerank=False), device="cpu")
    decisions.configure(None)
    eng.dedup_reps(texts)
    eng.dedup_against_index(texts, ix)
    assert sum(mixes()[0].values()) == 2 * len(texts)
    assert reads == [] and probes == []
    decisions.configure(str(tmp_path / "on.jsonl"), sample=1.0)
    eng.dedup_reps(texts)
    eng.dedup_against_index(texts, ix)
    assert reads == [len(texts)] and len(probes) == 1
    assert len(rows(decisions, str(tmp_path / "on.jsonl"))) == 2 * len(texts)
