"""The port's persistent index (``advanced_scrapper_tpu_torch/index/``) on
the CPU against the JAX package's: the write-ahead log, segments, the
store's lifecycle, crash windows (each package's ``ChaosFs`` and
``SimulatedCrash`` drive the port's index, with equal ledgers), integrity
and quarantine, and
directories that either package writes and the other reopens.  Exact
equality throughout: the same answers, and the same bytes on disk where no
compaction runs on a thread."""

from __future__ import annotations

import json
import os
import threading

import numpy as np
import pytest

from advanced_scrapper_tpu import index as ref_ix
from advanced_scrapper_tpu.index import repair as ref_repair
from advanced_scrapper_tpu.index import segment as ref_seg
from advanced_scrapper_tpu.storage import fsio as ref_fsio
from advanced_scrapper_tpu.storage.fsio import OsFs, SimulatedCrash
from advanced_scrapper_tpu_torch import index as ix
from advanced_scrapper_tpu_torch.index import repair, segment
from advanced_scrapper_tpu_torch.index.store import resolve_intra_batch
from advanced_scrapper_tpu_torch.index.wal import WriteAheadLog, replay_wal
from advanced_scrapper_tpu_torch.storage import fsio

PACKAGES = {"jax": ref_ix, "port": ix}
#: each package's fault injection: (ChaosFs, SimulatedCrash)
CHAOS = {"jax": (ref_fsio.ChaosFs, ref_fsio.SimulatedCrash),
         "port": (fsio.ChaosFs, fsio.SimulatedCrash)}
OTHER = {"jax": "port", "port": "jax"}


def _rand_keys(rng, n, nb=4):
    return rng.randint(0, 1 << 60, size=(n, nb)).astype(np.uint64)


def _flip_bit(path: str, byte_off: int, bit: int = 0) -> None:
    with open(path, "r+b") as fh:
        fh.seek(byte_off)
        b = fh.read(1)[0]
        fh.seek(byte_off)
        fh.write(bytes([b ^ (1 << bit)]))


def _tree(d: str) -> dict[str, bytes]:
    out = {}
    for root, _dirs, files in os.walk(d):
        for f in files:
            p = os.path.join(root, f)
            out[os.path.relpath(p, d)] = open(p, "rb").read()
    return out


class ReplaceCrashFs(OsFs):
    """Dies (``SimulatedCrash``) at the manifest swap once armed."""

    armed = False

    def replace(self, src, dst):
        if self.armed and "manifest" in os.path.basename(dst):
            raise SimulatedCrash(f"crash replacing {dst}")
        super().replace(src, dst)


# -- write-ahead log -----------------------------------------------------------


def test_wal_round_trip_bytes_and_replay_cross_packages(tmp_path):
    batches = [(np.array([1, 2, 3], np.uint64), np.array([10, 10, 10], np.uint64)),
               (np.array([4, 1 << 63, 2**64 - 1], np.uint64), np.array([11, 11, 12], np.uint64)),
               (np.zeros(0, np.uint64), np.zeros(0, np.uint64))]
    paths = {}
    for name, pkg in (("jax", ref_ix), ("port", ix)):
        paths[name] = str(tmp_path / f"wal-{name}.log")
        wal = pkg.WriteAheadLog(paths[name])
        for k, d in batches:
            wal.append(k, d)
        wal.sync()
        wal.close()
        assert wal.appended == 6
    assert open(paths["jax"], "rb").read() == open(paths["port"], "rb").read()
    for p in paths.values():
        for replay in (replay_wal, ref_ix.replay_wal):
            keys, docs, end = replay(p)
            assert keys.tolist() == [1, 2, 3, 4, 1 << 63, 2**64 - 1]
            assert docs.tolist() == [10, 10, 10, 11, 11, 12] and end == os.path.getsize(p)
    assert replay_wal(str(tmp_path / "missing.log"))[2] == 0
    with pytest.raises(ValueError, match="mismatch"):
        WriteAheadLog(str(tmp_path / "w.log")).append(np.array([1], np.uint64),
                                                       np.array([1, 2], np.uint64))


def test_wal_torn_tail_dropped_whole(tmp_path):
    path = str(tmp_path / "wal-0.log")
    wal = WriteAheadLog(path)
    wal.append(np.array([7, 8], np.uint64), np.array([1, 1], np.uint64))
    wal.append(np.array([9], np.uint64), np.array([2], np.uint64))
    wal.close()
    whole = open(path, "rb").read()
    rec2 = whole.rindex(b"\xde\xc0\x1d\xa5")
    for cut in range(rec2 + 1, len(whole)):
        with open(path, "wb") as fh:
            fh.write(whole[:cut])
        got = replay_wal(path)
        want = ref_ix.replay_wal(path)
        assert got[0].tolist() == [7, 8] and got[2] == want[2] == rec2, cut
    data = bytearray(whole)
    data[-1] ^= 0xFF
    with open(path, "wb") as fh:
        fh.write(bytes(data))
    assert replay_wal(path)[0].tolist() == [7, 8]


def wal_short_write(chaos: str, d) -> list:
    path = str(d / "wal-0.log")
    good = WriteAheadLog(path)
    good.append(np.array([1], np.uint64), np.array([5], np.uint64))
    good.close()
    fs = CHAOS[chaos][0](OsFs(), seed=3, short_write_rate=1.0, only="wal-")
    wal = WriteAheadLog(path, fs=fs)
    with pytest.raises(OSError):
        wal.append(np.array([2, 3], np.uint64), np.array([6, 6], np.uint64))
    wal.close()
    assert replay_wal(path)[0].tolist() == [1]
    wal2 = WriteAheadLog(path)
    wal2.append(np.array([4], np.uint64), np.array([7], np.uint64))
    wal2.close()
    keys, docs, _ = replay_wal(path)
    assert keys.tolist() == [1, 4] and docs.tolist() == [5, 7]
    return fs.ledger


@pytest.mark.parametrize("chaos", ["jax", "port"])
def test_wal_failed_append_rolls_back_framing(tmp_path, chaos):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    ledger = wal_short_write(chaos, tmp_path / "a")
    assert ledger and ledger == wal_short_write(OTHER[chaos], tmp_path / "b")


def wal_crash(chaos: str, d) -> list:
    path = str(d / "wal-0.log")
    WriteAheadLog(path).append(np.array([1], np.uint64), np.array([5], np.uint64))
    fs = CHAOS[chaos][0](OsFs(), seed=1, crash_rate=1.0, only="wal-")
    wal = WriteAheadLog(path, fs=fs)
    with pytest.raises(CHAOS[chaos][1]):
        wal.append(np.array([2, 3], np.uint64), np.array([6, 6], np.uint64))
    assert replay_wal(path)[0].tolist() == [1]
    return fs.ledger


@pytest.mark.parametrize("chaos", ["jax", "port"])
def test_wal_crash_mid_append_propagates(tmp_path, chaos):
    """A ``SimulatedCrash`` inside an append goes through (the process is
    dead) and leaves a torn tail that replay drops whole."""
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    ledger = wal_crash(chaos, tmp_path / "a")
    assert ledger and ledger == wal_crash(OTHER[chaos], tmp_path / "b")


# -- segments ------------------------------------------------------------------


@pytest.mark.parametrize("version", [1, 2])
def test_segment_bytes_and_probes_equal_reference(tmp_path, version):
    rng = np.random.RandomState(0)
    keys = rng.randint(0, 1 << 40, size=300).astype(np.uint64)
    keys[::7] = keys[1::7][: len(keys[::7])]  # shared keys, several docs each
    docs = rng.randint(0, 50, size=300).astype(np.uint64)
    p, q = str(tmp_path / "seg-port.seg"), str(tmp_path / "seg-jax.seg")
    dp = segment.write_segment(p, keys, docs, seed=3, version=version, block_bytes=512)
    dq = ref_seg.write_segment(q, keys, docs, seed=3, version=version, block_bytes=512)
    assert dp == dq and open(p, "rb").read() == open(q, "rb").read()
    assert segment.file_digest(p) == dp
    oracle: dict[int, set] = {}
    for k, d in zip(keys.tolist(), docs.tolist()):
        oracle.setdefault(k, set()).add(d)
    queries = np.concatenate([keys[:80], rng.randint(0, 1 << 40, size=200).astype(np.uint64)])
    for reader in (segment.Segment, ref_seg.Segment):
        for path in (p, q):
            seg = reader(path)
            assert seg.version == version
            rows, hit = seg.probe(queries)
            got: dict[int, set] = {}
            for r, d in zip(rows.tolist(), hit.tolist()):
                got.setdefault(int(queries[r]), set()).add(d)
            assert all(got.get(k, set()) == oracle.get(k, set()) for k in queries.tolist())
            assert seg.verify_all() == dp
    mine, ref = segment.Segment(p), ref_seg.Segment(q)
    assert (mine.resident_bytes, mine.file_bytes) == (ref.resident_bytes, ref.file_bytes)
    r1, h1 = mine.probe(queries)
    r2, h2 = ref.probe(queries)
    assert np.array_equal(r1, r2) and np.array_equal(h1, h2)
    assert (mine.bloom_hits, mine.bloom_false) == (ref.bloom_hits, ref.bloom_false)
    assert mine.resident_bytes < 16 * mine.count + mine.bloom.memory_bytes


def test_segment_duplicate_pairs_collapse_and_empty(tmp_path):
    path = str(tmp_path / "seg-1.seg")
    segment.write_segment(path, np.array([5, 5, 5, 9], np.uint64), np.array([2, 2, 3, 1], np.uint64))
    seg = segment.Segment(path)
    assert seg.count == 3
    assert sorted(seg.probe(np.array([5], np.uint64))[1].tolist()) == [2, 3]
    empty = str(tmp_path / "seg-2.seg")
    segment.write_segment(empty, np.zeros(0, np.uint64), np.zeros(0, np.uint64))
    assert segment.Segment(empty).probe(np.array([5], np.uint64))[0].size == 0
    with pytest.raises(ValueError, match="version"):
        segment.write_segment(empty, np.zeros(0, np.uint64), np.zeros(0, np.uint64), version=3)


def segment_crash(chaos: str, d) -> list:
    path = str(d / "seg-1.seg")
    fs = CHAOS[chaos][0](OsFs(), seed=5, crash_rate=1.0, only="seg-")
    with pytest.raises(CHAOS[chaos][1]):
        segment.write_segment(path, np.array([1, 2], np.uint64), np.array([0, 1], np.uint64),
                              fs=fs)
    assert not os.path.exists(path)
    return fs.ledger


@pytest.mark.parametrize("chaos", ["jax", "port"])
def test_segment_write_is_atomic_under_crash(tmp_path, chaos):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    ledger = segment_crash(chaos, tmp_path / "a")
    assert ledger and ledger == segment_crash(OTHER[chaos], tmp_path / "b")


@pytest.mark.parametrize("case", ["rot-in-block", "rotted-key", "downward-at-boundary",
                                  "bloom-plane", "header"])
def test_segment_rot_raises_on_the_probe_path(tmp_path, case):
    """Each kind of bit rot raises ``SegmentCorruption`` (or refuses the
    open) where the reference's does, never reading as 'never posted'."""
    keys = np.arange(1000, 2000, dtype=np.uint64)
    docs = np.arange(1000, dtype=np.uint64)
    outcomes = []
    for name, mod in (("port", segment), ("jax", ref_seg)):
        path = str(tmp_path / f"seg-{name}.seg")
        mod.write_segment(path, keys, docs, seed=2, block_bytes=256)
        seg = mod.Segment(path)
        base = mod.HEADER_LEN + seg.bloom.memory_bytes
        if case == "rot-in-block":
            _flip_bit(path, base + 8 * 500, bit=3)
            assert seg.probe(np.array([1001], np.uint64))[1].tolist() == [1]
            query = 1500
        elif case == "rotted-key":
            _flip_bit(path, base + 8 * 40 + 4, bit=7)
            query = 1040
        elif case == "downward-at-boundary":
            with open(path, "r+b") as fh:
                fh.seek(base + 8 * 63 + 1)
                fh.write(b"\x00")
            query = 1063
        else:
            _flip_bit(path, mod.HEADER_LEN + 3 if case == "bloom-plane" else 20, bit=2)
            try:
                mod.Segment(path)
                outcomes.append("opened")
            except mod.SegmentCorruption as e:
                outcomes.append(e.detail)
            continue
        with pytest.raises(mod.SegmentCorruption) as err:
            seg.probe(np.array([query], np.uint64))
        outcomes.append(err.value.detail)
    assert outcomes[0] == outcomes[1] != "opened"


# -- the store -----------------------------------------------------------------


def test_resolve_intra_batch_equals_reference():
    rng = np.random.RandomState(4)
    keys = rng.randint(0, 12, size=(60, 3)).astype(np.uint64)
    ids = np.arange(100, 160, dtype=np.uint64)
    attr0 = np.where(rng.rand(60) < 0.2, rng.randint(0, 50, size=60), -1).astype(np.int64)
    got = resolve_intra_batch(keys, ids, attr0.copy())
    want = ref_ix.store.resolve_intra_batch(keys, ids, attr0.copy())
    assert np.array_equal(got, want) and (got >= 0).sum() > (attr0 >= 0).sum()


def test_cut_reopen_never_loses_or_doubles_postings(tmp_path):
    idx = ix.PersistentIndex(str(tmp_path / "ix"), cut_postings=40, compact_segments=0)
    rng = np.random.RandomState(1)
    inserted = {}
    for _ in range(6):
        keys = _rand_keys(rng, 8)
        ids = idx.allocate_doc_ids(8)
        idx.insert_batch(keys.ravel(), np.repeat(ids, 4))
        for row, d in zip(keys, ids.tolist()):
            for k in row.tolist():
                inserted.setdefault(k, d)
    assert idx.segment_cuts == 3 and idx.postings_appended == 192
    idx.close()
    idx2 = ix.PersistentIndex(str(tmp_path / "ix"), cut_postings=40, compact_segments=0)
    keys, _docs = idx2.dump_postings()
    assert len(keys) == len(inserted) and set(keys.tolist()) == set(inserted)
    sample = list(inserted.items())[:20]
    out = idx2.probe_batch(np.array([[k] for k, _ in sample], np.uint64))
    assert out.tolist() == [d for _, d in sample]
    assert (idx2.probe_rows, idx2.probe_hits) == (20, 20)
    idx2.close()


def test_check_and_add_intra_batch_first_seen_and_kept_rows_only(tmp_path):
    idx = ix.PersistentIndex(str(tmp_path / "ix"), cut_postings=1000)
    keys = np.array([[1, 2], [3, 4], [1, 9], [8, 4], [7, 7]], np.uint64)
    ids = idx.allocate_doc_ids(5)
    assert idx.check_and_add_batch(keys, ids).tolist() == [-1, -1, 0, 1, -1]
    assert idx.probe_batch(np.array([[9], [8]], np.uint64)).tolist() == [-1, -1]
    idx.insert_batch(np.array([100], np.uint64), np.array([0], np.uint64))
    ids = idx.allocate_doc_ids(3)
    attr = idx.check_and_add_batch(np.array([[100, 70], [70, 80], [80, 90]], np.uint64), ids)
    assert attr.tolist() == [0, -1, int(ids[1])]
    with pytest.raises(ValueError, match="doc ids"):
        idx.check_and_add_batch(keys, ids)
    idx.close()


def test_probe_across_memtable_and_segments_prefers_earliest(tmp_path):
    idx = ix.PersistentIndex(str(tmp_path / "ix"), cut_postings=2, compact_segments=0)
    idx.insert_batch(np.array([50, 51], np.uint64), np.array([0, 0], np.uint64))
    assert idx.stats()["segments"] == 1
    idx.insert_batch(np.array([50], np.uint64), np.array([7], np.uint64))
    assert idx.probe_batch(np.array([50], np.uint64)).tolist() == [0]
    assert idx.probe_batch(np.zeros((0, 3), np.uint64)).shape == (0,)
    idx.close()


@pytest.mark.parametrize("step", ["cut", "compact"])
def test_crash_at_manifest_swap_converges(tmp_path, step):
    """A crash at the commit point of a cut or a compaction: a fresh open
    sees the old manifest, every posting exactly once, the orphan swept;
    the next try commits."""
    fs = ReplaceCrashFs()
    d = str(tmp_path / "ix")
    if step == "cut":
        idx = ix.PersistentIndex(d, cut_postings=10_000, compact_segments=0, fs=fs)
        keys = _rand_keys(np.random.RandomState(2), 10, 3)
        idx.insert_batch(keys.ravel(), np.repeat(idx.allocate_doc_ids(10), 3))
    else:
        idx = ix.PersistentIndex(d, cut_postings=4, compact_segments=0, fs=fs)
        for doc, extra in ((1, 100), (4, 101), (9, 102)):
            idx.insert_batch(np.array([77, extra, extra + 10, extra + 20], np.uint64),
                             np.full((4,), doc, np.uint64))
        assert idx.stats()["segments"] == 3
    pre, _ = idx.dump_postings()
    fs.armed = True
    with pytest.raises(SimulatedCrash):
        idx.cut_segment() if step == "cut" else idx.compact()
    idx2 = ix.PersistentIndex(d, cut_postings=4, compact_segments=0)
    k2, _ = idx2.dump_postings()
    assert sorted(k2.tolist()) == sorted(pre.tolist())
    if step == "cut":
        assert idx2.stats()["segments"] == 0 and len(k2) == len(set(k2.tolist()))
        assert not [f for f in os.listdir(d) if f.endswith(".seg")]
        assert idx2.cut_segment()
        assert idx2.stats()["segments"] == 1 and idx2.stats()["wal_postings"] == 0
    else:
        assert idx2.stats()["segments"] == 3
        assert idx2.compact() and idx2.stats()["segments"] == 1
        k3, d3 = idx2.dump_postings()
        assert len(k3) == 10 and d3[k3.tolist().index(77)] == 1 and idx2.tombstoned == 2
        assert idx2.probe_batch(np.array([77], np.uint64)).tolist() == [1]
    idx2.close()


def seeded_index_crashes(chaos: str, d) -> list:
    rng = np.random.RandomState(9)
    batches = [_rand_keys(rng, 6, 2) for _ in range(12)]
    crashed, ledgers = 0, []
    for seed in range(6):
        root = str(d / f"ix{seed}")
        fs = CHAOS[chaos][0](OsFs(), seed=seed, crash_rate=0.08)
        idx = ix.PersistentIndex(root, cut_postings=20, compact_segments=3,
                                 compact_inline=True, fs=fs)
        acked: list[int] = []
        try:
            for b in batches:
                ids = idx.allocate_doc_ids(len(b))
                idx.insert_batch(b.ravel(), np.repeat(ids, 2))
                acked += b.ravel().tolist()
        except CHAOS[chaos][1]:
            crashed += 1
        again = ix.PersistentIndex(root, cut_postings=20, compact_segments=3, compact_inline=True)
        keys, _ = again.dump_postings()
        have = keys.tolist()
        assert set(acked) <= set(have) and len(set(have)) == len(have)
        again.close()
        ledgers.append(list(fs.ledger))
    assert crashed
    return ledgers


@pytest.mark.parametrize("chaos", ["jax", "port"])
def test_seeded_crashes_inside_the_index_converge(tmp_path, chaos):
    """``ChaosFs`` crashes at seeded points of WAL appends, segment writes
    and manifest swaps: after each, a fresh open holds every posting that
    was acknowledged, none twice; both packages' ``ChaosFs`` fire the same
    faults."""
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    ledgers = seeded_index_crashes(chaos, tmp_path / "a")
    assert ledgers == seeded_index_crashes(OTHER[chaos], tmp_path / "b")


def test_docmap_torn_tail_read_only_and_ids_never_reissued(tmp_path):
    d = str(tmp_path / "ix")
    idx = ix.PersistentIndex(d, cut_postings=4, compact_segments=0)
    idx.log_names([0, 1], ["https://a", "https://b"])
    with open(os.path.join(d, "docmap.log"), "ab") as fh:
        fh.write(b"2\thttps://tor")
    assert idx.lookup_names([0, 1, 2]) == {0: "https://a", 1: "https://b"}
    idx.insert_batch(np.array([5, 6], np.uint64), np.array([0, 0], np.uint64))
    open(os.path.join(d, "seg-00000099.seg"), "wb").write(b"inflight")
    open(os.path.join(d, "wal-00000099.log"), "wb").close()
    before = sorted(os.listdir(d))
    ro = ix.PersistentIndex(d, read_only=True)
    assert ro.probe_batch(np.array([5], np.uint64)).tolist() == [0]
    for call in (lambda: ro.insert_batch(np.array([9], np.uint64), np.array([1], np.uint64)),
                 lambda: ro.allocate_doc_ids(1), ro.cut_segment, ro.compact, ro.checkpoint,
                 lambda: ro.log_names([1], ["x"]), ro.wipe):
        with pytest.raises(ValueError, match="read_only"):
            call()
    ro.close()
    assert sorted(os.listdir(d)) == before
    idx.close()
    bands = ix.PersistentIndex(str(tmp_path / "bands"), cut_postings=1000)
    urls = ix.PersistentIndex(str(tmp_path / "urls"), cut_postings=1000)
    urls.insert_batch(np.array([11, 12, 13], np.uint64), bands.allocate_doc_ids(3))
    bands.close()
    urls.close()
    bands = ix.PersistentIndex(str(tmp_path / "bands"), cut_postings=1000)
    bands.raise_doc_id_floor(ix.PersistentIndex(str(tmp_path / "urls")).doc_id_floor())
    assert int(bands.allocate_doc_ids(1)[0]) == 3
    bands.close()


def test_wal_reopen_after_torn_tail_keeps_new_appends(tmp_path):
    d = str(tmp_path / "ix")
    idx = ix.PersistentIndex(d, cut_postings=10_000, compact_segments=0)
    idx.insert_batch(np.array([1], np.uint64), np.array([0], np.uint64))
    idx.close()
    wal = [f for f in os.listdir(d) if f.startswith("wal-")][0]
    with open(os.path.join(d, wal), "ab") as fh:
        fh.write(b"\xde\xc0\x1d\xa5GARBAGE-TORN-TAIL")
    idx2 = ix.PersistentIndex(d, cut_postings=10_000, compact_segments=0)
    assert idx2.wal_torn == 1
    idx2.insert_batch(np.array([2], np.uint64), np.array([1], np.uint64))
    idx2.close()
    idx3 = ref_ix.PersistentIndex(d, cut_postings=10_000, compact_segments=0)
    assert sorted(idx3.dump_postings()[0].tolist()) == [1, 2]
    idx3.close()


# -- integrity: scrub and quarantine --------------------------------------------


def test_store_probe_quarantines_rotted_segment(tmp_path):
    d = str(tmp_path / "ix")
    idx = ix.PersistentIndex(d, cut_postings=8, compact_segments=0)
    idx.insert_batch(np.arange(100, 116, dtype=np.uint64), np.arange(16, dtype=np.uint64))
    seg = idx._segments[0]
    name = os.path.basename(seg.path)
    _flip_bit(seg.path, segment.HEADER_LEN + seg.bloom.memory_bytes + 8 * 4, bit=5)
    assert int(idx.probe_batch(np.array([104], np.uint64))[0]) == -1
    assert os.path.exists(os.path.join(d, name + ".quarantine"))
    assert (idx.quarantined, idx.corrupt_segments) == (1, 1)
    idx.close()
    for pkg in (ix, ref_ix):
        again = pkg.PersistentIndex(d)
        assert all(os.path.basename(s.path) != name for s in again._segments)
        again.close()


def test_scrub_detects_quarantines_and_backfills(tmp_path):
    d = str(tmp_path / "ix")
    idx = ix.PersistentIndex(d, cut_postings=8, compact_segments=0)
    for i in range(3):
        idx.insert_batch(np.arange(i * 50, i * 50 + 16, dtype=np.uint64),
                         np.full(16, i, np.uint64))
    assert idx.scrub()["ok"]
    victim = os.path.basename(idx._segments[0].path)
    rotted = idx._segments[1].path
    idx._digests.pop(victim)
    _flip_bit(rotted, os.path.getsize(rotted) - 1, bit=1)
    report = idx.scrub()
    assert not report["ok"] and report["backfilled_digests"] == 1
    assert [c["segment"] for c in report["corrupt"]] == [os.path.basename(rotted)]
    assert os.path.exists(rotted + ".quarantine") and idx.scrubs == 2
    man = json.load(open(os.path.join(d, "manifest.json")))
    assert victim in man["digests"] and os.path.basename(rotted) not in man["segments"]
    idx.close()


def test_torn_segment_open_and_env_scrub_quarantine(tmp_path, monkeypatch):
    d = str(tmp_path / "ix")
    idx = ix.PersistentIndex(d, cut_postings=8, compact_segments=0)
    idx.insert_batch(np.arange(0, 16, dtype=np.uint64), np.zeros(16, np.uint64))
    idx.insert_batch(np.arange(50, 66, dtype=np.uint64), np.ones(16, np.uint64))
    bad, good = idx._segments[0].path, idx._segments[1]
    doc_off = segment.HEADER_LEN + good.bloom.memory_bytes + 8 * good.count + 8 * 3
    idx.close()
    _flip_bit(bad, 20, bit=2)
    idx2 = ix.PersistentIndex(d)
    assert len(idx2._segments) == 1 and os.path.exists(bad + ".quarantine")
    assert (np.asarray(idx2.probe_batch(np.arange(50, 66, dtype=np.uint64))) == 1).all()
    idx2.close()
    _flip_bit(good.path, doc_off, bit=0)  # a doc id: only a full check finds it
    monkeypatch.setenv("ASTPU_INDEX_SCRUB", "1")
    idx3 = ix.PersistentIndex(d)
    assert not idx3._segments and os.path.exists(good.path + ".quarantine")
    idx3.close()


def test_scrub_skips_segment_swept_by_racing_compaction(tmp_path):
    idx = ix.PersistentIndex(str(tmp_path / "ix"), cut_postings=8, compact_segments=0)
    for i in range(2):
        idx.insert_batch(np.arange(i * 30, i * 30 + 16, dtype=np.uint64),
                         np.full(16, i, np.uint64))
    victim = idx._segments[0]
    survivors = [s for s in idx._segments if s is not victim]
    real_verify = victim.verify_all

    def raced_verify(fs=None):
        idx._segments = list(survivors)
        os.unlink(victim.path)
        return real_verify(fs=fs)

    victim.verify_all = raced_verify
    report = idx.scrub()
    assert report["ok"] and not os.path.exists(victim.path + ".quarantine")
    idx.close()


# -- across the packages -------------------------------------------------------


def _drive(pkg, d: str, *, compact_segments: int = 3) -> list:
    """One session of mixed work on ``pkg``'s index; returns every answer."""
    rng = np.random.RandomState(5)
    idx = pkg.PersistentIndex(d, cut_postings=50, compact_segments=compact_segments,
                              compact_inline=True)
    log = []
    pool = rng.randint(0, 1 << 62, size=400).astype(np.uint64) | np.uint64(1 << 63)
    for b in range(14):
        keys = pool[rng.randint(0, pool.size, size=(12, 4))]
        ids = idx.allocate_doc_ids(12)
        log.append(idx.check_and_add_batch(keys, ids).tolist())
        idx.log_names(ids.tolist(), [f"https://x/{b}/{i}" for i in range(12)])
        if b % 5 == 4:
            idx.checkpoint()
    log.append(idx.probe_batch(pool[:64].reshape(16, 4)).tolist())
    log.append({k: v for k, v in idx.stats().items()})
    log.append([a.tolist() for a in idx.semantic_items()])
    log.append(idx.lookup_names([0, 5, 100, 167]))
    idx.close()
    return log


@pytest.mark.parametrize("compact_segments", [0, 3])
def test_both_packages_write_the_same_directory(tmp_path, compact_segments):
    """Same inputs, ``compact_inline=True``: the same answers, stats and
    semantic state, and byte-equal trees (manifest, WAL, segments,
    docmap)."""
    logs = {n: _drive(p, str(tmp_path / n), compact_segments=compact_segments)
            for n, p in PACKAGES.items()}
    assert logs["port"] == logs["jax"]
    assert any(a >= 0 for row in logs["port"][:14] for a in row)
    trees = {n: _tree(str(tmp_path / n)) for n in PACKAGES}
    assert trees["port"] == trees["jax"]
    assert sum(n.endswith(".seg") for n in trees["port"]) >= 1


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_each_package_reopens_the_others_directory(tmp_path, writer, reader):
    """A directory written (segments, a live WAL, a handed-off range and a
    reshard mark in its manifest) by one package reopens in the other with
    equal probes, postings and docmap, and goes on to the same answers."""
    d = str(tmp_path / "ix")
    _drive(PACKAGES[writer], d, compact_segments=0)
    w = PACKAGES[writer].PersistentIndex(d, cut_postings=50, compact_segments=0)
    w.insert_batch(np.arange(1, 9, dtype=np.uint64), np.full(8, 3, np.uint64))  # stays in the WAL
    w.retire_range(1 << 62, 1 << 63)
    w.set_reshard_mark("t1")
    w.close()
    copy_dir = str(tmp_path / "copy")
    os.makedirs(copy_dir)
    for name, data in _tree(d).items():
        open(os.path.join(copy_dir, name), "wb").write(data)
    answers = []
    for pkg, path in ((PACKAGES[reader], d), (PACKAGES[writer], copy_dir)):
        idx = pkg.PersistentIndex(path, cut_postings=50, compact_segments=0)
        rng = np.random.RandomState(8)
        q = np.concatenate([idx.dump_postings()[0][:60],
                            rng.randint(0, 1 << 62, size=20).astype(np.uint64)])
        got = [idx.probe_batch(q.reshape(20, 4)).tolist(),
               [a.tolist() for a in idx.dump_postings()],
               idx.handed_off_ranges(), idx.reshard_mark(), idx.lookup_names(range(0, 170, 7))]
        ids = idx.allocate_doc_ids(5)
        got.append(idx.check_and_add_batch(q[:20].reshape(5, 4) ^ np.uint64(1), ids).tolist())
        idx.unretire_range(1 << 62, 1 << 63)
        idx.clear_reshard_mark()
        got.append(idx.probe_batch(q.reshape(20, 4)).tolist())
        idx.close()
        answers.append(got)
    assert answers[0] == answers[1]
    assert _tree(d) == _tree(copy_dir)


def test_repair_helpers_equal_reference():
    rng = np.random.RandomState(6)
    keys = rng.randint(0, 1 << 62, size=500).astype(np.uint64) * np.uint64(3)
    docs = rng.randint(0, 40, size=500).astype(np.uint64)
    for got, want in zip(repair.semantic_min(keys, docs), ref_repair.semantic_min(keys, docs)):
        assert np.array_equal(got, want)
    assert np.array_equal(repair.mix64(keys), ref_repair.mix64(keys))
    ranges = [(0, 1 << 60), (1 << 63, repair.KEY_SPACE_END)]
    assert np.array_equal(repair.range_mask(keys, ranges), ref_repair.range_mask(keys, ranges))
    ivs = [(5, 10), (20, 30)]
    for lo, hi in ((8, 22), (30, 40), (0, 5), (12, 15), (40, 41)):
        assert repair.interval_add(ivs, lo, hi) == ref_repair.interval_add(ivs, lo, hi)
        assert repair.interval_sub(ivs, lo, hi) == ref_repair.interval_sub(ivs, lo, hi)


def test_background_compaction_is_joined_at_close(tmp_path):
    """Compaction on its daemon thread: probes during it answer as before,
    and ``close`` waits for it, so a reopen (by either package) finds one
    merged segment and the same postings."""
    d = str(tmp_path / "ix")
    idx = ix.PersistentIndex(d, cut_postings=16, compact_segments=4)
    rng = np.random.RandomState(7)
    all_keys = []
    for _ in range(8):
        keys = _rand_keys(rng, 4, 4)
        idx.insert_batch(keys.ravel(), np.repeat(idx.allocate_doc_ids(4), 4))
        all_keys += keys.ravel().tolist()
        assert (idx.probe_batch(np.array(all_keys, np.uint64)) >= 0).all()
    idx.close()
    assert idx.compactions >= 1
    for pkg in PACKAGES.values():
        again = pkg.PersistentIndex(d, cut_postings=16, compact_segments=0)
        assert sorted(again.dump_postings()[0].tolist()) == sorted(all_keys)
        again.close()


def test_cut_during_compaction_starts_no_second_merge(tmp_path, monkeypatch):
    """The first background compaction is held inside its merge while
    four more segments are cut: no second merge starts, ``close`` returns
    only after the held compaction's manifest swap, no thread raises, and
    either package reopens the directory with the same postings."""
    d = str(tmp_path / "ix")
    entered, release = threading.Event(), threading.Event()
    merging = []
    plain_arrays = segment.Segment.arrays

    def held_arrays(self):
        me = threading.current_thread()
        if me.name.startswith("astpu-index-compact"):
            if me not in merging:
                merging.append(me)
            entered.set()
            release.wait(30)
        return plain_arrays(self)

    raised = []
    monkeypatch.setattr(segment.Segment, "arrays", held_arrays)
    monkeypatch.setattr(threading, "excepthook", raised.append)
    idx = ix.PersistentIndex(d, cut_postings=16, compact_segments=4)
    rng = np.random.RandomState(11)
    all_keys = []

    def post_batch():
        keys = _rand_keys(rng, 4, 4)
        idx.insert_batch(keys.ravel(), np.repeat(idx.allocate_doc_ids(4), 4))
        all_keys.extend(keys.ravel().tolist())

    for _ in range(4):
        post_batch()
    assert entered.wait(10), "the fourth cut starts a compaction"
    held = idx._compactor
    for _ in range(4):
        post_batch()  # cuts 5..8, each past the compaction cadence
    assert idx.segment_cuts == 8
    assert idx._compactor is held and held.is_alive()
    before = json.loads(open(os.path.join(d, "manifest.json")).read())
    closer = threading.Thread(target=idx.close)
    closer.start()
    closer.join(0.3)
    assert closer.is_alive(), "close waits for the held compaction"
    assert json.loads(open(os.path.join(d, "manifest.json")).read()) == before
    release.set()
    closer.join(30)
    assert not closer.is_alive() and not held.is_alive()
    assert merging == [held]
    assert idx.compactions == 1
    assert raised == []
    after = json.loads(open(os.path.join(d, "manifest.json")).read())
    assert after != before
    dumps = []
    for pkg in PACKAGES.values():
        again = pkg.PersistentIndex(d, cut_postings=16, compact_segments=0)
        keys, docs = again.dump_postings()
        order = np.lexsort((docs, keys))
        dumps.append((keys[order].tolist(), docs[order].tolist()))
        assert sorted(keys.tolist()) == sorted(all_keys)
        again.close()
    assert dumps[0] == dumps[1]


def test_wipe_and_snapshot_meta_equal_reference(tmp_path):
    out = []
    for name, pkg in PACKAGES.items():
        idx = pkg.PersistentIndex(str(tmp_path / name), cut_postings=8, compact_segments=0,
                                  compact_inline=True)
        idx.insert_batch(np.arange(40, dtype=np.uint64), np.repeat(np.arange(10, dtype=np.uint64), 4))
        idx.insert_batch(np.array([99], np.uint64), np.array([10], np.uint64))
        idx.log_names([0], ["a"])
        meta = idx.snapshot_meta()
        out.append((meta, idx.read_file("manifest.json"), idx.wipe(), idx.stats(),
                    int(idx.allocate_doc_ids(1)[0])))
        idx.close()
    assert out[0] == out[1]
    assert _tree(str(tmp_path / "jax")) == _tree(str(tmp_path / "port"))
