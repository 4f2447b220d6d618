"""The port's live N→M resharding (``index/reshard.py`` and
``ShardedIndexClient.reshard_to`` in ``index/fleet.py``) against the JAX
package's.

The plan math (ring arcs, plans, the range table, per-key routes) equals
the reference's over seeded keys in every lifecycle state; the migration
WAL is byte-equal after every state change and each package loads the
other's; a live 2→4→2 split and merge through the port's client gives the
JAX client's probes, postings, per-server digests and stats, and a single
node's; the port's client reshards JAX shard servers; a probe/insert storm
runs through a live cutover without a failure; an interrupted cutover
resumes from its WAL in a fresh client of either package; and the stream
backend's persist mode is resharded mid-stream with the local index's
annotations.  In-process shard servers, the reference tests' sizes."""

from __future__ import annotations

import json
import os
import sys
import threading

import numpy as np
import pytest

from advanced_scrapper_tpu.index import fleet as ref_fleet
from advanced_scrapper_tpu.index import remote as ref_remote
from advanced_scrapper_tpu.index import repair as ref_repair
from advanced_scrapper_tpu.index import reshard as ref_reshard
from advanced_scrapper_tpu.index import store as ref_store
from advanced_scrapper_tpu_torch.config import DedupConfig
from advanced_scrapper_tpu_torch.extractors import tpu_batch
from advanced_scrapper_tpu_torch.index import fleet, remote, repair, reshard, store
from advanced_scrapper_tpu_torch.index.repair import KEY_SPACE_END, mix64
from test_torch_fleet import min_map, run_stream, stop_all, stream_records

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = {
    "jax": dict(remote=ref_remote, fleet=ref_fleet, store=ref_store, reshard=ref_reshard,
                repair=ref_repair),
    "port": dict(remote=remote, fleet=fleet, store=store, reshard=reshard, repair=repair),
}
VN = 8  # the reference tests' small ring: few arcs, the same properties
WAIT = 2.0
STATES = ("pending", "dual_write", "flipped", "retired")


def rand_keys(seed: int, n: int = 4096) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, np.iinfo(np.uint64).max, size=n,
                                                dtype=np.uint64, endpoint=True)


def in_arc(pos: np.ndarray, lo: int, hi: int) -> np.ndarray:
    return (pos >= np.uint64(lo)) & (pos <= np.uint64(hi - 1))


def corpus(n_docs: int, width: int = 8) -> np.ndarray:
    """Disjoint key rows spread over the ring: row ``i`` has ``width``
    unique keys and attributes to doc ``i``."""
    base = np.arange(n_docs * width, dtype=np.uint64).reshape(n_docs, width)
    return (base + np.uint64(1)) * np.uint64(0x9E3779B97F4A7C15)


def start_servers(pkg: str, root, n: int, first: int = 0) -> list:
    return [PKG[pkg]["remote"].IndexShardServer(
        str(root / f"s{s}n0"), spaces=("bands",), cut_postings=96, compact_segments=4,
        compact_inline=True, name=f"s{s}n0").start() for s in range(first, first + n)]


def spec_of(servers) -> str:
    return ";".join(f"127.0.0.1:{s.port}" for s in servers)


def open_client(pkg: str, spec: str, spill, **kw):
    opts = dict(space="bands", spill_dir=str(spill), vnodes=VN, timeout=WAIT, retries=1,
                health_timeout=0.2)
    opts.update(kw)
    return PKG[pkg]["fleet"].ShardedIndexClient(spec, **opts)


def fill(client, oracle, rows: np.ndarray, first_doc: int = 0) -> None:
    for i, row in enumerate(rows):
        docs = np.full(row.shape, first_doc + i, np.uint64)
        client.insert_batch(row, docs)
        if oracle is not None:
            oracle.insert_batch(row, docs)


def server_digests(pkg: str, servers) -> list:
    rp = PKG[pkg]["repair"]
    return [tuple(a.tolist() for a in rp.bucket_digests(*s.indexes["bands"].semantic_items(), 6))
            for s in servers]


# -- the plan math ----------------------------------------------------------------------

CHANGES = [(1, 2), (2, 4), (4, 2), (2, 3), (3, 5), (8, 1)]


@pytest.mark.parametrize("vnodes", [16, 64])
@pytest.mark.parametrize("old_n,new_n", CHANGES)
def test_plan_math_equals_the_reference(old_n, new_n, vnodes):
    """``ring_ranges``, ``plan_reshard``, ``RangeTable.locate/counts`` and
    ``route_keys`` equal the JAX package's over seeded keys, with every
    arc in each lifecycle state and with the states mixed."""
    for n in (old_n, new_n):
        assert reshard.ring_ranges(n, vnodes) == ref_reshard.ring_ranges(n, vnodes)
    plan = reshard.plan_reshard(old_n, new_n, vnodes)
    assert [tuple(vars(r).values()) for r in plan] == \
        [tuple(vars(r).values()) for r in ref_reshard.plan_reshard(old_n, new_n, vnodes)]
    assert plan and all(isinstance(r, reshard.MigrationRange) for r in plan)
    keys = rand_keys(old_n * 100 + new_n * 10 + vnodes)
    rows = [{"lo": r.lo, "hi": r.hi, "src": r.src, "dst": r.dst, "state": "pending"}
            for r in plan]
    rng = np.random.RandomState(vnodes)
    assignments = [[s] * len(rows) for s in STATES] + \
        [[STATES[i] for i in rng.randint(len(STATES), size=len(rows))]]
    for states in assignments:
        tables = [mod.RangeTable([dict(r, state=st) for r, st in zip(rows, states)])
                  for mod in (reshard, ref_reshard)]
        got = [t.locate(mix64(keys)) for t in tables]
        assert all((a == b).all() for a, b in zip(*got))
        assert tables[0].counts() == tables[1].counts()
        routes = [mod.route_keys(keys, t, old_n, new_n, vnodes)
                  for mod, t in zip((reshard, ref_reshard), tables)]
        assert all((a == b).all() and a.dtype == b.dtype for a, b in zip(*routes))
    empty = [mod.route_keys(keys, mod.RangeTable([]), old_n, new_n, vnodes)
             for mod in (reshard, ref_reshard)]
    assert all((a == b).all() for a, b in zip(*empty))


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_ring_ranges_tile_the_space(n):
    rr = reshard.ring_ranges(n, vnodes=VN)
    assert rr[0][0] == 0 and rr[-1][1] == KEY_SPACE_END
    for (lo, hi, _o), (lo2, _h, _o2) in zip(rr, rr[1:]):
        assert lo < hi == lo2
    keys = rand_keys(n)
    los = np.array([r[0] for r in rr], np.uint64)
    owners = np.array([r[2] for r in rr], np.int32)
    ix = np.searchsorted(los, mix64(keys), side="right") - 1
    assert (owners[ix] == fleet.ring_assign(keys, n, VN)).all()


@pytest.mark.parametrize("old_n,new_n", [(2, 4), (4, 2), (2, 3)])
def test_plan_arcs_are_exactly_the_ownership_diff(old_n, new_n):
    plan = reshard.plan_reshard(old_n, new_n, VN)
    for a, b in zip(plan, plan[1:]):
        assert a.lo < a.hi <= b.lo
        assert not (a.hi == b.lo and (a.src, a.dst) == (b.src, b.dst))
    keys = rand_keys(old_n * 10 + new_n)
    pos = mix64(keys)
    old, new = fleet.ring_assign(keys, old_n, VN), fleet.ring_assign(keys, new_n, VN)
    covered = np.zeros(keys.shape, bool)
    for r in plan:
        m = in_arc(pos, r.lo, r.hi)
        assert r.src != r.dst and not (covered & m).any()
        covered |= m
        assert (old[m] == r.src).all() and (new[m] == r.dst).all()
    assert (covered == (old != new)).all()


def test_plan_identity_validation_and_round_trip():
    assert reshard.plan_reshard(3, 3, VN) == ()
    for bad in ((0, 2), (2, 0)):
        with pytest.raises(ValueError):
            reshard.plan_reshard(*bad, VN)
    keys = rand_keys(99)
    pos = mix64(keys)
    own = fleet.ring_assign(keys, 2, VN).copy()
    start = own.copy()
    for old_n, new_n in ((2, 4), (4, 2)):
        for r in reshard.plan_reshard(old_n, new_n, VN):
            m = in_arc(pos, r.lo, r.hi)
            assert (own[m] == r.src).all()
            own[m] = r.dst
        assert (own == fleet.ring_assign(keys, new_n, VN)).all()
    assert (own == start).all()


def test_range_table_state_changes():
    plan = reshard.plan_reshard(2, 4, VN)
    table = reshard.RangeTable([{"lo": r.lo, "hi": r.hi, "src": r.src, "dst": r.dst,
                                 "state": "pending"} for r in plan])
    table.set_state(0, "flipped")
    assert table.state(0) == "flipped" and table.counts()["flipped"] == 1
    _ix, valid = reshard.RangeTable([]).locate(mix64(rand_keys(5)))
    assert not valid.any()


# -- the migration WAL --------------------------------------------------------------------


def ledger_steps(mod, path: str):
    """create, save, mark, void_unflipped and finish, yielding after each."""
    plan = mod.plan_reshard(2, 4, VN)
    led = mod.ReshardLedger.create(path, old_n=2, new_n=4, vnodes=VN, old_spec="a:1;b:2",
                                   new_spec="a:1;b:2;c:3;d:4", space="bands", ranges=plan)
    yield "create"
    led.save()
    yield "save"
    led.mark(0, "dual_write")
    led.mark(1, "dual_write")
    led.mark(1, "flipped")
    led.mark(2, "retired")
    yield "mark"
    assert led.void_unflipped() == 1
    yield "void_unflipped"
    for i, r in enumerate(led.ranges):
        if r["state"] == "pending":
            led.mark(i, "dual_write")
        if led.ranges[i]["state"] != "retired":
            led.mark(i, "retired")
    led.finish()
    yield "finish"


def test_ledger_bytes_equal_the_reference_at_every_step(tmp_path):
    paths = {pkg: reshard.ledger_path(str(tmp_path / pkg), "bands") for pkg in PKG}
    assert paths["port"].endswith(os.path.join("port", "reshard-wal-bands.json"))
    assert ref_reshard.ledger_path(str(tmp_path / "port"), "bands") == paths["port"]
    steps = {pkg: ledger_steps(PKG[pkg]["reshard"], paths[pkg]) for pkg in PKG}
    seen = []
    for port_step, ref_step in zip(steps["port"], steps["jax"]):
        assert port_step == ref_step
        seen.append(port_step)
        raw = {pkg: open(paths[pkg], "rb").read() for pkg in PKG}
        assert raw["port"] == raw["jax"], port_step
        for reader, writer in (("port", "jax"), ("jax", "port")):
            led = PKG[reader]["reshard"].ReshardLedger.load(paths[writer])
            assert led.doc == json.loads(raw[writer]) and led.phase in ("active", "done")
    assert seen == ["create", "save", "mark", "void_unflipped", "finish"]
    done = reshard.ReshardLedger.load(paths["jax"])
    assert done.phase == "done" and done.all_retired() and done.doc["voids"] == 1


def test_ledger_marks_are_forward_only_and_void_is_durable(tmp_path):
    path = reshard.ledger_path(str(tmp_path), "bands")
    led = reshard.ReshardLedger.create(path, old_n=2, new_n=4, vnodes=VN, old_spec="o",
                                       new_spec="n", space="bands",
                                       ranges=reshard.plan_reshard(2, 4, VN))
    assert reshard.ReshardLedger.load(str(tmp_path / "absent.json")) is None
    led.mark(0, "dual_write")
    for back in ("dual_write", "pending"):
        with pytest.raises(ValueError):
            led.mark(0, back)
    led.mark(1, "flipped")
    again = reshard.ReshardLedger.load(path)
    assert again.void_unflipped() == 1 and again.ranges[1]["state"] == "flipped"
    assert reshard.ReshardLedger.load(path).void_unflipped() == 0


@pytest.mark.parametrize("doc,match", [
    ({"version": 99, "phase": "active", "ranges": []}, "version"),
    ({"version": 1, "phase": "active",
      "ranges": [{"lo": 0, "hi": 8, "src": 0, "dst": 1, "state": "half-flipped"}]},
     "unrepresentable"),
])
def test_ledger_rejects_unrepresentable_documents(tmp_path, doc, match):
    path = reshard.ledger_path(str(tmp_path), "bands")
    with open(path, "w") as fh:
        json.dump(doc, fh)
    for mod in (reshard, ref_reshard):
        with pytest.raises(ValueError, match=match):
            mod.ReshardLedger.load(path)


# -- the live cutover ---------------------------------------------------------------------


def test_split_and_merge_equal_the_jax_client_and_an_oracle(tmp_path):
    """A live 2→4→2 round trip through the port's client over port servers
    and through the JAX client over JAX servers: after each transition the
    probes and ``dump_postings`` min-maps equal each other's and a single
    node's, each server's bucket digests equal its twin's, and the
    ``reshard_to`` stats are equal; a no-op re-target and writes after the
    merge too."""
    rows = corpus(48)
    servers = {pkg: start_servers(pkg, tmp_path / pkg, 4) for pkg in PKG}
    oracle = store.PersistentIndex(str(tmp_path / "oracle"), cut_postings=96)
    clients = {}
    try:
        fill(oracle, None, rows)
        for pkg in PKG:
            clients[pkg] = open_client(pkg, spec_of(servers[pkg][:2]), tmp_path / pkg / "spill")
            fill(clients[pkg], None, rows)
        want_probe = np.asarray(oracle.probe_batch(rows))
        want_map = min_map(*oracle.dump_postings())
        for shards in (4, 2):
            stats = {pkg: clients[pkg].reshard_to(spec_of(servers[pkg][:shards])) for pkg in PKG}
            assert stats["port"] == stats["jax"]
            assert stats["port"]["flips"] == stats["port"]["ranges"] > 0
            assert stats["port"]["voided"] == 0
            for pkg, c in clients.items():
                assert c._route_shards == shards and c._reshard is None
                assert (np.asarray(c.probe_batch(rows)) == want_probe).all()
                assert min_map(*c.dump_postings()) == want_map
                led = PKG[pkg]["reshard"].ReshardLedger.load(
                    reshard.ledger_path(str(tmp_path / pkg / "spill"), "bands"))
                assert led.phase == "done" and led.all_retired()
            assert server_digests("port", servers["port"]) == \
                server_digests("jax", servers["jax"])
            status = clients["port"].fleet_status()
            assert "reshard" not in status and len(status["shards"]) == 4
            again = clients["port"].reshard_to(spec_of(servers["port"][:shards]))
            assert again["already"] is True and again["ranges"] == 0
        extra = corpus(8) + np.uint64(7)
        fill(oracle, None, extra, first_doc=1000)
        for pkg in PKG:
            fill(clients[pkg], None, extra, first_doc=1000)
            assert (np.asarray(clients[pkg].probe_batch(extra))
                    == np.asarray(oracle.probe_batch(extra))).all()
    finally:
        for c in clients.values():
            c.close()
        oracle.close()
        stop_all(servers["port"] + servers["jax"])


def test_port_client_reshards_jax_shard_servers(tmp_path):
    """Across the wire: the port's client splits a fleet of JAX shard
    servers 2→3 and back; a JAX client opened on the result agrees."""
    rows = corpus(32)
    servers = start_servers("jax", tmp_path, 3)
    oracle = store.PersistentIndex(str(tmp_path / "oracle"), cut_postings=96)
    client = open_client("port", spec_of(servers[:2]), tmp_path / "spill")
    try:
        fill(client, oracle, rows)
        stats = client.reshard_to(spec_of(servers))
        assert stats["flips"] == stats["ranges"] > 0
        ref = open_client("jax", spec_of(servers), tmp_path / "spill-jax")
        try:
            for c in (client, ref):
                assert (np.asarray(c.probe_batch(rows))
                        == np.asarray(oracle.probe_batch(rows))).all()
        finally:
            ref.close()
        handed = [len(s.indexes["bands"].handed_off_ranges()) for s in servers]
        assert handed[0] + handed[1] > 0 and handed[2] == 0
        assert client.reshard_to(spec_of(servers[:2]))["flips"] > 0
        assert min_map(*client.dump_postings()) == min_map(*oracle.dump_postings())
    finally:
        client.close()
        oracle.close()
        stop_all(servers)


def test_storm_through_live_reshard_zero_downtime(tmp_path):
    """``tools/loadgen.py:storm_fleet`` drives the port's client through a
    live 2→4 cutover: zero transport failures, zero wrong answers."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import loadgen
    finally:
        sys.path.pop(0)
    servers = start_servers("port", tmp_path, 4)
    client = open_client("port", spec_of(servers[:2]), tmp_path / "spill", retries=2)
    try:
        rows = corpus(32)
        fill(client, None, rows)

        def fresh(seq: int):
            keys = (np.arange(8, dtype=np.uint64) + np.uint64((1 << 40) + seq * 8)) \
                * np.uint64(0x9E3779B97F4A7C15)
            return keys, 10_000 + seq

        box: dict = {}

        def cutover():
            try:
                box["stats"] = client.reshard_to(spec_of(servers))
            except BaseException as e:
                box["error"] = e

        t = threading.Thread(target=cutover, daemon=True)
        t.start()
        ledger = loadgen.storm_fleet(client, [(row, i) for i, row in enumerate(rows)],
                                     duration=2.0, workers=3, fresh=fresh)
        t.join(timeout=120)
        assert not t.is_alive() and "error" not in box, box.get("error")
        assert box["stats"]["flips"] == box["stats"]["ranges"] > 0
        assert ledger["ops"] > 50, ledger
        assert ledger["transport_failures"] == 0 and ledger["wrong_answers"] == 0, ledger
        assert ledger["errors"] == []
        assert client._route_shards == 4
        assert (np.asarray(client.probe_batch(rows)).ravel() == np.arange(len(rows))).all()
    finally:
        client.close()
        stop_all(servers)


def test_reshard_refuses_without_spill_dir_or_over_a_foreign_ledger(tmp_path):
    servers = start_servers("port", tmp_path, 2)
    try:
        bare = open_client("port", spec_of(servers[:1]), None, spill_dir=None)
        try:
            with pytest.raises(RuntimeError, match="spill_dir"):
                bare.reshard_to(spec_of(servers))
        finally:
            bare.close()
        spill = tmp_path / "spill"
        reshard.ReshardLedger.create(
            reshard.ledger_path(str(spill), "bands"), old_n=1, new_n=3, vnodes=VN,
            old_spec="127.0.0.1:1", new_spec="127.0.0.1:1;127.0.0.1:2;127.0.0.1:3",
            space="bands", ranges=reshard.plan_reshard(1, 3, VN))
        client = open_client("port", spec_of(servers[:1]), spill)
        try:
            assert client._reshard is None  # another topology's WAL is not adopted
            with pytest.raises(RuntimeError, match="different topology"):
                client.reshard_to(spec_of(servers))
        finally:
            client.close()
    finally:
        stop_all(servers)


class Crash(Exception):
    pass


def crash_after(client, step: str, k: int) -> None:
    """Make the ``k+1``-th call of a ``reshard_to`` step raise before it
    runs: ``flip`` leaves that range in ``dual_write``, ``retire`` leaves it
    ``flipped``; the ``k`` ranges before it are retired."""
    name = {"flip": "_flip_range", "retire": "_retire_range_src"}[step]
    real, calls = getattr(client, name), [0]

    def step_fn(*args, **kw):
        calls[0] += 1
        if calls[0] > k:
            raise Crash(f"{name} #{calls[0]}")
        return real(*args, **kw)

    setattr(client, name, step_fn)


@pytest.mark.parametrize("crasher,resumer", [("port", "port"), ("jax", "port"),
                                             ("port", "jax")])
@pytest.mark.parametrize("step,k", [("flip", 3), ("retire", 2)])
def test_interrupted_reshard_resumes_from_its_wal(tmp_path, crasher, resumer, step, k):
    """A cutover interrupted after ``k`` retired ranges resumes in a fresh
    client (of either package): the sealed ranges are kept, a range caught
    in its dual-write window is voided back to ``pending``, writes made
    before the rerun route by the adopted states, and the finished fleet
    equals the oracle."""
    servers = start_servers("port", tmp_path, 4)
    spill = tmp_path / "spill"
    oracle = store.PersistentIndex(str(tmp_path / "oracle"), cut_postings=96)
    rows = corpus(40)
    old, new = spec_of(servers[:2]), spec_of(servers)
    first = open_client(crasher, old, spill)
    try:
        fill(first, oracle, rows)
        crash_after(first, step, k)
        with pytest.raises(Crash):
            first.reshard_to(new)
    finally:
        first.close()
    path = reshard.ledger_path(str(spill), "bands")
    states = [r["state"] for r in reshard.ReshardLedger.load(path).ranges]
    assert states[:k] == ["retired"] * k
    assert states[k] == ("dual_write" if step == "flip" else "flipped")
    assert set(states[k + 1:]) <= {"pending"}
    client = open_client(resumer, old, spill)
    try:
        rs = client._reshard
        assert rs is not None and rs["voided"] == (step == "flip") and rs["new_n"] == 4
        adopted = [r["state"] for r in PKG[resumer]["reshard"].ReshardLedger.load(path).ranges]
        assert adopted[:k] == ["retired"] * k
        assert adopted[k] == ("pending" if step == "flip" else "flipped")
        extra = corpus(6) + np.uint64(3)
        fill(client, oracle, extra, first_doc=500)  # routed by the adopted states
        stats = client.reshard_to(new)
        assert stats["voided"] == (step == "flip")
        assert stats["flips"] == len(states) - k - (step == "retire")
        assert client._route_shards == 4
        every = np.concatenate([rows, extra])
        assert (np.asarray(client.probe_batch(every))
                == np.asarray(oracle.probe_batch(every))).all()
        assert min_map(*client.dump_postings()) == min_map(*oracle.dump_postings())
        done = reshard.ReshardLedger.load(path)
        assert done.phase == "done" and done.all_retired()
        assert done.doc["voids"] == (step == "flip")
    finally:
        client.close()
        oracle.close()
        stop_all(servers)


# -- the stream backend, resharded mid-stream ------------------------------------------


def test_stream_backend_resharded_mid_stream(tmp_path):
    """The persist mode over a 2-shard fleet, 8 batches of 128 records:
    after batch 3 the ``bands`` and then the ``urls`` space split to 4
    shards on a thread while the batches flow; the annotations equal the
    local index's, and a fresh client at 4 shards probes the postings."""
    records = stream_records(47, 8 * 128)
    local = tpu_batch.TpuBatchBackend(DedupConfig(batch_size=128, stream_index="persist"),
                                      index_dir=str(tmp_path / "plain"), device="cpu")
    want = run_stream(local, records)
    local.close()
    servers = [remote.IndexShardServer(str(tmp_path / f"s{s}"), spaces=("bands", "urls"),
                                       cut_postings=512, compact_segments=4,
                                       compact_inline=True, name=f"s{s}").start()
               for s in range(4)]
    cfg = DedupConfig(batch_size=128, stream_index="persist", index_fleet=spec_of(servers[:2]),
                      index_fleet_timeout=WAIT)
    backend = tpu_batch.TpuBatchBackend(cfg, index_dir=str(tmp_path / "local"), device="cpu")
    box: dict = {}

    def split():
        try:
            box["stats"] = [c.reshard_to(spec_of(servers))
                            for c in (backend._pindex, backend._pindex_urls)]
        except BaseException as e:
            box["error"] = e

    process, done = backend._process, [0]

    def splitting():
        out = process()
        done[0] += 1
        if done[0] == 3:
            box["thread"] = threading.Thread(target=split, daemon=True)
            box["thread"].start()
        return out

    backend._process = splitting
    try:
        got = run_stream(backend, records)
        box["thread"].join(timeout=120)
        assert "error" not in box, box.get("error")
        assert [s["flips"] for s in box["stats"]] == [s["ranges"] for s in box["stats"]]
        assert all(s["ranges"] > 0 for s in box["stats"])
        assert backend._pindex._route_shards == backend._pindex_urls._route_shards == 4
    finally:
        backend._process = process
        backend.close()
    assert got == want and any(a[2] for a in want) and any(a[1] for a in want)
    try:
        fresh = fleet.open_fleet_index(
            DedupConfig(stream_index="persist", index_fleet=spec_of(servers)),
            str(tmp_path / "local"), space="urls")
        try:
            assert fresh._route_shards == 4 and fresh._reshard is None
            assert sum(s.indexes["urls"].posting_count() for s in servers[2:]) > 0
        finally:
            fresh.close()
    finally:
        stop_all(servers)
