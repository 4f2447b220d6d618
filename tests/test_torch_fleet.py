"""The port's index fleet (``index/remote.py``, ``index/fleet.py``, the
bucket digests of ``index/repair.py``) against the JAX package's.

The topology helpers and digests equal the reference's on seeded inputs;
the fleet is byte-equal to a single-node ``PersistentIndex`` and to the
JAX fleet (answers, postings, digests and the shard directories' bytes),
also while a primary dies, a shard goes dark and spills, a replica misses
writes and is backfilled, or a scrubbed or overflowed replica is healed by
the anti-entropy plane.  Shard directories move between the packages, a
fleet mixes JAX and port nodes on one wire, and the stream backend and the
engine ride the port's fleet on the CPU as the JAX package's ride its own
(``reshard_to``: ``tests/test_torch_reshard.py``).  Shard servers run in this
process (their stop waits out a 0.5 s accept poll, so the helpers stop them
in parallel); waits are bounded by short timeouts of the tests' own."""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from advanced_scrapper_tpu.config import DedupConfig as RefConfig
from advanced_scrapper_tpu.extractors import tpu_batch as ref_tb
from advanced_scrapper_tpu.index import fleet as ref_fleet
from advanced_scrapper_tpu.index import remote as ref_remote
from advanced_scrapper_tpu.index import repair as ref_repair
from advanced_scrapper_tpu.index import store as ref_store
from advanced_scrapper_tpu.net import rpc as ref_rpc
from advanced_scrapper_tpu.obs import telemetry as ref_telemetry
from advanced_scrapper_tpu.pipeline.dedup import NearDupEngine as RefEngine
from advanced_scrapper_tpu_torch.config import DedupConfig
from advanced_scrapper_tpu_torch.extractors import tpu_batch
from advanced_scrapper_tpu_torch.index import fleet, remote, repair, store
from advanced_scrapper_tpu_torch.net import rpc
from advanced_scrapper_tpu_torch.obs import telemetry, trace
from advanced_scrapper_tpu_torch.pipeline.dedup import NearDupEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = {
    "jax": dict(remote=ref_remote, fleet=ref_fleet, store=ref_store, rpc=ref_rpc),
    "port": dict(remote=remote, fleet=fleet, store=store, rpc=rpc),
}
WAIT = 2.0


def start_server(pkg: str, directory, name: str, **kw):
    opts = dict(spaces=("bands", "urls"), cut_postings=96, compact_segments=4,
                compact_inline=True, name=name)
    opts.update(kw)
    return PKG[pkg]["remote"].IndexShardServer(str(directory), **opts).start()


def stop_all(servers) -> None:
    """Stop servers in parallel (each stop waits out its accept poll)."""
    threads = [threading.Thread(target=s.stop) for s in servers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)


def make_fleet(tmp_path, pkg="port", shards=2, replicas=2, *, nodes=None, server_kw=None,
               **client_kw):
    """``shards`` × ``replicas`` loopback shard servers (node ``(s, r)`` of
    package ``nodes[s][r]``, else ``pkg``) and a ``pkg`` fleet client."""
    servers, parts = [], []
    for s in range(shards):
        addrs = []
        for r in range(replicas):
            npkg = nodes[s][r] if nodes else pkg
            srv = start_server(npkg, tmp_path / f"s{s}n{r}", f"s{s}n{r}", **(server_kw or {}))
            servers.append(srv)
            addrs.append(f"127.0.0.1:{srv.port}")
        parts.append("|".join(addrs))
    kw = dict(space="bands", spill_dir=str(tmp_path / "spill"), timeout=WAIT, retries=1,
              health_timeout=0.2)
    kw.update(client_kw)
    return servers, PKG[pkg]["fleet"].ShardedIndexClient(";".join(parts), **kw)


def min_map(keys, docs) -> dict[int, int]:
    out: dict[int, int] = {}
    for k, d in zip(np.asarray(keys).tolist(), np.asarray(docs).tolist()):
        if k not in out or d < out[k]:
            out[k] = d
    return out


def tree(d) -> dict[str, bytes]:
    out = {}
    for root, _dirs, files in os.walk(str(d)):
        for f in files:
            p = os.path.join(root, f)
            out[os.path.relpath(p, str(d))] = open(p, "rb").read()
    return out


def oracle_stream(client, oracle, rng, batches: int, hi: int, *, kill=None):
    """``batches`` of 16 rows × 8 keys through ``client`` and the oracle,
    ids and attributions equal batch by batch; ``kill`` runs before batch 3."""
    for batch in range(batches):
        if batch == 3 and kill is not None:
            kill()
        keys = rng.integers(0, hi, size=(16, 8)).astype(np.uint64)
        ids = client.allocate_doc_ids(16)
        assert (ids == oracle.allocate_doc_ids(16)).all()
        got = np.asarray(client.check_and_add_batch(keys, ids))
        assert (got == np.asarray(oracle.check_and_add_batch(keys, ids))).all(), batch


# -- topology and digests ----------------------------------------------------------


@pytest.mark.parametrize("spec", ["a:1|b:2 ; c:3 ;", "127.0.0.1:5", " h:1|h:2|h:3;h:4 ",
                                  "", "nocolon", "h:x", ";;", "h:1|:2"])
def test_fleet_spec_parse_equals_reference(spec):
    try:
        want = ref_fleet.FleetSpec.parse(spec)
    except ValueError as e:
        with pytest.raises(ValueError, match="fleet"):
            fleet.FleetSpec.parse(spec)
        assert str(e)
        return
    got = fleet.FleetSpec.parse(spec)
    assert got.shards == want.shards and got.num_shards == want.num_shards


@pytest.mark.parametrize("shards,vnodes", [(1, 64), (2, 64), (3, 16), (4, 64), (7, 128),
                                           (16, 8)])
def test_ring_assign_equals_reference(shards, vnodes):
    keys = np.random.default_rng(shards * 100 + vnodes).integers(
        0, np.iinfo(np.uint64).max, 100_000, dtype=np.uint64, endpoint=True)
    got = fleet.ring_assign(keys, shards, vnodes)
    assert got.dtype == np.int32 and np.array_equal(got, ref_fleet.ring_assign(keys, shards, vnodes))
    pts, owner = fleet._ring(shards, vnodes)
    want_pts, want_owner = ref_fleet._ring(shards, vnodes)
    assert np.array_equal(pts, want_pts) and np.array_equal(owner, want_owner)
    if shards > 1:
        assert (np.bincount(got, minlength=shards) > 100_000 // (4 * shards)).all()


@pytest.mark.parametrize("bits", [1, 4, 8, 12])
def test_mix_pair_and_bucket_digests_equal_reference(bits):
    rng = np.random.default_rng(bits)
    keys = rng.integers(0, np.iinfo(np.uint64).max, 5000, dtype=np.uint64, endpoint=True)
    docs = rng.integers(0, 1 << 40, 5000).astype(np.uint64)
    assert np.array_equal(repair._mix_pair(keys, docs), ref_repair._mix_pair(keys, docs))
    sk, sd = repair.semantic_min(np.concatenate([keys, keys[:99]]),
                                 np.concatenate([docs, docs[:99] + 1]))
    for positions in (None, repair.mix64(sk)):
        got = repair.bucket_digests(sk, sd, bits, positions=positions)
        want = ref_repair.bucket_digests(sk, sd, bits, positions=positions)
        assert all(g.dtype == np.uint64 and np.array_equal(g, w) for g, w in zip(got, want))
        assert int(got[1].sum()) == sk.size
    empty = repair.bucket_digests(np.zeros(0, np.uint64), np.zeros(0, np.uint64), bits)
    assert all(np.array_equal(g, w) for g, w in zip(
        empty, ref_repair.bucket_digests(np.zeros(0, np.uint64), np.zeros(0, np.uint64), bits)))
    for b in (0, 1, (1 << bits) - 1):
        assert repair.bucket_range(b, bits) == ref_repair.bucket_range(b, bits)
    assert repair.bucket_range((1 << bits) - 1, bits)[1] == repair.KEY_SPACE_END
    assert repair.DEFAULT_BITS == ref_repair.DEFAULT_BITS


def test_namespace_policies_equal_reference():
    def fields(policies):
        return [(p.prefix, p.auto_provision, p.wipe_allowed, p.quota_class) for p in policies]

    assert fields(remote.NAMESPACE_POLICIES) == fields(ref_remote.NAMESPACE_POLICIES)
    for sp in ("bands", "urls", "canary:probe", "tenant:t:bands", "canary", ""):
        assert remote.namespace_policy(sp).prefix == ref_remote.namespace_policy(sp).prefix
    assert remote.CANARY_SPACE_PREFIX == ref_remote.CANARY_SPACE_PREFIX


# -- parity with the oracle and the JAX fleet ----------------------------------------


def test_fleet_equals_oracle_and_the_jax_fleet(tmp_path):
    """The same stream through the port's fleet, the JAX fleet and one
    ``PersistentIndex``: equal ids and attributions, probes, min-doc maps
    and node digests, and byte-equal shard directories node for node."""
    probes, maps, digests = {}, {}, {}
    q = np.random.default_rng(1).integers(0, 400, size=(64, 8)).astype(np.uint64)
    for pkg in ("jax", "port"):
        servers, client = make_fleet(tmp_path / pkg, pkg)
        oracle = PKG[pkg]["store"].PersistentIndex(str(tmp_path / pkg / "oracle"),
                                                   cut_postings=96)
        try:
            oracle_stream(client, oracle, np.random.default_rng(7), 5, 300)
            probes[pkg] = np.asarray(client.probe_batch(q))
            assert (probes[pkg] == np.asarray(oracle.probe_batch(q))).all()
            maps[pkg] = min_map(*client.dump_postings())
            assert maps[pkg] == min_map(*oracle.dump_postings())
            digests[pkg] = [tuple(a.tolist() for a in client._node_digest(sh, node))
                            for sh in client._shards for node in sh.nodes]
            assert client.doc_id_floor() == oracle.doc_id_floor() == 80
            client.checkpoint()
        finally:
            client.close()
            oracle.close()
            stop_all(servers)
    assert (probes["port"] == probes["jax"]).all() and maps["port"] == maps["jax"]
    assert digests["port"] == digests["jax"]
    for s in range(2):
        for r in range(2):
            port_tree = tree(tmp_path / "port" / f"s{s}n{r}")
            assert port_tree and port_tree == tree(tmp_path / "jax" / f"s{s}n{r}")


def test_remote_index_drop_in_and_semantic_idempotency(tmp_path):
    srv = start_server("port", tmp_path / "one", "one", spaces=("bands",), cut_postings=64)
    oracle = store.PersistentIndex(str(tmp_path / "oracle"), cut_postings=64)
    r = remote.RemoteIndex(("127.0.0.1", srv.port), space="bands", timeout=WAIT)
    try:
        rng = np.random.default_rng(3)
        for _ in range(3):
            keys = rng.integers(0, 200, size=(8, 4)).astype(np.uint64)
            ids = r.allocate_doc_ids(8)
            assert (ids == oracle.allocate_doc_ids(8)).all()
            assert (np.asarray(r.check_and_add_batch(keys, ids))
                    == np.asarray(oracle.check_and_add_batch(keys, ids))).all()
        r.log_names([0, 1], ["a", "b"])
        assert r.doc_id_floor() == oracle.doc_id_floor() == 24
        assert r.stats()["spaces"]["bands"]["next_doc_id"] == 24
        # a redelivered batch under a fresh id applies nothing
        keys = np.arange(1000, 1010, dtype=np.uint64)
        assert r.insert_batch(keys, keys + 100, request_id="r1") == 10
        assert r.insert_batch(keys, keys + 100, request_id="r2") == 0
        k, d = r.dump_postings(page=7)
        assert min_map(k, d) == min_map(*srv.indexes["bands"].dump_postings())
        assert sorted(r.fetch_range(1000, 1005, page=2)[0].tolist()) == list(range(1000, 1005))
        assert r.ping() and r.scrub()["bands"]["ok"]
    finally:
        r.close()
        oracle.close()
        stop_all([srv])


# -- failover, spill, backfill ----------------------------------------------------


@pytest.fixture
def metrics():
    """Telemetry on in both packages (the fleets' counters and histograms
    record), and fresh registries before and after."""
    for tel in (telemetry, ref_telemetry):
        tel.REGISTRY.reset()
        tel.set_enabled(True)
    yield
    for tel in (telemetry, ref_telemetry):
        tel.set_enabled(None)
        tel.REGISTRY.reset()


def test_two_shard_failover_mid_stream_byte_equal_oracle(tmp_path, metrics):
    """A primary dies mid stream: the client fails over and promotes, and
    every answer stays the oracle's; ``fleet_status`` has the reference's
    shape and shows the dead node."""
    servers, client = make_fleet(tmp_path)
    oracle = store.PersistentIndex(str(tmp_path / "oracle"), cut_postings=96)
    try:
        rng = np.random.default_rng(11)
        oracle_stream(client, oracle, rng, 8, 350, kill=servers[0].stop)
        q = rng.integers(0, 400, size=(64, 8)).astype(np.uint64)
        assert (np.asarray(client.probe_batch(q)) == np.asarray(oracle.probe_batch(q))).all()
        assert client._m_failovers.value >= 1 and client._m_promotions.value >= 1
        assert client._m_spilled.value == 0
        status = client.fleet_status()
        dead = [n for sh in status["shards"] for n in sh["nodes"] if not n["alive"]]
        assert len(dead) == 1 and not dead[0]["write_target"]
        assert set(status) == {"space", "shards"}
        assert set(status["shards"][0]) == {"shard", "nodes", "promoting", "spill_pending",
                                            "awaiting_resync"}
        hist = [h for h in telemetry.REGISTRY.find("astpu_fleet_rpc_seconds") if h.count]
        assert {h.labels["method"] for h in hist} == {"probe", "insert"}
    finally:
        client.close()
        oracle.close()
        stop_all(servers)


def test_dark_shard_spills_then_replays(tmp_path, metrics):
    """Both nodes of a shard die: writes journal locally and the overlay
    answers for them (counted as degraded); a node restarted on its port
    over its directory gets the journal replayed, and the journal goes."""
    servers, client = make_fleet(tmp_path, shards=1)
    try:
        client.insert_batch(np.arange(0, 12, dtype=np.uint64), np.full(12, 1, np.uint64))
        port1 = servers[1].port
        stop_all(servers)
        keys2 = np.arange(100, 112, dtype=np.uint64)
        client.insert_batch(keys2, np.full(12, 2, np.uint64))  # no raise
        assert client._m_spilled.value == 12
        assert (np.asarray(client.probe_batch(keys2)) == 2).all()
        assert client._m_degraded.value > 0
        assert os.listdir(tmp_path / "spill") == ["shard0-bands.spill"]
        revived = start_server("port", tmp_path / "s0n1", "s0n1", port=port1)
        servers.append(revived)
        time.sleep(client.health_timeout + 0.05)
        client.checkpoint()  # recovery probe → revive → promote → replay
        assert client._m_replayed.value == 12 and client._m_promotions.value == 1
        assert not client._shards[0].pending
        got = min_map(*revived.indexes["bands"].dump_postings())
        assert all(got[k] == 2 for k in keys2.tolist()) and got[0] == 1
        assert not os.listdir(tmp_path / "spill"), "a drained journal is removed"
    finally:
        client.close()
        stop_all(servers)


def test_spill_survives_restart_and_torn_tail_is_truncated(tmp_path):
    """A journal written by the JAX package's WAL, torn at its tail,
    replays its valid prefix into the live shard at open and is truncated;
    then a dark shard spills, the client 'crashes', and a new client
    reloads the spill and answers for it from the overlay."""
    from advanced_scrapper_tpu.index.wal import WriteAheadLog as RefWal

    spill = tmp_path / "spill"
    spill.mkdir()
    path = spill / "shard0-bands.spill"
    w = RefWal(str(path))
    w.append(np.arange(5, dtype=np.uint64), np.full(5, 3, np.uint64))
    w.close()
    with open(path, "ab") as f:
        f.write(b"torn-garbage-tail")
    servers, client = make_fleet(tmp_path, shards=1, replicas=1, retries=0)
    try:
        assert not client._shards[0].pending
        assert set(range(5)) <= set(servers[0].indexes["bands"].dump_postings()[0].tolist())
        if path.exists():
            assert path.stat().st_size == ref_store.replay_wal(str(path))[2]
        stop_all(servers)
        keys = np.arange(100, 104, dtype=np.uint64)
        client.insert_batch(keys, np.full(4, 7, np.uint64))
        client._pool.shutdown(wait=True)  # a crash: no close, only the journal survives
        client2 = fleet.ShardedIndexClient(client.spec, space="bands", spill_dir=str(spill),
                                           timeout=0.5, retries=0, health_timeout=0.1)
        try:
            assert sum(int(k.size) for _r, k, _d in client2._shards[0].pending) == 4
            assert (np.asarray(client2.probe_batch(keys)) == 7).all()
            # the JAX package reloads the port's journal the same way
            client2._pool.shutdown(wait=True)
            ref_client = ref_fleet.ShardedIndexClient(
                ref_fleet.FleetSpec(client.spec.shards), space="bands", spill_dir=str(spill), timeout=0.5, retries=0,
                health_timeout=0.1)
            assert (np.asarray(ref_client.probe_batch(keys)) == 7).all()
            ref_client.close()
        finally:
            client2.close()
    finally:
        client.close()
        stop_all(servers)


def test_gap_backfill_makes_promotion_safe(tmp_path, metrics):
    """The replica misses acked writes while the primary takes them; it
    rejoins only after absorbing its gap ledger, so promoting it when the
    primary dies loses nothing."""
    servers, client = make_fleet(tmp_path, shards=1)
    oracle = store.PersistentIndex(str(tmp_path / "oracle"), cut_postings=96)
    try:
        rng = np.random.default_rng(23)
        oracle_stream(client, oracle, rng, 1, 250)
        sh = client._shards[0]
        client._note_failure(sh, sh.nodes[1])
        oracle_stream(client, oracle, rng, 2, 250)
        assert sh.gaps.get(1), "missed acked writes must be ledgered"
        time.sleep(client.health_timeout + 0.05)
        client._try_revive(sh)
        assert sh.nodes[1].alive and not sh.gaps.get(1) and client._m_backfilled.value > 0
        stop_all(servers[:1])
        oracle_stream(client, oracle, rng, 2, 250)
        q = rng.integers(0, 300, size=(64, 8)).astype(np.uint64)
        assert (np.asarray(client.probe_batch(q)) == np.asarray(oracle.probe_batch(q))).all()
        assert sh.write_target == 1
    finally:
        client.close()
        oracle.close()
        stop_all(servers)


def test_remote_error_is_loud_not_a_failover(tmp_path):
    srv = start_server("port", tmp_path / "one", "one", spaces=("bands",))
    client = fleet.ShardedIndexClient(f"127.0.0.1:{srv.port}", space="nope", timeout=WAIT,
                                      retries=0)
    try:
        with pytest.raises(rpc.RpcRemoteError, match="nope"):
            client.probe_batch(np.arange(4, dtype=np.uint64))
        assert client._shards[0].nodes[0].alive, "a config error is not a dead node"
        assert client._m_failovers.value == 0
    finally:
        client.close()
        stop_all([srv])


def test_allocation_refuses_an_unsynced_floor(tmp_path):
    servers, client = make_fleet(tmp_path / "a", shards=1, replicas=1, retries=0)
    try:
        stop_all(servers)  # dark before any sync
        with pytest.raises(rpc.RpcUnavailable, match="floor"):
            client.allocate_doc_ids(4)
    finally:
        client.close()
    servers, client = make_fleet(tmp_path / "b", shards=1, replicas=1, retries=0)
    try:
        first = client.allocate_doc_ids(4)  # synced: the floor is known
        stop_all(servers)
        second = client.allocate_doc_ids(4)  # degraded but safe
        assert first.tolist() == [0, 1, 2, 3] and second.tolist() == [4, 5, 6, 7]
    finally:
        client.close()


# -- anti-entropy ------------------------------------------------------------------


def flip_bit_at(path: str, byte_off: int) -> None:
    with open(path, "r+b") as fh:
        fh.seek(byte_off)
        b = fh.read(1)[0]
        fh.seek(byte_off)
        fh.write(bytes([b ^ 0x10]))


def test_anti_entropy_heals_a_scrubbed_replica_under_churn(tmp_path):
    """Scrub withdraws a bit-rotted replica segment; repair passes run
    while inserts flow, and the quiesced pass converges both replicas to
    every insert, with equal ``bucket_digests``."""
    servers, client = make_fleet(tmp_path, shards=1)
    expect: dict[int, int] = {}
    try:
        for i in range(4):
            keys = np.arange(i * 100, i * 100 + 40, dtype=np.uint64)
            client.insert_batch(keys, np.full(40, i, np.uint64))
            expect.update({int(k): i for k in keys.tolist()})
        ridx = servers[1].indexes["bands"]
        ridx.cut_segment()
        seg_path = ridx._segments[0].path
        flip_bit_at(seg_path, os.path.getsize(seg_path) - 3)
        assert not ridx.scrub()["ok"] and os.path.exists(seg_path + ".quarantine")
        stop = threading.Event()
        churned: dict[int, int] = {}

        def churn():
            j = 0
            while not stop.is_set() and j < 200:
                keys = np.arange(10_000 + j * 50, 10_000 + j * 50 + 16, dtype=np.uint64)
                client.insert_batch(keys, np.full(16, 500 + j, np.uint64))
                churned.update({int(k): 500 + j for k in keys.tolist()})
                j += 1
                time.sleep(0.01)

        t = threading.Thread(target=churn)
        t.start()
        try:
            for _ in range(3):
                client.repair_once()
        finally:
            stop.set()
            t.join(timeout=WAIT)
        expect.update(churned)
        stats = client.repair_once()
        assert stats["pairs"] == 1 and stats["unmatched"] == 0, stats
        m0 = min_map(*servers[0].indexes["bands"].dump_postings())
        assert m0 == min_map(*ridx.dump_postings()) == expect
        assert client._m_repair_postings.value > 0
        d0, d1 = (repair.bucket_digests(*s.indexes["bands"].semantic_items()) for s in servers)
        assert all(np.array_equal(a, b) for a, b in zip(d0, d1))
    finally:
        client.close()
        stop_all(servers)


def test_gap_overflowed_node_rejoins_only_by_resync(tmp_path):
    """A replica whose gap ledger overflowed is refused by the plain
    drain and rejoins through the digest-verified resync, with writes
    still flowing; then both nodes hold every acked posting."""
    servers, client = make_fleet(tmp_path, shards=1, gap_limit_postings=64,
                                 health_timeout=0.1, digest_bits=4)
    expect: dict[int, int] = {}

    def put(lo: int, n: int, doc: int):
        keys = np.arange(lo, lo + n, dtype=np.uint64)
        client.insert_batch(keys, np.full(n, doc, np.uint64))
        expect.update({int(k): doc for k in keys.tolist()})

    try:
        put(0, 32, 0)
        sh = client._shards[0]
        overflow = telemetry.event_counter("astpu_fleet_gap_overflow_total")
        before = overflow.value
        client._note_failure(sh, sh.nodes[1])
        port1 = servers[1].port
        stop_all(servers[1:])
        put(1000, 48, 1)
        put(2000, 48, 2)  # past the 64-posting cap: the ledger is dropped
        assert 1 in sh.gap_overflow and not sh.gaps.get(1) and overflow.value > before
        revived = start_server("port", tmp_path / "s0n1", "s0n1", port=port1)
        servers.append(revived)
        time.sleep(client.health_timeout + 0.05)
        client._try_revive(sh)
        assert not sh.nodes[1].alive, "the plain drain must refuse an overflowed node"
        stop = threading.Event()
        churned: dict[int, int] = {}

        def churn():
            j = 0
            while not stop.is_set() and j < 100:
                keys = np.arange(50_000 + j * 40, 50_000 + j * 40 + 8, dtype=np.uint64)
                client.insert_batch(keys, np.full(8, 900 + j, np.uint64))
                churned.update({int(k): 900 + j for k in keys.tolist()})
                j += 1
                time.sleep(0.05)

        t = threading.Thread(target=churn)
        t.start()
        try:
            deadline = time.monotonic() + 8
            while not sh.nodes[1].alive and time.monotonic() < deadline:
                client.checkpoint()
        finally:
            stop.set()
            t.join(timeout=WAIT)
        expect.update(churned)
        assert sh.nodes[1].alive and not sh.gap_overflow, "resync never readmitted the node"
        assert client._m_resyncs.value >= 1 and client._m_resync_postings.value > 0
        client.checkpoint()
        client.repair_once()
        assert min_map(*servers[0].indexes["bands"].dump_postings()) == expect
        assert min_map(*revived.indexes["bands"].dump_postings()) == expect
    finally:
        client.close()
        stop_all(servers)


def test_snapshot_wipe_restore_byte_identical(tmp_path):
    """Snapshot a live 2×2 port fleet (``tools/fleet_snapshot.py``, whose
    client is the JAX package's, over the wire), tear it down, restore
    onto fresh directories: replicas byte-identical, every index verifies,
    and port servers over them answer as before.  Then the canary-plane
    wipe of the restored fleet leaves the real spaces untouched."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import fleet_snapshot
    finally:
        sys.path.remove(os.path.join(ROOT, "tools"))
    servers, client = make_fleet(tmp_path)
    q = np.arange(0, 600, dtype=np.uint64).reshape(-1, 4)
    try:
        rng = np.random.default_rng(17)
        for _ in range(5):
            keys = rng.integers(0, 500, size=(16, 4)).astype(np.uint64)
            client.check_and_add_batch(keys, client.allocate_doc_ids(16))
        before = np.asarray(client.probe_batch(q))
        spec = ";".join("|".join(f"{h}:{p}" for h, p in nodes) for nodes in client.spec.shards)
        man = fleet_snapshot.snapshot_fleet(spec, str(tmp_path / "snap"),
                                            spaces=("bands", "urls"))
        assert fleet_snapshot.verify_snapshot(str(tmp_path / "snap")) == [] and len(man["shards"]) == 2
        assert (np.asarray(client.probe_batch(q)) == before).all()
    finally:
        client.close()
        stop_all(servers)
    node_dirs = fleet_snapshot.restore_fleet(str(tmp_path / "snap"), str(tmp_path / "restored"),
                                             replicas=2)
    assert len(node_dirs) == 4
    for s in range(2):
        a, b = (tree(tmp_path / "restored" / f"s{s}n{r}" / "bands") for r in range(2))
        assert a == b and any(n.endswith(".seg") for n in a)
    for nd in node_dirs:
        idx = store.PersistentIndex(os.path.join(nd, "bands"), read_only=True)
        try:
            report = idx.scrub()
            assert report["ok"] and report["backfilled_digests"] == 0, report
        finally:
            idx.close()
    servers2, parts = [], []
    for s in range(2):
        addrs = []
        for r in range(2):
            srv = start_server("port", tmp_path / "restored" / f"s{s}n{r}", f"r{s}n{r}")
            servers2.append(srv)
            addrs.append(f"127.0.0.1:{srv.port}")
        parts.append("|".join(addrs))
    client2 = fleet.ShardedIndexClient(";".join(parts), space="bands",
                                       spill_dir=str(tmp_path / "spill2"), timeout=WAIT,
                                       retries=1)
    try:
        assert (np.asarray(client2.probe_batch(q)) == before).all(), "restored fleet differs"
        with pytest.raises(ValueError, match="wipe"):
            client2.wipe()
        canary = client2.for_space(remote.CANARY_SPACE_PREFIX + "x")
        canary.insert_batch(np.arange(8, dtype=np.uint64), np.zeros(8, np.uint64))
        assert canary.wipe() == 16 and canary.wipe() == 0
        canary.close()
        assert (np.asarray(client2.probe_batch(q)) == before).all()
    finally:
        client2.close()
        stop_all(servers2)


# -- the packages together -----------------------------------------------------------


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_shard_directory_round_trip(tmp_path, writer, reader):
    """A shard directory written through one package's server (and its
    client) opens under the other's: equal probe answers, digests (raw and
    mixed, over a ring arc), ``fetch_range`` and ``dump_postings``."""
    servers, client = make_fleet(tmp_path, writer, shards=1, replicas=1)
    rng = np.random.default_rng(5)
    try:
        for _ in range(6):
            keys = rng.integers(0, 1 << 62, size=(32, 8)).astype(np.uint64)
            client.check_and_add_batch(keys, client.allocate_doc_ids(32))
        client.log_names(np.arange(4, dtype=np.uint64), ["a", "b", "c", "d"])
        q = rng.integers(0, 1 << 62, size=(64, 8)).astype(np.uint64)
        q[:16] = keys[:16]
        answers = {writer: observe(writer, servers[0].port, q)}
    finally:
        client.close()
        stop_all(servers)
    srv = start_server(reader, tmp_path / "s0n0", "s0n0")
    try:
        answers[reader] = observe(reader, srv.port, q)
    finally:
        stop_all([srv])
    assert min(answers[writer][0][:16]) >= 0
    assert answers[reader] == answers[writer]


def observe(pkg: str, port: int, q: np.ndarray) -> tuple:
    """What one node answers, through ``pkg``'s client and node handle."""
    client = PKG[pkg]["fleet"].ShardedIndexClient(f"127.0.0.1:{port}", timeout=WAIT)
    node = PKG[pkg]["remote"].RemoteIndex(("127.0.0.1", port), timeout=WAIT)
    try:
        return (np.asarray(client.probe_batch(q)).tolist(),
                [a.tolist() for a in node.digest()],
                [a.tolist() for a in node.digest(bits=6, lo=1 << 62, hi=3 << 62, mixed=True)],
                [a.tolist() for a in node.fetch_range(0, 1 << 61, page=50)],
                [a.tolist() for a in node.dump_postings(page=100)],
                node.doc_id_floor(), node.stats()["spaces"]["bands"]["segments"])
    finally:
        node.close()
        client.close()


@pytest.mark.parametrize("cpkg", ["port", "jax"])
def test_mixed_fleet_of_jax_and_port_nodes(tmp_path, cpkg, metrics):
    """Each shard a JAX and a port node, driven by either package's client:
    the oracle's answers, a failover across the packages, and replicas of
    each package holding equal min-doc maps after a repair pass."""
    servers, client = make_fleet(tmp_path, cpkg, nodes=[["jax", "port"], ["port", "jax"]])
    oracle = store.PersistentIndex(str(tmp_path / "oracle"), cut_postings=96)
    try:
        rng = np.random.default_rng(29)
        oracle_stream(client, oracle, rng, 6, 300, kill=servers[2].stop)
        q = rng.integers(0, 400, size=(64, 8)).astype(np.uint64)
        assert (np.asarray(client.probe_batch(q)) == np.asarray(oracle.probe_batch(q))).all()
        assert client._m_failovers.value >= 1
        assert client.repair_once()["unmatched"] == 0
        a, b = (min_map(*servers[i].indexes["bands"].dump_postings()) for i in (0, 1))
        assert a == b and a
    finally:
        client.close()
        oracle.close()
        stop_all(servers)


# -- the entry points -----------------------------------------------------------------


def words(rng: np.random.RandomState, n: int) -> str:
    w = rng.randint(97, 123, size=(n, 6))
    return " ".join("".join(map(chr, x[: rng.randint(2, 7)])) for x in w)


def stream_records(seed: int, n: int = 96) -> list[dict]:
    rng = np.random.RandomState(seed)
    texts, recs = [], []
    for i in range(n):
        u = rng.rand()
        if i > 4 and u < 0.3:
            chars = list(texts[rng.randint(i)])
            for _ in range(max(1, len(chars) // 60)):
                chars[rng.randint(len(chars))] = chr(rng.randint(97, 123))
            text = "".join(chars)
        elif i > 4 and u < 0.4:
            text = texts[rng.randint(i)]
        else:
            text = words(rng, int(rng.randint(20, 80)))
        texts.append(text)
        url = f"https://news.example/{rng.randint(i)}.html" if i and rng.rand() < 0.1 \
            else f"https://news.example/{i}.html"
        recs.append({"url": url, "article": text, "i": i})
    return recs


def run_stream(backend, records) -> list[tuple]:
    out = []
    for rec in records:
        out += backend.submit(dict(rec))
    out += backend.flush()
    return [(r["i"], r["dup_of"], r["near_dup_of"]) for r in out]


def test_stream_backend_rides_the_fleet(tmp_path):
    """``DedupConfig(stream_index="persist", index_fleet=spec)``: the port's
    backend on the CPU over a port fleet annotates as the JAX backend over
    a JAX fleet, and as the port's local persist mode, in two sessions; the
    shard servers hold the postings (equal between the fleets), and the
    local directory holds no ``bands/``."""
    records = stream_records(41)
    base = dict(batch_size=32, stream_index="persist", index_fleet_timeout=WAIT)
    ann, dumps = {}, {}
    for pkg, make, cfg, kw in (("jax", ref_tb.TpuBatchBackend, RefConfig, {}),
                               ("port", tpu_batch.TpuBatchBackend, DedupConfig,
                                {"device": "cpu"})):
        servers, client = make_fleet(tmp_path / pkg, pkg, replicas=1)
        client.close()
        spec = ";".join(f"127.0.0.1:{s.port}" for s in servers)
        try:
            ann[pkg] = []
            for part in (records[:48], records[48:]):
                b = make(cfg(**base, index_fleet=spec), index_dir=str(tmp_path / pkg / "local"),
                         **kw)
                ann[pkg] += run_stream(b, part)
                b.checkpoint(None)  # persist mode: the path is unused
                b.close()
            dumps[pkg] = [min_map(*s.indexes[sp].dump_postings()) for s in servers
                          for sp in ("bands", "urls")]
        finally:
            stop_all(servers)
        assert not (tmp_path / pkg / "local" / "bands").exists()
        assert os.listdir(tmp_path / pkg / "local") == ["spill"]
    local = tpu_batch.TpuBatchBackend(DedupConfig(batch_size=32, stream_index="persist"),
                                      index_dir=str(tmp_path / "plain"), device="cpu")
    local_ann = run_stream(local, records)
    local.close()
    assert ann["port"] == ann["jax"] == local_ann
    assert any(a[2] for a in local_ann) and any(a[1] for a in local_ann)
    assert dumps["port"] == dumps["jax"] and all(dumps["port"])


def test_engine_open_stream_index_picks_the_fleet(tmp_path):
    srv = start_server("port", tmp_path / "shard", "shard", spaces=("bands",))
    texts = [r["article"] for r in stream_records(43, 40)]
    try:
        local = NearDupEngine(DedupConfig(stream_index="persist", rerank=False), device="cpu")
        idx = local.open_stream_index(str(tmp_path / "local"))
        assert isinstance(idx, store.PersistentIndex)
        want = local.dedup_against_index(texts, idx)
        idx.close()
        cfg = dict(stream_index="persist", rerank=False, index_fleet=f"127.0.0.1:{srv.port}",
                   index_fleet_timeout=WAIT, index_fleet_retries=1, index_fleet_health_checks=3)
        eng = NearDupEngine(DedupConfig(**cfg), device="cpu")
        idx = eng.open_stream_index(str(tmp_path / "flt"))
        assert isinstance(idx, fleet.ShardedIndexClient)
        assert (idx.timeout, idx.health_checks, idx._retries) == (WAIT, 3, 1)
        assert idx.spill_dir == str(tmp_path / "flt" / "spill")
        got = eng.dedup_against_index(texts, idx)
        idx.close()
        assert (got == want).all() and (got >= 0).any() and (got < 0).any()
        ref_eng = RefEngine(RefConfig(**cfg))
        ref_idx = ref_eng.open_stream_index(str(tmp_path / "flt-jax"))
        # the JAX engine over the same shard, now holding the port's postings
        # (doc i under id i): a fresh row finds itself, a dup its source
        again = np.asarray(ref_eng.dedup_against_index(texts, ref_idx))
        ref_idx.close()
        assert (again == np.where(got < 0, np.arange(len(texts)), got)).all()
    finally:
        stop_all([srv])


# -- the shard process --------------------------------------------------------------------


def test_shard_modules_load_no_torch():
    code = ("import sys\n"
            "import advanced_scrapper_tpu_torch.index.remote, advanced_scrapper_tpu_torch.net.rpc\n"
            "import advanced_scrapper_tpu_torch.index.fleet, advanced_scrapper_tpu_torch.index.reshard\n"
            "import advanced_scrapper_tpu_torch.runtime.autoscaler\n"
            "import advanced_scrapper_tpu_torch.service.tenancy\n"
            "import advanced_scrapper_tpu_torch.service.gateway\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', "
            "'advanced_scrapper_tpu')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=60, env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr


def test_serve_main_port_file_and_clean_sigterm(tmp_path):
    """``python -m advanced_scrapper_tpu_torch.index.remote``: the port file
    appears once the socket listens, a JAX client is served, the process
    maps no torch library, and SIGTERM stops it with status 0."""
    port_file = tmp_path / "port"
    proc = subprocess.Popen(
        [sys.executable, "-m", "advanced_scrapper_tpu_torch.index.remote",
         "--dir", str(tmp_path / "shard"), "--port-file", str(port_file), "--name", "solo"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 30
        while not port_file.exists() and time.monotonic() < deadline and proc.poll() is None:
            time.sleep(0.05)
        port = int(port_file.read_text())
        node = ref_remote.RemoteIndex(("127.0.0.1", port), timeout=WAIT)
        keys = np.arange(10, dtype=np.uint64)
        assert node.insert_batch(keys, keys) == 10
        assert (np.asarray(node.probe_batch(keys)) == np.arange(10)).all()
        assert node.stats()["shard"] == "solo"
        node.close()
        maps = open(f"/proc/{proc.pid}/maps").read()
        assert "libtorch" not in maps and "libc10" not in maps
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=10)
        finally:
            if proc.poll() is None:
                proc.kill()
    assert rc == 0, proc.stderr.read()
    with socket.socket() as s:  # the port is free again
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", port))


# -- the stitched trace ------------------------------------------------------------------


@pytest.fixture
def traced():
    telemetry.REGISTRY.reset()
    telemetry.set_enabled(True)
    trace.set_enabled(True)
    trace.RECORDER.clear()
    yield
    trace.RECORDER.clear()
    telemetry.REGISTRY.reset()
    telemetry.set_enabled(None)
    trace.set_enabled(None)


def test_stitched_trace_spans_client_fanout_and_shard_execution(tmp_path, traced):
    """One batch against a 2×2 port fleet: the client's fan-out spans and
    the shard servers' execution spans carry the same trace id (the server
    threads have no ambient context: the id crossed the socket), span ids
    are distinct, and the fleet's latency histograms keep it as exemplar."""
    servers, client = make_fleet(tmp_path, server_kw=dict(spaces=("bands",)))
    try:
        tid = trace.new_trace_id()
        keys = np.random.default_rng(3).integers(0, 500, size=(32, 8)).astype(np.uint64)
        with trace.trace_context(tid):
            client.check_and_add_batch(keys, client.allocate_doc_ids(32))
            client.probe_batch(keys)
        events = trace.RECORDER.snapshot()
        fanout = [e for e in events if e.get("name") in ("fleet.probe", "fleet.insert")]
        shard_side = [e for e in events if str(e.get("name", "")).startswith("rpc.")
                      and e.get("kind") == "span"]
        assert fanout and shard_side
        assert {e.get("trace") for e in fanout} == {e.get("trace") for e in shard_side} == {tid}
        assert {e.get("shard") for e in fanout} == {0, 1}
        assert {e["name"] for e in shard_side} >= {"rpc.probe", "rpc.insert", "rpc.allocate"}
        span_ids = [e.get("span") for e in fanout + shard_side]
        assert len(span_ids) == len(set(span_ids))
        exes = [h.exemplar for h in telemetry.REGISTRY.find("astpu_fleet_rpc_seconds")
                if h.exemplar is not None]
        assert exes and all(e["trace"] == tid for e in exes)
    finally:
        client.close()
        stop_all(servers)


def test_trace_id_survives_a_replayed_retry(traced):
    """The connection is cut after the request went out: the retry carries
    the same request id and trace header, the server executes once and
    replays once, and both the execution span and the replay event carry
    the original trace id."""
    calls = {"n": 0}

    def echo(header, arrays):
        calls["n"] += 1
        return {"echo": header.get("x")}

    srv = rpc.RpcServer({"echo": echo}, name="replay-t", frame_deadline=WAIT).start()
    cut = {"done": False}

    class CutAfterSend:
        def __init__(self, inner):
            self._inner = inner

        def sendall(self, data):
            self._inner.sendall(data)
            if not cut["done"]:
                cut["done"] = True
                self._inner.close()
                raise ConnectionResetError("injected post-send cut")

        def __getattr__(self, name):
            return getattr(self._inner, name)

    cli = rpc.RpcClient(("127.0.0.1", srv.port), timeout=WAIT, retries=3, backoff_base=0.001,
                        connect=lambda a: CutAfterSend(socket.create_connection(a, timeout=WAIT)))
    try:
        tid = trace.new_trace_id()
        with trace.trace_context(tid):
            assert cli.call("echo", {"x": 7})[0]["echo"] == 7
        deadline = time.monotonic() + WAIT
        while srv.replays < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert calls["n"] == 1 and srv.replays == 1
        events = trace.RECORDER.snapshot()
        spans = [e for e in events if e.get("name") == "rpc.echo"]
        replays = [e for e in events if e.get("name") == "rpc.replay"]
        assert len(spans) == 1 and spans[0]["trace"] == tid
        assert len(replays) == 1 and replays[0]["trace"] == tid
    finally:
        cli.close()
        srv.stop()


def test_status_sidecar_serves_the_shard(tmp_path):
    """``status_port=0`` starts the shard's ``/status`` and ``/metrics``
    sidecar (the port's ``obs/telemetry.StatusServer``)."""
    import urllib.request

    srv = start_server("port", tmp_path / "s", "side", status_port=0)
    try:
        url = f"http://127.0.0.1:{srv.status_server.port}/status"
        with urllib.request.urlopen(url, timeout=WAIT) as r:
            body = json.loads(r.read())
        assert body["shard"] == "side" and set(body["spaces"]) == {"bands", "urls"}
    finally:
        stop_all([srv])
        assert srv.status_server is None
