"""Replicated, fault-tolerant sharded index fleet — the client half.

:class:`ShardedIndexClient` presents the :class:`~.store.PersistentIndex`
API (``probe_batch`` / ``insert_batch`` / ``check_and_add_batch`` /
``allocate_doc_ids`` / ``log_names`` / ``doc_id_floor``) over a fleet of
:class:`~.remote.IndexShardServer` nodes, so every existing caller — the
engine's ``dedup_against_index``, the TPU batch backend's persist mode —
scales past one disk by changing a config string, not a call site.

**Topology.**  The uint64 band-key space is consistent-hashed (virtual
nodes on a ring) into N shards; each shard is a primary plus a
configurable replica.  All postings for a key live on exactly one shard,
so a probe's global minimum doc id is the minimum over per-shard answers
— the property that keeps fleet attribution byte-equal to a single-node
index.

**Writes** replicate synchronously: a posting batch is acked only when
every live node of its shard applied it (same request id on each — the
transport's idempotency cache and the shard's semantic insert filter make
redelivery harmless).  **Reads** go to the shard's current write target,
min-combined with the local spill overlay.

**Failover.**  A node that misses its deadline is marked down and counted.
If it was the write target, the shard enters *promotion*: reads move to
the surviving replica immediately; writes spill until the candidate has
answered ``health_checks`` consecutive pings, then it is promoted and the
spill journal replays into it.  A shard with NO reachable node degrades
gracefully: writes journal to a local WAL (crash-safe through the fsio
seam, reloaded on client restart) with an in-memory overlay answering
probes for the spilled postings, and the journal replays — original
request ids — when any node returns.  Degraded probes that might miss
history are counted, never raised: the pipeline keeps flowing.

**The live-node invariant.**  Every write a shard ACKS is also recorded
in a *gap ledger* for each node that missed it (dead, or failed the
call); a returning node must absorb its ledger before it rejoins.  So
``live ⇒ holding every acked posting``, and promotion may safely elect
any live node — a replica that was briefly down while the primary took
writes can never be promoted into silent data loss.  A ledger that
outgrows ``GAP_LIMIT_POSTINGS`` is dropped and its node sits out this
client's lifetime (counted; an operator resync is cheaper than
unbounded client RAM).

Every edge is on the telemetry plane: per-shard RPC latency histograms,
retry / failover / promotion / spill / replay counters, and a
``fleet_status()`` dict for ``/status``.

The port's copy of the reference's ``index/fleet.py``, ``reshard_to``
included: request ids, routing, spill journals, the migration WAL and
every RPC are the reference's, so a port client drives reference shard
servers (and reshards them) and the other way round.  Host code: no
torch.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from advanced_scrapper_tpu_torch.index.repair import (
    interval_add,
    interval_sub,
    mix64,
    range_mask,
)
from advanced_scrapper_tpu_torch.index.remote import (
    CANARY_SPACE_PREFIX,
    namespace_policy,
)
from advanced_scrapper_tpu_torch.index.store import NO_DOC, resolve_intra_batch
from advanced_scrapper_tpu_torch.runtime import FanoutPool
from advanced_scrapper_tpu_torch.index.wal import WriteAheadLog, replay_wal
from advanced_scrapper_tpu_torch.net.rpc import (
    RpcClient,
    RpcOverloaded,
    RpcUnavailable,
)

__all__ = [
    "FleetSpec",
    "ShardedIndexClient",
    "open_fleet_index",
    "ring_assign",
]


def open_fleet_index(cfg, index_dir: str, *, space: str = "bands", **kw):
    """THE fleet-client factory — every call site (the TPU batch
    backend's persist mode, ``NearDupEngine.open_stream_index``) builds
    its :class:`ShardedIndexClient` here, so the knob-to-constructor
    mapping and the spill layout can never drift between paths.

    ``cfg`` is anything carrying the ``DedupConfig`` fleet fields
    (``index_fleet`` / ``index_fleet_timeout`` / ``index_fleet_retries``
    / ``index_fleet_health_checks``); ``index_dir`` is the LOCAL
    directory — in fleet mode it holds only the spill journals."""
    return ShardedIndexClient(
        FleetSpec.parse(cfg.index_fleet),
        space=space,
        spill_dir=os.path.join(index_dir, "spill"),
        timeout=cfg.index_fleet_timeout,
        retries=cfg.index_fleet_retries,
        health_checks=cfg.index_fleet_health_checks,
        **kw,
    )

_I64_MAX = np.iinfo(np.int64).max


# -- topology ----------------------------------------------------------------

@dataclass(frozen=True)
class FleetSpec:
    """Parsed fleet topology: ``shards[i]`` is that shard's replica set,
    primary first.  Wire syntax (the ``DedupConfig.index_fleet`` string)::

        host:port|host:port ; host:port|host:port ; ...

    ``;`` separates shards, ``|`` separates a shard's replicas.
    Whitespace is ignored.  One shard, one node is valid (a remote
    single-node index with no failover)."""

    shards: tuple[tuple[tuple[str, int], ...], ...]

    @classmethod
    def parse(cls, spec: str) -> "FleetSpec":
        shards = []
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            nodes = []
            for ep in part.split("|"):
                ep = ep.strip()
                if not ep:
                    continue
                host, _, port = ep.rpartition(":")
                if not host or not port.isdigit():
                    raise ValueError(
                        f"bad fleet endpoint {ep!r} in {spec!r} "
                        "(want host:port|host:port;host:port|...)"
                    )
                nodes.append((host, int(port)))
            if nodes:
                shards.append(tuple(nodes))
        if not shards:
            raise ValueError(f"fleet spec {spec!r} names no shards")
        return cls(shards=tuple(shards))

    @property
    def num_shards(self) -> int:
        return len(self.shards)


_RING_CACHE: dict[tuple[int, int], tuple[np.ndarray, np.ndarray]] = {}


def _ring(num_shards: int, vnodes: int) -> tuple[np.ndarray, np.ndarray]:
    """Sorted ring points + owning shard per point.  Pure function of
    ``(num_shards, vnodes)`` — every client of a fleet, in every process,
    on every run, maps a key to the same shard."""
    got = _RING_CACHE.get((num_shards, vnodes))
    if got is not None:
        return got
    pts, owner = [], []
    for s in range(num_shards):
        for v in range(vnodes):
            h = hashlib.blake2b(
                f"astpu-fleet|{s}|{v}".encode(), digest_size=8
            ).digest()
            pts.append(int.from_bytes(h, "little"))
            owner.append(s)
    pts = np.asarray(pts, np.uint64)
    owner = np.asarray(owner, np.int32)
    order = np.argsort(pts)
    out = (pts[order], owner[order])
    _RING_CACHE[(num_shards, vnodes)] = out
    return out


#: splitmix64 finalizer mapping band keys to ring positions — ONE
#: definition, shared with the repair/reshard planes (``repair.mix64``),
#: so a migration range computed there selects exactly the keys this
#: router sends to the same arc
_mix64 = mix64


def ring_assign(
    keys: np.ndarray, num_shards: int, vnodes: int = 64
) -> np.ndarray:
    """``int32[n]`` owning shard per uint64 key (consistent-hash ring:
    first ring point clockwise of the mixed key, wrapping)."""
    if num_shards == 1:
        return np.zeros(keys.shape, np.int32)
    pts, owner = _ring(num_shards, vnodes)
    ix = np.searchsorted(pts, _mix64(np.asarray(keys, np.uint64)))
    return owner[ix % len(pts)]


# -- per-shard state ---------------------------------------------------------

@dataclass
class _Node:
    address: tuple[str, int]
    client: RpcClient
    alive: bool = True


@dataclass
class _Shard:
    sid: int
    nodes: list[_Node]
    write_target: int = 0          # index into nodes
    promoting: bool = False        # write target lost, candidate unproven
    replaying: bool = False        # a spill replay is on this thread's stack
    last_revive: float = 0.0       # monotonic stamp of the last dead-node ping
    pending: list = field(default_factory=list)  # [(request_id, keys, docs)]
    overlay: dict = field(default_factory=dict)  # key → min doc (spilled)
    gaps: dict = field(default_factory=dict)     # node ix → [(rid, keys, docs)]
    #   writes ACKED by the shard while this node was unreachable — the
    #   backfill a returning node must absorb BEFORE it may rejoin (else a
    #   later promotion could elect a replica missing acked postings)
    gap_overflow: set = field(default_factory=set)  # node ix: gap ledger
    #   dropped past the cap — the node may only return through a FULL
    #   digest-verified resync (_resync_node), never the plain drain path
    resyncing: set = field(default_factory=set)  # node ix: a resync is in
    #   flight — a second caller must not re-arm (and thereby wipe) the
    #   first's gap ledger
    journal: WriteAheadLog | None = None
    lock: threading.RLock = field(default_factory=threading.RLock)

    def live_nodes(self) -> list[_Node]:
        return [n for n in self.nodes if n.alive]


class ShardedIndexClient:
    """Fleet-backed drop-in for :class:`~.store.PersistentIndex`."""

    _seq_lock = threading.Lock()
    _seq = 0

    def __init__(
        self,
        spec: FleetSpec | str,
        *,
        space: str = "bands",
        spill_dir: str | None = None,
        timeout: float = 5.0,
        retries: int = 2,
        health_checks: int = 2,
        health_timeout: float = 0.5,
        vnodes: int = 64,
        connect=None,
        seed: int = 0,
        fs=None,
        overload_backoff_cap: float = 2.0,
        overload_budget: float = 45.0,
        sleep=time.sleep,
        gap_limit_postings: int | None = None,
        repair_interval: float | None = None,
        resync_rounds: int = 4,
        digest_bits: int | None = None,
    ):
        """``spill_dir`` holds one journal per shard (``shardN-<space>
        .spill``); ``None`` disables the durable journal (spills are then
        memory-only — fine for tests, wrong for production).  ``connect``
        is the chaos seam: a dialer wrapped under every node connection.
        """
        self.spec = spec if isinstance(spec, FleetSpec) else FleetSpec.parse(spec)
        self.space = space
        self.spill_dir = spill_dir
        self.timeout = timeout
        self.health_checks = health_checks
        self.health_timeout = health_timeout
        self.vnodes = vnodes
        #: overload discipline: an RpcOverloaded answer (or a deadline
        #: miss while the node still answers pings) backs off IN PLACE —
        #: capped per wait, bounded per call by ``overload_budget``
        #: seconds — and never counts toward failover/promotion
        self.overload_backoff_cap = float(overload_backoff_cap)
        self.overload_budget = float(overload_budget)
        self._sleep = sleep
        #: per-node gap-ledger cap (instance-scoped so tests can shrink
        #: it; defaults to the class constant)
        self.gap_limit_postings = int(
            self.GAP_LIMIT_POSTINGS
            if gap_limit_postings is None else gap_limit_postings
        )
        #: anti-entropy knobs: digest resolution, resync convergence
        #: rounds, and the background repair cadence (seconds; 0 = off,
        #: env ASTPU_FLEET_REPAIR_INTERVAL is the deployment default)
        from advanced_scrapper_tpu_torch.index.repair import DEFAULT_BITS

        self.digest_bits = int(DEFAULT_BITS if digest_bits is None else digest_bits)
        self.resync_rounds = int(resync_rounds)
        if repair_interval is None:
            repair_interval = float(
                os.environ.get("ASTPU_FLEET_REPAIR_INTERVAL", "0") or 0
            )
        self.repair_interval = float(repair_interval)
        self._repair_stop = threading.Event()
        self._repair_thread: threading.Thread | None = None
        from advanced_scrapper_tpu_torch.storage.fsio import default_fs

        self._fs = fs or default_fs()
        # request-id namespace unique ACROSS client processes: a server
        # that outlived a previous client must never replay that client's
        # cached response for this one's fresh request
        self._token = os.urandom(4).hex()
        self._floor = 0           # local doc-id high water (allocator cache)
        self._floor_known = False  # True once a durable floor was synced
        #   from the allocator shard — the gate on degraded local
        #   allocation (see allocate_doc_ids)
        self._postings_written = 0  # client-side view for cheap gauges
        self._floor_lock = threading.Lock()
        self._closed = False
        # node-client construction knobs, kept so a scale-out reshard can
        # grow the topology with clients built exactly like __init__'s
        self._retries = int(retries)
        self._connect = connect
        self._seed = int(seed)
        self._shards: list[_Shard] = []
        for sid, nodes in enumerate(self.spec.shards):
            self._shards.append(
                _Shard(
                    sid=sid,
                    nodes=[
                        _Node(
                            address=addr,
                            client=RpcClient(
                                addr,
                                timeout=timeout,
                                retries=retries,
                                connect=connect,
                                seed=seed * 1000 + sid * 10 + k,
                                # the fleet owns the backoff budget: the
                                # client's INTERNAL retry-after honoring
                                # must sleep in fleet-cap units, or one
                                # call() could overshoot _node_call's
                                # deadline by retries × its own 5 s cap
                                overload_wait_cap=self.overload_backoff_cap,
                            ),
                        )
                        for k, addr in enumerate(nodes)
                    ],
                )
            )
        # per-shard RPC fan-out rides the runtime's Edge-fed pool: remote
        # hops get the same queue telemetry/snapshot as local stages
        self._pool = FanoutPool(
            min(16, 2 * len(self._shards)), name=f"fleet-{space}"
        )
        # -- elastic reshard state (reshard_to) -----------------------------
        self._reshard: dict | None = None      # live cutover: table/ledger/…
        self._reshard_lock = threading.RLock()  # single-flight reshard driver
        self._route_shards = len(self._shards)  # ring size OUTSIDE a reshard
        #: arcs each shard handed off / re-acquired — re-asserted on nodes
        #: that were unreachable when the cutover told them (rejoin sync)
        self._retired: dict[int, list[tuple[int, int]]] = {}
        self._unretired: dict[int, list[tuple[int, int]]] = {}
        self._reshard_dirty: set[int] = set()  # shards owed a control resync
        #: the flip gate: writes intersecting the arc under digest-verify
        #: hold at the door (bounded — see _gate_wait) so the src/dst
        #: comparison sees a settled range
        self._gate_cv = threading.Condition()
        self._gate: tuple[int, int] | None = None
        self._inflight = 0
        self._instrument()
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)
            self._reload_spill()
            for sh in self._shards:
                if sh.pending:  # best-effort recovery replay at open
                    self._ensure_write_target(sh)
            self._resume_reshard()
        if self.repair_interval > 0:
            self.start_repair(self.repair_interval)

    # -- telemetry ---------------------------------------------------------

    def _instrument(self) -> None:
        from advanced_scrapper_tpu_torch.obs import telemetry

        with ShardedIndexClient._seq_lock:
            fid = f"{ShardedIndexClient._seq}:{self.space}"
            ShardedIndexClient._seq += 1
        self._fid = fid
        self._m_rpc_s = {}
        for sid in range(len(self._shards)):
            for method in ("probe", "insert"):
                self._m_rpc_s[(sid, method)] = telemetry.histogram(
                    "astpu_fleet_rpc_seconds",
                    "per-shard RPC wall clock, by method",
                    fleet=fid, shard=str(sid), method=method,
                )
        mk = lambda name, help: telemetry.counter(name, help, fleet=fid)  # noqa: E731
        self._m_failovers = mk(
            "astpu_fleet_failovers_total",
            "node deadline/connection failures that re-routed traffic",
        )
        self._m_promotions = mk(
            "astpu_fleet_promotions_total",
            "replicas promoted to write target after health checks",
        )
        self._m_spilled = mk(
            "astpu_fleet_spilled_postings_total",
            "postings journaled locally because no shard node could ack",
        )
        self._m_replayed = mk(
            "astpu_fleet_replayed_postings_total",
            "spilled postings successfully replayed into a recovered shard",
        )
        self._m_degraded = mk(
            "astpu_fleet_degraded_probes_total",
            "probe sub-queries answered without any live shard node "
            "(overlay-only: historical postings on that shard were invisible)",
        )
        self._m_rejoins = mk(
            "astpu_fleet_rejoins_total",
            "dead nodes that absorbed their gap ledger and came back",
        )
        self._m_backfilled = mk(
            "astpu_fleet_backfilled_postings_total",
            "acked-elsewhere postings delivered to returning nodes before "
            "their rejoin",
        )
        # always-on like the overload pair: resync/repair are exactly what
        # an operator audits after an incident, telemetry gate or not
        self._m_resyncs = telemetry.REGISTRY.counter(
            "astpu_fleet_resync_total",
            "gap-overflowed nodes restored by digest-verified full resync "
            "(the auto path behind astpu_fleet_gap_overflow_total)",
            always=True, fleet=fid,
        )
        self._m_resync_postings = telemetry.REGISTRY.counter(
            "astpu_fleet_resync_postings_total",
            "semantic postings streamed into returning nodes during resync",
            always=True, fleet=fid,
        )
        self._m_repair_rounds = telemetry.REGISTRY.counter(
            "astpu_repair_rounds_total",
            "anti-entropy repair passes over the fleet",
            always=True, fleet=fid,
        )
        self._m_repair_ranges = telemetry.REGISTRY.counter(
            "astpu_repair_ranges_total",
            "divergent digest buckets streamed during repair",
            always=True, fleet=fid,
        )
        self._m_repair_postings = telemetry.REGISTRY.counter(
            "astpu_repair_postings_total",
            "postings pushed between replicas to heal divergence",
            always=True, fleet=fid,
        )
        # always-on (not gated by ASTPU_TELEMETRY): the overload-vs-dead
        # distinction is exactly what an operator audits in an incident
        self._m_overload = telemetry.REGISTRY.counter(
            "astpu_fleet_overload_backoff_total",
            "node calls answered RpcOverloaded and backed off in place "
            "(never a failover)",
            always=True, fleet=fid,
        )
        self._m_slow = telemetry.REGISTRY.counter(
            "astpu_fleet_slow_node_backoff_total",
            "calls that missed their deadline while the node still "
            "answered pings — treated as overload, not death",
            always=True, fleet=fid,
        )
        telemetry.gauge_fn(
            "astpu_fleet_gap_postings",
            lambda s: sum(
                int(k.size)
                for sh in s._shards
                for gap in sh.gaps.values()
                for (_r, k, _d) in gap
            ),
            owner=self, fleet=fid,
            help="acked postings awaiting backfill into unreachable nodes",
        )
        telemetry.gauge_fn(
            "astpu_fleet_shards_healthy",
            lambda s: sum(
                1 for sh in s._shards if sh.live_nodes() and not sh.promoting
            ),
            owner=self, fleet=fid,
            help="shards with a proven write target",
        )
        telemetry.gauge_fn(
            "astpu_fleet_spill_pending_postings",
            lambda s: sum(
                int(k.size) for sh in s._shards for (_r, k, _d) in sh.pending
            ),
            owner=self, fleet=fid,
            help="spilled postings awaiting replay",
        )

    def fleet_status(self) -> dict:
        """JSON-able fleet view for ``/status`` dashboards."""
        shards = []
        for sh in self._shards:
            with sh.lock:
                shards.append(
                    {
                        "shard": sh.sid,
                        "nodes": [
                            {
                                "address": f"{n.address[0]}:{n.address[1]}",
                                "alive": n.alive,
                                "write_target": i == sh.write_target,
                            }
                            for i, n in enumerate(sh.nodes)
                        ],
                        "promoting": sh.promoting,
                        "spill_pending": sum(int(k.size) for _r, k, _d in sh.pending),
                        "awaiting_resync": sorted(sh.gap_overflow),
                    }
                )
        out = {"space": self.space, "shards": shards}
        rs = self._reshard
        if rs is not None:
            out["reshard"] = {
                "old_shards": rs["old_n"],
                "new_shards": rs["new_n"],
                "ranges": rs["table"].counts(),
            }
        return out

    # -- spill journal -----------------------------------------------------

    def _journal_path(self, sh: _Shard) -> str:
        return os.path.join(
            self.spill_dir, f"shard{sh.sid}-{self.space}.spill"
        )

    #: replay/reload chunk size — 256k postings ≈ 4 MiB per insert frame,
    #: far under the RPC frame cap (one giant reloaded journal must never
    #: build a frame the server is REQUIRED to refuse)
    REPLAY_CHUNK_POSTINGS = 1 << 18

    def _reload_spill(self) -> None:
        """Client restart: re-arm pending replay from the on-disk journals
        (the 'replayed on recovery' half of the degraded-mode contract),
        chunked so no single replay frame can exceed the RPC cap.

        A torn tail (client SIGKILLed mid spill append) is truncated away
        BEFORE any reopen — the WAL reopen contract (``replay_wal``):
        appending in ``ab`` mode behind torn garbage would make every
        later spilled posting unreplayable forever."""
        for sh in self._shards:
            path = self._journal_path(sh)
            keys, docs, end = replay_wal(path, fs=self._fs)
            if self._fs.exists(path) and self._fs.size(path) > end:
                try:
                    with self._fs.open(path, "r+b") as fh:
                        fh.truncate(end)
                except OSError:
                    pass
            if keys.size:
                for ci, lo in enumerate(
                    range(0, keys.size, self.REPLAY_CHUNK_POSTINGS)
                ):
                    hi = lo + self.REPLAY_CHUNK_POSTINGS
                    rid = (
                        f"spill-{self._token}-{self._fid}-s{sh.sid}"
                        f"-reload{ci}"
                    )
                    sh.pending.append((rid, keys[lo:hi], docs[lo:hi]))
                for k, d in zip(keys.tolist(), docs.tolist()):
                    prev = sh.overlay.get(k)
                    if prev is None or d < prev:
                        sh.overlay[k] = d
                sh.journal = WriteAheadLog(path, fs=self._fs)

    def _spill(self, sh: _Shard, keys: np.ndarray, docs: np.ndarray, rid: str):
        """No node could ack: journal + overlay, never raise."""
        with sh.lock:
            if self.spill_dir is not None:
                try:
                    if sh.journal is None:
                        sh.journal = WriteAheadLog(
                            self._journal_path(sh), fs=self._fs
                        )
                    sh.journal.append(keys, docs)
                    sh.journal.sync()
                except OSError:
                    pass  # overlay still covers this process's lifetime
            sh.pending.append((rid, keys, docs))
            for k, d in zip(keys.tolist(), docs.tolist()):
                prev = sh.overlay.get(k)
                if prev is None or d < prev:
                    sh.overlay[k] = d
        self._m_spilled.inc(int(keys.size))
        from advanced_scrapper_tpu_torch.obs import trace

        trace.record(
            "event", "fleet.spill", shard=sh.sid, postings=int(keys.size)
        )

    def _drop_journal(self, sh: _Shard) -> None:
        if sh.journal is not None:
            sh.journal.close()
            sh.journal = None
        if self.spill_dir is not None:
            try:
                self._fs.remove(self._journal_path(sh))
            except OSError:
                pass

    # -- node health / promotion ------------------------------------------

    def _note_failure(self, sh: _Shard, node: _Node) -> None:
        with sh.lock:
            if not node.alive:
                return
            node.alive = False
            if sh.nodes[sh.write_target] is node:
                sh.promoting = True
        self._m_failovers.inc()
        from advanced_scrapper_tpu_torch.obs import trace

        trace.record(
            "event", "fleet.failover", shard=sh.sid,
            node=f"{node.address[0]}:{node.address[1]}",
        )

    def _try_revive(self, sh: _Shard, *, allow_resync: bool = False) -> None:
        """Ping dead nodes (cheap timeout, rate-limited so a dark shard
        costs one ping round per interval, not per operation); a
        responder must first absorb its gap ledger — every write the
        shard ACKED while it was away — and only then rejoins, as a
        replica, NOT as write target.  That invariant is what makes any
        live node a safe promotion candidate: live ⇒ not missing any
        acked posting.

        ``allow_resync`` gates the expensive leg: gap-OVERFLOWED nodes
        (dropped ledger) can only return through a full digest-verified
        resync, which streams state and must never run inline from the
        probe/insert hot path — only ``checkpoint()``, ``repair_once()``
        and the background repair loop pass True."""
        now = time.monotonic()
        with sh.lock:
            if now - sh.last_revive < self.health_timeout and not allow_resync:
                return
            sh.last_revive = now
        for ix, node in enumerate(sh.nodes):
            if node.alive or (ix in sh.gap_overflow and not allow_resync):
                continue
            if not node.client.ping(timeout=self.health_timeout):
                continue
            if ix in sh.gap_overflow and not self._resync_node(sh, ix, node):
                continue  # still diverged; the next repair round retries
            with sh.lock:
                gap = list(sh.gaps.get(ix, ()))
            backfilled = 0
            n_done = 0
            for rid, keys, docs in gap:
                try:
                    # ONE call-timeout of backoff, not the 45 s default:
                    # _try_revive runs inline from the probe/insert hot
                    # path — a returning-but-overloaded node must cost a
                    # bounded beat, with the next revive round (not this
                    # caller) finishing the backfill
                    self._node_call(
                        sh, node, "insert", {"space": self.space},
                        [keys, docs],
                        request_id=f"{rid}@{node.address[0]}:{node.address[1]}",
                        budget=self.timeout,
                    )
                    n_done += 1
                    backfilled += int(keys.size)
                except (RpcUnavailable, RpcOverloaded):
                    break  # node stays out this round
            with sh.lock:
                # appends-only discipline (like _replay): drop exactly the
                # prefix we delivered; anything appended meanwhile — or
                # left by a mid-drain failure — keeps the node out until
                # the next revive round finishes the job.  Re-check the
                # overflow set AT COMMIT: a ledger that overflowed while
                # we drained was dropped with writes we never delivered —
                # that node must stay out, not rejoin half-backfilled.
                if ix in sh.gap_overflow:
                    continue
                remaining = sh.gaps.get(ix, [])[n_done:]
                if remaining:
                    sh.gaps[ix] = remaining
                else:
                    sh.gaps.pop(ix, None)
                    node.alive = True
            if backfilled:
                self._m_backfilled.inc(backfilled)
            if node.alive:
                self._m_rejoins.inc()
                # a rejoiner may have missed reshard control calls
                # (retire/unretire/fence) while dark — re-assert them
                if (
                    self._retired.get(sh.sid)
                    or self._unretired.get(sh.sid)
                    or sh.sid in self._reshard_dirty
                ):
                    self._sync_reshard_node(sh, node)

    def _ensure_write_target(self, sh: _Shard) -> _Node | None:
        """Advance the shard state machine; returns the proven write
        target or ``None`` (shard fully down → caller spills).

        Promotion is the health-checked path: a candidate replica must
        answer ``health_checks`` consecutive pings before any write
        lands on it, then the spill journal replays into it FIRST — so
        the moment a promoted node serves reads it already holds every
        posting this client ever acked or spilled for the shard."""
        with sh.lock:
            target = sh.nodes[sh.write_target]
            healthy = target.alive and not sh.promoting
        if healthy:
            if sh.pending:
                self._replay(sh)
            return target if target.alive else None
        # write target is down: look for a promotion candidate
        self._try_revive(sh)
        live = sh.live_nodes()
        if not live:
            return None
        candidate = live[0]
        for _ in range(self.health_checks):
            if not candidate.client.ping(timeout=self.health_timeout):
                self._note_failure(sh, candidate)
                return None
        promoted = False
        with sh.lock:
            # a racing thread may have promoted meanwhile — commit once
            target = sh.nodes[sh.write_target]
            if (target.alive and not sh.promoting) or not candidate.alive:
                candidate = target if target.alive else candidate
            else:
                sh.write_target = sh.nodes.index(candidate)
                sh.promoting = False
                promoted = True
        if promoted:
            self._m_promotions.inc()
            from advanced_scrapper_tpu_torch.obs import trace

            trace.record(
                "event", "fleet.promotion", shard=sh.sid,
                node=f"{candidate.address[0]}:{candidate.address[1]}",
            )
        if sh.pending:
            self._replay(sh)
        return candidate if candidate.alive else None

    def _replay(self, sh: _Shard) -> None:
        """Push the spill journal into the (recovered/promoted) shard
        under the ORIGINAL request ids.

        Runs WITHOUT ``sh.lock`` held across the RPCs — a replay of a few
        batches at the full call timeout must not stall every probe and
        status read on the shard.  The ``replaying`` flag makes this a
        single-flight section (and stops ``_ensure_write_target`` from
        re-entering it from inside the replay's own inserts); the commit
        merges in any batches ``_spill`` appended while we were out."""
        with sh.lock:
            if sh.replaying or not sh.pending:
                return
            sh.replaying = True
            batch = list(sh.pending)
        done = 0
        try:
            still: list = []
            for rid, keys, docs in batch:
                if self._replicated_insert(sh, keys, docs, rid, allow_spill=False):
                    done += int(keys.size)
                else:
                    still.append((rid, keys, docs))
            with sh.lock:
                # appends-only discipline: _spill appends, only THIS
                # single-flight section removes — the snapshot's suffix
                # is exactly what arrived while we replayed
                sh.pending = still + sh.pending[len(batch):]
                if not sh.pending:
                    sh.overlay.clear()
                    self._drop_journal(sh)
        finally:
            with sh.lock:
                sh.replaying = False
        if done:
            self._m_replayed.inc(done)
            from advanced_scrapper_tpu_torch.obs import trace

            trace.record("event", "fleet.replay", shard=sh.sid, postings=done)

    # -- anti-entropy: digests, repair, resync ----------------------------

    def _node_digest(self, sh: _Shard, node: _Node):
        _h, (dig, cnt) = self._node_call(
            sh, node, "digest",
            {"space": self.space, "bits": self.digest_bits},
            budget=self.timeout,
        )
        return np.asarray(dig, np.uint64), np.asarray(cnt, np.uint64)

    def _fetch_semantic_range(self, sh: _Shard, node: _Node, lo: int, hi: int):
        """Paged ``fetch_range`` under the frame cap — the shared
        pagination loop, over this client's failure-accounted call."""
        from advanced_scrapper_tpu_torch.index.remote import paged_fetch_range

        return paged_fetch_range(
            lambda header: self._node_call(
                sh, node, "fetch_range",
                {"space": self.space, **header},
                budget=self.timeout,
            ),
            lo, hi, page=self.REPLAY_CHUNK_POSTINGS,
        )

    def _push_pairs(self, sh: _Shard, dst: _Node, keys, docs) -> None:
        rid = (
            f"repair-{self._token}-{self._fid}-s{sh.sid}"
            f"-{self._next_wid()}"
        )
        self._node_call(
            sh, dst, "insert", {"space": self.space}, [keys, docs],
            request_id=f"{rid}@{dst.address[0]}:{dst.address[1]}",
            budget=self.timeout,
        )

    def _heal_pair(
        self, sh: _Shard, a: _Node, b: _Node
    ) -> tuple[int, bool, bool]:
        """One SYMMETRIC anti-entropy pass between two replicas: diff
        bucket digests, stream only the divergent key ranges, and push
        each side the pairs the other is missing (or holds with a LATER
        doc — min-doc semantics).  Postings are inserts, never deletes,
        so a pair present on EITHER side is legitimate acked data and
        propagates both ways — without this, a replica holding a pair no
        peer has (an applied insert whose ack was lost) could never
        digest-match and a resync would spin forever.

        Returns ``(postings_pushed, a_matched, b_matched)``.  Each match
        compares that side's FINAL digest against the expected UNION of
        the two START states (computed locally per divergent bucket, so
        it is immune to writes the pass races): a True for side X proves
        X now covers everything EITHER side held when the pass looked —
        the resync-gate property for a returning node, whose concurrent
        writes sit in the armed gap ledger, not in this check.  A side
        taking live writes mid-pass legitimately reports False and the
        next pass picks up the remainder."""
        dig_a, cnt_a = self._node_digest(sh, a)
        dig_b, cnt_b = self._node_digest(sh, b)
        diff = np.flatnonzero((dig_a != dig_b) | (cnt_a != cnt_b))
        if diff.size == 0:
            return 0, True, True
        from advanced_scrapper_tpu_torch.index.repair import (
            bucket_digests,
            bucket_range,
        )

        # expected end state per bucket: non-divergent buckets already
        # agree (dig_a rows are the shared truth); divergent ones get the
        # locally-computed union digest below
        expect_dig, expect_cnt = dig_a.copy(), cnt_a.copy()
        pushed = 0
        for bucket in diff.tolist():
            lo, hi = bucket_range(bucket, self.digest_bits)
            ka, da = self._fetch_semantic_range(sh, a, lo, hi)
            kb, db = self._fetch_semantic_range(sh, b, lo, hi)
            have_a = dict(zip(ka.tolist(), da.tolist()))
            have_b = dict(zip(kb.tolist(), db.tolist()))
            self._m_repair_ranges.inc()
            merged = dict(have_b)
            for k, d in have_a.items():
                if merged.get(k, _I64_MAX) > d:
                    merged[k] = d
            for dst, src_k, src_d, have in (
                (b, ka, da, have_b),
                (a, kb, db, have_a),
            ):
                need = [
                    j
                    for j, (k, d) in enumerate(
                        zip(src_k.tolist(), src_d.tolist())
                    )
                    if have.get(k, _I64_MAX) > d
                ]
                if need:
                    self._push_pairs(sh, dst, src_k[need], src_d[need])
                    pushed += len(need)
            uk = np.fromiter(merged.keys(), np.uint64, len(merged))
            ud = np.fromiter(merged.values(), np.uint64, len(merged))
            u_dig, u_cnt = bucket_digests(uk, ud, self.digest_bits)
            expect_dig[bucket] = u_dig[bucket]
            expect_cnt[bucket] = u_cnt[bucket]
        self._m_repair_postings.inc(pushed)
        dig_a2, cnt_a2 = self._node_digest(sh, a)
        dig_b2, cnt_b2 = self._node_digest(sh, b)
        a_matched = bool(
            (dig_a2 == expect_dig).all() and (cnt_a2 == expect_cnt).all()
        )
        b_matched = bool(
            (dig_b2 == expect_dig).all() and (cnt_b2 == expect_cnt).all()
        )
        return pushed, a_matched, b_matched

    RESYNC_ROUNDS = 4  # class default; instance knob is resync_rounds

    def _resync_node(self, sh: _Shard, ix: int, node: _Node) -> bool:
        """Full resync of a gap-OVERFLOWED node — the headline healing
        path: its dropped ledger means an unknown set of acked writes is
        missing, so the plain drain can never certify it.  Instead:

        1. arm a FRESH gap ledger (writes acked from this instant on are
           preserved again) — the overflow mark STAYS SET the whole time,
           so a racing plain ``_try_revive`` keeps refusing the node (a
           cleared mark mid-stream would let it rejoin uncertified);
        2. stream the full divergence against a healthy live peer — which
           by the live-node invariant holds every acked posting — via the
           bucket-digest diff, repeating up to ``resync_rounds`` times;
        3. only when the node's digest MATCHES the peer's (and the armed
           ledger survived — an overflowed ledger means unpreserved
           writes) does the mark clear and the node proceed to the
           normal ledger-drain + rejoin gate in ``_try_revive``.

        Digest-matched means the node covers everything acked up to the
        match instant; the armed ledger covers everything after.  On ANY
        failure — no live peer, RPC fault, churn outran the rounds, or an
        unexpected exception (the ``finally`` voids the attempt before it
        propagates) — the mark is still set and the next repair round
        starts over: the node stays out, but never forever."""
        source = None
        with sh.lock:
            for cand in sh.nodes:
                if cand.alive and cand is not node:
                    source = cand
                    break
        if source is None:
            # no healthy peer holds the acked history right now; resync
            # would certify against nothing.  Keep the node out — a peer
            # that rejoins (it holds every acked posting) unblocks this.
            return False
        with sh.lock:
            if ix in sh.resyncing:
                # another thread (checkpoint vs the background repair
                # loop) is mid-resync: re-arming here would WIPE its
                # armed ledger and certify a node missing those writes
                return False
            sh.resyncing.add(ix)
            sh.gaps[ix] = []  # armed: concurrent acked writes land here
        from advanced_scrapper_tpu_torch.obs import trace

        pushed_total = 0
        ok = False
        try:
            for _ in range(max(1, self.resync_rounds)):
                # the gate is the NODE's side only: the live source keeps
                # taking writes mid-pass and legitimately trails the
                # union; the returning node receives nothing but our
                # pushes, so its match is churn-immune
                pushed, _src_ok, matched = self._heal_pair(sh, source, node)
                pushed_total += pushed
                self._m_resync_postings.inc(pushed)
                if matched:
                    with sh.lock:
                        # the armed ledger must have SURVIVED: if it
                        # overflowed mid-resync, writes went unpreserved
                        # and the match certifies a stale state
                        if sh.gaps.get(ix) is not None:
                            sh.gap_overflow.discard(ix)
                            ok = True
                    break
        except (RpcUnavailable, RpcOverloaded):
            pass
        finally:
            with sh.lock:
                sh.resyncing.discard(ix)
                if not ok:
                    # void the attempt: keep the node out (mark stays /
                    # returns set, armed ledger dropped — the next full
                    # push covers it) even when an unexpected exception
                    # is propagating
                    sh.gap_overflow.add(ix)
                    sh.gaps.pop(ix, None)
        if ok:
            self._m_resyncs.inc()
            trace.record(
                "event", "fleet.resync", shard=sh.sid,
                node=f"{node.address[0]}:{node.address[1]}",
                postings=pushed_total,
            )
        return ok

    def repair_once(self) -> dict:
        """One anti-entropy pass over every shard: revive/resync
        returning nodes, then one symmetric heal per live replica pair
        (bucket-digest diff → divergent ranges only, pushed both ways).
        Safe under concurrent inserts — pushes are semantically
        idempotent and the min-doc merge is monotone; a pass that raced
        a write simply leaves the remainder to the next pass.  Returns a
        stats dict."""
        stats = {"shards": 0, "pushed": 0, "pairs": 0, "unmatched": 0}
        self._m_repair_rounds.inc()
        for sh in self._shards:
            self._try_revive(sh, allow_resync=True)
            if sh.sid in self._reshard_dirty:
                # shards owed reshard control calls (retire/unretire/
                # fence marks that failed in line) heal at repair cadence
                self._reshard_dirty.discard(sh.sid)
                for node in sh.live_nodes():
                    self._sync_reshard_node(sh, node)
            live = sh.live_nodes()
            stats["shards"] += 1
            if len(live) < 2:
                continue
            ref = live[0]
            for other in live[1:]:
                try:
                    pushed, m_ref, m_other = self._heal_pair(sh, ref, other)
                except (RpcUnavailable, RpcOverloaded):
                    stats["unmatched"] += 1
                    continue
                stats["pushed"] += pushed
                stats["pairs"] += 1
                if not (m_ref and m_other):
                    stats["unmatched"] += 1
        return stats

    def start_repair(self, interval: float) -> None:
        """Arm the background repair loop (idempotent): every
        ``interval`` seconds one ``repair_once`` pass runs on a daemon
        thread.  ``ASTPU_FLEET_REPAIR_INTERVAL`` (seconds, 0=off) arms it
        at construction; ``interval <= 0`` means OFF here too (never a
        busy loop — ``Event.wait(0)`` returns immediately)."""
        if interval <= 0:
            return
        if self._repair_thread is not None and self._repair_thread.is_alive():
            return
        self.repair_interval = float(interval)
        self._repair_stop.clear()

        def loop():
            while not self._repair_stop.wait(self.repair_interval):
                try:
                    self.repair_once()
                except Exception:
                    # the repair plane must never take the client down;
                    # the next pass retries (faults already counted by
                    # the per-call paths)
                    from advanced_scrapper_tpu_torch.obs import trace

                    trace.record("event", "fleet.repair_error")

        self._repair_thread = threading.Thread(
            target=loop, daemon=True, name=f"astpu-fleet-repair-{self.space}"
        )
        self._repair_thread.start()

    def stop_repair(self) -> None:
        self._repair_stop.set()
        t = self._repair_thread
        if t is not None:
            t.join(timeout=5)
            self._repair_thread = None

    # -- elastic reshard: live N→M cutover --------------------------------

    #: upper bound a write intersecting the arc-under-flip waits at the
    #: gate.  Proceeding past it is SAFE (a late dual-write applies to
    #: both owners; any transient divergence fails the digest check and
    #: retries) — the bound only stops a wedged flip from deadlocking the
    #: write path.
    GATE_WAIT_S = 30.0

    @staticmethod
    def _spec_string(spec: FleetSpec) -> str:
        """Canonical wire form of a topology — the ledger's identity check
        (a resumed reshard must be THE reshard the WAL recorded)."""
        return ";".join(
            "|".join(f"{h}:{p}" for h, p in nodes) for nodes in spec.shards
        )

    def _grow_shards(self, new_spec: FleetSpec) -> None:
        """Extend the live topology with the new spec's extra shards
        (scale-out).  Shard ids present in both specs must keep their
        replica sets — moving a shard's NODES is the repair/restore
        plane's job; a reshard only moves ring arcs between shards."""
        for sid in range(min(len(self._shards), new_spec.num_shards)):
            if new_spec.shards[sid] != self.spec.shards[sid]:
                raise ValueError(
                    f"reshard cannot move shard {sid}'s replica set "
                    f"({self.spec.shards[sid]} → {new_spec.shards[sid]}); "
                    "node replacement is repair/restore, not reshard"
                )
        from advanced_scrapper_tpu_torch.obs import telemetry

        for sid in range(len(self._shards), new_spec.num_shards):
            self._shards.append(
                _Shard(
                    sid=sid,
                    nodes=[
                        _Node(
                            address=addr,
                            client=RpcClient(
                                addr,
                                timeout=self.timeout,
                                retries=self._retries,
                                connect=self._connect,
                                seed=self._seed * 1000 + sid * 10 + k,
                                overload_wait_cap=self.overload_backoff_cap,
                            ),
                        )
                        for k, addr in enumerate(new_spec.shards[sid])
                    ],
                )
            )
            for method in ("probe", "insert"):
                self._m_rpc_s.setdefault(
                    (sid, method),
                    telemetry.histogram(
                        "astpu_fleet_rpc_seconds",
                        "per-shard RPC wall clock, by method",
                        fleet=self._fid, shard=str(sid), method=method,
                    ),
                )

    def _resume_reshard(self) -> None:
        """Client (re)start: adopt an in-flight migration WAL.

        Flipped/retired ranges keep their new owner — the flip write was
        the commit point, sealed strictly after the digest match proved
        the data on the next owner.  Every dual-write window caught open
        is VOIDED back to ``pending``: unsealed progress never counts
        (the armed-ledger discipline the resync path uses).  Routing
        honors the adopted states immediately; the migration itself
        continues when ``reshard_to`` runs again."""
        from advanced_scrapper_tpu_torch.index import reshard as _rs

        path = _rs.ledger_path(self.spill_dir, self.space)
        try:
            ledger = _rs.ReshardLedger.load(path, fs=self._fs)
        except (OSError, ValueError, KeyError):
            return  # unreadable/foreign ledger: surfaced when reshard_to runs
        if ledger is None or ledger.phase != "active":
            return
        if ledger.doc.get("old_spec") != self._spec_string(self.spec):
            return  # a different topology's WAL; not ours to resume
        voided = ledger.void_unflipped()
        new_spec = FleetSpec.parse(ledger.doc["new_spec"])
        self._grow_shards(new_spec)
        table = _rs.RangeTable(ledger.ranges)
        metrics = _rs.reshard_metrics(self._fid)
        if voided:
            metrics["voids"].inc(voided)
        _rs.register_state_gauges(self._fid, table)
        for r in ledger.ranges:
            # every dst is owed an unretire (its arc may be handed-off
            # residue from an earlier topology round trip); sealed arcs
            # re-enter the src's handed-off set
            self._unretired[int(r["dst"])] = interval_add(
                self._unretired.get(int(r["dst"]), []), r["lo"], r["hi"]
            )
            if r["state"] in ("flipped", "retired"):
                self._retired[int(r["src"])] = interval_add(
                    self._retired.get(int(r["src"]), []), r["lo"], r["hi"]
                )
        self._reshard_dirty.update(range(len(self._shards)))
        self._reshard = {
            "table": table,
            "ledger": ledger,
            "old_n": int(ledger.doc["old_n"]),
            "new_n": int(ledger.doc["new_n"]),
            "new_spec": new_spec,
            "metrics": metrics,
            "voided": voided,
        }

    def _route(self, flat: np.ndarray) -> tuple[np.ndarray, np.ndarray | None]:
        """Owning shard per key: the plain ring — unless a reshard is
        live, in which case the range table decides per the cutover
        lifecycle.  Returns ``(primary, dual)``; ``dual`` names each
        key's NEXT owner during its arc's dual-write window (-1 outside
        one, ``None`` when no reshard is running)."""
        rs = self._reshard
        if rs is None:
            return ring_assign(flat, self._route_shards, self.vnodes), None
        from advanced_scrapper_tpu_torch.index.reshard import route_keys

        return route_keys(
            flat, rs["table"], rs["old_n"], rs["new_n"], self.vnodes
        )

    def _gate_wait(self, keys: np.ndarray) -> None:
        """Hold a write that intersects the arc being flipped until the
        cutover releases the gate (bounded by ``GATE_WAIT_S`` — see the
        constant's note on why proceeding late is safe)."""
        if self._gate is None:
            return
        deadline = time.monotonic() + self.GATE_WAIT_S
        with self._gate_cv:
            while self._gate is not None:
                lo, hi = self._gate
                if not range_mask(keys, [(lo, hi)]).any():
                    return
                left = deadline - time.monotonic()
                if left <= 0:
                    return
                self._gate_cv.wait(timeout=min(left, 0.1))

    def _sync_reshard_node(self, sh: _Shard, node: _Node) -> None:
        """Re-assert this client's reshard verdicts on one node — the
        rejoin half of the control plane.  A node that was dark when the
        cutover told it to retire/unretire an arc (or drop its fence
        mark) hears it here; every call is idempotent, every failure
        re-queues via the dirty set."""
        sid = sh.sid
        try:
            for lo, hi in self._retired.get(sid, ()):
                self._node_call(
                    sh, node, "retire_range",
                    {"space": self.space, "lo": lo, "hi": hi},
                    budget=self.timeout,
                )
            for lo, hi in self._unretired.get(sid, ()):
                self._node_call(
                    sh, node, "unretire_range",
                    {"space": self.space, "lo": lo, "hi": hi},
                    budget=self.timeout,
                )
            if self._reshard is None:
                self._node_call(
                    sh, node, "reshard_mark", {"op": "clear"},
                    budget=self.timeout,
                )
            else:
                self._node_call(
                    sh, node, "reshard_mark",
                    {"op": "set", "token": self._token},
                    budget=self.timeout,
                )
        except (RpcUnavailable, RpcOverloaded):
            self._reshard_dirty.add(sid)

    def _broadcast_mark(self, op: str) -> None:
        """Best-effort reshard fence on every live node (``set`` while a
        migration is in flight, ``clear`` at completion) — what
        ``tools/fleet_snapshot.py`` checks before trusting a fence.
        Nodes missed here catch up through the rejoin/dirty sync."""
        for sh in self._shards:
            ok = True
            for node in sh.live_nodes():
                try:
                    header = {"op": op}
                    if op == "set":
                        header["token"] = self._token
                    self._node_call(
                        sh, node, "reshard_mark", header, budget=self.timeout
                    )
                except (RpcUnavailable, RpcOverloaded):
                    ok = False
            if not ok or any(not n.alive for n in sh.nodes):
                self._reshard_dirty.add(sh.sid)

    def reshard_to(self, new_spec: FleetSpec | str) -> dict:
        """Live-migrate the fleet to ``new_spec`` (N→M shards, split or
        merge) while it keeps answering probes and inserts.

        Per migrating arc, in ring order: unretire the arc on its next
        owner → durably arm the dual-write window (every write from that
        instant applies to BOTH owners; reads stay on the old one) →
        stream the old owner's semantic state across, paged under the
        frame cap → under the write gate, require the arc's mixed bucket
        digest to MATCH on the old owner and every live replica of the
        new one → seal the flip in the migration WAL (THE commit point;
        reads+writes move atomically) → retire the arc on the old owner.

        Crash-safe at any instant: rerunning (or reconstructing the
        client) resumes from the WAL — sealed flips keep their new
        owner, open dual-write windows are voided back to pending.
        Raises when a shard the migration needs is fully dark; the WAL
        stays resumable."""
        new = (
            new_spec if isinstance(new_spec, FleetSpec)
            else FleetSpec.parse(new_spec)
        )
        if not self.spill_dir:
            raise RuntimeError(
                "reshard_to needs a spill_dir: the migration WAL (the "
                "crash-safety of the cutover) lives there"
            )
        from advanced_scrapper_tpu_torch.index import reshard as rs

        with self._reshard_lock:
            if (
                self._reshard is None
                and self._spec_string(new) == self._spec_string(self.spec)
            ):
                return {"ranges": 0, "flips": 0, "migrated_postings": 0,
                        "digest_retries": 0, "voided": 0, "already": True}
            st = self._arm_reshard(new, rs)
            ledger = st["ledger"]
            stats = {
                "ranges": len(ledger.ranges),
                "flips": 0,
                "migrated_postings": 0,
                "digest_retries": 0,
                "voided": int(st.get("voided", 0)),
            }
            self._broadcast_mark("set")
            for i, r in enumerate(ledger.ranges):
                if r["state"] == "retired":
                    continue
                lo, hi = int(r["lo"]), int(r["hi"])
                src, dst = int(r["src"]), int(r["dst"])
                if r["state"] != "flipped":
                    self._migrate_range(st, i, lo, hi, src, dst, stats)
                self._retire_range_src(st, i, lo, hi, src, dst, stats)
            self._finish_reshard(st, new)
        return stats

    def _arm_reshard(self, new: FleetSpec, rs) -> dict:
        """Adopt the in-flight reshard state, or create it (plan + fresh
        migration WAL + grown topology + routing table)."""
        if self._reshard is not None:
            got = self._spec_string(self._reshard["new_spec"])
            if got != self._spec_string(new):
                raise RuntimeError(
                    f"a reshard to {got!r} is already in flight; it must "
                    "finish (rerun it) before targeting another topology"
                )
            return self._reshard
        old_n = self._route_shards
        path = rs.ledger_path(self.spill_dir, self.space)
        stale = rs.ReshardLedger.load(path, fs=self._fs)
        if stale is not None and stale.phase == "active":
            # _resume_reshard didn't adopt it ⇒ its old_spec is not ours:
            # overwriting would orphan that migration's verdicts
            raise RuntimeError(
                f"{path}: an unfinished reshard WAL for a different "
                "topology is present; resolve it first"
            )
        plan = rs.plan_reshard(old_n, new.num_shards, self.vnodes)
        ledger = rs.ReshardLedger.create(
            path,
            old_n=old_n,
            new_n=new.num_shards,
            vnodes=self.vnodes,
            old_spec=self._spec_string(self.spec),
            new_spec=self._spec_string(new),
            space=self.space,
            ranges=plan,
            fs=self._fs,
        )
        self._grow_shards(new)
        table = rs.RangeTable(ledger.ranges)
        metrics = rs.reshard_metrics(self._fid)
        rs.register_state_gauges(self._fid, table)
        st = {
            "table": table,
            "ledger": ledger,
            "old_n": old_n,
            "new_n": new.num_shards,
            "new_spec": new,
            "metrics": metrics,
            "voided": 0,
        }
        self._reshard = st
        from advanced_scrapper_tpu_torch.obs import trace

        trace.record(
            "event", "fleet.reshard_start", old=old_n,
            new=new.num_shards, ranges=len(plan),
        )
        return st

    def _migrate_range(self, st, i, lo, hi, src, dst, stats) -> None:
        """One arc, pending → flipped: arm, stream, digest-verify, seal."""
        table, ledger, metrics = st["table"], st["ledger"], st["metrics"]
        src_sh, dst_sh = self._shards[src], self._shards[dst]
        # the next owner may hold this arc as handed-off residue from an
        # earlier topology (N→M→N): un-retire BEFORE any page lands, or
        # its own insert filter would silently drop the stream
        self._unretired[dst] = interval_add(
            self._unretired.get(dst, []), lo, hi
        )
        self._retired[dst] = interval_sub(self._retired.get(dst, []), lo, hi)
        for node in dst_sh.live_nodes():
            try:
                self._node_call(
                    dst_sh, node, "unretire_range",
                    {"space": self.space, "lo": lo, "hi": hi},
                    budget=self.timeout,
                )
            except (RpcUnavailable, RpcOverloaded):
                self._reshard_dirty.add(dst)
        if table.state(i) == "pending":
            # the LEDGER write precedes the first dual-applied write: a
            # crash between the two leaves a recorded window that moved
            # nothing — voided on resume, nothing unaccounted
            ledger.mark(i, "dual_write")
            table.set_state(i, "dual_write")
        for attempt in range(max(1, self.resync_rounds)):
            src_node = self._ensure_write_target(src_sh)
            if src_node is None:
                raise RpcUnavailable(
                    f"reshard: shard {src} is fully dark; the migration "
                    "WAL stays resumable — rerun when it returns"
                )
            self._stream_range(st, src_sh, src_node, dst_sh, lo, hi, stats)
            if self._flip_range(st, i, lo, hi, src_sh, dst_sh, stats):
                return
            metrics["retries"].inc()
            stats["digest_retries"] += 1
        raise RuntimeError(
            f"reshard: range {i} [{lo:#x},{hi:#x}) did not digest-converge "
            f"after {self.resync_rounds} rounds (WAL resumable)"
        )

    def _stream_range(self, st, src_sh, src_node, dst_sh, lo, hi, stats):
        """Page the arc's semantic state src → dst under the frame cap;
        pushes ride ``_replicated_insert`` so every live dst replica (and
        the gap ledgers of dead ones) receives it."""
        metrics = st["metrics"]
        off = 0
        while True:
            t0 = time.perf_counter()
            h, (k, d) = self._node_call(
                src_sh, src_node, "fetch_range",
                {
                    "space": self.space, "lo": lo, "hi": hi,
                    "offset": off, "limit": self.REPLAY_CHUNK_POSTINGS,
                    "mixed": True,
                },
                budget=self.timeout,
            )
            k = np.asarray(k, np.uint64)
            d = np.asarray(d, np.uint64)
            if k.size:
                rid = (
                    f"mig-{self._token}-{self._fid}-{dst_sh.sid}"
                    f"-{self._next_wid()}"
                )
                self._replicated_insert(dst_sh, k, d, rid)
            metrics["pages"].inc()
            metrics["postings"].inc(int(k.size))
            metrics["page_s"].observe(time.perf_counter() - t0)
            metrics["page_b"].observe(float(k.nbytes + d.nbytes))
            stats["migrated_postings"] += int(k.size)
            off += int(k.size)
            if off >= int(h.get("total", off)) or k.size == 0:
                break

    def _range_digest(self, sh, node, lo, hi):
        _h, (dig, cnt) = self._node_call(
            sh, node, "digest",
            {
                "space": self.space, "bits": self.digest_bits,
                "lo": lo, "hi": hi, "mixed": True,
            },
            budget=self.timeout,
        )
        return np.asarray(dig, np.uint64), np.asarray(cnt, np.uint64)

    def _flip_range(self, st, i, lo, hi, src_sh, dst_sh, stats) -> bool:
        """The two-phase commit's decision point, under the write gate:
        flip iff the old owner and EVERY live replica of the new one
        answer identical mixed digests over the arc — and neither side
        holds un-replayed spill for it (a spilled-but-acked write absent
        from both digests would otherwise flip, then replay into a
        retired range and vanish).  False = not yet; caller re-streams."""
        table, ledger, metrics = st["table"], st["ledger"], st["metrics"]
        with self._gate_cv:
            self._gate = (lo, hi)
            deadline = time.monotonic() + 2 * self.timeout
            while self._inflight > 0 and time.monotonic() < deadline:
                self._gate_cv.wait(timeout=0.05)
        try:
            # replay both sides' spill journals first; pending spill on
            # either side makes the digests meaningless for a flip
            src_node = self._ensure_write_target(src_sh)
            self._ensure_write_target(dst_sh)
            if src_node is None or src_sh.pending or dst_sh.pending:
                return False
            live = dst_sh.live_nodes()
            if not live:
                return False
            want = self._range_digest(src_sh, src_node, lo, hi)
            for node in live:
                got = self._range_digest(dst_sh, node, lo, hi)
                if not (
                    np.array_equal(want[0], got[0])
                    and np.array_equal(want[1], got[1])
                ):
                    return False
            # sealed: the ledger write IS the commit point — a crash
            # after it keeps the flip (the data is proven on the new
            # owner), a crash before it voids the window cleanly
            ledger.mark(i, "flipped")
            table.set_state(i, "flipped")
            metrics["flips"].inc()
            stats["flips"] += 1
            return True
        except (RpcUnavailable, RpcOverloaded):
            return False
        finally:
            with self._gate_cv:
                self._gate = None
                self._gate_cv.notify_all()

    def _retire_range_src(self, st, i, lo, hi, src, dst, stats) -> None:
        """Post-flip: the old owner drops the arc (handed-off manifest
        mark — probes/inserts for it now answer empty there) and the
        verdict is sealed.  Re-run-safe: a crash between flip and here
        re-asserts on resume."""
        table, ledger = st["table"], st["ledger"]
        src_sh = self._shards[src]
        self._retired[src] = interval_add(self._retired.get(src, []), lo, hi)
        self._unretired[src] = interval_sub(
            self._unretired.get(src, []), lo, hi
        )
        for node in src_sh.live_nodes():
            try:
                self._node_call(
                    src_sh, node, "retire_range",
                    {"space": self.space, "lo": lo, "hi": hi},
                    budget=self.timeout,
                )
            except (RpcUnavailable, RpcOverloaded):
                self._reshard_dirty.add(src)
        if any(not n.alive for n in src_sh.nodes):
            self._reshard_dirty.add(src)
        ledger.mark(i, "retired")
        table.set_state(i, "retired")

    def _finish_reshard(self, st, new: FleetSpec) -> None:
        """Every range retired: seal the WAL, swap the routing topology,
        drop the fence marks.  Shard objects beyond a scale-in's new
        count stay open (their stores hold only handed-off residue and
        answer empty) — closing live sockets under in-flight fan-outs is
        not worth an empty probe saved."""
        ledger = st["ledger"]
        if not ledger.all_retired():
            raise RuntimeError("reshard finish with unretired ranges")
        ledger.finish()
        self._route_shards = new.num_shards
        self.spec = new
        self._reshard = None
        self._broadcast_mark("clear")
        from advanced_scrapper_tpu_torch.obs import trace

        trace.record(
            "event", "fleet.reshard_done", shards=new.num_shards,
        )

    # -- RPC fan-out internals --------------------------------------------

    def _node_call(
        self,
        sh: _Shard,
        node: _Node,
        method: str,
        header: dict,
        arrays=(),
        *,
        request_id: str | None = None,
        budget: float | None = None,
    ):
        """One node RPC under the overload-vs-dead discipline:

        - :class:`RpcOverloaded` (the node REFUSED admission — provably
          alive) backs off in place, honoring the retry-after hint,
          bounded by ``budget`` (default ``overload_budget``) seconds;
        - :class:`RpcUnavailable` (deadline/connection fault) is only
          allowed to propagate — and so mark the node dead — when the
          node ALSO fails a ping; a node that still answers pings is
          alive-but-slow and gets the same in-place backoff, because
          failing over a healthy shard under load amplifies the storm
          onto the survivors and can cascade the fleet.

        Raises :class:`RpcOverloaded` when the budget runs out with the
        node still alive (the caller decides: another replica, spill, or
        propagate), :class:`RpcUnavailable` only on true unreachability.
        """
        deadline = time.monotonic() + (
            self.overload_budget if budget is None else budget
        )
        wait = 0.05
        while True:
            try:
                return node.client.call(
                    method,
                    header,
                    arrays,
                    timeout=self.timeout,
                    request_id=request_id,
                )
            except RpcOverloaded as e:
                self._m_overload.inc()
                wait = min(
                    max(e.retry_after, wait), self.overload_backoff_cap
                )
            except RpcUnavailable:
                if not node.client.ping(timeout=self.health_timeout):
                    raise  # truly dark: the caller's failover path owns it
                self._m_slow.inc()
                wait = min(wait * 2, self.overload_backoff_cap)
            if time.monotonic() + wait > deadline:
                raise RpcOverloaded(
                    f"{method} to {node.address[0]}:{node.address[1]} still "
                    "overloaded after the in-place backoff budget",
                    retry_after=wait,
                )
            self._sleep(wait)

    def _shard_probe(
        self, sh: _Shard, keys: np.ndarray, tctx=None
    ) -> np.ndarray:
        """Probe one shard's key subset → int64 min doc per key (-1 miss).
        Prefers the write target (it holds everything acked); falls back
        across replicas; a fully-dark shard answers from the overlay only
        and counts the degradation.

        ``tctx`` is the CALLER's trace context, captured before the
        fan-out (pool threads have no ambient context of their own): the
        per-shard span and every RPC under it stitch into the corpus
        trace, and the latency histogram keeps the trace id as its
        slow-call exemplar."""
        from advanced_scrapper_tpu_torch.obs import trace

        with trace.trace_context(*(tctx or (None, None))):
            with trace.span("fleet.probe", shard=sh.sid, keys=int(keys.size)):
                return self._shard_probe_inner(sh, keys, tctx)

    def _shard_probe_inner(self, sh: _Shard, keys: np.ndarray, tctx) -> np.ndarray:
        t0 = time.perf_counter()
        hist = self._m_rpc_s[(sh.sid, "probe")]
        deadline = time.monotonic() + self.overload_budget
        docs = None
        while docs is None:
            order: list[_Node] = []
            with sh.lock:
                wt = sh.nodes[sh.write_target]
            if wt.alive and not sh.promoting:
                order.append(wt)
            order += [n for n in sh.live_nodes() if n not in order]
            saw_overload = False
            # per-node slice of the budget, NOT the whole remainder: an
            # overloaded write target must not absorb the full 45 s
            # before an idle replica gets a chance — one call-timeout of
            # in-place backoff per node per round, then rotate
            node_budget = max(0.5, min(deadline - time.monotonic(), self.timeout))
            for node in order:
                try:
                    _h, (docs,) = self._node_call(
                        sh, node, "probe", {"space": self.space}, [keys],
                        budget=node_budget,
                    )
                    break
                except RpcOverloaded:
                    # alive but refusing/slow: try the next replica, and
                    # NEVER mark the node dead — an overloaded shard
                    # failed over would cascade the storm
                    saw_overload = True
                except RpcUnavailable:
                    # transport fault with pings also failing: a
                    # deterministic handler error (RpcRemoteError — bad
                    # space, operator typo) must stay LOUD, never quietly
                    # mark a healthy node dead
                    self._note_failure(sh, node)
            if docs is None:
                # promotion may still rescue a replica that was merely
                # unproven
                target = self._ensure_write_target(sh)
                if target is not None and target not in order:
                    try:
                        _h, (docs,) = self._node_call(
                            sh, target, "probe", {"space": self.space},
                            [keys], budget=node_budget,
                        )
                    except RpcOverloaded:
                        saw_overload = True
                    except RpcUnavailable:
                        self._note_failure(sh, target)
            if docs is None:
                if saw_overload and time.monotonic() < deadline:
                    self._sleep(0.05)  # every node overloaded: one more round
                    continue
                self._m_degraded.inc(int(keys.size))
                docs = np.full(keys.shape, -1, np.int64)
        docs = np.asarray(docs, np.int64)
        with sh.lock:
            # O(probed keys) lookups under the lock — never a full-dict
            # copy, which would make every degraded probe O(spill size)
            ov = (
                np.fromiter(
                    (sh.overlay.get(k, -1) for k in keys.tolist()),
                    np.int64, keys.size,
                )
                if sh.overlay
                else None
            )
        if ov is not None:
            hit = ov >= 0
            miss = docs < 0
            docs = np.where(
                hit & miss, ov, np.where(hit, np.minimum(docs, ov), docs)
            )
        hist.observe(time.perf_counter() - t0, trace=tctx[0] if tctx else None)
        return docs

    def _replicated_insert(
        self,
        sh: _Shard,
        keys: np.ndarray,
        docs: np.ndarray,
        rid: str,
        *,
        allow_spill: bool = True,
        tctx=None,
    ) -> bool:
        """Write one shard's postings to EVERY live node (same request
        id).  True iff at least one node — including a freshly promoted
        one — durably applied it; on total failure the batch spills
        (unless this IS the replay path).  Nodes that missed an ACKED
        write get the batch recorded in their gap ledger: they must
        absorb it before they may rejoin (``_try_revive``).

        ``tctx`` restores the caller's trace context on the fan-out pool
        thread (None = inherit whatever is ambient, the direct-call and
        replay paths)."""
        from advanced_scrapper_tpu_torch.obs import trace

        if tctx is None:
            tctx = trace.current_context()
        with trace.trace_context(*(tctx or (None, None))):
            with trace.span(
                "fleet.insert", shard=sh.sid, postings=int(keys.size)
            ):
                return self._replicated_insert_inner(
                    sh, keys, docs, rid, allow_spill, tctx
                )

    def _replicated_insert_inner(
        self, sh, keys, docs, rid, allow_spill, tctx
    ) -> bool:
        t0 = time.perf_counter()
        hist = self._m_rpc_s[(sh.sid, "insert")]
        target = self._ensure_write_target(sh)
        acked_ix: set[int] = set()
        # the overload budget is a PER-CALL bound (the _node_call
        # docstring's promise): slice it across the replica fan-out so a
        # 2-replica overloaded shard stalls one insert ~overload_budget
        # total, not 2× (+ another on the promotion retry)
        n_live = max(1, len(sh.live_nodes()))
        node_budget = max(self.timeout, self.overload_budget / (n_live + 1))
        for ix, node in enumerate(list(sh.nodes)):
            if not node.alive:
                continue
            try:
                self._node_call(
                    sh, node, "insert", {"space": self.space}, [keys, docs],
                    request_id=f"{rid}@{node.address[0]}:{node.address[1]}",
                    budget=node_budget,
                )
                acked_ix.add(ix)
            except RpcOverloaded:
                # alive but refusing past the in-place budget: missed
                # this write — the gap-ledger loop below treats any
                # non-acked node identically (the live-node invariant is
                # unconditional) — but NO failover count, no
                # health-check demotion
                pass
            except RpcUnavailable:
                self._note_failure(sh, node)
        if not acked_ix and target is not None:
            # every node died mid-write: one promotion attempt, then spill
            target = self._ensure_write_target(sh)
            if target is not None:
                try:
                    self._node_call(
                        sh, target, "insert", {"space": self.space},
                        [keys, docs],
                        request_id=f"{rid}@{target.address[0]}:{target.address[1]}",
                        budget=node_budget,
                    )
                    acked_ix.add(sh.nodes.index(target))
                except RpcOverloaded:
                    pass  # still alive: falls through to spill below
                except RpcUnavailable:
                    self._note_failure(sh, target)
        hist.observe(time.perf_counter() - t0, trace=tctx[0] if tctx else None)
        acked = bool(acked_ix)
        if acked:
            with sh.lock:
                for ix in range(len(sh.nodes)):
                    if ix not in acked_ix:
                        # an overloaded node that missed an ACKED write
                        # must still absorb it before it may serve again —
                        # the live-node invariant (live ⇒ holding every
                        # acked posting) holds unconditionally, so
                        # _gap_append sidelines it until the backfill
                        # drains.  With the in-place budget this is the
                        # rare tail, not the storm steady state.
                        self._gap_append(sh, ix, rid, keys, docs)
        elif allow_spill:
            # fully refused (all nodes overloaded) or fully dark: the
            # spill journal absorbs the batch and replays later — counted
            # backpressure, never data loss, and for pure overload the
            # nodes stay alive and unpromoted
            self._spill(sh, keys, docs, rid)
        return acked

    #: per-node gap ledger cap — beyond this many missed postings the
    #: ledger is dropped and the node is routed through a FULL
    #: digest-verified resync before it may rejoin (bounded client RAM,
    #: no node ever sits out forever); instance-overridable via the
    #: ``gap_limit_postings`` constructor knob
    GAP_LIMIT_POSTINGS = 1 << 20

    def _gap_append(self, sh: _Shard, ix: int, rid, keys, docs) -> None:
        """Record an acked write a node missed; caller holds ``sh.lock``.

        If a racing ``_try_revive`` brought the node back between our
        fan-out snapshot and this append, the node is live WITHOUT this
        write — re-kill it so the next revive round drains the ledger;
        the live-node invariant must hold unconditionally.

        Overflowed nodes: with no ledger armed the write is dropped — a
        future resync's full-state push covers it by construction.  A
        resync in flight ARMS a fresh ledger (``_resync_node``) so the
        writes it races with are preserved; if even that ledger overflows
        the resync is voided and restarts."""
        gap = sh.gaps.get(ix)
        if ix in sh.gap_overflow and gap is None:
            return  # awaiting resync; the full-state push will carry this
        if sh.nodes[ix].alive:
            sh.nodes[ix].alive = False
            if sh.nodes[sh.write_target] is sh.nodes[ix]:
                sh.promoting = True
        if gap is None:
            gap = sh.gaps.setdefault(ix, [])
        held = sum(int(k.size) for _r, k, _d in gap)
        if held + int(keys.size) > self.gap_limit_postings:
            sh.gaps.pop(ix, None)
            sh.gap_overflow.add(ix)
            from advanced_scrapper_tpu_torch.obs import telemetry

            telemetry.event_counter(
                "astpu_fleet_gap_overflow_total",
                "nodes whose gap ledger outgrew the cap and was dropped; "
                "they rejoin through digest-verified auto-resync "
                "(astpu_fleet_resync_total), never by the plain drain path",
            ).inc()
            return
        gap.append((rid, keys, docs))

    # -- PersistentIndex API ----------------------------------------------

    def probe_batch(self, keys: np.ndarray) -> np.ndarray:
        """``int64[B]`` earliest candidate doc per query row (-1 = none);
        same contract (and same row-min combination) as the single-node
        index, fanned out per shard in parallel."""
        keys = np.asarray(keys, dtype=np.uint64)
        if keys.ndim == 1:
            keys = keys[:, None]
        B = keys.shape[0]
        if B == 0:
            return np.zeros((0,), np.int64)
        flat = keys.ravel()
        shard_of, _dual = self._route(flat)
        best = np.full(flat.shape, _I64_MAX, np.int64)
        from advanced_scrapper_tpu_torch.obs import trace

        tctx = trace.current_context()  # captured HERE: pool threads have none
        futures = []
        for sid in range(len(self._shards)):
            ix = np.flatnonzero(shard_of == sid)
            if ix.size == 0:
                continue
            futures.append(
                (
                    ix,
                    self._pool.submit(
                        self._shard_probe, self._shards[sid], flat[ix], tctx
                    ),
                )
            )
        for ix, fut in futures:
            docs = fut.result()
            hit = docs >= 0
            best[ix[hit]] = np.minimum(best[ix[hit]], docs[hit])
        best = best.reshape(B, -1).min(axis=1)
        return np.where(best == _I64_MAX, NO_DOC, best)

    def insert_batch(self, keys: np.ndarray, docs: np.ndarray) -> None:
        """Durably append postings, sharded + replicated; a dark shard
        spills instead of raising."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64).ravel()
        docs = np.ascontiguousarray(docs, dtype=np.uint64).ravel()
        if keys.size == 0:
            return
        with self._floor_lock:
            self._floor = max(self._floor, int(docs.max()) + 1)
            self._postings_written += int(keys.size)
        self._gate_wait(keys)
        with self._gate_cv:
            self._inflight += 1
        try:
            shard_of, dual_of = self._route(keys)
            from advanced_scrapper_tpu_torch.obs import trace

            tctx = trace.current_context()
            futures = []
            for sid in range(len(self._shards)):
                ix = np.flatnonzero(shard_of == sid)
                if ix.size:
                    sh = self._shards[sid]
                    rid = (
                        f"ins-{self._token}-{self._fid}-{sid}"
                        f"-{self._next_wid()}"
                    )
                    futures.append(
                        self._pool.submit(
                            self._replicated_insert,
                            sh, keys[ix], docs[ix], rid, tctx=tctx,
                        )
                    )
                if dual_of is None:
                    continue
                # dual-write window: the arc's NEXT owner gets the same
                # postings, first-class (gap ledger / spill discipline
                # included) — idempotent server inserts make any overlap
                # with the migration stream harmless
                dx = np.flatnonzero(dual_of == sid)
                if dx.size:
                    rs = self._reshard
                    if rs is not None:
                        rs["metrics"]["dual"].inc(int(dx.size))
                    rid = (
                        f"dual-{self._token}-{self._fid}-{sid}"
                        f"-{self._next_wid()}"
                    )
                    futures.append(
                        self._pool.submit(
                            self._replicated_insert,
                            self._shards[sid], keys[dx], docs[dx], rid,
                            tctx=tctx,
                        )
                    )
            for fut in futures:
                fut.result()
        finally:
            with self._gate_cv:
                self._inflight -= 1
                self._gate_cv.notify_all()

    _wid_lock = threading.Lock()
    _wid = 0

    def _next_wid(self) -> int:
        with ShardedIndexClient._wid_lock:
            ShardedIndexClient._wid += 1
            return ShardedIndexClient._wid

    def check_and_add_batch(
        self, keys: np.ndarray, doc_ids: np.ndarray
    ) -> np.ndarray:
        """Sharded stream step, byte-equal to the single-node oracle:
        fan-out probe → the SHARED intra-batch resolution
        (:func:`~.store.resolve_intra_batch`) → replicated insert of the
        fresh rows' postings."""
        keys = np.asarray(keys, dtype=np.uint64)
        if keys.ndim == 1:
            keys = keys[:, None]
        doc_ids = np.ascontiguousarray(doc_ids, dtype=np.uint64).ravel()
        B, nb = keys.shape
        if B != doc_ids.size:
            raise ValueError(f"{B} key rows vs {doc_ids.size} doc ids")
        attr = resolve_intra_batch(
            keys, doc_ids, np.asarray(self.probe_batch(keys))
        )
        fresh = attr < 0
        if fresh.any():
            self.insert_batch(
                keys[fresh].ravel(), np.repeat(doc_ids[fresh], nb)
            )
        return attr

    def allocate_doc_ids(self, n: int) -> np.ndarray:
        """Monotonic uint64 ids from shard 0's durable allocator, floored
        by the client-side high water (so failover to a lagging replica
        can never reissue an id this client already referenced).  A fully
        dark shard 0 degrades to local allocation from the high water —
        but ONLY once this client has synced a durable floor at least
        once this session: a fresh client that never reached the
        allocator would otherwise restart at 0 and alias ids the fleet
        already holds from earlier runs, silently re-pointing historical
        attributions.  With no synced floor the darkness is an error."""
        sh = self._shards[0]
        with self._floor_lock:
            floor = self._floor
            floor_known = self._floor_known
        target = self._ensure_write_target(sh)
        ids = None
        if target is not None:
            try:
                _h, (ids,) = self._node_call(
                    sh, target, "allocate",
                    {"space": self.space, "n": int(n), "floor": floor},
                )
            except RpcOverloaded:
                pass  # alive but refusing: degrade like darkness below,
                #       WITHOUT marking the allocator shard dead
            except RpcUnavailable:
                self._note_failure(sh, target)
        synced = ids is not None
        if ids is None and not floor_known:
            raise RpcUnavailable(
                f"cannot allocate doc ids for space {self.space!r}: shard 0 "
                "is unreachable and no durable id floor was ever synced — "
                "local allocation could reissue ids the fleet already holds"
            )
        if ids is None:
            ids = np.arange(floor, floor + int(n), dtype=np.uint64)
        ids = np.asarray(ids, np.uint64)
        with self._floor_lock:
            if synced:
                self._floor_known = True
            self._floor = max(self._floor, int(ids.max()) + 1 if ids.size else 0)
        return ids

    def posting_count(self) -> int:
        """Postings THIS client wrote (acked or spilled) — the cheap gauge
        accessor; a fleet-wide census would be an RPC fan-out per metrics
        scrape (use :meth:`stats` for that, deliberately)."""
        with self._floor_lock:
            return self._postings_written

    def doc_id_floor(self) -> int:
        sh = self._shards[0]
        target = self._ensure_write_target(sh)
        if target is not None:
            try:
                h, _ = self._node_call(sh, target, "floor", {"space": self.space})
                with self._floor_lock:
                    self._floor_known = True
                    self._floor = max(self._floor, int(h["floor"]))
            except RpcOverloaded:
                pass  # keep the cached floor; never a death signal
            except RpcUnavailable:
                self._note_failure(sh, target)
        with self._floor_lock:
            return self._floor

    def raise_doc_id_floor(self, floor: int) -> None:
        with self._floor_lock:
            self._floor = max(self._floor, int(floor))

    def log_names(self, doc_ids, names) -> None:
        """Best-effort docmap on shard 0 (attribution-only, like local)."""
        sh = self._shards[0]
        target = self._ensure_write_target(sh)
        if target is None:
            return
        try:
            self._node_call(
                sh, target, "log_names",
                {"space": self.space, "names": [str(x) for x in names]},
                [np.asarray(doc_ids, np.uint64)],
            )
        except RpcOverloaded:
            pass  # best-effort sidecar: drop under overload, stay alive
        except RpcUnavailable:
            self._note_failure(sh, target)

    def checkpoint(self) -> None:
        """Fan the durability point to every live node; spill journals
        are already fsync'd at append time.  Also the periodic recovery
        probe: a dark shard that came back replays its spill here, and a
        gap-OVERFLOWED node gets its digest-verified resync attempt —
        checkpoint cadence is the hot-path-safe place for that streaming
        work (the backend already calls it at its durability cadence)."""
        for sh in self._shards:
            if any(not n.alive for n in sh.nodes):
                self._try_revive(sh, allow_resync=True)
            if sh.pending or not sh.live_nodes():
                self._ensure_write_target(sh)
            for node in sh.live_nodes():
                try:
                    self._node_call(
                        sh, node, "checkpoint", {"space": self.space},
                        budget=self.timeout,
                    )
                except RpcOverloaded:
                    pass  # durability point deferred, node NOT dead
                except RpcUnavailable:
                    self._note_failure(sh, node)

    def dump_postings(self) -> tuple[np.ndarray, np.ndarray]:
        """Every live posting across the fleet + the un-replayed overlay —
        the crashsweep verification surface, same contract as local.
        Paged (``REPLAY_CHUNK_POSTINGS`` per RPC) so a grown shard never
        produces a frame past the cap; meant to run quiescently — pages
        are not one snapshot under concurrent inserts."""
        parts_k, parts_d = [], []
        for sh in self._shards:
            target = self._ensure_write_target(sh)
            if target is not None:
                try:
                    off = 0
                    while True:
                        h, (k, d) = self._node_call(
                            sh, target, "dump",
                            {
                                "space": self.space,
                                "offset": off,
                                "limit": self.REPLAY_CHUNK_POSTINGS,
                            },
                        )
                        parts_k.append(np.asarray(k, np.uint64))
                        parts_d.append(np.asarray(d, np.uint64))
                        off += int(np.asarray(k).size)
                        if off >= int(h.get("total", off)) or np.asarray(k).size == 0:
                            break
                except RpcOverloaded:
                    pass  # partial dump; verification reruns quiescently
                except RpcUnavailable:
                    self._note_failure(sh, target)
            with sh.lock:
                for _rid, k, d in sh.pending:
                    parts_k.append(k)
                    parts_d.append(d)
        if not parts_k:
            e = np.zeros((0,), np.uint64)
            return e, e
        return np.concatenate(parts_k), np.concatenate(parts_d)

    def stats(self) -> dict:
        out = {"space": self.space, "shards": []}
        for sh in self._shards:
            target = self._ensure_write_target(sh)
            st = None
            if target is not None:
                try:
                    st, _ = self._node_call(
                        sh, target, "stats", {"space": self.space},
                        budget=self.timeout,
                    )
                except RpcOverloaded:
                    pass
                except RpcUnavailable:
                    self._note_failure(sh, target)
            out["shards"].append(st)
        return out

    def wipe(self) -> int:
        """Expire every posting of this wipe-allowed space fleet-wide;
        returns the total dropped count.

        Refused client-side (and again server-side) for any space whose
        :func:`~advanced_scrapper_tpu_torch.index.remote.namespace_policy` does
        not declare ``wipe_allowed`` (``canary:`` probe expiry and
        ``tenant:`` offboarding qualify) — expiry must be structurally
        unable to touch real postings.  Fans
        to EVERY node of every shard, not just the write target: replicas
        hold synchronously replicated copies, and a wipe that missed one
        would resurrect canary postings at the next failover.  A node
        that is down or overloaded is skipped (its copy is wiped when the
        next round's wipe reaches it; canary spaces are never repaired
        back).  Pending spill entries for the space are dropped too — a
        replayed canary posting after expiry would be pollution."""
        if not namespace_policy(self.space).wipe_allowed:
            raise ValueError(
                f"wipe is restricted to wipe-allowed namespace prefixes "
                f"({CANARY_SPACE_PREFIX!r}, tenant spaces), not "
                f"{self.space!r}"
            )
        dropped = 0
        for sh in self._shards:
            with sh.lock:
                sh.pending.clear()
                sh.overlay.clear()
            for node in sh.nodes:
                if not node.alive:
                    continue
                try:
                    h, _ = self._node_call(
                        sh, node, "wipe", {"space": self.space},
                        budget=self.timeout,
                    )
                    dropped += int(h.get("dropped", 0))
                except RpcOverloaded:
                    pass
                except RpcUnavailable:
                    self._note_failure(sh, node)
        return dropped

    def for_space(self, space: str, *, spill_dir: str | None = None):
        """A sibling client over the SAME topology for another key space
        — the canary prober's entry point: given the live fleet client,
        build the isolated ``canary:…`` namespace client without
        re-plumbing addresses.  Construction knobs are replayed exactly
        (the ctor saved them for topology growth); the spill journal
        defaults OFF — synthetic canary postings must never durably
        journal into a real spill directory."""
        return ShardedIndexClient(
            self.spec,
            space=space,
            spill_dir=spill_dir,
            timeout=self.timeout,
            retries=self._retries,
            health_checks=self.health_checks,
            health_timeout=self.health_timeout,
            vnodes=self.vnodes,
            connect=self._connect,
            seed=self._seed,
            fs=self._fs,
            overload_backoff_cap=self.overload_backoff_cap,
            overload_budget=self.overload_budget,
            sleep=self._sleep,
            gap_limit_postings=self.gap_limit_postings,
            repair_interval=0,
            resync_rounds=self.resync_rounds,
            digest_bits=self.digest_bits,
        )

    def close(self) -> None:
        """Release sockets + journals.  Spilled-but-unreplayed postings
        stay in the on-disk journal for the next client's
        ``_reload_spill`` — close is NOT a drop."""
        if self._closed:
            return
        self._closed = True
        self.stop_repair()
        self._pool.shutdown(wait=True)
        for sh in self._shards:
            if sh.journal is not None:
                sh.journal.close()
                sh.journal = None
            for node in sh.nodes:
                node.client.close()
