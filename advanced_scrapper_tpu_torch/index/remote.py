"""Remote persistent-index shards: the server half of the index fleet.

:class:`IndexShardServer` hosts one or more :class:`~.store.PersistentIndex`
key spaces (``bands`` postings and the exact-``urls`` stage, mirroring the
local two-sub-index layout) behind the length-framed RPC plane
(``net/rpc.py``).  A shard owns a deterministic slice of the uint64
band-key space (the fleet client's consistent-hash ring decides which);
everything durable about it IS the wrapped ``PersistentIndex`` — WAL,
segments, manifest swap, crash recovery — so a SIGKILLed shard process
reopens with the exact guarantees the single-node crashsweep certified.

Retry idempotency has two nets:

- the transport replays cached responses for a duplicated request id
  (``RpcServer``), which covers retries within one server lifetime;
- ``insert`` is **semantically idempotent** across server restarts: the
  handler drops any posting ``(key, doc)`` whose key already attributes
  to a doc id ≤ ``doc``.  In the probe-before-insert protocols every
  caller uses (``check_and_add``, done markers, url postings) a key is
  only ever posted when absent, so the filter is a no-op on first
  delivery and exactly cancels a redelivery — a retried batch can never
  double-insert, and no future probe can tell the difference.

``python -m advanced_scrapper_tpu_torch.index.remote --dir D --port 0
--port-file P`` serves a shard standalone (a test or a smoke run SIGKILLs
these mid-WAL-append); the module imports no torch, so a shard process is
host-only and cheap to fork.

The port's copy of the reference's ``index/remote.py``: the same handlers,
wire headers and shard directories, so a port shard serves a reference
client and a directory either package's server wrote opens under the
other's.
"""

from __future__ import annotations

import dataclasses
import os
import threading

import numpy as np

import advanced_scrapper_tpu_torch.net.rpc as rpc  # the ONE allowed net import

from advanced_scrapper_tpu_torch.index import repair as antientropy
from advanced_scrapper_tpu_torch.index.store import PersistentIndex

__all__ = [
    "IndexShardServer",
    "NamespacePolicy",
    "NAMESPACE_POLICIES",
    "RemoteIndex",
    "namespace_policy",
    "paged_fetch_range",
    "serve_main",
]

DEFAULT_SPACES = ("bands", "urls")

#: reserved key-space name prefix for the ground-truth canary prober
#: (``obs/canary.py`` declares the same literal — it may not import this
#: layer).
CANARY_SPACE_PREFIX = "canary:"

#: reserved key-space name prefix for multi-tenant namespaces: the
#: service-layer gateway maps tenant ``t`` to ``tenant:t:<sub>`` spaces,
#: so a tenant's band keys cannot collide with another tenant's (or with
#: the shared ``bands``/``urls`` spaces) by construction.
TENANT_SPACE_PREFIX = "tenant:"


@dataclasses.dataclass(frozen=True)
class NamespacePolicy:
    """Declarative per-prefix key-space policy (the generalization of the
    canary plane's special-casing): which space names are provisioned on
    first touch, which the ``wipe`` RPC may drop, and which admission
    quota class the service layer bills them under.

    - ``auto_provision`` — spaces under the prefix materialize server-side
      on first touch (the prober / a new tenant needs a live fleet to
      answer without every deployment pre-declaring it); real spaces stay
      declaration-only, so a typo'd space name fails instead of silently
      shadowing the intended postings.
    - ``wipe_allowed`` — the ``wipe`` RPC drops postings only inside
      prefixes that declare it (canary expiry between probe rounds,
      tenant offboarding); a stray wipe aimed at a real space is refused
      server-side AND client-side.
    - ``quota_class`` — the admission class the front-door gateway uses
      when stacking per-namespace token buckets (informational at this
      layer: the index plane never imports runtime/).
    """

    prefix: str
    auto_provision: bool
    wipe_allowed: bool
    quota_class: str


#: longest-prefix-match table; the ``""`` entry is the catch-all for
#: declared real spaces (``bands``/``urls``/reshard targets): never
#: auto-provisioned, never wipeable.
NAMESPACE_POLICIES: tuple[NamespacePolicy, ...] = (
    NamespacePolicy(CANARY_SPACE_PREFIX, True, True, "canary"),
    NamespacePolicy(TENANT_SPACE_PREFIX, True, True, "tenant"),
    NamespacePolicy("", False, False, "system"),
)


def namespace_policy(space: str) -> NamespacePolicy:
    """The policy governing ``space``: longest matching prefix wins."""
    best = None
    for pol in NAMESPACE_POLICIES:
        if space.startswith(pol.prefix):
            if best is None or len(pol.prefix) > len(best.prefix):
                best = pol
    assert best is not None  # the "" catch-all always matches
    return best


class IndexShardServer:
    """One fleet shard: N persistent-index key spaces behind one RPC port."""

    def __init__(
        self,
        directory: str,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        spaces=DEFAULT_SPACES,
        cut_postings: int = 1 << 16,
        compact_segments: int = 8,
        compact_inline: bool = False,
        max_frame: int = rpc.DEFAULT_MAX_FRAME,
        frame_deadline: float = 30.0,
        name: str = "",
        status_port: int | None = None,
        max_inflight_inserts: int = 32,
        insert_rate: float = 0.0,
        ladder=None,
    ):
        """``status_port`` mirrors the lease server's observability
        sidecar: a small HTTP server beside the RPC socket serving ``GET
        /metrics`` + ``/status`` (0 = ephemeral port, None = only when
        telemetry is enabled) — the per-process endpoint the fleet
        metrics collector (``obs/collector.py``) scrapes.

        ``max_inflight_inserts`` bounds concurrently executing write
        handlers (``insert``/``check_and_add``): request number N+1 gets
        a counted ``RpcOverloaded`` reject with a retry-after hint
        instead of a thread and a WAL contention slot — the shard sheds
        instead of wedging (0 disables).  ``insert_rate`` adds a
        token-bucket rate cap on the same methods (writes/s; 0 = none).
        Probes, health pings and the control surface are never gated:
        an overloaded shard stays readable and provably alive.
        ``ladder`` (optional
        :class:`~advanced_scrapper_tpu_torch.runtime.admission.DegradationLadder`)
        receives the admission pressure signal, so sustained write
        pressure walks the declared brownout steps."""
        self.dir = directory
        self.name = name or os.path.basename(directory.rstrip("/")) or "shard"
        self._status_port = status_port
        self.status_server = None
        self._lock = threading.Lock()
        self._stopped = False
        self.admission = None
        if max_inflight_inserts > 0 or insert_rate > 0:
            from advanced_scrapper_tpu_torch.runtime.admission import (
                AdmissionController,
                DegradationLadder,
            )

            if ladder is None:
                # every admission-bounded shard exports a live
                # astpu_degraded_step series (the SLO engine's brownout
                # signal).  ONE step only: the shard's sole brownout
                # lever is shedding low-priority work — declaring the
                # engine steps (shrink_window/skip_rerank/fewer_bands)
                # here would emit phantom transitions for degradations
                # a shard cannot perform, and delay shed_low behind
                # three inert dwell climbs
                from advanced_scrapper_tpu_torch.runtime.admission import (
                    LadderStep,
                )

                ladder = DegradationLadder(
                    [LadderStep("shed_low", 0.98, 0.75)],
                    name=f"shard:{self.name}",
                )
            from advanced_scrapper_tpu_torch.runtime.admission import (
                PRIORITY_NORMAL,
            )

            self.admission = AdmissionController(
                rate=insert_rate,
                max_inflight=max_inflight_inserts,
                ladder=ladder,
                # gated writes arrive at NORMAL priority (no per-method
                # mapping here), so the shed step must shed AT normal or
                # it would be a declared lever that moves nothing —
                # under sustained ≥98% write pressure the shard refuses
                # ALL writes outright (reads/pings untouched) until
                # pressure calms below the exit threshold
                shed_at=PRIORITY_NORMAL,
                name=f"shard:{self.name}",
            )
        # saved for lazily provisioning canary: spaces with the same
        # durability knobs the declared spaces got
        self._index_kw = dict(
            cut_postings=cut_postings,
            compact_segments=compact_segments,
            compact_inline=compact_inline,
        )
        self.indexes: dict[str, PersistentIndex] = {
            sp: PersistentIndex(os.path.join(directory, sp), **self._index_kw)
            for sp in spaces
        }
        self.server = rpc.RpcServer(
            {
                "probe": self._h_probe,
                "insert": self._h_insert,
                "check_and_add": self._h_check_and_add,
                "allocate": self._h_allocate,
                "log_names": self._h_log_names,
                "floor": self._h_floor,
                "stats": self._h_stats,
                "dump": self._h_dump,
                "checkpoint": self._h_checkpoint,
                # the self-healing plane: anti-entropy digests + range
                # streaming, on-demand corruption scrub, and the
                # snapshot/fetch pair tools/fleet_snapshot.py drives
                "digest": self._h_digest,
                "fetch_range": self._h_fetch_range,
                "scrub": self._h_scrub,
                "snapshot": self._h_snapshot,
                "fetch_file": self._h_fetch_file,
                # the reshard control plane: handed-off range marks + the
                # mid-cutover fence (index/reshard.py drives these through
                # the fleet client's two-phase cutover)
                "retire_range": self._h_retire_range,
                "unretire_range": self._h_unretire_range,
                "reshard_mark": self._h_reshard_mark,
                # canary-space expiry (restricted to the canary: prefix)
                "wipe": self._h_wipe,
            },
            host=host,
            port=port,
            max_frame=max_frame,
            frame_deadline=frame_deadline,
            name=f"shard:{self.name}",
            admission=self.admission,
            # ONLY the write plane is gated: probes must keep answering
            # under a write storm (reads are cheap and the fleet's
            # byte-equality depends on them), and the control surface
            # (floor/stats/checkpoint) is how operators see the overload
            admission_methods=frozenset({"insert", "check_and_add"}),
        )

    # -- lifecycle ---------------------------------------------------------

    @property
    def port(self) -> int:
        return self.server.port

    def start(self) -> "IndexShardServer":
        self.server.start()
        from advanced_scrapper_tpu_torch.obs import telemetry, trace

        # the shard announces itself in the flight-recorder ring: a chaos
        # dump harvested centrally must NAME the dead shard, not just its
        # pid (the reference's collector reads this event out of the
        # sidecar)
        trace.record(
            "event", "shard.serve", shard=self.name, port=self.server.port
        )
        if self._status_port is not None or telemetry.enabled():
            self.status_server = telemetry.StatusServer(
                port=self._status_port or 0,
                name=f"shard-{self.name}",
                extra_status=lambda: {
                    "shard": self.name,
                    "spaces": {
                        sp: idx.stats() for sp, idx in self.indexes.items()
                    },
                },
            ).start()
        return self

    def stop(self) -> None:
        """Idempotent: tests stop a 'killed' node and sweep everything
        again in teardown."""
        self.server.stop()
        if self.status_server is not None:
            self.status_server.stop()
            self.status_server = None
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            for idx in self.indexes.values():
                idx.close()

    def _space(self, header: dict) -> PersistentIndex:
        sp = header.get("space", "bands")
        try:
            return self.indexes[sp]
        except KeyError:
            pass
        if namespace_policy(sp).auto_provision:
            # policy-declared prefixes (canary probe rounds, tenant
            # namespaces) are provisioned on first touch; real spaces
            # stay declaration-only — a typo'd space name must fail, not
            # silently shadow the intended postings.
            with self._lock:
                idx = self.indexes.get(sp)
                if idx is None and not self._stopped:
                    idx = PersistentIndex(
                        os.path.join(self.dir, sp), **self._index_kw
                    )
                    self.indexes[sp] = idx
            if idx is not None:
                return idx
        raise KeyError(
            f"shard {self.name} hosts {sorted(self.indexes)}, not {sp!r}"
        )

    # -- handlers ----------------------------------------------------------

    def _h_probe(self, header, arrays):
        (keys,) = arrays
        docs = self._space(header).probe_batch(np.asarray(keys, np.uint64))
        return {}, [np.asarray(docs, np.int64)]

    def _h_insert(self, header, arrays):
        keys, docs = arrays
        idx = self._space(header)
        keys = np.ascontiguousarray(keys, np.uint64).ravel()
        docs = np.ascontiguousarray(docs, np.uint64).ravel()
        with self._lock:
            # semantic idempotency (see module docstring): drop postings
            # already superseded-or-equal, so a redelivered batch — same
            # request after a crash-reopen wiped the transport cache —
            # applies zero times instead of twice
            attr = np.asarray(idx.probe_batch(keys))
            fresh = (attr < 0) | (attr.astype(np.int64) > docs.astype(np.int64))
            if fresh.any():
                idx.insert_batch(keys[fresh], docs[fresh])
        return {"applied": int(fresh.sum()), "skipped": int((~fresh).sum())}

    def _h_check_and_add(self, header, arrays):
        keys, doc_ids = arrays
        idx = self._space(header)
        with self._lock:
            attr = idx.check_and_add_batch(
                np.asarray(keys, np.uint64), np.asarray(doc_ids, np.uint64)
            )
        return {}, [np.asarray(attr, np.int64)]

    def _h_allocate(self, header, arrays):
        idx = self._space(header)
        n = int(header["n"])
        floor = int(header.get("floor", 0))
        with self._lock:
            if floor:
                idx.raise_doc_id_floor(floor)
            ids = idx.allocate_doc_ids(n)
        return {}, [ids]

    def _h_log_names(self, header, arrays):
        (ids,) = arrays
        self._space(header).log_names(
            np.asarray(ids, np.uint64).tolist(), header.get("names", [])
        )
        return {}

    def _h_floor(self, header, arrays):
        return {"floor": int(self._space(header).doc_id_floor())}

    def _h_stats(self, header, arrays):
        return {
            "shard": self.name,
            "spaces": {sp: idx.stats() for sp, idx in self.indexes.items()},
        }

    def _h_dump(self, header, arrays):
        """Paged: a shard past ~4M postings must never build a response
        frame the client's own cap forces it to refuse."""
        keys, docs = self._space(header).dump_postings()
        total = int(keys.size)
        off = int(header.get("offset", 0))
        limit = header.get("limit")
        if limit is not None:
            hi = off + int(limit)
            keys, docs = keys[off:hi], docs[off:hi]
        elif off:
            keys, docs = keys[off:], docs[off:]
        return {"total": total}, [keys, docs]

    def _h_checkpoint(self, header, arrays):
        for idx in self.indexes.values():
            idx.checkpoint()
        return {}

    # -- self-healing plane ------------------------------------------------

    def _h_digest(self, header, arrays):
        """Bucketed key-space digest of the SEMANTIC state — the
        anti-entropy comparison unit (``index/repair.py``).

        ``mixed`` mode buckets by the key's RING POSITION (``mix64``) and
        restricts to positions in ``[lo, hi)`` when given — the reshard
        cutover's digest gate compares one migrating ring arc between its
        old and new owner this way (raw-key bucketing could never name a
        ring arc: ring position decorrelates the two spaces by design)."""
        idx = self._space(header)
        bits = int(header.get("bits", antientropy.DEFAULT_BITS))
        keys, docs = idx.semantic_items()
        if header.get("mixed"):
            pos = antientropy.mix64(keys)
            if "lo" in header:
                lo, hi = int(header["lo"]), int(header["hi"])
                m = pos >= np.uint64(lo)
                if hi < antientropy.KEY_SPACE_END:
                    m &= pos < np.uint64(hi)
                keys, docs, pos = keys[m], docs[m], pos[m]
            dig, cnt = antientropy.bucket_digests(keys, docs, bits, positions=pos)
        else:
            dig, cnt = antientropy.bucket_digests(keys, docs, bits)
        return {"bits": bits}, [dig, cnt]

    def _h_fetch_range(self, header, arrays):
        """Semantic ``(key, min-doc)`` pairs with key in ``[lo, hi)`` —
        paged like ``dump`` so a hot bucket can never build a frame past
        the cap.  ``hi`` may be 2**64 (the last bucket's open end).
        ``mixed`` selects by ring position instead of raw key — the
        migration stream's page source."""
        idx = self._space(header)
        lo, hi = int(header["lo"]), int(header["hi"])
        keys, docs = idx.semantic_items()
        if header.get("mixed"):
            pos = antientropy.mix64(keys)
            m = pos >= np.uint64(lo)
            if hi < antientropy.KEY_SPACE_END:
                m &= pos < np.uint64(hi)
            keys, docs = keys[m], docs[m]
        else:
            # semantic keys are sorted: the [lo, hi) slice is two binary
            # searches, not a full-array mask per page
            i0 = int(np.searchsorted(keys, np.uint64(lo), side="left"))
            i1 = (
                keys.size
                if hi >= antientropy.KEY_SPACE_END
                else int(np.searchsorted(keys, np.uint64(hi), side="left"))
            )
            keys, docs = keys[i0:i1], docs[i0:i1]
        total = int(keys.size)
        off = int(header.get("offset", 0))
        limit = header.get("limit")
        if limit is not None:
            keys, docs = keys[off : off + int(limit)], docs[off : off + int(limit)]
        elif off:
            keys, docs = keys[off:], docs[off:]
        return {"total": total}, [keys, docs]

    def _h_scrub(self, header, arrays):
        """On-demand end-to-end corruption scrub: every block CRC + the
        manifest whole-file digests, per space; corrupt segments are
        quarantined server-side instead of ever answering a probe."""
        sp = header.get("space")
        spaces = [sp] if sp else sorted(self.indexes)
        return {
            "shard": self.name,
            "report": {s: self.indexes[s].scrub() for s in spaces},
        }

    def _h_snapshot(self, header, arrays):
        """Consistent-snapshot fence for one space: cut the memtable
        under the shard write lock (no insert can interleave with the
        fence), then name every live file with size + digest."""
        idx = self._space(header)
        with self._lock:
            return {"shard": self.name, "snapshot": idx.snapshot_meta()}

    def _h_fetch_file(self, header, arrays):
        """Raw paged bytes of one snapshot-named file (segments are
        immutable, so pages of one file always compose consistently)."""
        idx = self._space(header)
        data = idx.read_file(
            header["name"],
            int(header.get("offset", 0)),
            header.get("limit"),
        )
        return {"bytes": len(data)}, [np.frombuffer(data, np.uint8)]

    def _h_retire_range(self, header, arrays):
        """Mark ring range ``[lo, hi)`` handed off (idempotent, one
        atomic manifest write) — the cutover's last step per range."""
        idx = self._space(header)
        idx.retire_range(int(header["lo"]), int(header["hi"]))
        return {"handed_off": len(idx.handed_off_ranges())}

    def _h_unretire_range(self, header, arrays):
        """Re-acquire a previously handed-off range (the N→M→N round
        trip) — idempotent."""
        idx = self._space(header)
        idx.unretire_range(int(header["lo"]), int(header["hi"]))
        return {"handed_off": len(idx.handed_off_ranges())}

    def _h_wipe(self, header, arrays):
        """Drop every posting of ONE wipe-allowed space (crash-safe
        committed wipe, doc-id high-water preserved).  Refused for any
        space whose :func:`namespace_policy` does not declare
        ``wipe_allowed``: canary expiry and tenant offboarding are
        namespace-plane verbs, not a general data-deletion API."""
        sp = header.get("space", "")
        if not namespace_policy(sp).wipe_allowed:
            raise ValueError(
                f"wipe is restricted to wipe-allowed namespace prefixes "
                f"(policy {namespace_policy(sp).quota_class!r}), not {sp!r}"
            )
        idx = self.indexes.get(sp)
        if idx is None:
            return {"dropped": 0}  # never provisioned here: idempotent
        with self._lock:
            return {"dropped": int(idx.wipe())}

    def _h_reshard_mark(self, header, arrays):
        """Set/clear/read the mid-reshard fence on every space this node
        hosts (a reshard moves the whole node's ring slice, not one
        space's)."""
        op = header.get("op", "get")
        if op == "set":
            for idx in self.indexes.values():
                idx.set_reshard_mark(str(header["token"]))
        elif op == "clear":
            for idx in self.indexes.values():
                idx.clear_reshard_mark()
        elif op != "get":
            raise ValueError(f"reshard_mark op must be set/clear/get, not {op!r}")
        return {
            "marks": {
                sp: idx.reshard_mark() for sp, idx in self.indexes.items()
            }
        }


def paged_fetch_range(
    call, lo: int, hi: int, *, page: int = 1 << 18, mixed: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """The ONE ``fetch_range`` pagination loop (offset/total/empty-page
    termination), shared by :class:`RemoteIndex` and the fleet client's
    repair plane so the paging contract cannot drift between them.
    ``call(header)`` issues one RPC and returns ``(header, [keys, docs])``.
    """
    parts_k, parts_d = [], []
    off = 0
    while True:
        header = {"lo": int(lo), "hi": int(hi), "offset": off, "limit": int(page)}
        if mixed:
            header["mixed"] = True
        h, (keys, docs) = call(header)
        parts_k.append(np.asarray(keys, np.uint64))
        parts_d.append(np.asarray(docs, np.uint64))
        off += int(parts_k[-1].size)
        if off >= int(h.get("total", off)) or parts_k[-1].size == 0:
            break
    return np.concatenate(parts_k), np.concatenate(parts_d)


class RemoteIndex:
    """Client handle for ONE key space on ONE shard node.

    The per-node building block of ``index/fleet.py`` — and a drop-in
    single-shard remote for code written against ``PersistentIndex``
    (``probe_batch`` / ``insert_batch`` / ``check_and_add_batch`` /
    ``allocate_doc_ids`` / ``log_names``).  Retries ride the RPC layer's
    request-id discipline; ``check_and_add_batch`` retries are safe for
    the same reason (response replay within a server lifetime, and the
    orchestrating fleet client never uses it across one).
    """

    def __init__(
        self,
        address: tuple[str, int],
        *,
        space: str = "bands",
        client: rpc.RpcClient | None = None,
        timeout: float = 10.0,
        retries: int = 3,
        connect=None,
        seed: int = 0,
    ):
        self.address = tuple(address)
        self.space = space
        self.client = client or rpc.RpcClient(
            self.address,
            timeout=timeout,
            retries=retries,
            connect=connect,
            seed=seed,
        )

    def _call(self, method, header=None, arrays=(), **kw):
        h = {"space": self.space}
        h.update(header or {})
        return self.client.call(method, h, arrays, **kw)

    def ping(self, *, timeout: float | None = None) -> bool:
        return self.client.ping(timeout=timeout)

    def probe_batch(self, keys) -> np.ndarray:
        _h, (docs,) = self._call("probe", arrays=[np.asarray(keys, np.uint64)])
        return docs

    def insert_batch(self, keys, docs, *, request_id=None) -> int:
        h, _ = self._call(
            "insert",
            arrays=[np.asarray(keys, np.uint64), np.asarray(docs, np.uint64)],
            request_id=request_id,
        )
        return int(h.get("applied", 0))

    def check_and_add_batch(self, keys, doc_ids) -> np.ndarray:
        _h, (attr,) = self._call(
            "check_and_add",
            arrays=[np.asarray(keys, np.uint64), np.asarray(doc_ids, np.uint64)],
        )
        return attr

    def allocate_doc_ids(self, n: int, *, floor: int = 0) -> np.ndarray:
        _h, (ids,) = self._call("allocate", {"n": int(n), "floor": int(floor)})
        return ids

    def log_names(self, doc_ids, names) -> None:
        self._call(
            "log_names",
            {"names": [str(n) for n in names]},
            arrays=[np.asarray(doc_ids, np.uint64)],
        )

    def doc_id_floor(self) -> int:
        h, _ = self._call("floor")
        return int(h["floor"])

    def stats(self) -> dict:
        h, _ = self._call("stats")
        return h

    def dump_postings(
        self, *, page: int = 1 << 18
    ) -> tuple[np.ndarray, np.ndarray]:
        parts_k, parts_d = [], []
        off = 0
        while True:
            h, (keys, docs) = self._call(
                "dump", {"offset": off, "limit": int(page)}
            )
            parts_k.append(np.asarray(keys, np.uint64))
            parts_d.append(np.asarray(docs, np.uint64))
            off += int(parts_k[-1].size)
            if off >= int(h.get("total", off)) or parts_k[-1].size == 0:
                break
        return np.concatenate(parts_k), np.concatenate(parts_d)

    def checkpoint(self) -> None:
        self._call("checkpoint")

    def wipe(self) -> int:
        """Expire this space's postings (canary spaces only — the server
        refuses others); returns the dropped posting count."""
        h, _ = self._call("wipe")
        return int(h.get("dropped", 0))

    # -- self-healing plane ------------------------------------------------

    def digest(
        self,
        *,
        bits: int | None = None,
        lo: int | None = None,
        hi: int | None = None,
        mixed: bool = False,
    ):
        header: dict = {} if bits is None else {"bits": int(bits)}
        if mixed:
            header["mixed"] = True
            if lo is not None:
                header["lo"], header["hi"] = int(lo), int(hi)
        h, (dig, cnt) = self._call("digest", header)
        return dig, cnt

    def fetch_range(
        self, lo: int, hi: int, *, page: int = 1 << 18, mixed: bool = False
    ) -> tuple[np.ndarray, np.ndarray]:
        return paged_fetch_range(
            lambda header: self._call("fetch_range", header),
            lo, hi, page=page, mixed=mixed,
        )

    # -- reshard control plane ----------------------------------------------

    def retire_range(self, lo: int, hi: int) -> None:
        self._call("retire_range", {"lo": int(lo), "hi": int(hi)})

    def unretire_range(self, lo: int, hi: int) -> None:
        self._call("unretire_range", {"lo": int(lo), "hi": int(hi)})

    def set_reshard_mark(self, token: str) -> None:
        self._call("reshard_mark", {"op": "set", "token": str(token)})

    def clear_reshard_mark(self) -> None:
        self._call("reshard_mark", {"op": "clear"})

    def reshard_marks(self) -> dict:
        h, _ = self._call("reshard_mark", {"op": "get"})
        return h["marks"]

    def scrub(self) -> dict:
        h, _ = self._call("scrub")
        return h["report"]

    def snapshot_meta(self) -> dict:
        h, _ = self._call("snapshot")
        return h["snapshot"]

    def fetch_file_into(self, name: str, fh, *, page: int = 4 << 20) -> int:
        """Stream one snapshot-named file into ``fh`` paged under the
        frame cap (segments are immutable, so pages compose); returns
        the byte count.  Memory stays bounded at one page — a multi-GB
        compacted segment never materialises client-side."""
        off = 0
        while True:
            h, (chunk,) = self._call(
                "fetch_file", {"name": name, "offset": off, "limit": int(page)}
            )
            chunk = np.asarray(chunk, np.uint8).tobytes()
            if not chunk:
                break
            fh.write(chunk)
            off += len(chunk)
            if len(chunk) < page:
                break
        return off

    def fetch_file(self, name: str, *, page: int = 4 << 20) -> bytes:
        """:meth:`fetch_file_into` for small files whose bytes the
        caller wants in hand."""
        import io

        buf = io.BytesIO()
        self.fetch_file_into(name, buf, page=page)
        return buf.getvalue()

    def close(self) -> None:
        self.client.close()


def serve_main(argv=None) -> int:
    """Standalone shard entry (``python -m advanced_scrapper_tpu_torch.index.remote``).

    Writes the bound port to ``--port-file`` ATOMICALLY after listen, so a
    parent that forked N shards can wait for the files instead of racing
    the bind.  SIGTERM closes cleanly; SIGKILL is the crashsweep's job.
    """
    import argparse
    import signal
    import time as _time

    ap = argparse.ArgumentParser(description=serve_main.__doc__)
    ap.add_argument("--dir", required=True, help="shard index directory")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--port-file", default=None)
    ap.add_argument("--spaces", default=",".join(DEFAULT_SPACES))
    ap.add_argument("--cut-postings", type=int, default=1 << 16)
    ap.add_argument("--compact-segments", type=int, default=8)
    ap.add_argument("--name", default="")
    ap.add_argument(
        "--max-inflight-inserts", type=int, default=32,
        help="admission bound on concurrently executing write handlers "
        "(insert/check_and_add); beyond it requests get a counted "
        "RpcOverloaded reject with a retry-after hint (0 = unbounded)",
    )
    ap.add_argument(
        "--insert-rate", type=float, default=0.0,
        help="token-bucket cap on admitted writes/s (0 = unlimited)",
    )
    ap.add_argument(
        "--metrics-port", type=int, default=None,
        help="serve GET /metrics + /status beside the RPC socket "
        "(0 = ephemeral; omit = only under ASTPU_TELEMETRY)",
    )
    ap.add_argument(
        "--metrics-port-file", default=None,
        help="write the bound metrics port here (atomic, after listen) — "
        "how a parent wires the fleet collector to forked shards",
    )
    args = ap.parse_args(argv)

    if args.metrics_port_file is not None and args.metrics_port is None:
        # asking where the metrics port landed IS asking for the sidecar:
        # a parent waiting on the file must never hang because
        # --metrics-port was omitted and telemetry happened to be off
        args.metrics_port = 0

    srv = IndexShardServer(
        args.dir,
        host=args.host,
        port=args.port,
        spaces=tuple(s for s in args.spaces.split(",") if s),
        cut_postings=args.cut_postings,
        compact_segments=args.compact_segments,
        compact_inline=True,  # forked shards: deterministic compaction,
        name=args.name,       # a chaos/SIGKILL target like everything else
        status_port=args.metrics_port,
        max_inflight_inserts=args.max_inflight_inserts,
        insert_rate=args.insert_rate,
    ).start()
    if args.port_file:
        from advanced_scrapper_tpu_torch.storage.fsio import atomic_replace

        atomic_replace(args.port_file, str(srv.port).encode())
    if args.metrics_port_file and srv.status_server is not None:
        from advanced_scrapper_tpu_torch.storage.fsio import atomic_replace

        atomic_replace(
            args.metrics_port_file, str(srv.status_server.port).encode()
        )

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_a: stop.set())
    signal.signal(signal.SIGINT, lambda *_a: stop.set())
    try:
        while not stop.is_set():
            _time.sleep(0.1)
    finally:
        srv.stop()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(serve_main())
