"""Live N→M resharding: the plan math and the crash-safe cutover ledger.

The consistent-hash ring (``fleet.ring_assign``) froze the shard count at
:class:`~advanced_scrapper_tpu_torch.index.fleet.FleetSpec` construction; this
module is the pure half of lifting that — everything a topology change
needs that is NOT a remote call:

- :func:`plan_reshard` — diff the old ring against the new one into a
  minimal set of :class:`MigrationRange` arcs (mixed/ring space, disjoint,
  sorted).  Ring points depend only on ``(shard, vnode)``, so a split's
  new points interleave with the old ones and only the arcs whose owner
  actually changes ever move — the consistent-hash promise, made explicit.
- :class:`RangeTable` — the vectorized per-key router the fleet consults
  on every probe/insert while a reshard is live: a key's ring position
  falls in a migrating arc ⇒ route by that arc's cutover state (reads
  from the OLD owner until the flip, writes dual-applied during the
  dual-write window), else the old ring answers unchanged.
- :class:`ReshardLedger` — the migration WAL.  One atomically-replaced
  JSON document holding every range's cutover state
  (``pending → dual_write → flipped → retired``); a crash at ANY instant
  leaves either the previous whole document or the next one, so a
  half-flipped range is unrepresentable on disk.  Resume voids every
  non-flipped range back to ``pending`` (the armed-ledger discipline the
  fleet's resync uses: progress that was not sealed never counts) and
  keeps every flipped one — the flip write IS the commit point.

Who owns a range when (the cutover lifecycle the fleet drives):

====================  ===========  ======================  =============
state                 reads        writes                  on crash
====================  ===========  ======================  =============
``pending``           src          src                     nothing moved
``dual_write``        src          src (acked) + dst       void → pending
``flipped``           dst          dst                     keep; re-retire
``retired``           dst          dst (src drops range)   keep
====================  ===========  ======================  =============

Layering: plan/ledger math only — numpy + storage + obs.  The RPCs that
act on a plan (mixed digests, paged range fetches, retire marks) live in
``fleet.py``/``remote.py``; this module must not touch the transport
(held by ``tests/test_torch_boundary.py``: not even the ``net.rpc``
import the rest of ``index/`` makes).
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass

import numpy as np

from advanced_scrapper_tpu_torch.index.repair import KEY_SPACE_END, mix64

__all__ = [
    "MigrationRange",
    "RangeTable",
    "ReshardLedger",
    "ledger_path",
    "plan_reshard",
    "reshard_metrics",
    "ring_ranges",
    "route_keys",
]

#: cutover states, in lifecycle order; the ledger enforces the order
STATES = ("pending", "dual_write", "flipped", "retired")
_STATE_CODE = {s: i for i, s in enumerate(STATES)}

#: states at/after which the NEW owner answers reads
_FLIPPED_CODE = _STATE_CODE["flipped"]
_DUAL_CODE = _STATE_CODE["dual_write"]


@dataclass(frozen=True)
class MigrationRange:
    """One ring arc changing hands: positions ``[lo, hi)`` (mixed/ring
    space, Python ints — ``hi`` may be 2**64) move shard ``src`` → ``dst``."""

    lo: int
    hi: int
    src: int
    dst: int


def _ring_points(num_shards: int, vnodes: int):
    """The fleet's ring for ``num_shards`` — lazy import so this module
    stays importable without the transport stack behind ``fleet``."""
    from advanced_scrapper_tpu_torch.index.fleet import _ring

    return _ring(num_shards, vnodes)


def ring_ranges(num_shards: int, vnodes: int = 64) -> list[tuple[int, int, int]]:
    """The ring as disjoint sorted ``(lo, hi, owner)`` covering exactly
    ``[0, 2**64)`` — the interval form of ``ring_assign`` (the property
    tests assert the two agree on every key)."""
    pts, owner = _ring_points(num_shards, vnodes)
    out: list[tuple[int, int, int]] = []
    lo = 0
    for i in range(len(pts)):
        hi = int(pts[i]) + 1  # searchsorted-left: a point owns positions ≤ it
        if hi > lo:
            out.append((lo, hi, int(owner[i])))
        lo = hi
    # the wrap arc past the last point belongs to the first point's owner
    if lo < KEY_SPACE_END:
        out.append((lo, KEY_SPACE_END, int(owner[0])))
    return out


def _owner_at(pts, owner, pos: int) -> int:
    ix = int(np.searchsorted(pts, np.uint64(pos)))
    return int(owner[ix % len(pts)])


def plan_reshard(
    old_n: int, new_n: int, vnodes: int = 64
) -> tuple[MigrationRange, ...]:
    """Diff ring(``old_n``) against ring(``new_n``): the disjoint sorted
    arcs whose owner changes, coalesced.  Every position outside the
    returned ranges has the SAME owner under both rings — the router
    never needs a special case for them."""
    if old_n < 1 or new_n < 1:
        raise ValueError(f"shard counts must be ≥1 (got {old_n}→{new_n})")
    if old_n == new_n:
        return ()
    pts_o, own_o = _ring_points(old_n, vnodes)
    pts_n, own_n = _ring_points(new_n, vnodes)
    bounds = sorted(
        {0, KEY_SPACE_END}
        | {int(p) + 1 for p in pts_o}
        | {int(p) + 1 for p in pts_n}
    )
    out: list[MigrationRange] = []
    for lo, hi in zip(bounds, bounds[1:]):
        o = _owner_at(pts_o, own_o, lo)
        n = _owner_at(pts_n, own_n, lo)
        if o == n:
            continue
        if out and out[-1].hi == lo and (out[-1].src, out[-1].dst) == (o, n):
            out[-1] = MigrationRange(out[-1].lo, hi, o, n)
        else:
            out.append(MigrationRange(lo, hi, o, n))
    return tuple(out)


class RangeTable:
    """The migrating arcs + their live cutover states, as parallel numpy
    arrays so the fleet's per-batch routing is one ``searchsorted`` —
    rebuilt (cheap: one small array) on every state change."""

    def __init__(self, ranges: list[dict]):
        # each entry: {"lo", "hi", "src", "dst", "state"}
        self.ranges = [dict(r) for r in ranges]
        self._lock = threading.Lock()
        self._rebuild()

    def _rebuild(self) -> None:
        n = len(self.ranges)
        self._los = np.array([r["lo"] for r in self.ranges], np.uint64)
        # hi may be 2**64 (unrepresentable): compare against hi-1 inclusive
        self._his1 = np.array([r["hi"] - 1 for r in self.ranges], np.uint64)
        self._srcs = np.array([r["src"] for r in self.ranges], np.int32)
        self._dsts = np.array([r["dst"] for r in self.ranges], np.int32)
        self._codes = np.array(
            [_STATE_CODE[r["state"]] for r in self.ranges], np.int8
        ) if n else np.zeros(0, np.int8)

    def set_state(self, i: int, state: str) -> None:
        with self._lock:
            self.ranges[i]["state"] = state
            self._codes[i] = _STATE_CODE[state]

    def state(self, i: int) -> str:
        return self.ranges[i]["state"]

    def locate(self, pos: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """``(range index, in-a-migrating-arc mask)`` per ring position."""
        if not len(self.ranges):
            z = np.zeros(pos.shape, np.int64)
            return z, np.zeros(pos.shape, bool)
        ix = np.searchsorted(self._los, pos, side="right").astype(np.int64) - 1
        valid = ix >= 0
        ixc = np.clip(ix, 0, len(self.ranges) - 1)
        valid &= pos <= self._his1[ixc]
        return ixc, valid

    def counts(self) -> dict[str, int]:
        out = {s: 0 for s in STATES}
        for r in self.ranges:
            out[r["state"]] += 1
        return out


def route_keys(
    keys: np.ndarray, table: RangeTable, old_n: int, new_n: int, vnodes: int
) -> tuple[np.ndarray, np.ndarray]:
    """Per-key ``(read/write owner, dual-write target)`` while a reshard
    is live.  The dual target is ``-1`` outside a dual-write window; the
    primary is the OLD owner until an arc flips, the NEW owner after —
    exactly the lifecycle table in the module docstring."""
    from advanced_scrapper_tpu_torch.index.fleet import ring_assign

    keys = np.ascontiguousarray(keys, np.uint64).ravel()
    old = ring_assign(keys, old_n, vnodes)
    if not len(table.ranges):
        return old, np.full(keys.shape, -1, np.int32)
    new = ring_assign(keys, new_n, vnodes)
    ix, valid = table.locate(mix64(keys))
    codes = table._codes[ix]
    primary = np.where(valid & (codes >= _FLIPPED_CODE), new, old).astype(np.int32)
    dual = np.where(valid & (codes == _DUAL_CODE), new, -1).astype(np.int32)
    return primary, dual


# -- the migration WAL -------------------------------------------------------

def ledger_path(spill_dir: str, space: str) -> str:
    """The migration WAL's home — under the client's spill dir (the one
    durable directory the CLIENT owns), named ``reshard-wal-*`` so the
    chaos plane's WAL targeting (``only=wal-`` / ``only=reshard-wal``)
    reaches it."""
    return os.path.join(spill_dir, f"reshard-wal-{space}.json")


class ReshardLedger:
    """The durable cutover state machine: one JSON document, every write
    an ``atomic_replace`` — the commit point of every flip.

    A crash mid-write leaves the PREVIOUS whole document (that is what
    atomic replace means), so resume always reads a consistent snapshot:
    flipped/retired ranges are kept (their data is verified on the new
    owner — the flip write happened strictly after the digest match),
    everything else is voided back to ``pending`` and re-migrated.
    """

    VERSION = 1

    def __init__(self, path: str, doc: dict, fs=None):
        from advanced_scrapper_tpu_torch.storage.fsio import default_fs

        self.path = path
        self.fs = fs or default_fs()
        self.doc = doc

    # -- construction --------------------------------------------------------

    @classmethod
    def create(
        cls,
        path: str,
        *,
        old_n: int,
        new_n: int,
        vnodes: int,
        old_spec: str,
        new_spec: str,
        space: str,
        ranges,
        fs=None,
    ) -> "ReshardLedger":
        doc = {
            "version": cls.VERSION,
            "phase": "active",
            "old_n": int(old_n),
            "new_n": int(new_n),
            "vnodes": int(vnodes),
            "old_spec": old_spec,
            "new_spec": new_spec,
            "space": space,
            "voids": 0,
            "ranges": [
                {
                    "lo": int(r.lo), "hi": int(r.hi),
                    "src": int(r.src), "dst": int(r.dst),
                    "state": "pending",
                }
                for r in ranges
            ],
        }
        led = cls(path, doc, fs=fs)
        led.save()
        return led

    @classmethod
    def load(cls, path: str, fs=None) -> "ReshardLedger | None":
        from advanced_scrapper_tpu_torch.storage.fsio import default_fs

        fs = fs or default_fs()
        if not fs.exists(path):
            return None
        with fs.open(path, "rb") as fh:
            doc = json.loads(fh.read().decode("utf-8"))
        if int(doc.get("version", 0)) != cls.VERSION:
            raise ValueError(
                f"{path}: unknown reshard ledger version {doc.get('version')}"
            )
        for r in doc.get("ranges", []):
            if r.get("state") not in _STATE_CODE:
                raise ValueError(
                    f"{path}: unrepresentable range state {r.get('state')!r}"
                )
        return cls(path, doc, fs=fs)

    def save(self) -> None:
        from advanced_scrapper_tpu_torch.storage.fsio import atomic_replace

        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        atomic_replace(
            self.path,
            json.dumps(self.doc, indent=1).encode("utf-8"),
            fs=self.fs,
        )

    # -- state machine -------------------------------------------------------

    @property
    def phase(self) -> str:
        return self.doc["phase"]

    @property
    def ranges(self) -> list[dict]:
        return self.doc["ranges"]

    def mark(self, i: int, state: str) -> None:
        """Advance range ``i``; forward-only except the resume void
        (``dual_write → pending``), which goes through :meth:`void_unflipped`."""
        cur = self.doc["ranges"][i]["state"]
        if _STATE_CODE[state] <= _STATE_CODE[cur]:
            raise ValueError(
                f"range {i}: cannot move {cur!r} → {state!r} (forward-only)"
            )
        self.doc["ranges"][i]["state"] = state
        self.save()

    def void_unflipped(self) -> int:
        """The resume discipline: any range caught mid-window (armed but
        never sealed by a flip write) never happened.  Returns how many
        were voided; one durable write covers them all."""
        n = 0
        for r in self.doc["ranges"]:
            if r["state"] == "dual_write":
                r["state"] = "pending"
                n += 1
        if n:
            self.doc["voids"] = int(self.doc.get("voids", 0)) + n
            self.save()
        return n

    def finish(self) -> None:
        self.doc["phase"] = "done"
        self.save()

    def all_retired(self) -> bool:
        return all(r["state"] == "retired" for r in self.doc["ranges"])


# -- telemetry ---------------------------------------------------------------

def reshard_metrics(fleet_id: str) -> dict:
    """The ``astpu_reshard_*`` handles for one fleet client.  Counters are
    always-on (the crashsweep verifier reads them from a child report
    without the telemetry plane enabled); the page histograms are gated
    like every other volume series."""
    from advanced_scrapper_tpu_torch.obs import telemetry

    reg = telemetry.REGISTRY
    return {
        "pages": reg.counter(
            "astpu_reshard_pages_total",
            "migration pages streamed src → dst",
            always=True, fleet=fleet_id,
        ),
        "postings": reg.counter(
            "astpu_reshard_postings_moved_total",
            "semantic postings migrated to their new owner",
            always=True, fleet=fleet_id,
        ),
        "flips": reg.counter(
            "astpu_reshard_flips_total",
            "ranges atomically cut over to their new owner",
            always=True, fleet=fleet_id,
        ),
        "voids": reg.counter(
            "astpu_reshard_voids_total",
            "ranges voided back to pending on resume (crash mid-window)",
            always=True, fleet=fleet_id,
        ),
        "dual": reg.counter(
            "astpu_reshard_dual_writes_total",
            "insert batches dual-applied to a range's next owner",
            always=True, fleet=fleet_id,
        ),
        "retries": reg.counter(
            "astpu_reshard_digest_retries_total",
            "cutover digest mismatches that forced a re-stream",
            always=True, fleet=fleet_id,
        ),
        "page_s": telemetry.histogram(
            "astpu_reshard_page_seconds",
            "one migration page: fetch + push + ack",
            fleet=fleet_id,
        ),
        "page_b": telemetry.histogram(
            "astpu_reshard_page_bytes",
            "payload bytes per migration page",
            fleet=fleet_id,
        ),
    }


def register_state_gauges(fleet_id: str, table: RangeTable) -> None:
    """One ``astpu_reshard_range_state`` gauge per migrating arc (state
    code 0–3 per the lifecycle table) plus the in-flight total — gated,
    weakly owned by the table, so a finished reshard stops exporting."""
    from advanced_scrapper_tpu_torch.obs import telemetry

    for i in range(len(table.ranges)):
        telemetry.REGISTRY.gauge_fn(
            "astpu_reshard_range_state",
            lambda t, i=i: int(t._codes[i]),
            owner=table, fleet=fleet_id, range=str(i),
            help="cutover state per range: 0 pending, 1 dual_write, "
                 "2 flipped, 3 retired",
        )
    telemetry.REGISTRY.gauge_fn(
        "astpu_reshard_ranges_pending",
        lambda t: int((t._codes < _FLIPPED_CODE).sum()),
        owner=table, fleet=fleet_id,
        help="ranges not yet flipped to their new owner",
    )
