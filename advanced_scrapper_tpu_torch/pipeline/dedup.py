"""Near-duplicate dedup engine on the card.

Counterpart of the reference's ``pipeline/dedup.py:NearDupEngine``::

    chunk → segment → copy → CUDA MinHash segment fold, chunk by chunk →
    LSH candidate epilogue → [rerank tier | exact verify] → resolve →
    representatives

Articles are grouped, in order, into chunks of whole articles up to
``CHUNK_BYTES`` (``cpu.hostbatch.chunk_ranges``).  A chunk's bytes are
joined into one pinned buffer as they are, with no padding and no width
buckets, and copied to the card without blocking the host; its articles
are described as segments of at most ``ops.minhash.SEGMENT_SHINGLES``
shingles (``cpu.hostbatch.segment_ranges``), owned by the global article
index, and one kernel launch folds them into the ``uint32[n_bucket, 128]``
accumulator in place.  The join, the copy and the fold overlap as the
stages of ``pipeline.dispatch.PipelinedDispatcher`` (the knobs
``put_workers`` and ``dispatch_window``, defaulted from the perf ledger
by ``_resolve_knob_profile``); device memory holds a few chunks at a
time, whatever the corpus size, and a chunk that runs out of it is
halved at a segment boundary and retried.  The result does not depend on
``block_len``, ``batch_size`` or the knobs: every cut of an article keeps
its shingle set.

With no ``rerank_hook``, :meth:`NearDupEngine.dedup_reps_async` resolves
in one plain-PyTorch epilogue on the accumulator's device.  The default
configuration installs the rerank tier (``pipeline.rerank.RerankTier``)
as the hook: the candidate matrix and the signatures cross to the host,
the tier settles the pairs (its Jaccard on the card) and rewrites the
matrix, which goes back to the card to be resolved.  Without the tier,
:meth:`NearDupEngine.dedup_reps` confirms borderline edges by exact
Jaccard (``exact_verify_band``) before resolving.

``_host_tiles``, the reference's width-bucketed block chunker, feeds the
reference's legacy transport (``packed_h2d=False``: three copies and two
dispatches a tile, the signatures by ``minhash_signatures``) and the tile
path's timing (``ops.minhash.make_fused_tile_step``).  ``prewarm`` (and
``cfg.prewarm``) is a warm launch of each kernel the configuration runs.

:meth:`NearDupEngine.signatures_and_keys` serves the stream backend
(``extractors/tpu_batch.py``): one fold per chunk, then the keys epilogue,
and the keys (and, if asked, the signatures) read back.  :class:`ExactDedup`
is the first-seen exact dedup with its native tiers and hashed grouping.

Against a persistent index (``index.store.PersistentIndex``),
:meth:`NearDupEngine.dedup_against_index` attributes a corpus through the
same wide keys: ``open_stream_index`` opens one under a directory.

``backend="oph"`` (``ops.oph``) folds raw one-permutation signatures
(``oph_fold_segments`` a chunk, ``oph_sig`` a tile on the legacy
transport) into the same accumulator and densifies once after the fold
(``oph_densify``), in :meth:`NearDupEngine.signatures` or inside the
epilogue.

Decision provenance (``obs/decisions.py``): the certified one-shot
:meth:`NearDupEngine.dedup_reps` counts each document's verdict by the tier
that settled it (``astpu_decision_total{tier, verdict}``: ``rerank``,
``margin`` or ``band``), :meth:`NearDupEngine.dedup_against_index` at tier
``index`` and :class:`ExactDedup` at tier ``exact``; with the decision
journal on they also write one row a document, and only then read the band
keys (or re-probe the index) for the rows' winning band.  An installed
``ladder`` (``runtime/admission.py:DegradationLadder``) is honoured at three
points: ``shrink_window`` halves the dispatcher's window, ``skip_rerank``
bypasses the rerank hook, ``fewer_bands`` keeps the first half of the band
columns in :meth:`NearDupEngine.dedup_against_index`; each application is
counted by ``ladder.count_effect``.

:meth:`NearDupEngine.open_stream_index` opens the index fleet when
``cfg.index_fleet`` is set.

Over a device mesh (``core.mesh.build_mesh``, ``parallel/``),
:meth:`NearDupEngine.dedup_reps_sharded` runs the packed tile plane: the
reference's width-bucketed tiles (:meth:`_host_tiles`) in groups of one
tile a shard, each shard's tile packed, copied to its device and folded
into its own accumulator (``minhash_fold`` or ``oph_fold``, one launch a
shard a group), and one end-of-corpus epilogue that ``pmin``-combines the
shards and resolves; each shard's ledger (``obs.stages``, ``shard=``) is
tiles + 1 copies and tiles + 1 dispatches.  With ``packed_h2d=False`` it
runs the reference's blockwise plane
(``parallel.sharded.make_sharded_block_dedup``).
``dedup_against_index(mesh=...)`` takes its wide keys off the same plane.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from advanced_scrapper_tpu_torch import resolve_device
from advanced_scrapper_tpu_torch.config import DedupConfig
from advanced_scrapper_tpu_torch.core.hashing import MinHashParams, make_params
from advanced_scrapper_tpu_torch.core.mesh import ShardedArray
from advanced_scrapper_tpu_torch.core.tokenizer import (
    bucket_len,
    bucket_widths,
    encode_blocks,
    tile_rows_options,
    to_bytes,
)
from advanced_scrapper_tpu_torch.cpu.exactdedup import keep_first_list
from advanced_scrapper_tpu_torch.cpu.hostbatch import (
    block_counts,
    chunk_ranges,
    encode_blocks_ranges,
    exact_keep_first_native,
    segment_ranges,
)
from advanced_scrapper_tpu_torch.cpu.oracle import jaccard, shingle_set
from advanced_scrapper_tpu_torch.obs import devprof, stages, telemetry, trace
from advanced_scrapper_tpu_torch.obs.decisions import get_recorder
from advanced_scrapper_tpu_torch.obs.perfdb import platform_token
from advanced_scrapper_tpu_torch.obs.profiler import StepTimer
from advanced_scrapper_tpu_torch.ops.exact import ExactHasher
from advanced_scrapper_tpu_torch.ops.lsh import (
    borderline_edge_mask,
    fine_edge_thresholds,
    fused_candidate_epilogue,
    fused_keys_epilogue,
    fused_resolve_epilogue,
    resolve_rep_bands,
    resolve_rep_bands_from_ok,
    subband_salt,
)
from advanced_scrapper_tpu_torch.ops.minhash import (
    SEGMENT_SHINGLES,
    accumulate_block_signatures,
    check_backend,
    fold_segments,
    minhash_signatures,
    perm_tensors,
)
from advanced_scrapper_tpu_torch.ops.oph import densify, oph_fold_segments, oph_raw_signatures
from advanced_scrapper_tpu_torch.ops.pack import pack_tile, packed_nbytes
from advanced_scrapper_tpu_torch.ops.shingle import to_u32
from advanced_scrapper_tpu_torch.parallel.sharded import make_sharded_block_dedup
from advanced_scrapper_tpu_torch.parallel.sharded_packed import (
    assemble_packed_tiles,
    local_shard_rows,
    make_sharded_accumulator_init,
    make_sharded_fused_tile_step,
    make_sharded_keys_epilogue,
    make_sharded_resolve_epilogue,
    mesh_num_shards,
    shard_row_devices,
)
from advanced_scrapper_tpu_torch.pipeline.clock import StageClock
from advanced_scrapper_tpu_torch.pipeline.dispatch import (
    PipelinedDispatcher,
    auto_h2d_workers,
    dispatch_with_oom_backoff,
    resolve_dispatch_window,
)
from advanced_scrapper_tpu_torch.pipeline.rerank import RerankTier
from advanced_scrapper_tpu_torch.utils.bloom import pack_keys64

#: Most bytes of text in one chunk (one copy, one kernel launch); an
#: article longer than this is a chunk of its own.
CHUNK_BYTES = 64 << 20
#: Most bytes joined by one ``bytes.join`` while filling a chunk's pinned
#: buffer: small joins reuse warm heap memory, where one large join takes
#: fresh pages from the kernel and faults on every one of them.
JOIN_BYTES = 4 << 20
#: the OOM back-off's floor: a chunk of one segment is not split further
#: (the reference's floor is a tile of 64 rows)
OOM_FLOOR_SEGMENTS = 1


def _jump_rounds(n: int) -> int:
    r = 1
    while (1 << r) < n:
        r += 1
    return r


def _tile_bs(cfg: DedupConfig, width: int) -> int:
    """Full-tile row count for a width bucket: peak bytes per tile stay
    ``batch_size × block_len``, so rows scale up as the bucket narrows."""
    return min(max(cfg.batch_size * cfg.block_len // width, 64), 16384)


def _tile_rows_options(bs: int) -> list[int]:
    """Every row count the greedy chunker can emit for a width bucket."""
    return tile_rows_options(bs, 64)


def _prewarm_widths(cfg: DedupConfig) -> list[int]:
    """The chunker's width buckets: powers of two below ``block_len``, plus
    ``block_len`` itself."""
    widths = []
    w = 64
    while w < cfg.block_len:
        widths.append(w)
        w *= 2
    widths.append(cfg.block_len)
    return widths


#: dispatch knobs the perf-ledger profile may resolve, with the explicit
#: env key that always wins over a ledger row (the reference's third,
#: ``rerank_tile_rows``, sizes nothing in the port and is left out)
_KNOB_PROFILE_FIELDS: tuple[tuple[str, str], ...] = (
    ("put_workers", "ASTPU_DEDUP_PUT_WORKERS"),
    ("dispatch_window", "ASTPU_DEDUP_DISPATCH_WINDOW"),
)


def _resolve_knob_profile(cfg: DedupConfig, platform: str) -> DedupConfig:
    """Fill still-default dispatch knobs from the perf ledger's best
    sweep row of ``platform`` (``obs.perfdb.platform_token`` of the
    engine's device).  Per knob, in order:

    1. an explicit env key (``ASTPU_DEDUP_PUT_WORKERS`` etc.) wins, so a
       directly constructed ``DedupConfig()`` honours it as a
       ``config.from_env`` one does;
    2. a caller-pinned value (the field differs from the default);
    3. the best same-platform sweep row of ``$ASTPU_PERF_LEDGER``
       (``obs.perfdb.best_knob_profile``);
    4. the dataclass default.
    """
    defaults = DedupConfig()
    env_updates: dict[str, int] = {}
    open_knobs: list[str] = []
    for f, env_key in _KNOB_PROFILE_FIELDS:
        raw = os.environ.get(env_key)
        if raw is not None:
            try:
                env_updates[f] = int(raw)
            except ValueError:
                pass  # malformed env: leave the field as constructed
            continue
        if getattr(cfg, f) == getattr(defaults, f):
            open_knobs.append(f)
    if env_updates:
        cfg = dataclasses.replace(cfg, **env_updates)
    path = os.environ.get("ASTPU_PERF_LEDGER", "")
    if not path or not os.path.exists(path) or not open_knobs:
        return cfg
    from advanced_scrapper_tpu_torch.obs.perfdb import best_knob_profile

    profile = best_knob_profile(path, platform)  # a torn ledger reads as no rows
    updates = {k: v for k, v in profile.items() if k in open_knobs and v}
    return dataclasses.replace(cfg, **updates) if updates else cfg


def resolve_put_workers(cfg: DedupConfig) -> int:
    """Effective put-thread count: ``cfg.put_workers``, with 0 meaning the
    transport default (``pipeline.dispatch.auto_h2d_workers``: 1)."""
    return cfg.put_workers or auto_h2d_workers()


@dataclass
class _Chunk:
    """A chunk on its way to the fold: its host text and segment
    descriptors (pinned on the card), and the text's copy on the device
    once the put stage made it (``None`` until then)."""

    text: torch.Tensor
    start: torch.Tensor
    shingles: torch.Tensor
    owner: torch.Tensor
    text_dev: torch.Tensor | None = None
    put_s: float = 0.0


class NearDupEngine:
    """Batch near-duplicate detector on one device.

    ``device=None`` means ``"cuda"`` and raises without a card; pass
    ``device="cpu"`` to run the plain PyTorch versions of the kernel.
    """

    def __init__(
        self,
        cfg: DedupConfig | None = None,
        params: MinHashParams | None = None,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        # still-default dispatch knobs from the perf ledger's best row for
        # this device's platform; explicit env and pinned fields win
        self.cfg = _resolve_knob_profile(cfg or DedupConfig(), platform_token(self.device))
        self.params = params or make_params(
            num_perm=self.cfg.num_perm,
            num_bands=self.cfg.num_bands,
            shingle_k=self.cfg.shingle_k,
            seed=self.cfg.seed,
        )
        check_backend(self.cfg.backend, self.params.num_perm)
        #: the OPH backend folds raw signatures and densifies after the fold
        self._use_oph = self.cfg.backend == "oph"
        self._perm = perm_tensors(self.params, self.device)
        #: chunks (tiles on the unpacked transport) of the last corpus, each
        #: folded by one kernel launch unless the OOM back-off halved it;
        #: its halvings (each adds a launch); the bytes it copied to the
        #: device; and its dispatcher, with the staged items' lag and each
        #: stage's times (``None`` for a corpus of one chunk)
        self.last_chunks = 0
        self.last_halvings = 0
        self.last_h2d_bytes = 0
        self.last_dispatcher: PipelinedDispatcher | None = None
        #: tile groups of the last corpus on a mesh (one fold a shard each)
        self.last_tiles = 0
        #: the mesh planes' steps and epilogues, by (mesh, what)
        self._sharded_steps: dict = {}
        #: the hook on the candidates → resolve edge: every resolution path
        #: passes the candidate matrix through it (None = pass-through).
        #: ``cfg.rerank`` installs the precision tier, kept as
        #: ``rerank_tier`` for its per-corpus stats
        self.rerank_hook = None
        self.rerank_tier = None
        if self.cfg.rerank:
            self.rerank_tier = RerankTier(self.cfg, self.params, device=self.device)
            self.rerank_hook = self.rerank_tier
        #: whether the last corpus's candidates passed through an
        #: authoritative hook, whose rewritten cells are resolved as they are
        self._rerank_applied = False
        #: optional ``runtime.admission.DegradationLadder``: while one of its
        #: steps ``shrink_window``, ``skip_rerank`` or ``fewer_bands`` is
        #: active, the engine halves the dispatcher's window, bypasses the
        #: rerank hook or probes half the bands, and counts each application
        #: with ``ladder.count_effect`` (None = full service)
        self.ladder = None
        #: the pairs the last exact verify settled, ``(lo, hi) -> verdict``
        #: (the ``margin`` tier of the decision counts)
        self._last_exact_pairs: dict[tuple[int, int], bool] = {}
        #: host-clock seconds and device times of the last hooked or
        #: verified corpus's stages, and the exact checks of the last
        #: exact verify
        self.last_clock = StageClock(self.device)
        self.last_exact_checks = 0
        #: optional per-chunk observer ``(dict) -> None`` on the fold loop
        #: (chunk index, segments, text bytes, h2d bytes, put and
        #: dispatch ms); None = no per-chunk host work
        self.dispatch_probe = None
        self._instrument()
        #: warm launches made by ``cfg.prewarm`` at construction
        self.prewarm_launches = 0
        if self.cfg.prewarm and self.cfg.packed_h2d:
            self.prewarm_launches = self.prewarm(
                None if self.cfg.prewarm == 1 else self.cfg.prewarm
            )

    def _instrument(self) -> None:
        """Telemetry handles, the reference's series (no-ops while
        telemetry is disabled), and the ``StepTimer`` every fold launch
        lands in (:meth:`step_summary`)."""
        self.step_timer = StepTimer(
            histogram=telemetry.histogram(
                "astpu_dedup_step_seconds", "device block-batch dispatch latency"
            )
        )
        self._m_batches = telemetry.counter(
            "astpu_dedup_batches_total", "device block batches dispatched"
        )
        self._m_docs = {
            regime: telemetry.counter(
                "astpu_dedup_docs_total", "documents entering dedup", regime=regime
            )
            for regime in ("oneshot", "async", "sharded")
        }
        self._m_dups = {
            regime: telemetry.counter(
                "astpu_dedup_dups_total", "documents resolved as near-duplicates",
                regime=regime,
            )
            for regime in ("oneshot", "sharded")
        }
        self._m_ratio = {
            regime: telemetry.gauge(
                "astpu_dedup_ratio", "last corpus' duplicate fraction", regime=regime
            )
            for regime in ("oneshot", "sharded")
        }
        self._m_cand = telemetry.counter(
            "astpu_dedup_candidate_pairs_total",
            "LSH candidate (row, band) hits examined by the certified "
            "one-shot resolution (async/sharded never sync candidates)",
        )
        self._m_borderline = telemetry.counter(
            "astpu_dedup_borderline_edges_total",
            "estimator-fragile edges flagged for exact confirmation",
        )
        self._m_exact_checks = telemetry.counter(
            "astpu_dedup_exact_checks_total",
            "exact shingle-set Jaccard confirmations run",
        )

    def step_summary(self) -> dict:
        """Rolling per-launch latency/throughput (``StepTimer.summary``)."""
        return self.step_timer.summary()

    def _count_result(self, regime: str, n: int, reps: np.ndarray) -> None:
        """Duplicate count and ratio of a corpus whose representatives are
        on the host; skipped while telemetry is disabled."""
        if n == 0 or self._m_dups[regime] is telemetry.NOOP:
            return
        dups = int((reps[:n] != np.arange(n)).sum())
        self._m_dups[regime].inc(dups)
        self._m_ratio[regime].set(dups / n)

    # -- host encode ---------------------------------------------------------

    def _host_tiles(self, raw: list):
        """Width-bucketed power-of-two tiles ``(tok, lens, owners)``, lazily.

        Every document becomes one tail range, routed to the power-of-two
        width bucket of its length, plus — when longer than ``block_len`` —
        one body range that encodes as its full ``block_len`` blocks.  The
        block set is that of a whole-document split; only the tails ride
        narrower rows.  Each width group is cut into full tiles of
        ``_tile_bs`` rows, then descending power-of-two chunks (≥ 64, the
        last zero-padded), so every corpus draws from the same shape set.
        """
        cfg, params = self.cfg, self.params
        n = len(raw)
        overlap = params.shingle_k - 1
        stride = cfg.block_len - overlap
        lens = np.fromiter(map(len, raw), np.int64, count=n)
        doc_off = np.zeros((n + 1,), dtype=np.int64)
        np.cumsum(lens, out=doc_off[1:])
        # zero padding lets every block_len window of the blob be read in place
        blob = b"".join([*raw, bytes(cfg.block_len)])
        m = block_counts(lens, cfg.block_len, overlap)
        tail_start = (m - 1) * stride
        tail_len = lens - tail_start
        body_sel = np.flatnonzero(m > 1)
        range_starts = np.concatenate([doc_off[:n] + tail_start, doc_off[:n][body_sel]])
        range_lens = np.concatenate([tail_len, tail_start[body_sel] + overlap])
        range_owner = np.concatenate([np.arange(n, dtype=np.int64), body_sel])
        range_width = np.concatenate([
            bucket_widths(tail_len, max_bucket=cfg.block_len),
            np.full((len(body_sel),), cfg.block_len, np.int64),
        ])
        order = np.argsort(range_width, kind="stable")
        sorted_w = range_width[order]
        n_ranges = len(order)
        group_lo = (
            np.flatnonzero(np.r_[True, sorted_w[1:] != sorted_w[:-1]])
            if n_ranges
            else np.zeros((0,), np.int64)
        )
        for g, lo in enumerate(group_lo):
            hi = group_lo[g + 1] if g + 1 < len(group_lo) else n_ranges
            idx = order[lo:hi]
            w = int(sorted_w[lo])
            r_lens = range_lens[idx]
            tok, blk_lens, owners_local = encode_blocks_ranges(
                blob, range_starts[idx], r_lens,
                block_counts(r_lens, w, overlap), w, overlap,
            )
            owners = range_owner[idx].astype(np.int32)[owners_local]
            n_blocks = tok.shape[0]
            bs = _tile_bs(cfg, w)
            start = 0
            while start < n_blocks:
                remaining = n_blocks - start
                rows = bs
                if remaining < bs:
                    rows = 64
                    while rows * 2 <= remaining:
                        rows *= 2
                t = tok[start : start + rows]
                l = blk_lens[start : start + rows]
                o = owners[start : start + rows]
                if t.shape[0] < rows:
                    pad = rows - t.shape[0]
                    t = np.concatenate([t, np.zeros((pad, w), np.uint8)])
                    l = np.concatenate([l, np.zeros((pad,), np.int32)])
                    o = np.concatenate([o, np.zeros((pad,), np.int32)])
                yield t, l, o
                start += rows

    def _chunk_specs(self, lens: np.ndarray, ranges: list | None = None):
        """The chunks of whole articles (``ranges``, by default
        ``chunk_ranges``) that hold a shingle, lazily, as ``(lo, hi, off,
        seg_start, seg_shingles, seg_owner)``: the articles ``[lo, hi)``,
        their byte offsets in the chunk, and their segments
        (``segment_ranges``; owners are global article indices)."""
        k = self.params.shingle_k
        if ranges is None:
            ranges = chunk_ranges(lens, CHUNK_BYTES)
        for lo, hi in ranges:
            off = np.zeros((hi - lo + 1,), np.int64)
            np.cumsum(lens[lo:hi], out=off[1:])
            start, shingles, owner = segment_ranges(
                off[:-1], lens[lo:hi], np.arange(lo, hi), k, SEGMENT_SHINGLES
            )
            if len(start):
                yield lo, hi, off, start, shingles, owner

    def _pack_chunk(self, raw: list, lens: np.ndarray, spec) -> tuple:
        """A chunk's ``(text uint8[T], seg_start int64[G], seg_shingles
        int32[G], seg_owner int32[G])`` CPU tensors, pinned when the engine
        runs on the card: its bytes joined as they are, ``JOIN_BYTES`` at a
        time, and its descriptors in one buffer."""
        lo, hi, off, start, shingles, owner = spec
        g = len(start)
        pin = self.device.type == "cuda"
        text = torch.empty((int(off[-1]),), dtype=torch.uint8, pin_memory=pin)
        buf = text.numpy()
        for a, b in chunk_ranges(lens[lo:hi], JOIN_BYTES):
            buf[off[a] : off[b]] = np.frombuffer(b"".join(raw[lo + a : lo + b]), np.uint8)
        desc = torch.empty((16 * g,), dtype=torch.uint8, pin_memory=pin)
        d = desc.numpy()
        d[: 8 * g].view(np.int64)[:] = start
        d[8 * g : 12 * g].view(np.int32)[:] = shingles
        d[12 * g :].view(np.int32)[:] = owner
        return (
            text,
            desc[: 8 * g].view(torch.int64),
            desc[8 * g : 12 * g].view(torch.int32),
            desc[12 * g :].view(torch.int32),
        )

    def _host_chunks(self, raw: list):
        """The main path's host work, serially: :meth:`_pack_chunk` of
        every chunk of :meth:`_chunk_specs`."""
        lens = np.fromiter(map(len, raw), np.int64, count=len(raw))
        for spec in self._chunk_specs(lens):
            yield self._pack_chunk(raw, lens, spec)

    def _split_chunk(self, chunk: _Chunk) -> list[_Chunk]:
        """The OOM back-off's split: the chunk's segments cut in two halves
        at a segment boundary, each with the span of text its segments read
        (first start to last end + k − 1) and its starts rebased.  Exact:
        each segment keeps its bytes.  The chunk's device copy is dropped
        first, so its memory is free for the halves."""
        chunk.text_dev = None
        self.last_halvings += 1
        k = self.params.shingle_k
        g = chunk.start.numel()
        halves = []
        for a, b in ((0, g // 2), (g // 2, g)):
            start, shingles = chunk.start[a:b], chunk.shingles[a:b]
            s0 = int(start[0])
            end = int((start + shingles).max()) + k - 1
            halves.append(_Chunk(chunk.text[s0:end], start - s0, shingles, chunk.owner[a:b]))
        return halves

    # -- device accumulation ---------------------------------------------------

    def _accumulate_device(
        self, raw: list, clock: StageClock | None = None, trace_id: str | None = None
    ) -> tuple[torch.Tensor, int]:
        """``(running, n_bucket)``: the device ``uint32[n_bucket, P]``
        accumulator after folding every chunk of ``raw`` into it.  Rows
        past ``len(raw)`` stay all-``U32_MAX``.

        Several chunks run through :class:`PipelinedDispatcher`: the
        ``pack`` stage joins a chunk into its pinned buffer
        (:meth:`_pack_chunk`), ``put_workers`` threads
        (:func:`resolve_put_workers`) copy it to the card with
        ``non_blocking=True``, and this thread folds each staged chunk
        (``dispatch_window`` of them may wait, resolved by
        ``resolve_dispatch_window``) with one launch of
        ``minhash_fold_segments``.  The min-fold does not depend on the
        order chunks arrive in.  Every copy runs on this thread's current
        stream, so each fold is ordered after its copy, the caching
        allocator sees one stream, and PyTorch's pinned cache keeps a host
        buffer out of reuse until its copy has completed.  A corpus of one
        chunk (a stream batch) has nothing to overlap: this thread packs,
        copies and folds it, with no graph and no threads
        (``last_dispatcher`` is then ``None``).

        A fold that runs out of device memory (at the copy or in the
        kernel; ``ASTPU_CHAOS_DISPATCH_OOM`` injects one) is halved by
        :meth:`_split_chunk` and retried, down to one segment
        (:func:`dispatch_with_oom_backoff`); a copy the put stage could not
        make is made here.  With ``packed_h2d=False`` the reference's
        legacy transport runs instead (:meth:`_accumulate_tiles`).

        With a ``clock``, each chunk laps ``encode``, ``copy`` (a copy made
        on this thread) and ``fold``.  ``encode`` is the join of a lone
        chunk, and through the dispatcher the wait for the next staged
        chunk, whose join and copy ran on the pipeline's threads.

        Each join is timed into the ``encode`` stage, each copy into
        ``h2d`` (one device put of the chunk's text), each fold launch into
        ``kernel``, ``step_timer`` and ``dispatch_span("dedup_fold_segments",
        rows=segments, width=text bytes)``, and counted as one dispatch
        once it returned (so the back-off's leaf launches are what count).
        """
        dev = self.device
        tid = trace_id or trace.new_trace_id()
        n_bucket = bucket_len(len(raw), min_bucket=64)
        running = torch.full(
            (n_bucket, self.params.num_perm), -1, dtype=torch.int32, device=dev
        ).view(torch.uint32)
        self.last_halvings = 0
        if not self.cfg.packed_h2d:
            self._accumulate_tiles(raw, running, tid)
            return running, n_bucket
        lens = np.fromiter(map(len, raw), np.int64, count=len(raw))
        stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        h2d = 0

        def copy(chunk: _Chunk) -> None:
            t0 = time.perf_counter()
            chunk.text_dev = chunk.text.to(dev, non_blocking=True)
            chunk.put_s = time.perf_counter() - t0
            stages.add("h2d", chunk.put_s)
            stages.count_device_put(chunk.text.numel(), "dedup")

        def pack(spec) -> _Chunk:
            with stages.timed("encode"):
                return _Chunk(*self._pack_chunk(raw, lens, spec))

        def put(chunk: _Chunk) -> _Chunk:
            with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
                try:
                    copy(chunk)
                except torch.cuda.OutOfMemoryError:
                    pass  # the fold's back-off copies it, halving on OOM
            return chunk

        def fold(acc: torch.Tensor, chunk: _Chunk) -> torch.Tensor:
            nonlocal h2d
            if chunk.text_dev is None:
                copy(chunk)
            if clock is not None:
                clock.lap("copy")
            with devprof.dispatch_span(
                "dedup_fold_segments", rows=chunk.start.numel(),
                width=chunk.text.numel(), trace=tid,
            ) as sp:
                sp.out = self._fold(
                    acc, chunk.text_dev, chunk.start, chunk.shingles, chunk.owner
                )
            stages.count_dispatch("dedup")
            if clock is not None:
                clock.lap("fold")
            h2d += chunk.text.numel() + 16 * chunk.start.numel()
            return acc

        ranges = chunk_ranges(lens, CHUNK_BYTES)
        specs = self._chunk_specs(lens, ranges)
        pipe = self.last_dispatcher = (
            PipelinedDispatcher(
                specs, pack=pack, put=put,
                put_workers=resolve_put_workers(self.cfg), window=self._dispatch_window(),
            )
            if len(ranges) > 1
            else None
        )
        chunks = 0
        probe = self.dispatch_probe
        try:
            for chunk in pipe if pipe is not None else map(pack, specs):
                if clock is not None:
                    clock.lap("encode")
                segments, put_s, before = chunk.start.numel(), chunk.put_s, h2d
                t0 = time.perf_counter()
                with stages.timed("kernel"), self.step_timer.step(segments):
                    running = dispatch_with_oom_backoff(
                        fold, running, chunk, split=self._split_chunk,
                        rows_of=lambda c: c.start.numel(), floor=OOM_FLOOR_SEGMENTS,
                    )
                if probe is not None:
                    probe({
                        "tile": chunks, "rows": segments, "width": chunk.text.numel(),
                        "h2d_bytes": h2d - before, "put_ms": round(put_s * 1e3, 3),
                        "dispatch_ms": round((time.perf_counter() - t0) * 1e3, 3),
                    })
                chunks += 1
        finally:
            if pipe is not None:
                pipe.close()
        self.last_chunks, self.last_h2d_bytes = chunks, h2d
        self._m_batches.inc(chunks)
        if trace.RECORDER.active:
            trace.record("span", "dedup.dispatch", trace=tid, batches=chunks, docs=len(raw))
        return running, n_bucket

    def _dispatch_window(self) -> int:
        """The window of a corpus's dispatcher: ``cfg.dispatch_window``, or
        while the ladder's ``shrink_window`` step is active half the
        effective window (at least 1), counted once a dispatcher."""
        window = self.cfg.dispatch_window
        if self.ladder is not None and self.ladder.active("shrink_window"):
            workers = resolve_put_workers(self.cfg)
            window = max(1, resolve_dispatch_window(window, workers) // 2)
            self.ladder.count_effect("shrink_window")
        return window

    def _fold(self, running, text, seg_start, seg_shingles, seg_owner) -> torch.Tensor:
        """One segment fold into ``running``: ``minhash_fold_segments``,
        or under ``backend="oph"`` the raw ``oph_fold_segments`` (plain
        versions on the CPU)."""
        if self._use_oph:
            return oph_fold_segments(
                running, text, seg_start, seg_shingles, seg_owner, self.params
            )
        return fold_segments(
            running, text, seg_start, seg_shingles, seg_owner, self.params, self._perm
        )

    def _accumulate_tiles(self, raw: list, running: torch.Tensor, tid: str) -> None:
        """Fold ``raw`` into ``running`` by the reference's legacy tile
        transport (``packed_h2d=False``): the width-bucketed tiles of
        :meth:`_host_tiles` through the dispatcher, three copies a tile
        (tokens, lengths, owners), then two dispatches on this thread:
        ``minhash_signatures`` (the ``minhash_sig`` kernel on the card; the
        raw ``oph_raw_signatures``, ``oph_sig``, under ``backend="oph"``)
        and ``accumulate_block_signatures``.  No OOM back-off, as in the
        reference."""
        dev = self.device
        block_fn = oph_raw_signatures if self._use_oph else minhash_signatures
        stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None

        def put(tile) -> tuple:
            with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
                with stages.timed("h2d"):
                    out = tuple(torch.from_numpy(x).to(dev) for x in tile)
            for x in tile:
                stages.count_device_put(x.nbytes, "dedup")
            return out

        pipe = self.last_dispatcher = PipelinedDispatcher(
            self._host_tiles(raw), pack=lambda tile: tile, put=put,
            put_workers=resolve_put_workers(self.cfg), window=self._dispatch_window(),
        )
        tiles = h2d = 0
        try:
            for tok, lens, owners in pipe:
                rows, width = tok.shape
                with stages.timed("kernel"), self.step_timer.step(rows):
                    with devprof.dispatch_span(
                        "dedup_tile_sig", rows=rows, width=width, trace=tid
                    ) as sp:
                        sp.out = block_fn(tok, lens, self.params)
                    stages.count_dispatch("dedup")
                    accumulate_block_signatures(running, sp.out, owners)
                tiles += 1
                h2d += tok.numel() + 4 * lens.numel() + 4 * owners.numel()
        finally:
            pipe.close()
        self.last_chunks, self.last_h2d_bytes = tiles, h2d
        self._m_batches.inc(tiles)

    def _fine_salt(self) -> np.ndarray:
        """``subband_salt(cand_subbands)``, or empty when fine bands are off."""
        cs = self.cfg.cand_subbands
        if not cs:
            return np.zeros((0,), np.uint32)
        if self.params.num_perm % cs:
            raise ValueError(
                f"cand_subbands {cs} must divide num_perm {self.params.num_perm} "
                "(each sub-band folds num_perm/cand_subbands signature rows)"
            )
        return subband_salt(cs)

    def _valid_host(self, raw: list, n_bucket: int) -> np.ndarray:
        """``bool[n_bucket]``: rows with at least one k-shingle."""
        lens = np.fromiter(map(len, raw), np.int64, count=len(raw))
        valid = np.zeros((n_bucket,), bool)
        valid[: len(raw)] = lens >= self.params.shingle_k
        return valid

    def _valid_device(self, raw: list, n_bucket: int) -> torch.Tensor:
        """Device ``bool[n_bucket]``: rows with at least one k-shingle
        (counted as the corpus's one device put beside its chunks)."""
        valid = self._valid_host(raw, n_bucket)
        stages.count_device_put(valid.nbytes, "dedup")
        return torch.from_numpy(valid).to(self.device)

    def _count_densify(self) -> None:
        """Count the OPH densify an epilogue launches (one a corpus)."""
        if self._use_oph:
            stages.count_dispatch("dedup")

    def _prepare(self, texts: Sequence[str | bytes], tid: str):
        """Front half of the hooked and verified paths: encode → device
        accumulator → candidate epilogue → the hook, if any.  With a hook,
        ``sigs``, ``rep_bands`` and ``valid`` cross to the host (the
        signatures as their ``int32`` view, read as ``uint32``), the hook
        rewrites the matrix, and the rewritten matrix goes back to the
        device; while the ladder's ``skip_rerank`` step is active the hook
        is bypassed (counted) and nothing crosses.  Returns ``(raw, sigs, keys, valid, rep_bands, n_bucket)``
        on the device.  A new ``last_clock`` laps ``fold`` (encode, copy,
        fold), ``candidate_epilogue`` and, with a hook, ``readback``,
        ``hook`` and ``writeback``; the caller laps ``resolve``.  The
        epilogue is timed into the ``resolve`` stage under the
        ``dedup.candidates`` span of trace ``tid``, the hook under
        ``dedup.rerank``."""
        clock = self.last_clock = StageClock(self.device)
        raw = [to_bytes(t) for t in texts]
        running, n_bucket = self._accumulate_device(raw, trace_id=tid)
        clock.lap("fold")
        valid_host = self._valid_host(raw, n_bucket)
        valid = torch.from_numpy(valid_host).to(self.device)
        stages.count_device_put(valid_host.nbytes, "dedup")
        with stages.timed("resolve"), trace.span("dedup.candidates", trace=tid, docs=len(raw)):
            sigs, keys, rep_bands = fused_candidate_epilogue(
                running, valid, self.params.band_salt, self._fine_salt(),
                densify_oph=self._use_oph,
            )
            self._count_densify()
        clock.lap("candidate_epilogue")
        self._rerank_applied = False
        if self.rerank_hook is None:
            return raw, sigs, keys, valid, rep_bands, n_bucket
        if self.ladder is not None and self.ladder.active("skip_rerank"):
            # brownout: the candidates pass through unreranked, counted
            self.ladder.count_effect("skip_rerank")
            return raw, sigs, keys, valid, rep_bands, n_bucket
        sigs_host = sigs.view(torch.int32).cpu().numpy().view(np.uint32)
        rb_host = rep_bands.cpu().numpy()
        clock.lap("readback")
        with trace.span("dedup.rerank", trace=tid, docs=len(raw)):
            rb_host = np.asarray(self.rerank_hook(raw, sigs_host, rb_host, valid_host))
        clock.lap("hook")
        rep_bands = torch.from_numpy(rb_host).to(self.device)
        stages.count_device_put(rb_host.nbytes, "dedup")
        clock.lap("writeback")
        self._rerank_applied = bool(getattr(self.rerank_hook, "authoritative", False))
        return raw, sigs, keys, valid, rep_bands, n_bucket

    def _resolve_authoritative(self, rep_bands, valid, n_bucket) -> torch.Tensor:
        """An authoritative hook's rewritten cells are settled edges: every
        non-self cell is resolved as it is (no ``valid`` mask on ``ok``)."""
        idx = torch.arange(rep_bands.shape[0], dtype=rep_bands.dtype, device=rep_bands.device)
        ok = rep_bands != idx[:, None]
        return resolve_rep_bands_from_ok(
            rep_bands, ok, valid, jump_rounds=_jump_rounds(n_bucket)
        )

    def _exact_verified_ok(self, raw, sigs, keys, valid, rep_bands):
        """The verified-edge matrix with its fragile edges confirmed or
        refuted by exact shingle-set Jaccard (``cpu.oracle``).

        ``borderline_edge_mask`` flags the edges that clear
        ``sim_threshold`` but are fine-only or below ``exact_verify_band``;
        they are walked in row-major order, each undirected pair settled
        once.  Past ``exact_verify_cap`` exact checks a pair keeps the
        estimator's verdict at the strict bar ``sim_threshold +
        fine_margin``.  Returns ``ok`` (on the device when nothing was
        flagged, else on the host) and the number of exact checks; the
        settled pairs stay in ``_last_exact_pairs``."""
        cfg = self.cfg
        need_dev, ok_dev = borderline_edge_mask(
            rep_bands, sigs, keys, valid, cfg.sim_threshold, cfg.exact_verify_band,
            num_coarse=self.params.num_bands,
        )
        need = need_dev.cpu().numpy()
        self._last_exact_pairs = {}
        if self._m_cand is not telemetry.NOOP:
            # metric-only host work, before the early return: candidate
            # volume must not read 0 because every edge cleared the bar
            rb_m = rep_bands.cpu().numpy()
            self._m_cand.inc(int((rb_m != np.arange(rb_m.shape[0])[:, None]).sum()))
            self._m_borderline.inc(int(need.sum()))
        if not need.any():
            return ok_dev, 0
        rb = rep_bands.cpu().numpy()
        ok = ok_dev.cpu().numpy().copy()
        pairs: dict[tuple[int, int], bool] = {}  # an edge is undirected
        shingles: dict[int, set] = {}

        def sset(i: int) -> set:
            if i not in shingles:
                shingles[i] = shingle_set(raw[i], self.params.shingle_k)
            return shingles[i]

        checked = 0
        sigs_np = None
        for r, c in zip(*(x.tolist() for x in np.nonzero(need))):
            j = int(rb[r, c])
            key = (min(r, j), max(r, j))
            if key not in pairs:
                if checked >= cfg.exact_verify_cap:
                    if sigs_np is None:
                        sigs_np = sigs.view(torch.int32).cpu().numpy()
                    agree = float((sigs_np[key[0]] == sigs_np[key[1]]).mean())
                    pairs[key] = agree >= cfg.sim_threshold + cfg.fine_margin
                else:
                    checked += 1
                    pairs[key] = jaccard(sset(key[0]), sset(key[1])) >= cfg.sim_threshold
            if not pairs[key]:
                ok[r, c] = False  # exact Jaccard (or the strict bar) refuted it
        self._m_exact_checks.inc(checked)
        self._last_exact_pairs = pairs
        return ok, checked

    # -- public API ------------------------------------------------------------

    def signatures(self, texts: Sequence[str | bytes]) -> np.ndarray:
        """``uint32[N, num_perm]`` MinHash signatures (blockwise, batched);
        under ``backend="oph"`` the raw fold densified once after it."""
        if len(texts) == 0:
            return np.zeros((0, self.params.num_perm), np.uint32)
        tid = trace.new_trace_id()
        running, _ = self._accumulate_device([to_bytes(t) for t in texts], trace_id=tid)
        if self._use_oph:
            running = densify(running)
            self._count_densify()
        with stages.timed("kernel"), trace.span("dedup.readback", trace=tid, docs=len(texts)):
            return running[: len(texts)].view(torch.int32).cpu().numpy().view(np.uint32)

    def dedup_reps_async(
        self, texts: Sequence[str | bytes], *, _regime: str = "async"
    ) -> torch.Tensor:
        """The device ``int32[bucket_len(N)]`` representatives.  Rows past
        ``len(texts)`` are padding (invalid, self-assigned).

        Without a hook it does not wait for the device: encode → chunks →
        one resolve epilogue.  A hook needs the candidate matrix on the
        host, so the hooked path syncs there; it resolves an authoritative
        hook's cells as they are, others by signature agreement (with the
        fine-only bars when ``fine_margin`` is set).  ``_regime`` labels
        the documents' counter: the one-shot path delegates here as
        ``"oneshot"``."""
        tid = trace.new_trace_id()
        span = dict(trace=tid, regime=_regime, docs=len(texts))
        if self.rerank_hook is not None:
            _raw, sigs, keys, valid, rep_bands, n_bucket = self._prepare(texts, tid)
            self._m_docs[_regime].inc(len(texts))
            with stages.timed("resolve"), trace.span("dedup.resolve", **span):
                if self._rerank_applied:
                    rep = self._resolve_authoritative(rep_bands, valid, n_bucket)
                else:
                    cfg = self.cfg
                    thr = (
                        fine_edge_thresholds(
                            rep_bands, keys, cfg.sim_threshold, cfg.fine_margin,
                            num_coarse=self.params.num_bands,
                        )
                        if cfg.cand_subbands and cfg.fine_margin
                        else cfg.sim_threshold
                    )
                    rep = resolve_rep_bands(
                        rep_bands, sigs, valid, thr, jump_rounds=_jump_rounds(n_bucket)
                    )
            self.last_clock.lap("resolve")
            return rep
        raw = [to_bytes(t) for t in texts]
        running, n_bucket = self._accumulate_device(raw, trace_id=tid)
        valid = self._valid_device(raw, n_bucket)
        self._m_docs[_regime].inc(len(texts))
        cfg = self.cfg
        with stages.timed("resolve"), trace.span("dedup.resolve", **span):
            rep = fused_resolve_epilogue(
                running,
                valid,
                self.params.band_salt,
                self._fine_salt(),
                cfg.sim_threshold,
                cfg.fine_margin,
                num_coarse=self.params.num_bands,
                jump_rounds=_jump_rounds(n_bucket),
                use_fine_margin=bool(cfg.cand_subbands and cfg.fine_margin),
                densify_oph=self._use_oph,
            )
            self._count_densify()
        return rep

    def dedup_reps(self, texts: Sequence[str | bytes]) -> np.ndarray:
        """``int32[N]`` first-seen-wins representative per text, the
        certified one-shot path: with ``exact_verify_band`` set, edges are
        resolved as an authoritative hook rewrote them, else after exact
        verify (:meth:`_exact_verified_ok`); without it, as
        :meth:`dedup_reps_async` resolves them."""
        n = len(texts)
        if n == 0:
            return np.zeros((0,), np.int32)
        if not self.cfg.exact_verify_band:
            out = self.dedup_reps_async(texts, _regime="oneshot")[:n].cpu().numpy()
            self._count_result("oneshot", n, out)
            return out
        tid = trace.new_trace_id()
        raw, sigs, keys, valid, rep_bands, n_bucket = self._prepare(texts, tid)
        self._m_docs["oneshot"].inc(n)
        with stages.timed("resolve"), trace.span(
            "dedup.resolve", trace=tid, regime="oneshot", docs=n
        ):
            if self._rerank_applied:
                rep = self._resolve_authoritative(rep_bands, valid, n_bucket)
            else:
                ok, self.last_exact_checks = self._exact_verified_ok(
                    raw, sigs, keys, valid, rep_bands
                )
                rep = resolve_rep_bands_from_ok(
                    rep_bands, torch.as_tensor(ok, device=self.device), valid,
                    jump_rounds=_jump_rounds(n_bucket),
                )
            out = rep[:n].cpu().numpy()
        self.last_clock.lap("resolve")
        self._count_result("oneshot", n, out)
        self._emit_decisions("oneshot", out, keys, n)
        return out

    def _read_keys(self, keys: torch.Tensor, n: int) -> np.ndarray:
        """The first ``n`` rows of the candidate keys on the host (the
        decision journal's winning band keys)."""
        return keys[:n].cpu().numpy()

    def _emit_decisions(self, regime: str, out: np.ndarray, keys: torch.Tensor, n: int) -> None:
        """Decision provenance of the certified one-shot path: each
        document's verdict counted by the tier that settled it, and with
        the journal on one row a document with its winning band key (the
        keys are read back only then).

        With an authoritative hook the tier's ``last_provenance`` (pairs
        settled on the host: ``margin`` or ``reprobe``; every other settled
        pair ``rerank``), ``last_evicted`` and ``last_participants`` name
        the tier; without one, the exact verify's ``_last_exact_pairs``
        (``margin``).  A document with no such evidence was decided by the
        band collisions (``band``)."""
        rec = get_recorder()
        out = np.asarray(out)[:n]
        dup = out != np.arange(n)
        if self._rerank_applied:
            prov = getattr(self.rerank_hook, "last_provenance", None) or {}
            evicted = getattr(self.rerank_hook, "last_evicted", None) or set()
            participants = getattr(self.rerank_hook, "last_participants", None) or set()
            # the strongest host evidence of each document: reprobe > margin
            host_tier: dict[int, str] = {}
            for (a, b), t in prov.items():
                if t in ("margin", "reprobe"):
                    for d in (a, b):
                        if t == "reprobe" or d not in host_tier:
                            host_tier[d] = t

            def dup_tier(i: int, r: int) -> str:
                return prov.get((i, r) if i < r else (r, i), "rerank")

            def uniq_tier(i: int) -> str:
                if i in evicted:
                    return "rerank"
                t = host_tier.get(i)
                if t is not None:
                    return t
                return "rerank" if i in participants else "band"
        else:
            pairs = self._last_exact_pairs
            margin_docs = {d for k in pairs for d in k}

            def dup_tier(i: int, r: int) -> str:
                return "margin" if ((i, r) if i < r else (r, i)) in pairs else "band"

            def uniq_tier(i: int) -> str:
                return "margin" if i in margin_docs else "band"

        tiers = [dup_tier(i, int(out[i])) if dup[i] else uniq_tier(i) for i in range(n)]
        counts: dict[tuple[str, bool], int] = {}
        for i, t in enumerate(tiers):
            k = (t, bool(dup[i]))
            counts[k] = counts.get(k, 0) + 1
        for (t, is_dup), c in counts.items():
            rec.count(t, "dup" if is_dup else "unique", c)
        if rec.journal is None:
            return
        keys_host = self._read_keys(keys, n)
        rows = []
        for i in range(n):
            r = int(out[i])
            band_key = None
            if dup[i]:
                # the first candidate column where the document's key
                # equals its representative's (None for a transitive merge)
                cols = np.flatnonzero(keys_host[i] == keys_host[r])
                if cols.size:
                    band_key = int(keys_host[i, cols[0]])
            rows.append({
                "doc": i,
                "verdict": "dup" if dup[i] else "unique",
                "tier": tiers[i],
                "attr": r if dup[i] else -1,
                "band_key": band_key,
                "regime": regime,
            })
        rec.journal_rows(rows)

    def _emit_index_decisions(self, out: np.ndarray, keys64: np.ndarray,
                              eligible: np.ndarray, index) -> None:
        """Decision provenance of :meth:`dedup_against_index`: every
        eligible row settled at tier ``index``.  With the journal on, a dup
        row's winning band key comes from a probe of its own (already
        posted) keys: the column whose attribution equals the row's answer;
        the index is probed only then."""
        rec = get_recorder()
        dup_rows = np.flatnonzero(out >= 0)
        n_dup = int(dup_rows.size)
        rec.count("index", "dup", n_dup)
        rec.count("index", "unique", int(eligible.sum()) - n_dup)
        if rec.journal is None:
            return
        band_keys: dict[int, int | None] = {}
        if n_dup:
            nb = keys64.shape[1]
            attr = np.asarray(index.probe_batch(keys64[dup_rows].reshape(-1))).reshape(n_dup, nb)
            for x, i in enumerate(dup_rows.tolist()):
                cols = np.flatnonzero(attr[x] == out[i])
                band_keys[i] = int(keys64[i, cols[0]]) if cols.size else None
        rec.journal_rows(
            {
                "doc": int(i),
                "verdict": "dup" if out[i] >= 0 else "unique",
                "tier": "index",
                "attr": int(out[i]),
                "band_key": band_keys.get(int(i)),
                "regime": "stream",
            }
            for i in np.flatnonzero(eligible).tolist()
        )

    def keep(self, texts: Sequence[str | bytes]) -> np.ndarray:
        reps = self.dedup_reps(texts)
        return reps == np.arange(len(reps))

    def prewarm(self, n_articles: int | None = None) -> int:
        """Warm launches ahead of the first corpus: one
        ``minhash_fold_segments`` (under ``backend="oph"``:
        ``oph_fold_segments`` and ``oph_densify``) on a zero text of one
        segment into a scratch accumulator of ``bucket_len(n_articles or
        batch_size)`` rows, and with the rerank tier its
        :meth:`RerankTier.prewarm`.
        Each kernel is built and loaded at its first launch, so a first
        corpus pays neither.  Returns the launches made, where the
        reference returns the tile shapes it compiled: the port compiles
        no shape set."""
        dev = self.device
        n_bucket = bucket_len(n_articles or self.cfg.batch_size, min_bucket=64)
        running = torch.full(
            (n_bucket, self.params.num_perm), -1, dtype=torch.int32, device=dev
        ).view(torch.uint32)
        text = torch.zeros((self.params.shingle_k,), dtype=torch.uint8, device=dev)
        self._fold(
            running, text, torch.zeros((1,), dtype=torch.int64),
            torch.ones((1,), dtype=torch.int32), torch.zeros((1,), dtype=torch.int32),
        )
        stages.count_dispatch("dedup")
        launches = 1
        if self._use_oph:
            densify(running)
            self._count_densify()
            launches += 1
        if self.rerank_tier is not None:
            launches += self.rerank_tier.prewarm()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return launches

    def signatures_and_keys(
        self,
        texts: Sequence[str | bytes],
        *,
        wide: bool = False,
        sync_sigs: bool = True,
    ) -> tuple[np.ndarray | None, np.ndarray]:
        """Host ``(sigs uint32[N, P], keys)``, the keys computed on the
        accumulator's device by :func:`fused_keys_epilogue`.

        ``wide=False`` gives the coarse + fine candidate keys
        ``uint32[N, nb + cand_subbands]``; ``wide=True`` the two-lane wide
        keys ``uint32[N, nb, 2]`` (``utils.bloom.pack_keys64`` packs them).
        ``sync_sigs=False`` returns ``(None, keys)`` and reads only the keys
        back.  A new ``last_clock`` laps ``encode``, ``copy`` and ``fold``
        per chunk, then ``keys_epilogue`` and ``readback``."""
        n = len(texts)
        if n == 0:
            nb = self.params.num_bands
            shape = (0, nb, 2) if wide else (0, nb + self.cfg.cand_subbands)
            sigs0 = np.zeros((0, self.params.num_perm), np.uint32)
            return (sigs0 if sync_sigs else None), np.zeros(shape, np.uint32)
        clock = self.last_clock = StageClock(self.device)
        tid = trace.new_trace_id()
        raw = [to_bytes(t) for t in texts]
        running, _n_bucket = self._accumulate_device(raw, clock, trace_id=tid)
        sig_dev, keys_dev = fused_keys_epilogue(
            running, self.params.band_salt, self._fine_salt(),
            densify_oph=self._use_oph, wide=wide,
        )
        self._count_densify()
        keys_dev = to_u32(keys_dev[:n]).view(torch.int32)
        clock.lap("keys_epilogue")
        with stages.timed("kernel"), trace.span("dedup.readback", trace=tid, docs=n):
            keys = keys_dev.cpu().numpy().view(np.uint32)
            sigs = (
                sig_dev[:n].view(torch.int32).cpu().numpy().view(np.uint32)
                if sync_sigs
                else None
            )
        clock.lap("readback")
        return sigs, keys

    def open_stream_index(self, index_dir: str):
        """The durable stream index this engine's config names: a local
        :class:`~advanced_scrapper_tpu_torch.index.store.PersistentIndex`
        under ``index_dir`` at the config's cut and compaction cadence, or,
        when ``cfg.index_fleet`` is set, a
        :class:`~advanced_scrapper_tpu_torch.index.fleet.ShardedIndexClient`
        over the remote shard fleet (``index_dir`` then holds only the
        degraded-mode spill journals).  Either is a valid ``index`` for
        :meth:`dedup_against_index`."""
        if self.cfg.index_fleet:
            from advanced_scrapper_tpu_torch.index.fleet import open_fleet_index

            return open_fleet_index(self.cfg, index_dir, space="bands")
        from advanced_scrapper_tpu_torch.index import PersistentIndex

        return PersistentIndex(
            index_dir,
            cut_postings=self.cfg.index_cut_postings,
            compact_segments=self.cfg.index_compact_segments,
        )

    def dedup_against_index(
        self, texts: Sequence[str | bytes], index, doc_ids=None, *, mesh=None
    ) -> np.ndarray:
        """``int64[N]`` attribution of a corpus against a persistent index:
        wide keys from :meth:`signatures_and_keys` (one fold launch per
        chunk, no signature read back), packed to ``uint64`` on the host,
        then ``index.check_and_add_batch``.  A row ``>= 0`` is a near-dup
        of that doc id; fresh rows post their keys under ``doc_ids``
        (allocated from the index when not given) and give -1.  Rows with
        fewer bytes than a shingle are neither probed nor posted (-1).
        While the ladder's ``fewer_bands`` step is active only the first
        half of the band columns is probed and posted (counted per row).
        With ``mesh`` the keys come off the mesh's packed plane
        (:meth:`_keys_wide_sharded`), equal to the one-device keys, so the
        attributions do not depend on the device layout; with
        ``packed_h2d=False`` ``mesh`` is ignored, as in the reference (its
        blockwise plane has no keys epilogue)."""
        n = len(texts)
        out = np.full((n,), -1, np.int64)
        if n == 0:
            return out
        raw = [to_bytes(t) for t in texts]
        if mesh is not None and self.cfg.packed_h2d:
            keys_wide = self._keys_wide_sharded(raw, mesh)
        else:
            _sigs, keys_wide = self.signatures_and_keys(raw, wide=True, sync_sigs=False)
        keys64 = pack_keys64(keys_wide)
        if (
            self.ladder is not None
            and self.ladder.active("fewer_bands")
            and keys64.shape[1] > 1
        ):
            # brownout: probe and post the first half of the bands only
            keys64 = keys64[:, : max(1, keys64.shape[1] // 2)]
            self.ladder.count_effect("fewer_bands", n)
        eligible = np.fromiter((len(r) >= self.params.shingle_k for r in raw), bool, n)
        if not eligible.any():
            return out
        if doc_ids is None:
            doc_ids = index.allocate_doc_ids(n)
        doc_ids = np.asarray(doc_ids, dtype=np.uint64)
        out[eligible] = index.check_and_add_batch(keys64[eligible], doc_ids[eligible])
        self._emit_index_decisions(out, keys64, eligible, index)
        return out

    # -- the packed plane over a device mesh ------------------------------------

    def _sharded(self, mesh, what: str, make):
        """The mesh's step or epilogue ``what``, made once per (mesh, what)."""
        key = (mesh, what)
        got = self._sharded_steps.get(key)
        if got is None:
            got = self._sharded_steps[key] = make()
        return got

    def _get_sharded_fused_step(self, mesh):
        """The tile step over the mesh (one fold launch a local shard)."""
        return self._sharded(mesh, "fused", lambda: make_sharded_fused_tile_step(
            mesh, self.params, self.cfg.backend))

    def _get_sharded_init(self, mesh):
        return self._sharded(mesh, "init", lambda: make_sharded_accumulator_init(
            mesh, self.params.num_perm))

    def _get_sharded_epilogue(self, mesh):
        """The end-of-corpus combine and resolve (``pmin`` across shards,
        then the estimator-only resolution of :meth:`dedup_reps_async`)."""
        cfg = self.cfg
        return self._sharded(mesh, "resolve", lambda: make_sharded_resolve_epilogue(
            mesh, self.params, threshold=cfg.sim_threshold, fine_margin=cfg.fine_margin,
            fine_salt=self._fine_salt(), backend=cfg.backend))

    def _get_sharded_keys_epilogue(self, mesh):
        return self._sharded(mesh, "keys", lambda: make_sharded_keys_epilogue(
            mesh, self.params, self.cfg.backend))

    def _sharded_tile_groups(self, tiles, nsh: int):
        """The chunker's tiles in groups of ``nsh`` of one shape, one tile a
        shard: one group is one step over the mesh.  The min-combine does
        not depend on which shard folds which tile.  A shape's leftover
        group is padded with zero tiles (lengths 0: all-``U32_MAX``
        signatures, the min identity), so every shard's ledger stays
        tiles + 1 copies and tiles + 1 dispatches a corpus."""
        pending: dict = {}
        for t, l, o in tiles:
            shape = (t.shape[0], t.shape[1])
            bucket = pending.setdefault(shape, [])
            bucket.append((t, l, o))
            if len(bucket) == nsh:
                yield shape, pending.pop(shape)
        for (rows, w), bucket in list(pending.items()):
            while len(bucket) < nsh:
                bucket.append((
                    np.zeros((rows, w), np.uint8),
                    np.zeros((rows,), np.int32),
                    np.zeros((rows,), np.int32),
                ))
            yield (rows, w), bucket

    def _accumulate_device_sharded(self, raw: list, mesh, trace_id: str | None = None):
        """``(running, n_bucket)``: the mesh's accumulator (one
        ``uint32[n_bucket, P]`` a shard) after folding every tile group of
        ``raw`` into it.  The chunker's tiles (:meth:`_host_tiles`) run
        through :class:`PipelinedDispatcher`: ``pack`` packs the local
        shards' tiles of a group into pinned buffers (``ops.pack``), the
        put threads copy each to its shard's device on that device's
        current stream (one copy a shard, counted ``shard=``), and this
        thread launches one fold a local shard (counted ``shard=``).  A
        remote shard's tile is packed and copied by the rank that owns
        it."""
        tid = trace_id or trace.new_trace_id()
        n = len(raw)
        n_bucket = bucket_len(n, min_bucket=64)
        nsh = mesh_num_shards(mesh)
        shards = shard_row_devices(mesh)
        local_rows = local_shard_rows(mesh)
        step = self._get_sharded_fused_step(mesh)
        streams = {shards[s].device: torch.cuda.current_stream(shards[s].device)
                   for s in local_rows if shards[s].device.type == "cuda"}
        tiles = self._sharded_tile_groups(self._host_tiles(raw), nsh)

        def pack(group):
            (rows, w), batch = group
            nb = packed_nbytes(rows, w)
            bufs = {}
            with stages.timed("encode"):
                for s in local_rows:
                    buf = torch.empty((nb,), dtype=torch.uint8,
                                      pin_memory=shards[s].device.type == "cuda")
                    pack_tile(*batch[s], out=buf.numpy())
                    bufs[s] = buf
            return bufs, rows, w

        def put(item):
            bufs, rows, w = item
            t0 = time.perf_counter()
            pieces = []
            with stages.timed("h2d"):
                for s in local_rows:
                    dev = shards[s].device
                    ctx = torch.cuda.stream(streams[dev]) if dev in streams \
                        else contextlib.nullcontext()
                    with ctx:
                        pieces.append(bufs[s].to(dev, non_blocking=True))
                    stages.count_device_put(bufs[s].numel(), "sharded", shard=s)
                packed = assemble_packed_tiles(mesh, pieces, packed_nbytes(rows, w))
            nbytes = sum(bufs[s].numel() for s in local_rows)
            return packed, rows, w, nbytes, time.perf_counter() - t0

        def dispatch(running, item):
            packed, rows, w, _nb, _put_s = item
            # one latency observation a step; the per-shard truth is the
            # ledger's copies and launches
            with devprof.dispatch_span("sharded_fused_tile", rows=rows, width=w, trace=tid) as sp:
                sp.out = step(running, packed, rows=rows, width=w, num_articles=n_bucket)
            for s in local_rows:
                stages.count_dispatch("sharded", shard=s)
            return sp.out

        running = self._get_sharded_init(mesh)(num_articles=n_bucket)
        probe = self.dispatch_probe
        pipe = self.last_dispatcher = PipelinedDispatcher(
            tiles, pack=pack, put=put, put_workers=resolve_put_workers(self.cfg),
            window=self._dispatch_window(), name="dedup.sharded.h2d",
        )
        dispatched = 0
        try:
            for item in pipe:
                t0 = time.perf_counter()
                rows = int(item[1])
                with stages.timed("kernel"), self.step_timer.step(rows * nsh):
                    running = dispatch(running, item)
                if probe is not None:
                    probe({
                        "tile": dispatched, "rows": rows, "width": int(item[2]),
                        "shards": nsh, "h2d_bytes": int(item[3]),
                        "put_ms": round(item[4] * 1e3, 3),
                        "dispatch_ms": round((time.perf_counter() - t0) * 1e3, 3),
                    })
                dispatched += 1
        finally:
            pipe.close()
        self._m_batches.inc(dispatched)
        self.last_tiles = dispatched
        if trace.RECORDER.active:
            trace.record("span", "dedup.dispatch", trace=tid, batches=dispatched, docs=n,
                         shards=nsh)
        return running, n_bucket

    def _valid_device_sharded(self, raw: list, n_bucket: int, mesh) -> ShardedArray:
        """The replicated ``bool[n_bucket]`` eligibility mask, one copy on
        each local shard's device (one put a shard)."""
        valid = self._valid_host(raw, n_bucket)
        pieces = []
        for s in local_shard_rows(mesh):
            pieces.append(torch.from_numpy(valid).to(mesh.shards[s].device))
            stages.count_device_put(valid.nbytes, "sharded", shard=s)
        return ShardedArray(mesh, (None,), pieces, valid.shape)

    def prewarm_sharded(self, mesh, n_articles: int | None = None) -> int:
        """Warm launches over the mesh ahead of the first corpus: one fold
        of a zero tile of the chunker's smallest shape (64 rows of 64
        bytes) a local shard into a scratch accumulator of
        ``bucket_len(n_articles or batch_size)`` rows, and the end-of-corpus
        epilogue once (``oph_densify`` under OPH).  The steps are made and
        cached here and each kernel built and loaded at its first launch,
        so a first corpus pays neither.  Returns the launches made, where
        the reference returns the shapes it compiled."""
        n_bucket = bucket_len(n_articles or self.cfg.batch_size, min_bucket=64)
        step = self._get_sharded_fused_step(mesh)
        running = self._get_sharded_init(mesh)(num_articles=n_bucket)
        rows, w = 64, 64
        nb = packed_nbytes(rows, w)
        pieces = [torch.zeros((nb,), dtype=torch.uint8, device=mesh.shards[s].device)
                  for s in local_shard_rows(mesh)]
        step(running, assemble_packed_tiles(mesh, pieces, nb), rows=rows, width=w,
             num_articles=n_bucket)
        launches = len(pieces)
        valid = ShardedArray(mesh, (None,), [
            torch.zeros((n_bucket,), dtype=torch.bool, device=p.device) for p in pieces
        ], (n_bucket,))
        self._get_sharded_epilogue(mesh)(running, valid, jump_rounds=_jump_rounds(n_bucket))
        self._get_sharded_keys_epilogue(mesh)
        if self._use_oph:
            launches += 1
        for p in pieces:
            if p.device.type == "cuda":
                torch.cuda.synchronize(p.device)
        return launches

    def dedup_reps_sharded(self, texts: Sequence[str | bytes], mesh) -> np.ndarray:
        """``int32[N]`` representatives over a device mesh, equal to
        :meth:`dedup_reps_async`'s (its estimator-only resolution; the
        one-shot :meth:`dedup_reps` is the certified path).

        With ``packed_h2d`` (the default), the packed plane: per-shard
        packed tiles through the dispatcher, one fold a shard a tile group
        (:meth:`_accumulate_device_sharded`), then one epilogue: the
        shards' ``pmin`` and the resolution.  ``packed_h2d=False`` runs the
        reference's blockwise plane (``encode_blocks`` →
        ``make_sharded_block_dedup``), kept equal as the packed plane's
        oracle."""
        if self.cfg.packed_h2d:
            return self._dedup_reps_sharded_packed(texts, mesh)
        return self._dedup_reps_sharded_legacy(texts, mesh)

    def _dedup_reps_sharded_packed(self, texts, mesh) -> np.ndarray:
        n = len(texts)
        if n == 0:
            return np.zeros((0,), np.int32)
        tid = trace.new_trace_id()
        self._m_docs["sharded"].inc(n)
        raw = [to_bytes(t) for t in texts]
        running, n_bucket = self._accumulate_device_sharded(raw, mesh, trace_id=tid)
        valid = self._valid_device_sharded(raw, n_bucket, mesh)
        with stages.timed("resolve"), trace.span(
            "dedup.resolve", trace=tid, regime="sharded", docs=n
        ):
            rep = self._get_sharded_epilogue(mesh)(
                running, valid, jump_rounds=_jump_rounds(n_bucket))
            for s in local_shard_rows(mesh):
                stages.count_dispatch("sharded", shard=s)
            out = rep[:n].cpu().numpy()
        self._count_result("sharded", n, out)
        return out

    def _keys_wide_sharded(self, raw: list, mesh) -> np.ndarray:
        """Host ``uint32[N, nb, 2]`` wide band keys off the mesh's packed
        accumulator: the sharded twin of ``signatures_and_keys(wide=True,
        sync_sigs=False)``, one keys epilogue (``pmin`` and
        ``band_keys_wide``)."""
        tid = trace.new_trace_id()
        running, _n_bucket = self._accumulate_device_sharded(raw, mesh, trace_id=tid)
        keys = self._get_sharded_keys_epilogue(mesh)(running)
        for s in local_shard_rows(mesh):
            stages.count_dispatch("sharded", shard=s)
        keys = to_u32(keys[: len(raw)]).view(torch.int32)
        with stages.timed("kernel"), trace.span("dedup.readback", trace=tid, docs=len(raw)):
            return keys.cpu().numpy().view(np.uint32)

    def _dedup_reps_sharded_legacy(self, texts, mesh) -> np.ndarray:
        """The reference's blockwise mesh plane: ``encode_blocks`` → one
        ``make_sharded_block_dedup`` step (the blocks split over the data
        axis, each shard's segment minimum, ``pmin``, the resolution), the
        block rows padded to a multiple of the shards, padding owned by
        the scratch article ``n_bucket``."""
        n = len(texts)
        if n == 0:
            return np.zeros((0,), np.int32)
        tid = trace.new_trace_id()
        self._m_docs["sharded"].inc(n)
        cfg = self.cfg
        raw = [to_bytes(t) for t in texts]
        with stages.timed("encode"):
            tok, lens, owners = encode_blocks(raw, cfg.block_len, overlap=self.params.shingle_k - 1)
            owners = owners.astype(np.int32)
            n_bucket = bucket_len(n, min_bucket=64)
            ndev = mesh_num_shards(mesh)
            rows = bucket_len(max(tok.shape[0], ndev), min_bucket=64)
            rows = -(-rows // ndev) * ndev  # an exact multiple for odd meshes
            if tok.shape[0] < rows:
                pad = rows - tok.shape[0]
                tok = np.concatenate([tok, np.zeros((pad, cfg.block_len), np.uint8)])
                lens = np.concatenate([lens, np.zeros((pad,), np.int32)])
                owners = np.concatenate([owners, np.full((pad,), n_bucket, np.int32)])
        step = self._sharded(mesh, ("legacy", n_bucket, cfg.block_len),
                             lambda: make_sharded_block_dedup(
                                 mesh, self.params, n_bucket, threshold=cfg.sim_threshold,
                                 jump_rounds=_jump_rounds(n_bucket), backend=cfg.backend,
                                 cand_subbands=cfg.cand_subbands, fine_margin=cfg.fine_margin))
        with self.step_timer.step(int(tok.shape[0])):
            rep, _hist = step(tok, lens, owners)
        stages.count_dispatch("dedup")
        self._m_batches.inc()
        with stages.timed("resolve"), trace.span(
            "dedup.resolve", trace=tid, regime="sharded", docs=n
        ):
            out = rep[:n].cpu().numpy()
        self._count_result("sharded", n, out)
        return out


class ExactDedup:
    """First-seen exact dedup, byte-identical to pandas
    ``drop_duplicates(keep='first')``.

    Three tiers, as in the reference; ``last_path`` names the one that
    served the last :meth:`keep_indices` call:

    - ``"zero-copy"``: ``cpu.exactdedup.keep_first_list`` reads each str or
      bytes item in place (``native/exactdedup.cpp``; off where the CPython
      headers are missing);
    - ``"blob"``: ``cpu.hostbatch.exact_keep_first_native`` over the items
      joined into one blob (``native/hostbatch.cpp``);
    - ``"grouping"``: the items' 128-bit hashes (``ops.exact.ExactHasher``
      on ``device``) group them, and each group with more than one member
      is settled by comparing the strings themselves.

    Both native tiers confirm every hash-equal probe with ``memcmp``.  An
    input a tier does not serve (mixed str and bytes, a str UTF-8 cannot
    view) goes on to the next; a caller-supplied ``hasher`` pins the
    grouping path.  ``device=None`` means the card for the default hasher
    and raises without one."""

    def __init__(
        self,
        hasher: ExactHasher | None = None,
        max_len: int = 4096,
        device: str | torch.device | None = None,
    ):
        self._custom_hasher = hasher is not None
        self.hasher = hasher or ExactHasher(device=device)
        #: the block width of the grouping path's hash (no cap on length)
        self.max_len = max_len
        self.last_path: str = ""

    def keep_indices(self, items: Sequence[str]) -> list[int]:
        keep = self._keep_indices(items)
        if items:
            # the exact tier settled every verdict: kept rows are first-seen
            # uniques, the rest byte-equal dups of an earlier row
            rec = get_recorder()
            rec.count("exact", "unique", len(keep))
            rec.count("exact", "dup", len(items) - len(keep))
        return keep

    def _keep_indices(self, items: Sequence[str]) -> list[int]:
        if not items:
            return []
        if not self._custom_hasher:
            keep = keep_first_list(items)
            self.last_path = "zero-copy"
            if keep is None:
                keep = exact_keep_first_native(items)
                self.last_path = "blob"
            if keep is not None:
                return np.flatnonzero(keep).tolist()
        self.last_path = "grouping"
        n = len(items)
        raw = [to_bytes(s) for s in items]
        block = bucket_len(max(1, min(max(len(r) for r in raw), self.max_len)))
        h = self.hasher.hash_docs(raw, block_len=block)  # uint32[N, 4]
        # group rows by their 128-bit hash with one lexsort: a row whose
        # hash is unique is kept outright, and only groups of several rows
        # reach the string compare below
        hi = (h[:, 0].astype(np.uint64) << 32) | h[:, 1]
        lo = (h[:, 2].astype(np.uint64) << 32) | h[:, 3]
        order = np.lexsort((lo, hi))  # stable: ties stay in original order
        shi, slo = hi[order], lo[order]
        new_group = np.empty(n, bool)
        new_group[0] = True
        new_group[1:] = (shi[1:] != shi[:-1]) | (slo[1:] != slo[:-1])
        gid = np.empty(n, np.int64)
        gid[order] = np.cumsum(new_group) - 1
        leader_of = order[np.flatnonzero(new_group)]  # smallest index per group
        counts = np.bincount(gid)
        keep = counts[gid] == 1
        multi_rows = np.flatnonzero(~keep)  # ascending: original order
        if len(multi_rows):
            # most groups are true duplicates, every member equal to its
            # leader: one object compare settles them; a group holding a
            # member that differs (a hash collision) takes the walk
            obj = np.array(items, dtype=object)
            leaders = leader_of[gid[multi_rows]]
            eq_leader = obj[multi_rows] == obj[leaders]
            keep[leader_of] = True
            rare = np.unique(gid[multi_rows[~eq_leader]])
            for g in rare.tolist():
                members = multi_rows[gid[multi_rows] == g]
                kept_distinct: list[int] = []
                for i in members.tolist():
                    if not any(items[j] == items[i] for j in kept_distinct):
                        kept_distinct.append(i)
                        keep[i] = True
                    else:
                        keep[i] = False
        return np.flatnonzero(keep).tolist()

    def keep_mask(self, items: Sequence[str]) -> np.ndarray:
        mask = np.zeros(len(items), dtype=bool)
        mask[self.keep_indices(items)] = True
        return mask
