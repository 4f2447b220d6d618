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
accumulator in place.  Device memory holds one chunk at a time, whatever
the corpus size.  The result does not depend on ``block_len`` or
``batch_size``: every cut of an article keeps its shingle set.

With no ``rerank_hook``, :meth:`NearDupEngine.dedup_reps_async` resolves
in one plain-PyTorch epilogue on the accumulator's device.  The default
configuration installs the rerank tier (``pipeline.rerank.RerankTier``)
as the hook: the candidate matrix and the signatures cross to the host,
the tier settles the pairs (its Jaccard on the card) and rewrites the
matrix, which goes back to the card to be resolved.  Without the tier,
:meth:`NearDupEngine.dedup_reps` confirms borderline edges by exact
Jaccard (``exact_verify_band``) before resolving.

``_host_tiles``, the reference's width-bucketed block chunker, stays for
the tile path (``ops.minhash.make_fused_tile_step``) and its timing.

:meth:`NearDupEngine.signatures_and_keys` serves the stream backend
(``extractors/tpu_batch.py``): one fold per chunk, then the keys epilogue,
and the keys (and, if asked, the signatures) read back.  :class:`ExactDedup`
is the first-seen exact dedup with its native tiers and hashed grouping.

Against a persistent index (``index.store.PersistentIndex``),
:meth:`NearDupEngine.dedup_against_index` attributes a corpus through the
same wide keys: ``open_stream_index`` opens one under a directory.

What is not ported yet raises ``NotImplementedError`` naming its slice:
the ``oph`` backend, the legacy unpacked transport (``packed_h2d=False``),
``prewarm``, the sharded methods and ``mesh=``, and the index fleet
(``index_fleet``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from advanced_scrapper_tpu_torch import resolve_device
from advanced_scrapper_tpu_torch.config import DedupConfig
from advanced_scrapper_tpu_torch.core.hashing import MinHashParams, make_params
from advanced_scrapper_tpu_torch.core.tokenizer import (
    bucket_len,
    bucket_widths,
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
    check_backend,
    fold_segments,
    perm_tensors,
)
from advanced_scrapper_tpu_torch.ops.shingle import to_u32
from advanced_scrapper_tpu_torch.pipeline.clock import StageClock
from advanced_scrapper_tpu_torch.pipeline.rerank import SLICE_DISPATCH, RerankTier
from advanced_scrapper_tpu_torch.utils.bloom import pack_keys64

SLICE_LATER = "a later slice (ROADMAP queue 1)"
SLICE_FLEET = "the slice of ROADMAP item 9c (the index fleet)"
SLICE_MESH = "the slice of ROADMAP item 15 (parallel/* on torch.distributed)"

#: Most bytes of text in one chunk (one copy, one kernel launch); an
#: article longer than this is a chunk of its own.
CHUNK_BYTES = 64 << 20
#: Most bytes joined by one ``bytes.join`` while filling a chunk's pinned
#: buffer: small joins reuse warm heap memory, where one large join takes
#: fresh pages from the kernel and faults on every one of them.
JOIN_BYTES = 4 << 20


def _not_ported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet; it comes in {where}")


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
        self.cfg = cfg or DedupConfig()
        self.device = resolve_device(device)
        if not self.cfg.packed_h2d:
            raise _not_ported("the unpacked tile transport (packed_h2d=False)", SLICE_LATER)
        if self.cfg.prewarm:
            raise _not_ported("prewarm", SLICE_DISPATCH)
        self.params = params or make_params(
            num_perm=self.cfg.num_perm,
            num_bands=self.cfg.num_bands,
            shingle_k=self.cfg.shingle_k,
            seed=self.cfg.seed,
        )
        check_backend(self.cfg.backend)
        self._perm = perm_tensors(self.params, self.device)
        #: chunks folded (one kernel launch each) and bytes copied to the
        #: device by the last corpus
        self.last_chunks = 0
        self.last_h2d_bytes = 0
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
        #: host-clock seconds and device times of the last hooked or
        #: verified corpus's stages, and the exact checks of the last
        #: exact verify
        self.last_clock = StageClock(self.device)
        self.last_exact_checks = 0

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

    def _host_chunks(self, raw: list):
        """The main path's host work, lazily: per chunk of whole articles
        (``chunk_ranges``), ``(text uint8[T], seg_start int64[G],
        seg_shingles int32[G], seg_owner int32[G])`` CPU tensors, pinned
        when the engine runs on the card.  The text is the chunk's bytes
        joined as they are, ``JOIN_BYTES`` at a time; segment owners are
        global article indices.  Chunks whose articles hold no shingle are
        skipped."""
        k = self.params.shingle_k
        lens = np.fromiter(map(len, raw), np.int64, count=len(raw))
        pin = self.device.type == "cuda"
        for lo, hi in chunk_ranges(lens, CHUNK_BYTES):
            off = np.zeros((hi - lo + 1,), np.int64)
            np.cumsum(lens[lo:hi], out=off[1:])
            start, shingles, owner = segment_ranges(
                off[:-1], lens[lo:hi], np.arange(lo, hi), k, SEGMENT_SHINGLES
            )
            g = len(start)
            if not g:
                continue
            text = torch.empty((int(off[-1]),), dtype=torch.uint8, pin_memory=pin)
            buf = text.numpy()
            for a, b in chunk_ranges(lens[lo:hi], JOIN_BYTES):
                buf[off[a] : off[b]] = np.frombuffer(b"".join(raw[lo + a : lo + b]), np.uint8)
            desc = torch.empty((16 * g,), dtype=torch.uint8, pin_memory=pin)
            d = desc.numpy()
            d[: 8 * g].view(np.int64)[:] = start
            d[8 * g : 12 * g].view(np.int32)[:] = shingles
            d[12 * g :].view(np.int32)[:] = owner
            yield (
                text,
                desc[: 8 * g].view(torch.int64),
                desc[8 * g : 12 * g].view(torch.int32),
                desc[12 * g :].view(torch.int32),
            )

    # -- device accumulation ---------------------------------------------------

    def _accumulate_device(
        self, raw: list, clock: StageClock | None = None
    ) -> tuple[torch.Tensor, int]:
        """``(running, n_bucket)``: the device ``uint32[n_bucket, P]``
        accumulator after folding every chunk of ``raw`` into it.  With a
        ``clock``, each chunk laps ``encode`` (the host join), ``copy`` and
        ``fold``.

        Each chunk's pinned text and descriptors are copied with
        ``non_blocking=True`` and folded by one kernel launch; the host
        returns to joining the next chunk while the copy and the kernel
        run on the current stream.  PyTorch's pinned-memory cache keeps a
        buffer out of reuse until its copy has completed.  Rows past
        ``len(raw)`` stay all-``U32_MAX``.
        """
        dev = self.device
        n_bucket = bucket_len(len(raw), min_bucket=64)
        running = torch.full(
            (n_bucket, self.params.num_perm), -1, dtype=torch.int32, device=dev
        ).view(torch.uint32)
        chunks = h2d = 0
        for text, start, shingles, owner in self._host_chunks(raw):
            if clock is not None:
                clock.lap("encode")
            text_dev = text.to(dev, non_blocking=True)
            if clock is not None:
                clock.lap("copy")
            fold_segments(
                running, text_dev, start, shingles, owner, self.params, self._perm
            )
            if clock is not None:
                clock.lap("fold")
            chunks += 1
            h2d += text.numel() + 16 * start.numel()
        self.last_chunks, self.last_h2d_bytes = chunks, h2d
        return running, n_bucket

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
        """Device ``bool[n_bucket]``: rows with at least one k-shingle."""
        return torch.from_numpy(self._valid_host(raw, n_bucket)).to(self.device)

    def _prepare(self, texts: Sequence[str | bytes]):
        """Front half of the hooked and verified paths: encode → device
        accumulator → candidate epilogue → the hook, if any.  With a hook,
        ``sigs``, ``rep_bands`` and ``valid`` cross to the host (the
        signatures as their ``int32`` view, read as ``uint32``), the hook
        rewrites the matrix, and the rewritten matrix goes back to the
        device.  Returns ``(raw, sigs, keys, valid, rep_bands, n_bucket)``
        on the device.  A new ``last_clock`` laps ``fold`` (encode, copy,
        fold), ``candidate_epilogue`` and, with a hook, ``readback``,
        ``hook`` and ``writeback``; the caller laps ``resolve``."""
        clock = self.last_clock = StageClock(self.device)
        raw = [to_bytes(t) for t in texts]
        running, n_bucket = self._accumulate_device(raw)
        clock.lap("fold")
        valid_host = self._valid_host(raw, n_bucket)
        valid = torch.from_numpy(valid_host).to(self.device)
        sigs, keys, rep_bands = fused_candidate_epilogue(
            running, valid, self.params.band_salt, self._fine_salt()
        )
        clock.lap("candidate_epilogue")
        self._rerank_applied = False
        if self.rerank_hook is None:
            return raw, sigs, keys, valid, rep_bands, n_bucket
        sigs_host = sigs.view(torch.int32).cpu().numpy().view(np.uint32)
        rb_host = rep_bands.cpu().numpy()
        clock.lap("readback")
        rb_host = np.asarray(self.rerank_hook(raw, sigs_host, rb_host, valid_host))
        clock.lap("hook")
        rep_bands = torch.from_numpy(rb_host).to(self.device)
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
        flagged, else on the host) and the number of exact checks."""
        cfg = self.cfg
        need_dev, ok_dev = borderline_edge_mask(
            rep_bands, sigs, keys, valid, cfg.sim_threshold, cfg.exact_verify_band,
            num_coarse=self.params.num_bands,
        )
        need = need_dev.cpu().numpy()
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
        return ok, checked

    # -- public API ------------------------------------------------------------

    def signatures(self, texts: Sequence[str | bytes]) -> np.ndarray:
        """``uint32[N, num_perm]`` MinHash signatures (blockwise, batched)."""
        if len(texts) == 0:
            return np.zeros((0, self.params.num_perm), np.uint32)
        running, _ = self._accumulate_device([to_bytes(t) for t in texts])
        return running[: len(texts)].view(torch.int32).cpu().numpy().view(np.uint32)

    def dedup_reps_async(self, texts: Sequence[str | bytes]) -> torch.Tensor:
        """The device ``int32[bucket_len(N)]`` representatives.  Rows past
        ``len(texts)`` are padding (invalid, self-assigned).

        Without a hook it does not wait for the device: encode → chunks →
        one resolve epilogue.  A hook needs the candidate matrix on the
        host, so the hooked path syncs there; it resolves an authoritative
        hook's cells as they are, others by signature agreement (with the
        fine-only bars when ``fine_margin`` is set)."""
        if self.rerank_hook is not None:
            _raw, sigs, keys, valid, rep_bands, n_bucket = self._prepare(texts)
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
        running, n_bucket = self._accumulate_device(raw)
        cfg = self.cfg
        return fused_resolve_epilogue(
            running,
            self._valid_device(raw, n_bucket),
            self.params.band_salt,
            self._fine_salt(),
            cfg.sim_threshold,
            cfg.fine_margin,
            num_coarse=self.params.num_bands,
            jump_rounds=_jump_rounds(n_bucket),
            use_fine_margin=bool(cfg.cand_subbands and cfg.fine_margin),
        )

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
            return self.dedup_reps_async(texts)[:n].cpu().numpy()
        raw, sigs, keys, valid, rep_bands, n_bucket = self._prepare(texts)
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
        return out

    def keep(self, texts: Sequence[str | bytes]) -> np.ndarray:
        reps = self.dedup_reps(texts)
        return reps == np.arange(len(reps))

    def prewarm(self, n_articles: int | None = None) -> int:
        raise _not_ported("prewarm", SLICE_DISPATCH)

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
        raw = [to_bytes(t) for t in texts]
        running, _n_bucket = self._accumulate_device(raw, clock)
        sig_dev, keys_dev = fused_keys_epilogue(
            running, self.params.band_salt, self._fine_salt(),
            densify_oph=False, wide=wide,
        )
        keys_dev = to_u32(keys_dev[:n]).view(torch.int32)
        clock.lap("keys_epilogue")
        keys = keys_dev.cpu().numpy().view(np.uint32)
        sigs = (
            sig_dev[:n].view(torch.int32).cpu().numpy().view(np.uint32)
            if sync_sigs
            else None
        )
        clock.lap("readback")
        return sigs, keys

    def open_stream_index(self, index_dir: str):
        """A local :class:`~advanced_scrapper_tpu_torch.index.store.PersistentIndex`
        under ``index_dir``, at the config's cut and compaction cadence: a
        valid ``index`` for :meth:`dedup_against_index`.  ``cfg.index_fleet``
        raises (the fleet is not ported)."""
        if self.cfg.index_fleet:
            raise _not_ported("the index fleet (index_fleet)", SLICE_FLEET)
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
        ``mesh=`` raises (the sharded path is not ported)."""
        if mesh is not None:
            raise _not_ported("dedup_against_index(mesh=...)", SLICE_MESH)
        n = len(texts)
        out = np.full((n,), -1, np.int64)
        if n == 0:
            return out
        raw = [to_bytes(t) for t in texts]
        _sigs, keys_wide = self.signatures_and_keys(raw, wide=True, sync_sigs=False)
        keys64 = pack_keys64(keys_wide)
        eligible = np.fromiter((len(r) >= self.params.shingle_k for r in raw), bool, n)
        if not eligible.any():
            return out
        if doc_ids is None:
            doc_ids = index.allocate_doc_ids(n)
        doc_ids = np.asarray(doc_ids, dtype=np.uint64)
        out[eligible] = index.check_and_add_batch(keys64[eligible], doc_ids[eligible])
        return out

    def prewarm_sharded(self, mesh, n_articles: int | None = None) -> int:
        raise _not_ported("the sharded path", SLICE_LATER)

    def dedup_reps_sharded(self, texts, mesh) -> np.ndarray:
        raise _not_ported("the sharded path", SLICE_LATER)


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
