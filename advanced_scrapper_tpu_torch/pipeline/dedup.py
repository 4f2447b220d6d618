"""Near-duplicate dedup engine on the card.

Counterpart of the reference's ``pipeline/dedup.py:NearDupEngine``, its
estimator-only path::

    encode → pack → CUDA MinHash fold, tile by tile → fused LSH resolve
    epilogue → representatives

Texts are cut into width-bucketed blocks on the host (``_host_tiles``,
the reference's chunker), each tile is packed into one pinned buffer,
copied to the card without blocking the host, and folded into the
``uint32[n_bucket, 128]`` accumulator in place by the kernel; the host
encodes the next tile meanwhile.  The LSH epilogue then runs in plain
PyTorch on the accumulator's device.

What is not ported yet raises ``NotImplementedError`` naming its slice:
the rerank tier (``cfg.rerank=True``), the one-shot exact-verify stage
(``dedup_reps`` with ``exact_verify_band > 0``), the ``oph`` backend, the
legacy unpacked transport (``packed_h2d=False``), ``prewarm`` and the
sharded, stream-index and fleet methods.
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
from advanced_scrapper_tpu_torch.cpu.hostbatch import block_counts, encode_blocks_ranges
from advanced_scrapper_tpu_torch.ops.lsh import fused_resolve_epilogue, subband_salt
from advanced_scrapper_tpu_torch.ops.minhash import make_fused_tile_step
from advanced_scrapper_tpu_torch.ops.pack import pack_tile, packed_nbytes

SLICE_RERANK = "slice 2 (rerank tier and one-shot exact verify)"
SLICE_DISPATCH = "the pipelined-dispatcher slice (ROADMAP queue 1)"
SLICE_LATER = "a later slice (ROADMAP queue 1)"


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
        if self.cfg.rerank:
            raise _not_ported("the rerank precision tier (cfg.rerank=True)", SLICE_RERANK)
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
        self._step = make_fused_tile_step(self.params, self.cfg.backend, self.device)
        #: tiles dispatched and bytes copied to the device by the last corpus
        self.last_tiles = 0
        self.last_h2d_bytes = 0

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

    # -- device accumulation ---------------------------------------------------

    def _accumulate_device(self, raw: list) -> tuple[torch.Tensor, int]:
        """``(running, n_bucket)``: the device ``uint32[n_bucket, P]``
        accumulator after folding every tile of ``raw`` into it.

        Each tile is packed into a pinned host buffer and copied with
        ``non_blocking=True``; the host returns to encoding the next tile
        while the copy and the kernel run on the current stream.  PyTorch's
        pinned-memory cache keeps a buffer out of reuse until its copy has
        completed.  Rows past ``len(raw)`` stay all-``U32_MAX``.
        """
        dev = self.device
        n_bucket = bucket_len(len(raw), min_bucket=64)
        running = torch.full(
            (n_bucket, self.params.num_perm), -1, dtype=torch.int32, device=dev
        ).view(torch.uint32)
        pin = dev.type == "cuda"
        tiles = h2d = 0
        for t, l, o in self._host_tiles(raw):
            rows, w = t.shape
            buf = torch.empty(packed_nbytes(rows, w), dtype=torch.uint8, pin_memory=pin)
            pack_tile(t, l, o, out=buf.numpy())
            packed = buf.to(dev, non_blocking=True)
            self._step(running, packed, rows=rows, width=w)
            tiles += 1
            h2d += buf.numel()
        self.last_tiles, self.last_h2d_bytes = tiles, h2d
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

    def _valid_device(self, raw: list, n_bucket: int) -> torch.Tensor:
        """Device ``bool[n_bucket]``: rows with at least one k-shingle."""
        lens = np.fromiter(map(len, raw), np.int64, count=len(raw))
        valid = np.zeros((n_bucket,), bool)
        valid[: len(raw)] = lens >= self.params.shingle_k
        return torch.from_numpy(valid).to(self.device)

    # -- public API ------------------------------------------------------------

    def signatures(self, texts: Sequence[str | bytes]) -> np.ndarray:
        """``uint32[N, num_perm]`` MinHash signatures (blockwise, batched)."""
        if len(texts) == 0:
            return np.zeros((0, self.params.num_perm), np.uint32)
        running, _ = self._accumulate_device([to_bytes(t) for t in texts])
        return running[: len(texts)].view(torch.int32).cpu().numpy().view(np.uint32)

    def dedup_reps_async(self, texts: Sequence[str | bytes]) -> torch.Tensor:
        """The device ``int32[bucket_len(N)]`` representatives, without
        waiting for the device: encode → tiles → one resolve epilogue.
        Rows past ``len(texts)`` are padding (invalid, self-assigned)."""
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
        """``int32[N]`` first-seen-wins representative per text
        (estimator-only: ``exact_verify_band`` must be 0 in this slice)."""
        if self.cfg.exact_verify_band:
            raise _not_ported(
                "dedup_reps with exact_verify_band > 0 (one-shot exact verify)",
                SLICE_RERANK,
            )
        n = len(texts)
        if n == 0:
            return np.zeros((0,), np.int32)
        return self.dedup_reps_async(texts)[:n].cpu().numpy()

    def keep(self, texts: Sequence[str | bytes]) -> np.ndarray:
        reps = self.dedup_reps(texts)
        return reps == np.arange(len(reps))

    def prewarm(self, n_articles: int | None = None) -> int:
        raise _not_ported("prewarm", SLICE_DISPATCH)

    def signatures_and_keys(self, texts, *, wide=False, sync_sigs=True):
        raise _not_ported("signatures_and_keys (stream index)", SLICE_LATER)

    def open_stream_index(self, index_dir: str):
        raise _not_ported("the stream index", SLICE_LATER)

    def dedup_against_index(self, texts, index, *args, **kwargs):
        raise _not_ported("dedup_against_index (stream index and fleet)", SLICE_LATER)

    def prewarm_sharded(self, mesh, n_articles: int | None = None) -> int:
        raise _not_ported("the sharded path", SLICE_LATER)

    def dedup_reps_sharded(self, texts, mesh) -> np.ndarray:
        raise _not_ported("the sharded path", SLICE_LATER)
