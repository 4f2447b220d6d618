"""The rerank (precision) tier, with its settle on the card.

Counterpart of the reference's ``pipeline/rerank.py:RerankTier``, the
engine's default ``rerank_hook``: it takes the candidate matrix of the
LSH epilogue, settles each candidate pair by bottom-sketch Jaccard, and
returns a rewritten candidate matrix that holds exactly the surviving
cluster edges, which both of the engine's resolution paths then resolve.

Per corpus::

    pairs    coarse band buckets ∪ incoming candidate cells      (host)
    sketches bottom-S sketch of each participating document,
             compacted into one pinned uint32[n_sk, S]             (host)
    settle   the sketches and the int32 pair indices copied to the
             card once, rerank_settle launched once (the finalize
             fused), one readback of (jq, verdict)                 (card)
    margin   borderline verdicts re-settled by exact Jaccard, up to
             rerank_exact_cap, then (with an index) by the re-probe (host)
    clusters union-find over kept pairs; every within-cluster pair the
             candidacy never proposed settled by the host sketch
             estimator (margin → exact)                            (host)
    evict    the precision-targeted eviction walk, recall floor as a
             guard                                                 (host)
    rewrite  surviving settled-true cluster edges → candidate matrix

The tier is *authoritative*: its cells are settled truth, so the engine
resolves them as they are instead of re-screening them by signature
agreement or exact verify.  Where the reference packs and copies both
sketches of every pair in tiles, the port copies each participating
document's sketch once and addresses pairs by row.  With a persistent
index (``index=``, ``index.store.PersistentIndex``), a borderline pair
past ``rerank_exact_cap`` is re-probed: both documents' wide band keys
(``ops.rerank.band_keys_wide_host``) are probed, and the pair survives
when the index attributes both to the same earliest posted doc.
:meth:`RerankTier.prewarm` is a warm launch of the settle.

Each stage of ``last_clock`` also lands in the always-on stage histogram
as ``rerank_<stage>`` (``obs/stages.py``), and the settle counts two puts
(the sketches, the pair indices) and one dispatch on the ``rerank``
plane.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from advanced_scrapper_tpu_torch import resolve_device
from advanced_scrapper_tpu_torch.config import DedupConfig
from advanced_scrapper_tpu_torch.core.hashing import MinHashParams
from advanced_scrapper_tpu_torch.cpu.oracle import jaccard, shingle_set
from advanced_scrapper_tpu_torch.obs import stages
from advanced_scrapper_tpu_torch.ops import rerank as oprr
from advanced_scrapper_tpu_torch.ops.rerank_cuda import rerank_settle
from advanced_scrapper_tpu_torch.pipeline.clock import StageClock
from advanced_scrapper_tpu_torch.utils.bloom import pack_keys64

class RerankTier:
    """Callable ``(raw, sigs, rep_bands, valid) → rep_bands`` on host
    arrays (``sigs`` ``uint32[B, P]``, ``rep_bands`` ``int32[B, nc]``,
    ``valid`` ``bool[B]``).  ``stats`` holds the last corpus's settlement
    ledger; ``last_clock`` the host-clock seconds and device times of its
    stages; ``last_pairs`` its settled ``(i < j)`` pairs;
    ``last_settle_inputs`` what its settle took, ``(sk, idx)``: the
    sketches ``uint32[n_sk, S]`` on the tier's device and the pairs' row
    indices ``int32[2, m]`` on the host (``None`` without pairs), kept
    until the next corpus so the settle can be re-run alone.  ``index``:
    an optional persistent index for the borderline re-probe."""

    authoritative = True

    def __init__(
        self,
        cfg: DedupConfig,
        params: MinHashParams,
        *,
        index=None,
        device: str | torch.device | None = None,
    ):
        self.cfg = cfg
        self.index = index
        self.params = params
        self.device = resolve_device(device)
        self.stats: dict = {}
        self.last_provenance: dict[tuple[int, int], str] = {}
        self.last_evicted: set[int] = set()
        self.last_participants: set[int] = set()
        self.last_pairs = np.zeros((0, 2), np.int64)
        self.last_settle_inputs: tuple[torch.Tensor, torch.Tensor] | None = None
        self.last_clock = StageClock(self.device)

    def prewarm(self) -> int:
        """One warm launch of the settle (``rerank_settle`` on the card,
        its plain version on the CPU) on one pair of empty sketches of the
        configured width: the library is built and loaded before the first
        corpus.  Returns the launches made, 1, where the reference returns
        the settle shapes it compiled: the port has no shape set."""
        cfg = self.cfg
        dev = self.device
        sk = torch.full((1, cfg.rerank_sketch), -1, dtype=torch.int32, device=dev)
        sk = sk.view(torch.uint32)
        idx = torch.zeros((2, 1), dtype=torch.int32)
        lo = oprr.quantize(cfg.sim_threshold - cfg.rerank_margin)
        hi = oprr.quantize(cfg.sim_threshold + cfg.rerank_margin)
        if dev.type == "cuda":
            rerank_settle(sk, idx[0], idx[1], sk.shape[1], lo, hi)
            torch.cuda.synchronize(dev)
        else:
            oprr.settle_plain(sk, idx[0], idx[1], lo, hi)
        return 1

    def _candidate_pairs(self, sigs, rb, valid, n):
        """Settlement work-list: datasketch-class coarse band pairs plus
        every incoming candidate cell (fine-band candidacy included),
        capped at ``rerank_pair_cap`` with incoming cells first."""
        t0 = time.perf_counter()
        pairs, capped = oprr.coarse_pairs(sigs[:n], valid[:n], self.params.num_bands)
        self.last_clock.seconds["coarse_pairs"] = time.perf_counter() - t0
        rows, cols = np.nonzero(rb != np.arange(rb.shape[0])[:, None])
        i, j = rows.astype(np.int64), rb[rows, cols].astype(np.int64)
        keep = (i < n) & (j < n) & (i != j)
        i, j = i[keep], j[keep]
        keep = valid[i] & valid[j]
        i, j = i[keep], j[keep]
        from_cells = set(zip(np.minimum(i, j).tolist(), np.maximum(i, j).tolist()))
        extra = sorted(pairs - from_cells)
        ordered = sorted(from_cells) + extra
        cap = self.cfg.rerank_pair_cap
        overflow = max(0, len(ordered) - cap)
        return np.array(ordered[:cap], np.int64).reshape(-1, 2), {
            "capped_buckets": capped,
            "overflow_pairs": overflow,
        }

    def _settle_device(
        self, sketch_rows: torch.Tensor, idx: torch.Tensor, clock: StageClock
    ):
        """``(jq int32[m], verdict int8[m], h2d_bytes)``: the sketches
        (``int32[n_sk, S]``) copied to the device, the settle and its
        finalize over the pairs' row indices (``int32[2, m]``, pinned on
        the host: the wrapper checks them there and copies them), one
        readback, each a stage of ``clock``.  On the card one launch of
        ``rerank_settle`` writes both, and ``finalize`` is an empty stage;
        on the CPU the plain versions run one after the other."""
        cfg = self.cfg
        dev = self.device
        lo = oprr.quantize(cfg.sim_threshold - cfg.rerank_margin)
        hi = oprr.quantize(cfg.sim_threshold + cfg.rerank_margin)
        sk = sketch_rows.to(dev, non_blocking=True).view(torch.uint32)
        stages.count_device_put(sketch_rows.nbytes, "rerank")
        stages.count_device_put(idx.nbytes, "rerank")  # the wrapper copies it
        self.last_settle_inputs = (sk, idx)
        clock.lap("sketch_copy")
        if dev.type == "cuda":
            out = rerank_settle(sk, idx[0], idx[1], sk.shape[1], lo, hi)
            clock.lap("settle")
        else:
            jq = oprr.pair_jq_plain(sk, idx[0], idx[1])
            clock.lap("settle")
            out = torch.stack([jq, oprr.rerank_finalize(jq, lo, hi).to(torch.int32)])
        stages.count_dispatch("rerank")
        clock.lap("finalize")
        out = out.cpu().numpy()
        clock.lap("settle_readback")
        h2d = sketch_rows.nbytes + idx.nbytes if dev.type == "cuda" else 0
        return out[0], out[1].astype(np.int8), h2d

    def _reprobe(self, i: int, j: int, keys64) -> bool | None:
        """Borderline re-probe over the persistent index: both documents'
        wide band keys are probed; the pair survives when the index
        attributes both to the same earliest posted doc.  ``None``: no
        index, or no evidence either way."""
        if self.index is None or keys64 is None:
            return None
        attr = np.asarray(self.index.probe_batch(keys64[[i, j]]))
        if attr[0] < 0 or attr[1] < 0:
            return None
        return bool(attr[0] == attr[1])

    def __call__(self, raw: Sequence[bytes], sigs, rep_bands, valid):
        cfg = self.cfg
        thr = cfg.sim_threshold
        n = len(raw)
        sigs_np = np.asarray(sigs)
        rb = np.asarray(rep_bands)
        valid_np = np.asarray(valid)
        n_bucket, nc = rb.shape
        clock = self.last_clock = StageClock(self.device, stage_prefix="rerank_")
        lap = clock.lap
        pair_arr, stats = self._candidate_pairs(sigs_np, rb, valid_np, n)
        lap("candidates")
        m = pair_arr.shape[0]
        self.stats = stats
        stats.update(
            pairs=m, launches=0, h2d_bytes=0, borderline=0,
            exact_checks=0, reprobes=0, evicted=0, clusters=0,
            dropped_cells=0, predicted_precision=1.0,
        )
        # decision provenance: pairs the host re-settled, keyed (lo, hi) →
        # "margin" (exact Jaccard) or "rerank" (past the cap, the sketch
        # verdict stands); every other pair the device sketch settled
        prov: dict[tuple[int, int], str] = {}
        self.last_provenance = prov
        self.last_evicted = set()
        self.last_pairs = pair_arr
        self.last_settle_inputs = None
        if m == 0:
            self.last_participants = set()
            out, _ = oprr.rewrite_rep_bands(n_bucket, nc, [])
            return out

        # each participating document's sketch once, in one pinned buffer
        part = np.unique(pair_arr)
        self.last_participants = set(part.tolist())
        pin = self.device.type == "cuda"
        sketch_rows = torch.empty(
            (part.size, cfg.rerank_sketch), dtype=torch.int32, pin_memory=pin
        )
        sketches = oprr.bottom_sketches(
            [raw[i] for i in part.tolist()], self.params.shingle_k, cfg.rerank_sketch,
            skip=~valid_np[part], out=sketch_rows.numpy().view(np.uint32),
        )
        row = {d: r for r, d in enumerate(part.tolist())}
        idx = torch.empty((2, m), dtype=torch.int32, pin_memory=pin)
        idx.numpy()[:] = np.searchsorted(part, pair_arr.T)
        lap("bottom_sketches")

        launches = rerank_settle.launches
        jq, verdict, h2d = self._settle_device(sketch_rows, idx, clock)
        stats["launches"] = rerank_settle.launches - launches
        stats["h2d_bytes"] = h2d

        # host re-settle of the margin band: exact Jaccard up to the cap,
        # then the index re-probe, else the sketch verdict stands
        shingles: dict[int, set] = {}

        def sset(i: int) -> set:
            s = shingles.get(i)
            if s is None:
                s = shingles[i] = shingle_set(raw[i], self.params.shingle_k)
            return s

        exact_used = 0
        thr_q = oprr.quantize(thr)
        keep = verdict == 1
        border = np.flatnonzero(verdict == -1)
        stats["borderline"] = int(border.size)
        keys64 = None
        if self.index is not None and border.size:
            keys64 = pack_keys64(
                oprr.band_keys_wide_host(sigs_np[:n], self.params.band_salt)
            )

        def settle_exact(i: int, j: int, jq_ij: int) -> bool:
            nonlocal exact_used
            key = (i, j) if i < j else (j, i)
            if exact_used < cfg.rerank_exact_cap:
                exact_used += 1
                prov[key] = "margin"
                return jaccard(sset(i), sset(j)) >= thr
            rp = self._reprobe(i, j, keys64)
            if rp is not None:
                stats["reprobes"] += 1
                prov[key] = "reprobe"
                return rp
            prov[key] = "rerank"  # cap overflow: the sketch verdict stands
            return jq_ij >= thr_q

        for s in border.tolist():
            keep[s] = settle_exact(int(pair_arr[s, 0]), int(pair_arr[s, 1]), int(jq[s]))
        stats["exact_checks"] = exact_used
        lap("margin")

        # cluster the settled keep-edges, then classify every within-cluster
        # pair (wave 2: pairs the candidacy never proposed are settled on
        # the host — sketch estimator, margin → exact)
        reps = oprr.union_find(n, pair_arr[keep])
        clusters: dict[int, list[int]] = {}
        for i in np.flatnonzero(valid_np[:n]).tolist():
            clusters.setdefault(int(reps[i]), []).append(i)
        clusters = {r: ms for r, ms in clusters.items() if len(ms) > 1}
        stats["clusters"] = len(clusters)

        settled = {
            (a, b): (k, q)
            for (a, b), k, q in zip(pair_arr.tolist(), keep.tolist(), jq.tolist())
        }
        margin = cfg.rerank_margin
        lanes = sigs_np.shape[1]
        # expected oracle-recall mass of the whole work-list, summed pair by
        # pair in order: the eviction's recall floor divides by it
        total_op_mass = sum(oprr.op_weight(q / oprr.SCALE, lanes, thr) for q in jq.tolist())
        pairinfo: dict[tuple[int, int], tuple[bool, float]] = {}
        for r, ms in clusters.items():
            for x in range(len(ms)):
                for y in range(x + 1, len(ms)):
                    a, b = ms[x], ms[y]
                    key = (a, b)
                    if key in settled:
                        is_keep, q = settled[key]
                        w = oprr.op_weight(q / oprr.SCALE, lanes, thr)
                    else:
                        jhat = oprr.sketch_jaccard(sketches[row[a]], sketches[row[b]])
                        if abs(jhat - thr) < margin:
                            is_keep = settle_exact(a, b, oprr.quantize(jhat))
                        else:
                            is_keep = jhat >= thr
                        # extras the candidacy never proposed lie outside the
                        # estimator oracle's buckets: zero recall mass
                        w = 0.0
                    pairinfo[key] = (not is_keep, w)
        stats["exact_checks"] = exact_used
        lap("cluster")

        evicted, pprec = oprr.evict_for_precision(
            clusters,
            pairinfo,
            cfg.rerank_precision_target,
            recall_floor=cfg.rerank_recall_floor,
            total_op_mass=total_op_mass,
        )
        stats["evicted"] = len(evicted)
        stats["predicted_precision"] = pprec
        self.last_evicted = {int(d) for d in evicted}
        lap("evict")

        # surviving settled-true cluster edges become the new candidate matrix
        edges = []
        for r, ms in clusters.items():
            live = [d for d in ms if d not in evicted]
            for x in range(len(live)):
                for y in range(x + 1, len(live)):
                    a, b = live[x], live[y]
                    if not pairinfo[(a, b)][0]:
                        edges.append((a, b))
        out, dropped = oprr.rewrite_rep_bands(n_bucket, nc, edges)
        stats["dropped_cells"] = dropped
        lap("rewrite")
        return out
