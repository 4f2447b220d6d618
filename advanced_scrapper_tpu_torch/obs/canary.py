"""Ground-truth canary prober: live recall and precision SLIs for dedup.

The port's copy of the reference's ``obs/canary.py``.  :class:`CanaryProber`
*generates* seeded synthetic near-dup families whose oracle answers are
measured by exact shingle Jaccard (``cpu/oracle.py``'s definition), pushes
them through a live resolution path and scores the verdicts:

- ``astpu_canary_recall`` / ``astpu_canary_precision``: pair-level SLIs of
  the last round (always-on gauges);
- ``astpu_canary_latency_seconds``: the round's end-to-end latency
  (generate, resolve, score, expire);
- ``astpu_canary_rounds_total`` / ``astpu_canary_postings_wiped_total``:
  probe cadence and the expiry's proof of work.

The prober is hook-injected: it imports nothing of ``pipeline`` or
``index``.  The caller hands in ``resolve`` (on the card, the default
engine's certified one-shot ``NearDupEngine(DedupConfig(),
device="cuda").dedup_reps``, so the probe runs the real rerank, margin
and band tiers and feels the brownout ladder), and optionally an
``index_run`` + ``wipe`` pair over an index whose postings the round may
write (:data:`CANARY_SPACE_PREFIX` names the reserved key space);
:meth:`run_round` calls ``wipe`` before it returns, whether the round
raised or not.  As in the reference, that pair binds to a fleet client's
canary space: ``canary = client.for_space(CANARY_SPACE_PREFIX + "probe")``
(``index/fleet.py``), ``index_run`` over ``canary.check_and_add_batch`` and
``wipe=canary.wipe``; the shard servers provision the space on first touch
and refuse a wipe of any other.

Declared objectives (:meth:`objectives`) plug the SLIs into the SLO engine
(``obs/slo.py``) as ``gauge_min`` objectives: a round whose recall falls
under ``recall_min`` (``skip_rerank`` forced on, say) flips
``astpu_slo_compliant{objective="canary_recall"}`` to 0, and recovery
flips it back.
"""

from __future__ import annotations

import threading
import time

import numpy as np

__all__ = [
    "CANARY_SPACE_PREFIX",
    "CanaryProber",
    "make_canary_corpus",
]

#: reserved key-space name prefix for canary postings (the reference's
#: ``index/remote.py`` restricts its ``wipe`` RPC to spaces under it).
CANARY_SPACE_PREFIX = "canary:"

_MIX = 2654435761


def _perturb(rng, tokens: list[str], n_swap: int, vocab: int) -> list[str]:
    """Replace ``n_swap`` distinct token positions with fresh vocabulary
    — the family-member generator (token swaps map ~linearly onto char-
    shingle Jaccard loss, and the oracle measures the truth anyway)."""
    out = list(tokens)
    for p in rng.choice(len(out), size=min(n_swap, len(out)), replace=False):
        out[int(p)] = f"x{int(rng.integers(vocab, 4 * vocab))}"
    return out


def make_canary_corpus(
    seed: int,
    *,
    families: int = 6,
    members: int = 4,
    distractors: int = 8,
    tokens: int = 60,
    vocab: int = 50_000,
    shingle_k: int = 8,
    threshold: float = 0.7,
):
    """Deterministic synthetic corpus with a measured oracle.

    Families alternate two regimes: **clear** (few token swaps, true
    J ≈ 0.85–0.95 — every tier catches these) and **knee** (swaps tuned
    so true J sits just above ``threshold`` — the estimator-fragile band
    whose recall the rerank/margin tiers exist to save; a brownout that
    skips them shows up HERE first).  Distractors are unrelated docs.

    Returns ``(texts, oracle)`` where ``oracle`` is the set of doc-index
    pairs ``(i, j), i < j`` whose EXACT shingle Jaccard (the oracle's own
    ``shingle_set``/``jaccard`` definition, imported so the two can never
    diverge) is ≥ ``threshold`` — ground truth by measurement, not by
    intent, so a swap that overshot never mislabels the oracle.
    """
    from advanced_scrapper_tpu_torch.cpu.oracle import jaccard, shingle_set

    rng = np.random.default_rng((seed * _MIX) & 0xFFFFFFFF)
    texts: list[str] = []
    for f in range(families):
        base = [f"w{int(t)}" for t in rng.integers(0, vocab, size=tokens)]
        texts.append(" ".join(base))
        knee = f % 2 == 1
        for _m in range(members - 1):
            # knee members walk the swap count up until the measured J
            # falls into the target band (never below threshold: a
            # member that dropped out of the family would thin the
            # oracle, not stress the knee)
            n_swap = int(rng.integers(8, 13)) if knee else int(rng.integers(1, 3))
            cand = _perturb(rng, base, n_swap, vocab)
            if knee:
                a = shingle_set(" ".join(base).encode(), shingle_k)
                while (
                    n_swap > 0
                    and jaccard(
                        a, shingle_set(" ".join(cand).encode(), shingle_k)
                    )
                    < threshold + 0.02
                ):
                    n_swap -= 1
                    cand = _perturb(rng, base, n_swap, vocab)
            texts.append(" ".join(cand))
    for _d in range(distractors):
        texts.append(
            " ".join(
                f"w{int(t)}" for t in rng.integers(0, vocab, size=tokens)
            )
        )
    order = rng.permutation(len(texts))
    texts = [texts[int(i)] for i in order]
    shingles = [shingle_set(t.encode(), shingle_k) for t in texts]
    oracle = {
        (i, j)
        for i in range(len(texts))
        for j in range(i + 1, len(texts))
        if jaccard(shingles[i], shingles[j]) >= threshold
    }
    return texts, oracle


class CanaryProber:
    """Continuous quality prober over a live resolution path.

    ``resolve(texts) → int reps[N]`` — the live engine's certified
    one-shot (same-rep docs are predicted dup pairs).  ``index_run``
    (optional) pushes the corpus through a ``canary:``-space index /
    index (``texts → attr``), proving the index plane live;
    ``wipe()`` (optional, paired) expires those postings after scoring —
    :meth:`run_round` always calls it, success or not.
    """

    def __init__(
        self,
        resolve,
        *,
        index_run=None,
        wipe=None,
        registry=None,
        seed: int = 0,
        families: int = 6,
        members: int = 4,
        distractors: int = 8,
        shingle_k: int = 8,
        threshold: float = 0.7,
    ):
        from advanced_scrapper_tpu_torch.obs import telemetry

        self._resolve = resolve
        self._index_run = index_run
        self._wipe = wipe
        self._reg = registry or telemetry.REGISTRY
        self.seed = int(seed)
        self.families = int(families)
        self.members = int(members)
        self.distractors = int(distractors)
        self.shingle_k = int(shingle_k)
        self.threshold = float(threshold)
        self.rounds = 0
        self.last_sli: dict = {}
        self._lock = threading.Lock()

    # -- metric handles (generation-checked: a registry reset in tests
    # must not strand increments on stale objects) ------------------------

    def _metrics(self):
        reg = self._reg
        return {
            "recall": reg.gauge(
                "astpu_canary_recall",
                "last canary round's pair recall vs the measured oracle "
                "(ground-truth synthetic families; always-on quality SLI)",
                always=True,
            ),
            "precision": reg.gauge(
                "astpu_canary_precision",
                "last canary round's pair precision vs the measured oracle",
                always=True,
            ),
            "latency": reg.histogram(
                "astpu_canary_latency_seconds",
                "end-to-end canary round latency (generate → resolve → "
                "score → expire)",
                always=True,
            ),
            "rounds": reg.counter(
                "astpu_canary_rounds_total",
                "canary probe rounds completed",
                always=True,
            ),
            "wiped": reg.counter(
                "astpu_canary_postings_wiped_total",
                "canary-space postings expired after probe rounds (the "
                "no-pollution proof-of-work)",
                always=True,
            ),
        }

    def run_round(self, round_id: int | None = None) -> dict:
        """One probe round; returns (and exports) the SLI dict:
        ``{round, recall, precision, latency_seconds, oracle_pairs,
        predicted_pairs, caught_pairs, index_dups, wiped}``."""
        with self._lock:
            rid = self.rounds if round_id is None else int(round_id)
            m = self._metrics()
            t0 = time.perf_counter()
            texts, oracle = make_canary_corpus(
                self.seed + rid,
                families=self.families,
                members=self.members,
                distractors=self.distractors,
                shingle_k=self.shingle_k,
                threshold=self.threshold,
            )
            wiped = 0
            try:
                reps = np.asarray(self._resolve(texts))
                n = len(texts)
                pred = {
                    (i, j)
                    for i in range(n)
                    for j in range(i + 1, n)
                    if reps[i] == reps[j]
                }
                index_dups = -1
                if self._index_run is not None:
                    attr = np.asarray(self._index_run(texts))
                    index_dups = int((attr >= 0).sum())
            finally:
                # expiry is unconditional: a raised round must not leave
                # synthetic postings behind
                if self._wipe is not None:
                    try:
                        wiped = int(self._wipe())
                    except Exception:
                        wiped = -1
            caught = len(pred & oracle)
            recall = caught / len(oracle) if oracle else 1.0
            precision = caught / len(pred) if pred else 1.0
            latency = time.perf_counter() - t0
            self.rounds = rid + 1
            sli = {
                "round": rid,
                "recall": recall,
                "precision": precision,
                "latency_seconds": latency,
                "oracle_pairs": len(oracle),
                "predicted_pairs": len(pred),
                "caught_pairs": caught,
                "index_dups": index_dups,
                "wiped": wiped,
            }
            self.last_sli = sli
            m["recall"].set(recall)
            m["precision"].set(precision)
            m["latency"].observe(latency)
            m["rounds"].inc()
            if wiped > 0:
                m["wiped"].inc(wiped)
            return sli

    def objectives(
        self,
        *,
        recall_min: float = 0.9,
        precision_min: float = 0.9,
        budget: float = 0.05,
    ) -> list:
        """Declared quality objectives for the SLO engine:
        ``gauge_min`` over the canary SLIs (violated while the live
        gauge sits under the floor; burn rates over the engine's
        fast/slow windows)."""
        from advanced_scrapper_tpu_torch.obs.slo import SloObjective

        return [
            SloObjective(
                name="canary_recall",
                kind="gauge_min",
                metric="astpu_canary_recall",
                threshold=float(recall_min),
                budget=budget,
            ),
            SloObjective(
                name="canary_precision",
                kind="gauge_min",
                metric="astpu_canary_precision",
                threshold=float(precision_min),
                budget=budget,
            ),
        ]
