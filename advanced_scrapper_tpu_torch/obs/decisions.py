"""Decision provenance: every dedup verdict names the tier that settled it.

The port's copy of the reference's ``obs/decisions.py``, with its series
names, record fields and file format, so that either package's
:meth:`DecisionJournal.read` reads the other's journal and the
reference's ``tools/explain_dedup.py`` reads the port's.

- **Always-on counters**: ``astpu_decision_total{tier, verdict}``
  (:data:`TIERS` × dup/unique), incremented through
  :class:`DecisionRecorder` by every producer: ``pipeline/dedup.py``'s
  certified one-shot and index paths and ``ExactDedup``, and
  ``extractors/tpu_batch.py``'s exact, bloom and persist stages.  Like the
  stage histograms they bypass the telemetry gate.
- **A bounded, sampled JSONL journal**: one record per decision (doc id,
  tier, verdict, attributed doc, winning band key), appended through the
  ``storage/fsio`` seam.  A torn tail is dropped whole by the reader,
  "dup" records are always kept while "unique" records are sampled
  (``sample``, a pure function of the seed and the record's sequence
  number), and the file rotates to ``<path>.old`` at ``max_bytes``.

The journal is off by default (``ASTPU_DECISION_JOURNAL=<path>`` turns it
on; ``ASTPU_DECISION_SAMPLE`` and ``ASTPU_DECISION_JOURNAL_MAX_BYTES`` tune
it).  Off, producers build no row and read nothing extra back from the
card: ``DecisionRecorder.journal is None`` gates every row-building branch,
so a corpus costs only the counter increments.

This module imports ``obs.telemetry`` and the fsio seam only: producers
call in, nothing here calls out.
"""

from __future__ import annotations

import json
import os
import threading
import time

__all__ = [
    "TIERS",
    "VERDICTS",
    "DecisionJournal",
    "DecisionRecorder",
    "get_recorder",
    "set_recorder",
    "configure",
    "decision_mix_snapshot",
    "decision_mix_delta",
]

#: the settling tiers, in evidence order (strongest first):
#: ``exact``   — byte/url-identity stage (memcmp-confirmed first-seen);
#: ``index``   — persistent/bloom stream-index posting hit;
#: ``band``    — raw LSH band collision settled by the signature
#:               estimator (or a collision-free unique);
#: ``rerank``  — the precision tier's device bottom-sketch settle or its
#:               precision-targeted eviction;
#: ``margin``  — host exact-Jaccard re-settle of the margin band (both
#:               the rerank margin and the certified path's
#:               exact_verify_band);
#: ``reprobe`` — the borderline ANN re-probe over index postings.
TIERS = ("exact", "index", "band", "rerank", "margin", "reprobe")
VERDICTS = ("dup", "unique")

JOURNAL_ENV = "ASTPU_DECISION_JOURNAL"
SAMPLE_ENV = "ASTPU_DECISION_SAMPLE"
MAX_BYTES_ENV = "ASTPU_DECISION_JOURNAL_MAX_BYTES"
DEFAULT_SAMPLE = 0.05
DEFAULT_MAX_BYTES = 64 << 20

_MIX = 2654435761  # Knuth multiplicative hash: seeded per-seq sampling


class DecisionJournal:
    """Bounded, sampled, torn-tail-tolerant JSONL decision sidecar.

    Append-only through the fsio seam; each :meth:`append` writes whole
    ``\\n``-terminated lines in one buffer, so a short write can
    only ever tear the LAST line — which the reader (and every torn-tail
    reader in the tree) drops whole.  After a failed append the next one
    leads with a ``\\n``: a record can never merge into a torn tail and
    parse as garbage.
    """

    def __init__(
        self,
        path: str,
        *,
        fs=None,
        sample: float = DEFAULT_SAMPLE,
        max_bytes: int = DEFAULT_MAX_BYTES,
        seed: int = 0,
    ):
        from advanced_scrapper_tpu_torch.storage.fsio import default_fs

        self.path = path
        self._fs = fs or default_fs()
        self.sample = float(sample)
        self.max_bytes = int(max_bytes)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._seq = 0
        self._torn = False  # last append faulted: lead the next with \n
        self.appended = 0
        self.sampled_out = 0
        self.write_errors = 0

    def _keep(self, seq: int, verdict: str) -> bool:
        """dup records are always kept (they are what explain queries
        join on); unique records are sampled — deterministically per
        (seed, seq), not by a shared random stream, so a run's journal
        is reproducible."""
        if verdict != "unique" or self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        h = (((seq + self.seed) * _MIX) & 0xFFFFFFFF) / 2.0**32
        return h < self.sample

    def append(self, rows) -> int:
        """Append decision rows (dicts); returns the count actually
        journaled (after sampling).  OSErrors are contained: a faulty
        substrate costs records, never the producer."""
        ts = round(time.time(), 3)
        with self._lock:
            payload = []
            for row in rows:
                seq = self._seq
                self._seq += 1
                if not self._keep(seq, row.get("verdict", "")):
                    self.sampled_out += 1
                    continue
                rec = {"seq": seq, "ts": ts}
                rec.update(row)
                payload.append(
                    json.dumps(rec, separators=(",", ":"), sort_keys=True)
                )
            if not payload:
                return 0
            data = ("\n".join(payload) + "\n").encode("utf-8")
            if self._torn:
                data = b"\n" + data
            try:
                self._rotate_locked(len(data))
                with self._fs.open(self.path, "ab") as fh:
                    fh.write(data)
            except OSError:
                self.write_errors += 1
                self._torn = True
                from advanced_scrapper_tpu_torch.obs import telemetry

                telemetry.event_counter(
                    "astpu_decision_journal_errors_total",
                    "decision-journal appends that faulted (records lost "
                    "whole; the journal stays parseable)",
                ).inc()
                return 0
            self._torn = False
            self.appended += len(payload)
            return len(payload)

    def _rotate_locked(self, incoming: int) -> None:
        """One-deep rotation at the byte cap: ``path`` → ``path.old``.
        The sidecar is bounded at ~2× ``max_bytes``; readers walk both
        generations oldest-first."""
        if self.max_bytes <= 0:
            return
        try:
            size = self._fs.size(self.path) if self._fs.exists(self.path) else 0
            if size + incoming <= self.max_bytes:
                return
            old = self.path + ".old"
            if self._fs.exists(old):
                self._fs.remove(old)
            self._fs.replace(self.path, old)
        except OSError:
            pass  # rotation is best-effort; append decides durability

    @staticmethod
    def read(path: str, fs=None) -> list[dict]:
        """Every parseable record, ``path.old`` first (oldest-first).
        An unterminated tail is torn — dropped whole; a line that fails
        to parse (merged torn garbage, bit rot) is skipped, never
        propagated."""
        from advanced_scrapper_tpu_torch.storage.fsio import default_fs

        fs = fs or default_fs()
        out: list[dict] = []
        for p in (path + ".old", path):
            if not fs.exists(p):
                continue
            with fs.open(p, "rb") as fh:
                data = fh.read()
            for line in data.split(b"\n")[:-1]:  # unterminated tail = torn
                if not line:
                    continue
                try:
                    rec = json.loads(line.decode("utf-8"))
                except (ValueError, UnicodeDecodeError):
                    continue
                if isinstance(rec, dict):
                    out.append(rec)
        return out


class DecisionRecorder:
    """The producer handle: always-on per-(tier, verdict) counters plus
    the optional journal.  Producers gate every row-building branch on
    ``recorder.journal is not None`` — the disabled journal costs
    nothing but the counter increments."""

    def __init__(self, journal: DecisionJournal | None = None, registry=None):
        from advanced_scrapper_tpu_torch.obs import telemetry

        self._reg = registry or telemetry.REGISTRY
        self.journal = journal
        self._handles: dict[tuple[str, str], object] = {}
        self._gen = self._reg.generation
        self._hlock = threading.Lock()

    def _handle(self, tier: str, verdict: str):
        # the admission plane's lazy re-instrument pattern: a registry
        # reset (tests) bumps `generation`; cached handles from the old
        # generation would increment outside the fresh registry's view
        with self._hlock:
            if self._gen != self._reg.generation:
                self._handles.clear()
                self._gen = self._reg.generation
            key = (tier, verdict)
            h = self._handles.get(key)
            if h is None:
                h = self._reg.counter(
                    "astpu_decision_total",
                    "dedup verdicts by the tier that settled them "
                    "(always-on decision provenance)",
                    always=True,
                    tier=tier,
                    verdict=verdict,
                )
                self._handles[key] = h
            return h

    def count(self, tier: str, verdict: str, n: int = 1) -> None:
        if n:
            self._handle(tier, verdict).inc(n)

    def journal_rows(self, rows) -> int:
        j = self.journal
        return j.append(rows) if j is not None else 0

    def record(self, tier: str, verdict: str, **fields) -> None:
        """Count + journal ONE decision — for sparse call sites (the
        batch paths build row lists and call :meth:`journal_rows`)."""
        self.count(tier, verdict)
        if self.journal is not None:
            self.journal.append([{"tier": tier, "verdict": verdict, **fields}])


_LOCK = threading.Lock()
_RECORDER: DecisionRecorder | None = None


def get_recorder() -> DecisionRecorder:
    """The process-wide recorder, built lazily from the env knobs
    (``ASTPU_DECISION_JOURNAL`` path — empty/unset disables the
    journal)."""
    global _RECORDER
    with _LOCK:
        if _RECORDER is None:
            path = os.environ.get(JOURNAL_ENV, "")
            journal = None
            if path:
                journal = DecisionJournal(
                    path,
                    sample=float(
                        os.environ.get(SAMPLE_ENV, "") or DEFAULT_SAMPLE
                    ),
                    max_bytes=int(
                        os.environ.get(MAX_BYTES_ENV, "") or DEFAULT_MAX_BYTES
                    ),
                )
            _RECORDER = DecisionRecorder(journal)
        return _RECORDER


def set_recorder(recorder: DecisionRecorder | None) -> None:
    """Install (or clear — next :func:`get_recorder` re-reads the env)
    the process recorder; tests and tools wire explicit journals here."""
    global _RECORDER
    with _LOCK:
        _RECORDER = recorder


def configure(
    journal_path: str | None,
    *,
    sample: float = DEFAULT_SAMPLE,
    max_bytes: int = DEFAULT_MAX_BYTES,
    fs=None,
    seed: int = 0,
) -> DecisionRecorder:
    """Build + install a recorder explicitly (None/'' path = counters
    only).  Returns the installed recorder."""
    journal = None
    if journal_path:
        journal = DecisionJournal(
            journal_path, fs=fs, sample=sample, max_bytes=max_bytes, seed=seed
        )
    rec = DecisionRecorder(journal)
    set_recorder(rec)
    return rec


def decision_mix_snapshot(registry=None) -> dict[str, float]:
    """``{"<tier>:<verdict>": count}`` from the live counters — the
    snapshot/delta surface bench's per-regime ``<regime>_decision_mix``
    keys subtract over (the ``regime_device_counters`` pattern)."""
    from advanced_scrapper_tpu_torch.obs import telemetry

    reg = registry or telemetry.REGISTRY
    out: dict[str, float] = {}
    for m in reg.find("astpu_decision_total"):
        tier = m.labels.get("tier", "?")
        verdict = m.labels.get("verdict", "?")
        out[f"{tier}:{verdict}"] = float(m.value)
    return out


def decision_mix_delta(
    before: dict[str, float], after: dict[str, float] | None = None
) -> dict[str, float]:
    """Non-zero per-(tier, verdict) deltas since ``before``."""
    if after is None:
        after = decision_mix_snapshot()
    out = {}
    for k, v in sorted(after.items()):
        d = v - before.get(k, 0.0)
        if d:
            out[k] = d
    return out
