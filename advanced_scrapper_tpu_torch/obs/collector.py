"""The Prometheus text parser of the reference's ``obs/collector.py``.

:func:`parse_prometheus_text` turns a registry's exposition text
(``telemetry.Registry.prometheus_text``) into flat ``(name, labels,
value)`` samples, the form the SLO engine (``obs/slo.py``) evaluates.  The
rest of the reference's collector, the ``FleetCollector`` that scrapes and
merges a fleet's ``/metrics`` endpoints, is not ported yet: it comes with
ROADMAP item 18 (the host planes).
"""

from __future__ import annotations

import re

__all__ = ["parse_prometheus_text"]

#: one parsed series sample: (name, labels, value)
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>[^\s]+)"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_EXEMPLAR_RE = re.compile(
    r"^# exemplar (?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r'\s+trace="(?P<trace>[^"]*)" value=(?P<value>[^\s]+) ts=(?P<ts>[^\s]+)'
)


def _escape_label(v) -> str:
    """Inverse of :func:`_parse_labels`' unescaping — label values round-
    trip through the collector unchanged (quotes/backslashes included)."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


def _parse_labels(raw: str | None) -> dict:
    if not raw:
        return {}
    return {
        k: v.replace('\\"', '"').replace("\\\\", "\\")
        for k, v in _LABEL_RE.findall(raw)
    }


def parse_prometheus_text(text: str):
    """Parse Prometheus exposition text → ``(samples, types, exemplars)``.

    ``samples`` is ``[(name, labels, value)]`` (histogram ``_bucket`` /
    ``_sum`` / ``_count`` series appear as plain samples — exactly the
    shape the merge re-serves); ``types`` maps base metric name → kind
    from ``# TYPE`` lines; ``exemplars`` is the slow-call exemplar
    comment lines (``obs/telemetry.py``) as dicts.  Unparseable lines are
    skipped, never raised — a half-written or foreign exporter must not
    poison the whole merge."""
    samples: list[tuple[str, dict, float]] = []
    types: dict[str, str] = {}
    exemplars: list[dict] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            if line.startswith("# TYPE "):
                parts = line.split()
                if len(parts) >= 4:
                    types[parts[2]] = parts[3]
            else:
                m = _EXEMPLAR_RE.match(line)
                if m:
                    try:
                        exemplars.append(
                            {
                                "name": m.group("name"),
                                "labels": _parse_labels(m.group("labels")),
                                "trace": m.group("trace"),
                                "value": float(m.group("value")),
                                "ts": float(m.group("ts")),
                            }
                        )
                    except ValueError:
                        pass
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        try:
            v = float(m.group("value"))
        except ValueError:
            continue
        samples.append((m.group("name"), _parse_labels(m.group("labels")), v))
    return samples, types, exemplars
