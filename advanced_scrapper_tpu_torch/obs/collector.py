"""Fleet-wide metrics aggregation: one scrape plane over every process.

The port's copy of the reference's ``obs/collector.py``: the same
merged view, served by the port's ``obs/telemetry.py``.

Telemetry makes each process observable; the system is a multi-process
fleet (RPC index shards, lease servers, scraper workers, bench children)
whose ``/metrics`` endpoints are islands.  This module is
the pull-based collector that merges them:

- **discovery**: endpoints are added explicitly (``add_endpoint``), parsed
  from a comma/semicolon list of urls, or discovered from an *obs dir* —
  every :class:`~.telemetry.StatusServer` under ``ASTPU_OBS_DIR`` drops a
  ``<name>.endpoint`` file after its listen succeeds, so the collector
  never races an ephemeral bind and never needs a port registry;
- **scrape + merge**: each endpoint's ``GET /metrics`` (Prometheus text)
  is pulled concurrently under a per-endpoint timeout and re-served from
  ONE merged view with an ``instance=<name>`` label on every series, so
  two shards exporting the same series name can never collide;
- **staleness, not blocking**: a dead endpoint (mid-failover, SIGKILLed)
  costs one timeout in the background scrape loop — serving always reads
  the cached last-known samples, flagged by ``astpu_collector_endpoint_up
  {instance}`` and ``astpu_collector_scrape_age_seconds{instance}``, so a
  scrape during failover returns partial results with a staleness marker
  instead of hanging the dashboard;
- **crash-sidecar harvesting**: flight-recorder JSONL dumps
  (``obs/trace.py``) written by dying processes are pulled centrally from
  a sidecar directory; the harvest names the dead shard (the
  ``shard.serve`` event every :class:`~..index.remote.IndexShardServer`
  records at start) so a chaos kill is attributable from the collector's
  ``/status`` alone.

The merged view is itself served on ``GET /metrics`` + ``/status``
(:meth:`FleetCollector.serve`), which is also what the SLO engine
(``obs/slo.py``) and ``obs_top --fleet`` evaluate/render.
"""

from __future__ import annotations

import json
import math
import os
import re
import threading
import time
import urllib.request

__all__ = [
    "FleetCollector",
    "parse_prometheus_text",
    "parse_endpoint_list",
]

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


def parse_endpoint_list(spec: str) -> list[tuple[str, str]]:
    """``name=url,name=url`` (or bare urls, named by host:port) → pairs."""
    out = []
    for part in re.split(r"[,;]", spec):
        part = part.strip()
        if not part:
            continue
        if "=" in part and not part.startswith("http"):
            name, _, url = part.partition("=")
        else:
            name, url = "", part
        if not url.startswith("http"):
            url = f"http://{url}"
        if not name:
            name = url.split("://", 1)[-1].rstrip("/")
        out.append((name, url))
    return out


class _Endpoint:
    """Per-endpoint scrape state; mutated only by the scrape path, read
    (under the collector lock) by the serve path."""

    __slots__ = (
        "name", "url", "samples", "types", "exemplars", "ok", "error",
        "last_ok", "last_attempt", "scrapes", "failures",
        "profile", "profile_ok",
    )

    def __init__(self, name: str, url: str):
        self.name = name
        self.url = url.rstrip("/")
        self.samples: list = []
        self.types: dict = {}
        self.exemplars: list = []
        self.ok = False
        self.error = ""
        self.last_ok = 0.0       # monotonic stamp of the last good scrape
        self.last_attempt = 0.0
        self.scrapes = 0
        self.failures = 0
        self.profile = ""        # last-known /profile folded text
        self.profile_ok = False


class FleetCollector:
    """Scrape N ``/metrics`` endpoints, merge them under ``instance``
    labels, harvest crash sidecars, serve the fleet-wide view."""

    def __init__(
        self,
        endpoints=(),
        *,
        timeout: float = 2.0,
        obs_dir: str | None = None,
        sidecar_dir: str | None = None,
        stale_after: float = 15.0,
        profiles: bool = False,
    ):
        """``endpoints``: iterable of ``(name, url)`` pairs or bare urls.
        ``obs_dir``: directory of ``*.endpoint`` announcement files,
        re-scanned on every scrape round (new processes join the merge
        without a restart).  ``sidecar_dir``: where dying processes'
        flight-recorder JSONL dumps land (``ASTPU_FLIGHT_RECORDER``);
        scanned by :meth:`harvest_sidecars`.  ``stale_after``: seconds
        without a good scrape before an endpoint's cached samples are
        flagged stale in ``/status``.  ``profiles``: also pull each
        endpoint's ``GET /profile`` (the continuous host profiler,
        ``obs/profiler.py``) every scrape round and serve the merged
        per-instance folded stacks on the collector's own ``/profile``
        (off by default — profile bodies are bigger than metrics and only
        exist under ``ASTPU_PROFILE``; :meth:`harvest_profiles` is always
        callable on demand)."""
        self.timeout = timeout
        self.obs_dir = obs_dir
        self.sidecar_dir = sidecar_dir
        self.stale_after = stale_after
        self.profiles = profiles
        self._lock = threading.Lock()
        self._endpoints: dict[str, _Endpoint] = {}
        self._sidecars: dict[str, dict] = {}  # path → harvested summary
        self._rounds = 0
        self._stop = threading.Event()
        self._loop_thread: threading.Thread | None = None
        self._server = None
        for ep in endpoints:
            if isinstance(ep, str):
                for name, url in parse_endpoint_list(ep):
                    self.add_endpoint(name, url)
            else:
                self.add_endpoint(*ep)

    # -- topology ----------------------------------------------------------

    def add_endpoint(self, name: str, url: str) -> None:
        with self._lock:
            if name not in self._endpoints:
                self._endpoints[name] = _Endpoint(name, url)

    def discover(self) -> int:
        """Scan the obs dir for ``*.endpoint`` files; returns how many NEW
        endpoints joined.  A vanished file does not remove the endpoint —
        its staleness marker is the honest signal (the process may be
        mid-crash with its dump still worth harvesting)."""
        if not self.obs_dir or not os.path.isdir(self.obs_dir):
            return 0
        added = 0
        for fn in sorted(os.listdir(self.obs_dir)):
            if not fn.endswith(".endpoint"):
                continue
            name = fn[: -len(".endpoint")]
            with self._lock:
                known = name in self._endpoints
            if known:
                continue
            try:
                with open(os.path.join(self.obs_dir, fn), encoding="utf-8") as fh:
                    url = fh.readline().strip()
            except OSError:
                continue
            if url.startswith("http"):
                self.add_endpoint(name, url)
                added += 1
        return added

    # -- scraping ----------------------------------------------------------

    def _scrape_endpoint(self, ep: _Endpoint) -> None:
        ep.last_attempt = time.monotonic()
        ep.scrapes += 1
        try:
            with urllib.request.urlopen(
                ep.url + "/metrics", timeout=self.timeout
            ) as r:
                text = r.read().decode("utf-8", errors="replace")
            samples, types, exemplars = parse_prometheus_text(text)
        except Exception as e:  # noqa: BLE001 — any fetch fault = endpoint down
            with self._lock:
                ep.ok = False
                ep.error = f"{type(e).__name__}: {e}"
                ep.failures += 1
            return
        with self._lock:
            ep.samples = samples
            ep.types = types
            ep.exemplars = exemplars
            ep.ok = True
            ep.error = ""
            ep.last_ok = time.monotonic()

    def scrape_once(self) -> dict:
        """One concurrent scrape round over every known endpoint (after a
        discovery pass); returns ``{endpoint: ok}``.  Bounded by the
        per-endpoint timeout — one dark shard costs one timeout, in
        parallel with the live scrapes, never a serial stall."""
        self.discover()
        with self._lock:
            eps = list(self._endpoints.values())
        threads = [
            threading.Thread(target=self._scrape_endpoint, args=(ep,), daemon=True)
            for ep in eps
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=self.timeout + 1.0)
        if self.sidecar_dir:
            self.harvest_sidecars()
        if self.profiles:
            self.harvest_profiles()
        with self._lock:
            self._rounds += 1
            return {ep.name: ep.ok for ep in eps}

    # -- profile harvest ---------------------------------------------------

    def _fetch_profile(self, ep: _Endpoint) -> None:
        try:
            with urllib.request.urlopen(
                ep.url + "/profile", timeout=self.timeout
            ) as r:
                text = r.read().decode("utf-8", errors="replace")
        except Exception:
            with self._lock:
                ep.profile_ok = False
            return
        with self._lock:
            ep.profile = text
            ep.profile_ok = True

    def harvest_profiles(self) -> dict:
        """Pull every endpoint's ``GET /profile`` (concurrently, same
        per-endpoint timeout discipline as the metrics scrape); returns
        ``{endpoint: ok}``.  A dead or profile-less endpoint keeps its
        last-known folded stacks — the merged view is a fleet snapshot,
        staleness travels with the metrics-side markers."""
        with self._lock:
            eps = list(self._endpoints.values())
        threads = [
            threading.Thread(target=self._fetch_profile, args=(ep,), daemon=True)
            for ep in eps
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=self.timeout + 1.0)
        with self._lock:
            return {ep.name: ep.profile_ok for ep in eps}

    def merged_profile(self) -> str:
        """The fleet-wide folded-stack view: every endpoint's last-known
        ``/profile`` body with the instance name prefixed onto each stack
        (``instance;root;...;leaf count``) — one text a flamegraph tool
        renders with per-process towers side by side.  Endpoint header
        comments are kept, re-tagged per instance."""
        lines: list[str] = []
        with self._lock:
            eps = list(self._endpoints.values())
        for ep in eps:
            if not ep.profile:
                continue
            for line in ep.profile.splitlines():
                line = line.strip()
                if not line:
                    continue
                if line.startswith("#"):
                    lines.append(f"# instance={ep.name} {line.lstrip('# ')}")
                else:
                    lines.append(f"{ep.name};{line}")
        return "\n".join(lines) + "\n"

    # -- sidecar harvest ---------------------------------------------------

    def harvest_sidecars(self) -> list[dict]:
        """Pull flight-recorder JSONL dumps from the sidecar dir into the
        collector's state: each dump is summarized (pid, reason, event
        count, every ``shard``/``graph`` name seen in its events) so the
        fleet view NAMES what died.  Cached by (size, mtime); a dump is
        re-read only when it grew (a process can dump once per death, but
        several processes may share a file via append)."""
        if not self.sidecar_dir or not os.path.isdir(self.sidecar_dir):
            return []
        for root, _dirs, files in os.walk(self.sidecar_dir):
            for fn in sorted(files):
                if not fn.endswith(".jsonl"):
                    continue
                path = os.path.join(root, fn)
                try:
                    st = os.stat(path)
                except OSError:
                    continue
                key = (st.st_size, int(st.st_mtime))
                with self._lock:
                    prev = self._sidecars.get(path)
                if prev is not None and prev.get("_stat") == list(key):
                    continue
                summary = self._read_sidecar(path)
                if summary is None:
                    continue
                summary["_stat"] = list(key)
                with self._lock:
                    self._sidecars[path] = summary
        with self._lock:
            return [
                {k: v for k, v in s.items() if k != "_stat"}
                for _p, s in sorted(self._sidecars.items())
            ]

    @staticmethod
    def _read_sidecar(path: str) -> dict | None:
        dumps = 0
        pid = None
        reasons: list[str] = []
        shards: set[str] = set()
        events = 0
        faults: list[str] = []
        try:
            with open(path, encoding="utf-8", errors="replace") as fh:
                for line in fh:
                    try:
                        ev = json.loads(line)
                    except ValueError:
                        continue  # an OS-cut tail line stays tolerable
                    if not isinstance(ev, dict):
                        continue
                    events += 1
                    if ev.get("kind") == "dump":
                        dumps += 1
                        pid = ev.get("pid", pid)
                        if ev.get("reason"):
                            reasons.append(str(ev["reason"]))
                    elif ev.get("kind") == "fault":
                        faults.append(str(ev.get("reason", ev.get("name"))))
                    # DEATH attribution only — never routine traffic: a
                    # shard names ITSELF via its shard.serve event (its
                    # dump exists because it died), and a surviving
                    # client names dead PEERS via failover events.  A
                    # client's fleet.probe/insert spans name every shard
                    # it ever touched and must not count.
                    if "shard" in ev and ev.get("name") in (
                        "shard.serve", "fleet.failover"
                    ):
                        shards.add(str(ev["shard"]))
        except OSError:
            return None
        if events == 0:
            return None
        return {
            "path": path,
            "name": os.path.basename(path),
            "pid": pid,
            "dumps": dumps,
            "reasons": reasons[-3:],
            "faults": faults[-3:],
            "shards": sorted(shards),
            "events": events,
        }

    def dead_shards(self) -> list[str]:
        """Every shard name appearing in a harvested crash dump — the
        "which shard died" answer the chaos battery asserts on."""
        with self._lock:
            out: set[str] = set()
            for s in self._sidecars.values():
                out.update(s.get("shards", ()))
            return sorted(out)

    # -- merged views ------------------------------------------------------

    def _self_samples(self):
        """The collector's own always-on series (computed, not stored: the
        collector aggregates OTHER registries and must not also race the
        process-local one)."""
        now = time.monotonic()
        samples: list[tuple[str, dict, float]] = []
        types = {
            "astpu_collector_endpoint_up": "gauge",
            "astpu_collector_scrape_age_seconds": "gauge",
            "astpu_collector_scrape_failures_total": "counter",
            "astpu_collector_endpoints": "gauge",
            "astpu_collector_rounds_total": "counter",
            "astpu_collector_sidecar_dumps": "gauge",
            "astpu_collector_series": "gauge",
        }
        with self._lock:
            eps = list(self._endpoints.values())
            n_series = sum(len(ep.samples) for ep in eps)
            for ep in eps:
                lab = {"instance": ep.name}
                samples.append(
                    ("astpu_collector_endpoint_up", lab, 1.0 if ep.ok else 0.0)
                )
                age = (now - ep.last_ok) if ep.last_ok else float("inf")
                samples.append(
                    (
                        "astpu_collector_scrape_age_seconds",
                        lab,
                        age if age != float("inf") else -1.0,
                    )
                )
                samples.append(
                    ("astpu_collector_scrape_failures_total", lab, float(ep.failures))
                )
            samples.append(("astpu_collector_endpoints", {}, float(len(eps))))
            samples.append(("astpu_collector_rounds_total", {}, float(self._rounds)))
            samples.append(
                ("astpu_collector_sidecar_dumps", {}, float(len(self._sidecars)))
            )
            samples.append(("astpu_collector_series", {}, float(n_series)))
        return samples, types

    def merged_samples(self):
        """Every endpoint's last-known samples with ``instance=<name>``
        stamped on, plus the collector's own series.  Dead endpoints keep
        serving their cache (partial results beat a blocking scrape); the
        ``astpu_collector_*`` series carry the staleness truth."""
        out, types = self._self_samples()
        with self._lock:
            for ep in self._endpoints.values():
                for name, labels, v in ep.samples:
                    out.append((name, {**labels, "instance": ep.name}, v))
                for n, k in ep.types.items():
                    types.setdefault(n, k)
        return out, types

    def prometheus_text(self) -> str:
        """The merged fleet registry in Prometheus text format (what the
        collector's own ``/metrics`` serves)."""
        samples, types = self.merged_samples()
        lines: list[str] = []
        typed: set[str] = set()
        for name, labels, v in samples:
            base = name
            for suffix in ("_bucket", "_sum", "_count"):
                if name.endswith(suffix) and name[: -len(suffix)] in types:
                    base = name[: -len(suffix)]
                    break
            if base not in typed and base in types:
                typed.add(base)
                lines.append(f"# TYPE {base} {types[base]}")
            sv = (
                str(int(v))
                if math.isfinite(v) and v == int(v) and abs(v) < 1e15
                else repr(v)
            )
            if labels:
                inner = ",".join(
                    f'{k}="{_escape_label(v2)}"'
                    for k, v2 in sorted(labels.items())
                )
                lines.append(f"{name}{{{inner}}} {sv}")
            else:
                lines.append(f"{name} {sv}")
        with self._lock:
            for ep in self._endpoints.values():
                for ex in ep.exemplars:
                    inner = ",".join(
                        f'{k}="{_escape_label(v2)}"'
                        for k, v2 in sorted(
                            {**ex["labels"], "instance": ep.name}.items()
                        )
                    )
                    lines.append(
                        f"# exemplar {ex['name']}{{{inner}}} "
                        f'trace="{ex["trace"]}" value={ex["value"]!r} '
                        f"ts={ex['ts']!r}"
                    )
        return "\n".join(lines) + "\n"

    def status(self) -> dict:
        """JSON fleet view for ``/status``: per-endpoint health +
        staleness, merged series (flat), harvested sidecars."""
        now = time.monotonic()
        with self._lock:
            endpoints = []
            for ep in self._endpoints.values():
                age = (now - ep.last_ok) if ep.last_ok else None
                endpoints.append(
                    {
                        "name": ep.name,
                        "url": ep.url,
                        "ok": ep.ok,
                        "stale": (age is None) or (age > self.stale_after),
                        "age_s": round(age, 3) if age is not None else None,
                        "series": len(ep.samples),
                        "scrapes": ep.scrapes,
                        "failures": ep.failures,
                        "error": ep.error,
                    }
                )
            sidecars = [
                {k: v for k, v in s.items() if k != "_stat"}
                for _p, s in sorted(self._sidecars.items())
            ]
        samples, _types = self.merged_samples()
        return {
            "ts": time.time(),
            "pid": os.getpid(),
            "collector": True,
            "endpoints": endpoints,
            "dead_shards": self.dead_shards(),
            "sidecars": sidecars,
            "metrics": [
                {"name": n, "labels": l, "value": v} for n, l, v in samples
            ],
        }

    # -- serving -----------------------------------------------------------

    def serve(
        self, *, host: str = "127.0.0.1", port: int = 0, interval: float = 1.0
    ):
        """Start the background scrape loop + an HTTP exporter serving the
        MERGED ``/metrics`` and ``/status``; returns self (``.host`` /
        ``.port`` carry the bound address)."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        from advanced_scrapper_tpu_torch.obs import telemetry

        collector = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path == "/metrics":
                    telemetry.send_http_payload(
                        self, 200,
                        collector.prometheus_text().encode("utf-8"),
                        telemetry.PROMETHEUS_CONTENT_TYPE,
                    )
                elif self.path == "/status":
                    telemetry.send_http_payload(
                        self, 200,
                        json.dumps(collector.status()).encode("utf-8"),
                        "application/json",
                    )
                elif self.path == "/profile":
                    telemetry.send_http_payload(
                        self, 200,
                        collector.merged_profile().encode("utf-8"),
                        "text/plain; charset=utf-8",
                    )
                else:
                    telemetry.send_http_payload(
                        self, 404,
                        json.dumps(
                            {"error": f"no such endpoint {self.path}"}
                        ).encode("utf-8"),
                        "application/json",
                    )

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._server.server_address[:2]
        threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="astpu-collector-http",
        ).start()
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval):
                self.scrape_once()

        self.scrape_once()  # the first round is synchronous: serve real data
        self._loop_thread = threading.Thread(
            target=loop, daemon=True, name="astpu-collector-scrape"
        )
        self._loop_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=5)
            self._loop_thread = None
