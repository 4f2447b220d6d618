"""Constant-rate acquisition engine (L2).

The port's copy of the reference's ``pipeline/scraper.py``: pages parse
into the port's HTML tree (``core/soup.py:Soup``) in place of bs4, and
``run_scraper`` streams successes into the port's ``TpuBatchBackend`` on
``device`` (the card unless the caller asks for the CPU).

Re-implements the production engine's semantics
(``constant_rate_scrapper.py:115-493``) with the races designed out
(SURVEY.md §5.2):

- **admission control at the admit stage**, not the workers: one URL
  enters the runtime-owned ``urls`` edge every ``1/rate`` seconds (ref
  ``:207-220``).  The whole fixed mode is a stage graph
  (``runtime.StageGraph``): admit → urls → fetch×N → results, with the
  scheduler owning queues, backpressure, shutdown ordering and the
  crash drain-snapshot;
- **worker pool** of N fetch-stage workers, each owning its transport via
  the stage's ``worker_init``/``worker_close`` bracket (the ref's
  per-thread Firefox, ``:136``);
- **rate-limit circuit breaker**: the extractor's ``rate_limit_reached``
  sentinel or a network fingerprint (``contentEncodingError`` /
  ``about:neterror``, ref ``:190-193``) trips a global pause for
  ``rate_limit_wait`` seconds.  The ref mutates an unlocked global ``pause``
  read by three threads; here :class:`PauseController` owns a deadline
  behind a lock;
- **single-writer CSVs**: only the result loop touches the success/failed
  files (the ref locks per-file; we remove the shared mutation instead),
  flush-per-row so the checkpoint is always current;
- **resume**: the work list is anti-joined against urls already present in
  the success/failed CSVs (ref ``:316-356``) — failures are first-class
  data and are not retried;
- a URL consumed by a rate-limited fetch is *not* written anywhere, so a
  later resume retries it (ref behaviour, ``:160-164``).

The optional ``on_success`` hook is the host→device seam: ``run_scraper`` wires
it to ``extractors.tpu_batch.TpuBatchBackend.submit`` so scraped articles
stream into device batches asynchronously (north star).  The engine records
a hook's error in ``ScrapeSummary.errors`` and goes on, as the reference
does, unless it is built with ``fatal_hook=True``; ``run_scraper`` builds
it so, and a backend error ends the run.

Two stage series time the layers (``obs.stages``, the always-on
``astpu_stage_seconds`` histogram): ``scrape_extract`` is the tree build
and extractor of each page (``scrape_extract_cpu`` the same by the fetch
thread's CPU clock, so GIL waits drop out) and ``scrape_backend`` the
result loop's time in the hook and ``run_scraper``'s final flush.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, Sequence

from advanced_scrapper_tpu_torch.config import ScraperConfig
from advanced_scrapper_tpu_torch.core.soup import Soup
from advanced_scrapper_tpu_torch.obs import stages
from advanced_scrapper_tpu_torch.obs.console import ConsoleMux
from advanced_scrapper_tpu_torch.obs.stats import StatsTracker
from advanced_scrapper_tpu_torch.runtime import DONE, StageGraph

# the deadline-based global pause moved to the runtime (every graph can
# honour it, not just the scraper); re-exported here because this module
# has always been its import site
from advanced_scrapper_tpu_torch.runtime.pause import PauseGate as PauseController  # noqa: F401,E501
from advanced_scrapper_tpu_torch.storage.csvio import AppendCsv, count_rows, scraped_url_set

# canonical home is the extractor boundary (the schema is the plugin
# contract's output, and net/ consumes it too); re-exported here because
# this module has always been its import site
from advanced_scrapper_tpu_torch.extractors import (  # noqa: F401
    FAILED_FIELDS,
    SUCCESS_FIELDS,
)

_RATE_LIMIT_FINGERPRINTS = (
    "contentEncodingError",  # Firefox/geckodriver (ref :190)
    "about:neterror",        # Firefox/geckodriver (ref :190)
    "net::ERR_",             # Chrome/CDP network errors (stealth-chrome
    #                          transport: net::ERR_CONNECTION_RESET etc. —
    #                          without these the circuit breaker is blind
    #                          on the Chrome substrate)
    "ERR_HTTP2_PROTOCOL_ERROR",
)


@dataclass
class ScrapeSummary:
    total_urls: int = 0
    already_scraped: int = 0
    attempted: int = 0
    succeeded: int = 0
    failed: int = 0
    rate_limited_skipped: int = 0  # consumed by a sentinel page; retried on resume
    rate_limit_trips: int = 0
    errors: list = field(default_factory=list)


class ScraperEngine:
    def __init__(
        self,
        cfg: ScraperConfig,
        extractor: Callable,
        transport_factory: Callable[[], object],
        *,
        console: ConsoleMux | None = None,
        on_success: Callable[[dict], None] | None = None,
        fatal_hook: bool = False,
        sleep=time.sleep,
    ):
        self.cfg = cfg
        self.extractor = extractor
        self.transport_factory = transport_factory
        # An unstarted mux would buffer one string per URL for the whole run;
        # when the engine owns the console it runs (and stops) the consumer.
        self._owns_console = console is None
        self.console = console or ConsoleMux()
        self.on_success = on_success
        self.fatal_hook = fatal_hook
        self.sleep = sleep
        self.stats = StatsTracker(window=cfg.stats_time_window)
        self.pause = PauseController()
        self._stop = threading.Event()
        self._bridge_stats()

    _seq_lock = threading.Lock()
    _seq = 0

    def _bridge_stats(self) -> None:
        """Bridge the engine-local :class:`StatsTracker` (and the pause
        controller) into the process registry as scrape-time callback
        gauges — the 10 Hz console line and ``/metrics`` now read the same
        tracker.  Weakref'd on the engine: a finished run unregisters
        itself; no hot-path cost (workers keep calling the tracker
        directly)."""
        from advanced_scrapper_tpu_torch.obs import telemetry

        with ScraperEngine._seq_lock:
            eid = str(ScraperEngine._seq)
            ScraperEngine._seq += 1
        telemetry.gauge_fn(
            "astpu_scraper_fetch_success",
            lambda e: e.stats.get_cumulative_stats()[0],
            owner=self,
            help="cumulative successful fetches this run",
            engine=eid,
        )
        telemetry.gauge_fn(
            "astpu_scraper_fetch_fail",
            lambda e: e.stats.get_cumulative_stats()[1],
            owner=self,
            help="cumulative failed fetches this run",
            engine=eid,
        )
        telemetry.gauge_fn(
            "astpu_scraper_request_rate",
            lambda e: e.stats.get_actual_rate(),
            owner=self,
            help="requests/s over the stats window",
            engine=eid,
        )
        telemetry.gauge_fn(
            "astpu_scraper_pause_remaining_seconds",
            lambda e: e.pause.remaining(),
            owner=self,
            help="rate-limit circuit-breaker countdown (0 = not paused)",
            engine=eid,
        )

    # -- worker ------------------------------------------------------------

    def _classify(self, url: str, html: str):
        soup = Soup(html)
        data = self.extractor(soup)
        if "rate_limit_reached" in str(data.get("error", "")).lower():
            # carry the url so the result loop can account for it; the url is
            # still written nowhere (resume retries it, ref :160-164)
            return ("rate_limit", {"url": url})
        if not data.get("title", ""):
            return ("failed", {"url": url, "error": "Title is empty"})
        data["url"] = url
        return ("success", data)

    def _fetch_one(self, transport, url: str) -> list[tuple[str, object]]:
        """Fetch + classify one url → result events (usually one; a
        fingerprinted network failure emits its failed row AND the
        rate-limit signal, like the reference).  Decisions, console lines,
        stats and circuit-breaker trips are identical for the fixed-mode
        graph stage and the elastic worker bodies — both call this."""
        try:
            html = transport.fetch(url)
            t0, c0 = time.perf_counter(), time.thread_time()
            kind, payload = self._classify(url, html)
            stages.add("scrape_extract", time.perf_counter() - t0)
            stages.add("scrape_extract_cpu", time.thread_time() - c0)
            if kind == "rate_limit":
                self.console.failure("!!!RATE LIMIT DETECTED!!!")
                self.pause.trigger(self.cfg.rate_limit_wait)
                return [("rate_limit", payload)]
            if kind == "failed":
                self.console.failure(f"FAIL {url} : {payload['error']}")
                self.stats.record_fail()
                return [("failed", payload)]
            self.console.success(f"SUCCESS: {url}")
            self.stats.record_success()
            return [("success", payload)]
        except Exception as e:
            msg = str(e)
            self.console.failure(f"FAIL {url} : {msg}")
            self.stats.record_fail()
            out: list[tuple[str, object]] = [("failed", {"url": url, "error": msg})]
            if any(fp in msg for fp in _RATE_LIMIT_FINGERPRINTS):
                self.console.failure(
                    "!!!RATE LIMIT DETECTED (network fingerprint)!!!"
                )
                self.pause.trigger(self.cfg.rate_limit_wait)
                out.append(("rate_limit", None))
            return out

    def _worker(
        self,
        url_q,
        result_q,
        worker_stop: threading.Event | None = None,
    ) -> None:
        """Elastic-mode worker body (driven by :class:`ElasticWorkerPool`,
        which owns thread count): the queues are runtime Edges speaking the
        ``queue.Queue`` surface; fixed mode runs the same fetch logic as a
        graph stage instead."""

        def stopped() -> bool:
            return self._stop.is_set() or (
                worker_stop is not None and worker_stop.is_set()
            )

        try:
            transport = self.transport_factory()
        except Exception as e:
            self.console.failure(f"Failed to start transport: {e}")
            self._stop.set()
            return
        try:
            while not stopped():
                try:
                    url = url_q.get(timeout=0.1)
                except queue.Empty:
                    continue
                # honour the circuit breaker at the worker too: in elastic
                # modes there is no feeder to gate admission, so this is the
                # only place the pause can take effect
                self.pause.wait(sleep=self.sleep, should_stop=stopped)
                for item in self._fetch_one(transport, url):
                    result_q.put(item)
                url_q.task_done()
        finally:
            try:
                transport.close()
            except Exception:
                pass

    # -- stats line --------------------------------------------------------

    def _stats_line(self, initial_total: int, already: int) -> str:
        rate = self.stats.get_actual_rate()
        s, f = self.stats.get_stats()
        cs, cf = self.stats.get_cumulative_stats()
        total = cs + cf + already
        progress = (total / initial_total * 100) if initial_total else 0.0
        line = (
            f"Threads: {self.cfg.max_threads} | Requests: {rate:.2f}/s | "
            f"Last {int(self.cfg.stats_time_window)} s: {s} Success, {f} Fail | "
            f"Count: {total} | Progress: {progress:.4f}%"
        )  # format ref :236-242
        # Surface the circuit-break countdown so an operator can tell a
        # rate-limit pause from a stall (ref :244-249 renders this as a
        # per-second "resuming in N s" ticker).
        pause_left = self.pause.remaining()
        if pause_left > 0:
            line += f" | PAUSED: rate limit, resuming in {pause_left:.0f} s"
        return line

    # -- run ---------------------------------------------------------------

    def run(
        self,
        urls: Sequence[str],
        success_csv: str,
        failed_csv: str,
        *,
        initial_total: int | None = None,
        already_scraped: int = 0,
        show_stats: bool = False,
        mode: str = "fixed",
    ) -> ScrapeSummary:
        summary = ScrapeSummary(
            total_urls=len(urls), already_scraped=already_scraped
        )
        if self._owns_console and not self.console.running:
            self.console.start()
        initial_total = initial_total or len(urls)
        # ONE scheduler owns both queues: the graph's edges replace the
        # bespoke queue.Queue pair (elastic modes ride the same edges via
        # their queue-compat surface; the runtime's depth/stall telemetry
        # and the crash drain-snapshot cover both modes for free)
        # no graph-level pause gate on purpose: the fetch fn waits on
        # self.pause ITSELF so the engine's injectable sleep applies (the
        # runtime's pausable= path uses real time.sleep)
        graph = StageGraph("scrape")
        url_q = graph.edge("urls")       # unbounded: elastic modes pre-fill
        result_q = graph.edge("results")

        pool = None
        if mode == "fixed":
            # production design: fixed fetch pool + rate-paced admit stage
            # (ref C1).  admission control at the admit stage, not the
            # workers: one URL enters the edge every 1/rate seconds.
            urls_iter = iter(urls)
            interval = 1.0 / self.cfg.desired_request_rate
            first = [True]

            def admit():
                if self._stop.is_set():
                    return DONE
                if first[0]:
                    first[0] = False
                else:
                    self.sleep(interval)
                self.pause.wait(sleep=self.sleep, should_stop=self._stop.is_set)
                try:
                    return next(urls_iter)
                except StopIteration:
                    return DONE

            def init_transport():
                try:
                    return self.transport_factory()
                except Exception as e:
                    self.console.failure(f"Failed to start transport: {e}")
                    self._stop.set()
                    raise

            def fetch(url, transport):
                # honour the circuit breaker at the worker too (the pause
                # must gate in-queue urls, not just admission), with the
                # engine's injected sleep so tests stay fast
                self.pause.wait(sleep=self.sleep, should_stop=self._stop.is_set)
                return self._fetch_one(transport, url)

            graph.stage("admit", source=admit, out_edge=url_q)
            graph.stage(
                "fetch",
                fn=fetch,
                in_edge=url_q,
                out_edge=result_q,
                workers=self.cfg.max_threads,
                worker_init=init_transport,
                worker_close=lambda t: t.close(),
                fan_out=True,
            )
        else:
            # elastic designs: pre-filled queue, controller-driven pool size
            # (ref experiental/local_dynamic.py / local_pid.py)
            from advanced_scrapper_tpu_torch.pipeline.controllers import (
                ElasticWorkerPool,
                PController,
                PIDController,
                PoolLimits,
            )

            for u in urls:
                url_q.put(u)
            if mode == "elastic-p":
                controller = PController(self.cfg.desired_request_rate)
                interval = 0.5  # ref local_dynamic.py:233
            elif mode == "elastic-pid":
                controller = PIDController(self.cfg.desired_request_rate)
                interval = 0.8  # ref local_pid.py:279
            else:
                raise ValueError(f"unknown mode '{mode}'")
            pool = ElasticWorkerPool(
                controller,
                self.stats,
                lambda ev: self._worker(url_q, result_q, ev),
                limits=PoolLimits(1, self.cfg.max_threads),
                interval=interval,
                sleep=self.sleep,
            ).start()
        # started in BOTH modes: the elastic graph has no stages (the
        # controller owns the workers) but starting it registers the run
        # — and its edges — with the crash-snapshot plane
        graph.start()

        stats_stop = threading.Event()
        if show_stats:
            def stats_loop():
                while not stats_stop.is_set():
                    self.console.stats(self._stats_line(initial_total, already_scraped))
                    self.sleep(0.1)

            threading.Thread(target=stats_loop, daemon=True).start()

        try:
            with AppendCsv(success_csv, SUCCESS_FIELDS) as ok_csv, AppendCsv(
                failed_csv, FAILED_FIELDS
            ) as bad_csv:
                processed = 0
                while processed < len(urls):
                    try:
                        kind, data = result_q.get(timeout=self.cfg.result_timeout)
                    except queue.Empty:
                        # a failed graph closes the results edge, which
                        # reads as an IMMEDIATE Empty — report the real
                        # exception the runtime captured, not a phantom
                        # timeout nobody can debug
                        if graph.error is not None:
                            summary.errors.append(
                                f"workers died: {graph.error!r}"
                            )
                        else:
                            summary.errors.append("result timeout")
                        break
                    if kind == "success":
                        ok_csv.write_row(data)  # write_row fills missing fields
                        summary.succeeded += 1
                        processed += 1
                        if self.on_success is not None:
                            try:
                                with stages.timed("scrape_backend"):
                                    self.on_success(dict(data))
                            except Exception as e:
                                if self.fatal_hook:
                                    raise
                                summary.errors.append(f"on_success: {e}")
                    elif kind == "failed":
                        bad_csv.write_row(data)
                        summary.failed += 1
                        processed += 1
                    elif kind == "rate_limit":
                        # Sentinel-path events carry the consumed url: count it so
                        # the loop terminates without stalling on result_timeout.
                        # Fingerprint-path events (data None) already produced a
                        # failed row and must not double-count.
                        if data is not None:
                            summary.rate_limited_skipped += 1
                            processed += 1
                        # Wait out the pause here too (ref :463-468) — otherwise
                        # the result timeout below would fire mid-pause and abort
                        # the run.  The pause controller is the single authority.
                        self.console.event(
                            f"Rate limit: pausing {self.pause.remaining():.0f} s"
                        )
                        self.pause.wait(sleep=self.sleep, should_stop=self._stop.is_set)
                        self.console.event("Resuming scraping.")
        finally:
            # always tear the fleet down — a CSV write failing with EIO
            # (chaos substrate, disk full) must not strand live worker
            # threads behind the propagating exception.  graph.stop()
            # closes every edge (waking blocked puts/pops); join bounds
            # the total wait like the per-thread joins it replaces.
            summary.attempted = summary.succeeded + summary.failed
            summary.rate_limit_trips = self.pause.trips
            self._stop.set()
            stats_stop.set()
            if pool is not None:
                pool.stop()
            graph.stop()
            graph.join(timeout=10, raise_error=False)
            if self._owns_console:
                self.console.stop()
            self.console.drain()
        return summary


def run_scraper(
    cfg: ScraperConfig,
    *,
    transport_factory: Callable[[], object] | None = None,
    urls: Iterable[str] | None = None,
    with_tpu_backend: bool = True,
    show_stats: bool = True,
    device=None,
) -> int:
    """CLI entry: resume-aware scrape of ``cfg.input_csv``.

    Mirrors ``constant_rate_scrapper.main()`` (``:289-493``): dynamic
    extractor import, CSV resume anti-join, then the engine; optionally
    streams successes into the device dedup backend (north star).
    ``device`` is the backend's: ``None`` means the card and raises without
    one, ``"cpu"`` runs the kernels' plain versions.  A backend error is
    not caught: it ends the run (the engine is built with
    ``fatal_hook=True``), which never goes on without its device.
    """
    import os

    from advanced_scrapper_tpu_torch.extractors import load_extractor

    extractor = load_extractor(cfg.website)

    success_csv = os.path.join(cfg.out_dir, f"success_articles_{cfg.website}.csv")
    failed_csv = os.path.join(cfg.out_dir, f"failed_articles_{cfg.website}.csv")

    if urls is None:
        from advanced_scrapper_tpu_torch.storage.csvio import read_url_column

        if not os.path.exists(cfg.input_csv):
            print(f"Input CSV file '{cfg.input_csv}' not found.")
            return 1
        urls = read_url_column(cfg.input_csv)
    all_urls = [str(u) for u in urls]
    initial_total = len(all_urls)

    scraped = scraped_url_set(success_csv, failed_csv)
    already = count_rows(success_csv) + count_rows(failed_csv)
    todo = [u for u in all_urls if u not in scraped]
    print(f"Total URLs in CSV: {initial_total}")
    print(f"Already scraped (Success + Fails): {already}")
    print(f"Remaining URLs to scrape: {len(todo)}")

    if transport_factory is None:
        from advanced_scrapper_tpu_torch.net.transport import make_transport

        transport_factory = lambda: make_transport(  # noqa: E731
            cfg.transport,
            page_load_timeout=cfg.page_load_timeout,
            ready_state_timeout=cfg.ready_state_timeout,
        )

    on_success = None
    backend = None
    ann_csv = None
    if with_tpu_backend:
        from advanced_scrapper_tpu_torch.config import DedupConfig, from_env
        from advanced_scrapper_tpu_torch.extractors.tpu_batch import TpuBatchBackend
        from advanced_scrapper_tpu_torch.storage.csvio import AppendCsv as _Csv

        ann_csv = _Csv(
            os.path.join(cfg.out_dir, f"dedup_annotations_{cfg.website}.csv"),
            ["url", "dup_of", "near_dup_of"],
        )
        # from_env: the ASTPU_DEDUP_* knobs (stream_index=persist, the
        # checkpoint cadence, index geometry) reach the production entry
        dedup_cfg = from_env(DedupConfig, "dedup")
        index_dir = dedup_cfg.index_dir or os.path.join(
            cfg.out_dir, f"stream_index_{cfg.website}"
        )
        backend = TpuBatchBackend(
            dedup_cfg,
            sink=lambda rec: ann_csv.write_row(
                {
                    "url": rec.get("url", ""),
                    "dup_of": rec.get("dup_of") or "",
                    "near_dup_of": rec.get("near_dup_of") or "",
                }
            ),
            index_dir=index_dir,
            device=device,
        )
        if dedup_cfg.stream_index == "persist" and dedup_cfg.index_fleet:
            # remote fleet: announce the topology (the per-shard health is
            # live on /metrics, astpu_fleet_*; spill journals land under
            # the local index dir)
            print(
                f"Stream index: remote fleet "
                f"[{dedup_cfg.index_fleet}], spill at {index_dir}/spill"
            )
        # the fifth resume artifact: without the stream index a restarted
        # run re-admits near-dups of everything already annotated; a torn
        # checkpoint (pre-hardening crash) is quarantined and ignored.  In
        # persist mode the npz path is the LEGACY artifact, auto-imported
        # once into the durable index (MIGRATION.md).
        index_ckpt = os.path.join(cfg.out_dir, f"stream_index_{cfg.website}.npz")
        backend.load_index_if_valid(index_ckpt)

        # checkpoint cadence (DedupConfig.ckpt_every_batches — previously
        # the index persisted only at run end): every N processed device
        # batches the stream index checkpoints, so a crash loses at most N
        # batches of dedup memory, never the whole run's.  0 disables the
        # periodic checkpoint (end-of-run only — the right setting for
        # huge exact-mode corpora, where each checkpoint is a full npz
        # rewrite; persist mode checkpoints are O(new postings))
        every = dedup_cfg.ckpt_every_batches

        def on_success(rec, _backend=backend, _every=every, _ckpt=index_ckpt):
            if (
                _backend.submit(rec)
                and _every > 0
                and _backend.stats.batches % _every == 0
            ):
                _backend.checkpoint(_ckpt)

    console = ConsoleMux().start()
    engine = ScraperEngine(
        cfg,
        extractor,
        transport_factory,
        console=console,
        on_success=on_success,
        fatal_hook=True,
    )
    try:
        summary = engine.run(
            todo,
            success_csv,
            failed_csv,
            initial_total=initial_total,
            already_scraped=already,
            show_stats=show_stats,
        )
    finally:
        # nested so a failing flush/save (disk full, ...) can neither mask
        # the run's own exception with a half-cleaned console nor skip
        # closing the annotation CSV
        try:
            if backend is not None:
                with stages.timed("scrape_backend"):
                    backend.flush()
                backend.save_index(index_ckpt)
                backend.close()
        finally:
            try:
                if ann_csv is not None:
                    ann_csv.close()
            finally:
                console.stop()
    print(
        f"\nScraping completed: {summary.succeeded} success, "
        f"{summary.failed} failed, {summary.rate_limited_skipped} rate-limited, "
        f"{summary.rate_limit_trips} rate-limit trips."
    )
    return 0
