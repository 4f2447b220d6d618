"""Command-line interface of the port: ``astpu-torch``, or ``python -m
advanced_scrapper_tpu_torch``.

The reference's ``astpu`` (``advanced_scrapper_tpu/cli.py``) with the same
subcommands and arguments, plus one global ``--device {cuda,cpu}``
(default ``cuda``, which raises without a card; ``cpu`` runs every
kernel's plain version).  Flags override the ``ASTPU_*`` environment knobs
(``config.from_env``), which override the defaults.  Ported: ``version``,
``config``, ``dedup`` (whole corpus, and ``--stream`` with an exact or
bloom index), ``match``, ``xdedup``, ``scrape`` (its successes streamed
into the dedup backend on ``--device``), ``harvest`` (both engines; the
merge's exact dedup on ``--device``), ``new-links``, ``split``, ``serve``
and ``work`` (the lease server and client), ``enrich`` (Wikidata
enrichment; ``requests`` is needed only for a live run), ``poll`` (the
topic poller and its drain), ``selftest`` (the integration ladder; its
live rungs need ``--live`` and ``ASTPU_LIVE=1``) and ``smoke``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys

from advanced_scrapper_tpu_torch import __version__
from advanced_scrapper_tpu_torch.config import default_config

def _with_overrides(cfg, **overrides):
    overrides = {k: v for k, v in overrides.items() if v is not None}
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def _cmd_version(args: argparse.Namespace) -> int:
    print(__version__)
    return 0


def _cmd_config(args: argparse.Namespace) -> int:
    print(json.dumps(dataclasses.asdict(default_config()), indent=2, default=str))
    return 0


def _cmd_dedup(args: argparse.Namespace) -> int:
    """Near-dup dedup of a newline-delimited text file (one doc per line)."""

    def open_sink():
        # opened only after the input is readable: opening it earlier would
        # truncate an existing output on any early failure
        return (open(args.output, "w", encoding="utf-8") if args.output
                else contextlib.nullcontext(sys.stdout))

    if args.index and not args.stream:
        print("astpu dedup: --index requires --stream", file=sys.stderr)
        return 2
    if args.stream:
        # bounded memory: lines flow through the stream backend and its
        # cross-batch index instead of being read whole
        from advanced_scrapper_tpu_torch.extractors.tpu_batch import TpuBatchBackend

        cfg = _with_overrides(default_config().dedup, backend=args.backend,
                              stream_index=args.index)
        kept = total = 0
        with open(args.input, "r", encoding="utf-8", errors="replace") as f, \
                open_sink() as out:

            def emit(rec: dict) -> None:
                nonlocal kept
                if rec.get("dup_of") is None and rec.get("near_dup_of") is None:
                    kept += 1
                    out.write(rec["article"] + "\n")

            # line-number keys are unique, so every line is a near-dup
            # target, and exact_stage=False keeps them out of the exact-key
            # filter
            backend = TpuBatchBackend(cfg, sink=emit, exact_stage=False, device=args.device)
            # lines shorter than a shingle pass the near-dup stage untouched;
            # dedup those few byte strings here by content, as the
            # whole-corpus path merges them
            short_seen: set[str] = set()
            for i, line in enumerate(f):
                total += 1
                text = line.rstrip("\n")
                if len(text.encode("utf-8", "replace")) < cfg.shingle_k:
                    if text in short_seen:
                        continue
                    short_seen.add(text)
                backend.submit({"article": text, "url": f"L{i}"})
            backend.flush()
        print(f"kept {kept}/{total} docs (streamed)", file=sys.stderr)
        return 0

    from advanced_scrapper_tpu_torch.pipeline.dedup import NearDupEngine

    engine = NearDupEngine(_with_overrides(default_config().dedup, backend=args.backend),
                           device=args.device)
    with open(args.input, "r", encoding="utf-8", errors="replace") as f:
        docs = [line.rstrip("\n") for line in f]
    reps = engine.dedup_reps(docs)
    kept = 0
    with open_sink() as out:
        for i, r in enumerate(reps):
            if r == i:
                kept += 1
                out.write(docs[i] + "\n")
    print(f"kept {kept}/{len(docs)} docs", file=sys.stderr)
    return 0


def _cmd_enrich(args: argparse.Namespace) -> int:
    # --simple: the un-hardened single-pass flow (ref ticker_symbol_query.py)
    # — no retry ladder, no progress ledger, no cool-downs
    from advanced_scrapper_tpu_torch.pipeline.enrich import run_crypto_enrich, run_enrich

    cfg = _with_overrides(default_config().enrich, hardened=False if args.simple else None)
    if args.crypto:
        return run_crypto_enrich(cfg)
    return run_enrich(cfg)


def _cmd_match(args: argparse.Namespace) -> int:
    from advanced_scrapper_tpu_torch.pipeline.matcher import run_matcher

    if args.refine and args.no_screen:
        print("astpu match: --refine requires the screen; drop --no-screen")
        return 2
    kw = {}
    if args.no_screen:
        kw["use_screen"] = False
    if args.refine:
        kw["use_refine"] = True
    elif args.no_refine:
        kw["use_refine"] = False
    if args.workers is not None:
        kw["workers"] = args.workers
    try:
        return run_matcher(default_config().match, device=args.device, **kw)
    except ValueError as e:  # e.g. --refine with the screen off by config
        print(f"astpu match: {e}")
        return 2


def _cmd_xdedup(args: argparse.Namespace) -> int:
    from advanced_scrapper_tpu_torch.pipeline.cross_source import cross_source_dedup

    stats = cross_source_dedup(args.sources, args.output, device=args.device)
    print(json.dumps(stats, indent=2))
    return 0


def _cmd_scrape(args: argparse.Namespace) -> int:
    from advanced_scrapper_tpu_torch.pipeline.scraper import run_scraper

    return run_scraper(_with_overrides(default_config().scraper, transport=args.transport),
                       device=args.device)


def _cmd_harvest(args: argparse.Namespace) -> int:
    cfg = _with_overrides(default_config().harvest, transport=args.transport)
    if args.engine == "async":
        if args.transport is not None:
            # the async engine rides its own aiohttp session; silently
            # ignoring a requested browser transport would let the operator
            # believe it ran
            print("--engine async is plain-HTTP only; drop --transport "
                  "or use --engine threads")
            return 2
        from advanced_scrapper_tpu_torch.pipeline.harvest_async import run_harvest_async

        return run_harvest_async(cfg, device=args.device)
    from advanced_scrapper_tpu_torch.pipeline.harvest import run_harvest

    return run_harvest(cfg, device=args.device)


def _cmd_poll(args: argparse.Namespace) -> int:
    """Live topic poller + optional article drain (successor of the
    reference's experiental/04..10 infinite loops; bounded by --rounds)."""
    import time

    from advanced_scrapper_tpu_torch.extractors import load_extractor
    from advanced_scrapper_tpu_torch.net.transport import make_transport
    from advanced_scrapper_tpu_torch.pipeline.poller import (
        DEFAULT_TOPIC_URL,
        drain_unscraped,
        poll_links,
    )
    from advanced_scrapper_tpu_torch.storage.stores import ArticleStore, LinkStore

    links = LinkStore(args.db)
    transport = make_transport(args.transport or default_config().scraper.transport)
    extractor = load_extractor(args.website) if args.drain else None
    articles = ArticleStore(args.db) if args.drain else None
    new = stored = rounds_done = 0
    try:
        # drain interleaves with polling (the reference's 09/10 pair runs
        # discovery and scraping concurrently forever) — a trailing-only
        # drain would never run under the default infinite rounds
        while args.rounds is None or rounds_done < args.rounds:
            new += poll_links(links, transport, topic_url=args.topic or DEFAULT_TOPIC_URL,
                              interval=args.interval, max_iterations=1,
                              mirror_csv=args.mirror_csv, scroll=args.scroll)
            if args.drain:
                stored += drain_unscraped(links, articles, transport, extractor,
                                          max_rounds=args.drain_rounds)
            rounds_done += 1
            if args.rounds is None or rounds_done < args.rounds:
                time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    finally:
        transport.close()
    print(f"{new} new links → {args.db}")
    if args.drain:
        print(f"{stored} articles stored")
    return 0


def _cmd_serve(args: argparse.Namespace) -> int:
    """Lease server: resume-aware URL distribution + centralized parsing."""
    import os
    import time

    from advanced_scrapper_tpu_torch.extractors import load_extractor
    from advanced_scrapper_tpu_torch.net.lease import LeaseServer
    from advanced_scrapper_tpu_torch.storage.csvio import read_url_column, scraped_url_set

    cfg = default_config()
    scraper = cfg.scraper
    input_csv = args.input or scraper.input_csv
    if not os.path.exists(input_csv):
        print(f"Input CSV '{input_csv}' not found.")
        return 1
    success_csv = f"success_articles_{scraper.website}.csv"
    failed_csv = f"failed_articles_{scraper.website}.csv"
    urls = read_url_column(input_csv)
    scraped = scraped_url_set(success_csv, failed_csv)
    todo = [u for u in urls if u not in scraped]
    print(f"Serving {len(todo)} URLs ({len(urls) - len(todo)} already scraped)")
    feed = _with_overrides(cfg.feed, port=args.port)
    server = LeaseServer(feed, todo).start()
    print(f"Listening on {server.host}:{server.port} — Ctrl-C to stop")
    try:
        while not server.done():
            time.sleep(1)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    ok, bad = server.process_results(load_extractor(scraper.website), success_csv, failed_csv)
    print(f"Parsed results: {ok} success, {bad} failed")
    return 0


def _cmd_work(args: argparse.Namespace) -> int:
    """Lease worker node."""
    from advanced_scrapper_tpu_torch.net.lease import LeaseClient
    from advanced_scrapper_tpu_torch.net.transport import make_transport

    cfg = default_config()
    feed = _with_overrides(cfg.feed, host=args.host, port=args.port)
    transport = args.transport or cfg.scraper.transport
    client = LeaseClient(feed, lambda: make_transport(transport))
    sent = client.run(max_seconds=args.max_seconds)
    print(f"Worker done: {sent} pages shipped")
    return 0


def _cmd_new_links(args: argparse.Namespace) -> int:
    from advanced_scrapper_tpu_torch.utils.setops import new_links

    n = new_links(args.input, args.output, *args.done)
    print(f"{n} new links → {args.output}")
    return 0


def _cmd_split(args: argparse.Namespace) -> int:
    from advanced_scrapper_tpu_torch.utils.setops import round_robin_split

    paths = round_robin_split(args.input, args.parts, *args.done, output_template=args.template)
    print("wrote " + ", ".join(paths))
    return 0


def _cmd_smoke(args: argparse.Namespace) -> int:
    """Environment check: the device, the port's native host libraries, the
    transport (fetches a page with ``mock``, the default; builds and closes
    any other) and one tiny dedup on the device."""
    report: dict = {}
    ok = True
    try:
        import torch

        from advanced_scrapper_tpu_torch import resolve_device

        dev = resolve_device(args.device)
        report["torch"] = {
            "version": torch.__version__, "cuda": torch.version.cuda, "device": str(dev),
            "name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "devices": torch.cuda.device_count(),
        }
    except Exception as e:
        report["torch"] = {"error": str(e)}
        ok = False
    from advanced_scrapper_tpu_torch.cpu import csvnative, exactdedup, hostbatch
    from advanced_scrapper_tpu_torch.cpu import native as fastmatch

    native: dict = {}
    for name, load in (("fastmatch", fastmatch._load), ("hostbatch", hostbatch._load),
                       ("exactdedup", exactdedup.exactdedup_backend),
                       ("csvscan", csvnative._load)):
        try:
            got = load()
            native[name] = got if isinstance(got, str) else "native"
        except Exception as e:
            native[name] = f"error: {e}"
            ok = False
    report["native"] = native
    try:
        from advanced_scrapper_tpu_torch.net.transport import make_transport

        t = make_transport(args.transport, pages={"https://smoke/x": "<html></html>"})
        t.fetch("https://smoke/x") if args.transport == "mock" else None
        t.close()
        report["transport"] = {args.transport: "ok"}
    except Exception as e:
        report["transport"] = {args.transport: f"error: {e}"}
        ok = False
    try:
        from advanced_scrapper_tpu_torch.pipeline.dedup import NearDupEngine

        reps = NearDupEngine(device=args.device).dedup_reps(
            ["smoke test article body", "smoke test article body", "other"])
        assert reps.tolist()[1] == 0
        report["dedup"] = {"reps": reps.tolist()}
    except Exception as e:
        report["dedup"] = {"error": str(e)}
        ok = False
    report["ok"] = ok
    print(json.dumps(report, indent=2))
    return 0 if ok else 1


def _cmd_selftest(args: argparse.Namespace) -> int:
    """Integration ladder against REAL endpoints (ref experiental/
    02_test_1.py:45-69, 08_test.py:44-90 assert through the running stack
    against live URLs — the one class of bug mocks can't catch).

    Live rungs are double-gated (``--live`` AND ``ASTPU_LIVE=1``) because
    they send real traffic; without the gate only the offline rung runs.
    Each rung reports ``ok`` / ``skipped`` / ``unreachable`` — a dead
    network degrades to ``unreachable``, never a traceback; the exit code
    is 1 only when a rung REACHED its endpoint and misbehaved."""
    import os
    import tempfile

    from advanced_scrapper_tpu_torch.net.transport import (
        FetchError,
        RequestsTransport,
        _resolve_binary,
    )

    report: dict = {}
    failed = False

    # rung 0 (always): the ladder harness itself over a mock — a live run
    # that fails rung 0 is a broken harness, not a broken endpoint
    try:
        from advanced_scrapper_tpu_torch.core.soup import Soup
        from advanced_scrapper_tpu_torch.extractors.template import extract_with_template

        data = extract_with_template(Soup("<html><h1>t</h1></html>"), {"title": "h1"})
        assert data["title"] == "t"
        report["harness"] = "ok"
    except Exception as e:
        report["harness"] = f"failed: {e}"
        failed = True

    live = bool(args.live) and os.environ.get("ASTPU_LIVE") == "1"
    if not live:
        why = "pass --live and set ASTPU_LIVE=1" if not args.live else "ASTPU_LIVE=1 not set"
        report["cdx"] = report["fetch"] = report["extract"] = f"skipped ({why})"
        report["ok"] = not failed
        print(json.dumps(report, indent=2))
        return 0 if not failed else 1

    # rung 1: one-shard CDX harvest over plain HTTP (ref
    # yahoo_links_selenium.py:31-34 — the L1 discovery path)
    try:
        from advanced_scrapper_tpu_torch.config import HarvestConfig
        from advanced_scrapper_tpu_torch.pipeline.harvest import (
            cdx_query_url,
            normalize_cdx_frame,
            parse_cdx_text,
        )

        t = RequestsTransport(timeout=30.0)
        try:
            text = t.fetch(cdx_query_url(args.prefix, HarvestConfig()))
        finally:
            t.close()
        df = normalize_cdx_frame(parse_cdx_text(text))
        report["cdx"] = {"prefix": args.prefix, "rows": int(len(df))}
    except FetchError as e:
        report["cdx"] = f"unreachable ({e})"
    except Exception as e:
        report["cdx"] = f"failed: {e}"
        failed = True

    # rung 2: one real fetch through the first-party wire client, spawn
    # path included — only when a driver binary exists on this host
    driver = _resolve_binary("geckodriver") or _resolve_binary("chromedriver")
    if driver is None:
        report["fetch"] = "skipped (no geckodriver/chromedriver binary)"
    else:
        try:
            from advanced_scrapper_tpu_torch.net.transport import (
                WireChromeTransport,
                WireFirefoxTransport,
            )
            from advanced_scrapper_tpu_torch.net.webdriver import WebDriverError

            cls = (WireFirefoxTransport if "gecko" in os.path.basename(driver)
                   else WireChromeTransport)
            t = cls(executable_path=driver)
            try:
                html = t.fetch(args.live_url)
            finally:
                t.close()
            report["fetch"] = {"driver": driver, "bytes": len(html)}
        except FetchError as e:
            report["fetch"] = f"unreachable ({e})"
        except WebDriverError as e:
            # a driver binary that won't spawn/start a session is a LOCAL
            # stack problem (e.g. driver without a browser): no endpoint
            # was reached, so per the exit contract this is not a failure
            report["fetch"] = f"skipped (driver: {e})"
        except Exception as e:
            report["fetch"] = f"failed: {e}"
            failed = True

    # rung 3: one control-plane extract (ref 02_test_1.py:45-69 — template
    # registered, then a live URL processed through the plane's pool)
    try:
        from advanced_scrapper_tpu_torch.net.control import ControlPlane

        with tempfile.TemporaryDirectory() as d:
            plane = ControlPlane(lambda: RequestsTransport(timeout=30.0),
                                 templates_path=os.path.join(d, "templates.json"),
                                 workers=1, out_root=d)
            try:
                plane.add_template("selftest", {"title": "title"})
                data = plane.extract(args.live_url, "selftest")
            finally:
                plane.shutdown()
        report["extract"] = {"title": data.get("title", "")[:80]}
    except FetchError as e:
        report["extract"] = f"unreachable ({e})"
    except Exception as e:
        report["extract"] = f"failed: {e}"
        failed = True

    report["ok"] = not failed
    print(json.dumps(report, indent=2))
    return 0 if not failed else 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="astpu-torch",
        description="financial-news dedup and matching on one NVIDIA GPU "
        "(PyTorch/CUDA port of astpu)",
    )
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the kernels run (default: cuda; cpu runs their plain versions)")
    sub = p.add_subparsers(dest="command", required=True)

    sub.add_parser("version", help="print version").set_defaults(fn=_cmd_version)
    sub.add_parser("config", help="print effective config").set_defaults(fn=_cmd_config)

    d = sub.add_parser("dedup", help="near-dup dedup of a line-delimited corpus")
    d.add_argument("input")
    d.add_argument("-o", "--output", default=None)
    d.add_argument("--backend", default=None, choices=["scan", "oph", "pallas"],
                   help="signature backend (default: config; scan and pallas both run the "
                   "dense CUDA MinHash kernel; oph runs the CUDA one-permutation "
                   "fold and densify kernels)")
    d.add_argument("--stream", action="store_true",
                   help="bounded-memory streaming dedup (corpus never read whole; "
                   "first-seen-wins across batches via the stream index)")
    d.add_argument("--index", default=None, choices=["exact", "bloom"],
                   help="stream index: exact (attributed, grows with kept docs) or "
                   "bloom (LSHBloom, fixed memory forever); --stream only")
    d.set_defaults(fn=_cmd_dedup)

    h = sub.add_parser("harvest", help="CDX URL harvest (the merge's exact dedup on --device)")
    h.add_argument("--transport", default=None)
    h.add_argument("--engine", choices=("threads", "async"), default="threads",
                   help="threads: one transport per worker (browsers); async: one "
                   "event loop of plain HTTP fetches")
    h.set_defaults(fn=_cmd_harvest)

    s = sub.add_parser("scrape", help="constant-rate article scrape")
    s.add_argument("--transport", default=None)
    s.set_defaults(fn=_cmd_scrape)

    e = sub.add_parser("enrich", help="Wikidata ticker/crypto enrichment")
    e.add_argument("--crypto", action="store_true",
                   help="enrich the crypto symbol list into info/crypto/ instead")
    e.add_argument("--simple", action="store_true",
                   help="un-hardened single-pass queries (default: the rate-limit-protected "
                   "flow)")
    e.set_defaults(fn=_cmd_enrich)

    m = sub.add_parser("match", help="ticker→article entity matching")
    m.add_argument("--no-screen", action="store_true",
                   help="disable the device q-gram screen (pure reference scan)")
    refine_group = m.add_mutually_exclusive_group()
    refine_group.add_argument("--refine", action="store_true",
                              help="force the device alignment-bound prune on every chunk "
                              "(default: auto, the measured race)")
    refine_group.add_argument("--no-refine", action="store_true",
                              help="never run the alignment bound")
    m.add_argument("--workers", type=int, default=None,
                   help="exact-verify process fan-out (0 = cpu_count; 1 = inline; "
                   "default: config verify_workers)")
    m.set_defaults(fn=_cmd_match)

    pl = sub.add_parser("poll", help="live topic poller → link store")
    pl.add_argument("--db", default="crypto_news.db", help="sqlite path or postgres:// DSN")
    pl.add_argument("--topic", default=None)
    pl.add_argument("--interval", type=float, default=3.0)
    pl.add_argument("--rounds", type=int, default=None, help="default: forever")
    pl.add_argument("--drain", action="store_true", help="also scrape unscraped links")
    pl.add_argument("--drain-rounds", type=int, default=1)
    pl.add_argument("--website", default="yfin")
    pl.add_argument("--transport", default=None)
    pl.add_argument("--mirror-csv", default=None,
                    help="also append new links to this CSV")
    pl.add_argument("--scroll", action="store_true",
                    help="scroll-to-load discovery on scroll-capable transports")
    pl.set_defaults(fn=_cmd_poll)

    sv = sub.add_parser("serve", help="lease server: distribute urls, parse results centrally")
    sv.add_argument("--input", default=None)
    sv.add_argument("--port", type=int, default=None)
    sv.set_defaults(fn=_cmd_serve)

    wk = sub.add_parser("work", help="lease client: fetch leased urls")
    wk.add_argument("--host", default=None)
    wk.add_argument("--port", type=int, default=None)
    wk.add_argument("--transport", default=None)
    wk.add_argument("--max-seconds", type=float, default=3600.0)
    wk.set_defaults(fn=_cmd_work)

    nl = sub.add_parser("new-links", help="anti-join of scraped urls")
    nl.add_argument("input")
    nl.add_argument("output")
    nl.add_argument("done", nargs="+")
    nl.set_defaults(fn=_cmd_new_links)

    sp = sub.add_parser("split", help="round-robin shard split")
    sp.add_argument("input")
    sp.add_argument("-n", "--parts", type=int, required=True)
    sp.add_argument("--done", nargs="*", default=[])
    sp.add_argument("--template", default="part_{i}.csv")
    sp.set_defaults(fn=_cmd_split)

    xd = sub.add_parser("xdedup", help="cross-source dedup over CSVs and sqlite stores")
    xd.add_argument("sources", nargs="+")
    xd.add_argument("-o", "--output", default="xdedup_manifest.csv")
    xd.set_defaults(fn=_cmd_xdedup)

    st = sub.add_parser("selftest",
                        help="integration ladder; --live + ASTPU_LIVE=1 hits real endpoints")
    st.add_argument("--live", action="store_true", help="enable network rungs")
    st.add_argument("--prefix", default="aa", help="CDX shard prefix for the harvest rung")
    st.add_argument("--live-url", default="https://example.com/",
                    help="URL for the fetch/extract rungs")
    st.set_defaults(fn=_cmd_selftest)

    sm = sub.add_parser("smoke", help="environment check (device, native libraries, "
                        "transport, a tiny dedup)")
    sm.add_argument("--transport", default="mock")
    sm.set_defaults(fn=_cmd_smoke)

    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
