"""Command-line interface of the port: ``astpu-torch``, or ``python -m
advanced_scrapper_tpu_torch``.

The reference's ``astpu`` (``advanced_scrapper_tpu/cli.py``) with the same
subcommands and arguments, plus one global ``--device {cuda,cpu}``
(default ``cuda``, which raises without a card; ``cpu`` runs every
kernel's plain version).  Flags override the ``ASTPU_*`` environment knobs
(``config.from_env``), which override the defaults.  Ported: ``version``,
``config``, ``dedup`` (whole corpus, and ``--stream`` with an exact or
bloom index), ``match``, ``xdedup``, ``scrape`` (its successes streamed
into the dedup backend on ``--device``) and ``smoke``.  The harvest,
enrichment, lease and set-operation commands keep their arguments and
exit non-zero naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys

from advanced_scrapper_tpu_torch import __version__
from advanced_scrapper_tpu_torch.config import default_config

#: where the commands that are not ported yet come from
SLICE_HOST_PLANES = "ROADMAP item 18 (the host planes)"


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


def _not_ported(command: str):
    def run(args: argparse.Namespace) -> int:
        raise SystemExit(
            f"astpu: '{command}' is not ported to the PyTorch package yet; it comes with "
            f"{SLICE_HOST_PLANES}")

    return run


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

    h = sub.add_parser("harvest", help="CDX URL harvest (not ported: ROADMAP item 18)")
    h.add_argument("--transport", default=None)
    h.add_argument("--engine", choices=("threads", "async"), default="threads")
    h.set_defaults(fn=_not_ported("harvest"))

    s = sub.add_parser("scrape", help="constant-rate article scrape")
    s.add_argument("--transport", default=None)
    s.set_defaults(fn=_cmd_scrape)

    e = sub.add_parser("enrich", help="Wikidata enrichment (not ported: ROADMAP item 18)")
    e.add_argument("--crypto", action="store_true")
    e.add_argument("--simple", action="store_true")
    e.set_defaults(fn=_not_ported("enrich"))

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

    pl = sub.add_parser("poll", help="live topic poller (not ported: ROADMAP item 18)")
    pl.add_argument("--db", default="crypto_news.db")
    pl.add_argument("--topic", default=None)
    pl.add_argument("--interval", type=float, default=3.0)
    pl.add_argument("--rounds", type=int, default=None)
    pl.add_argument("--drain", action="store_true")
    pl.add_argument("--drain-rounds", type=int, default=1)
    pl.add_argument("--website", default="yfin")
    pl.add_argument("--transport", default=None)
    pl.add_argument("--mirror-csv", default=None)
    pl.add_argument("--scroll", action="store_true")
    pl.set_defaults(fn=_not_ported("poll"))

    sv = sub.add_parser("serve", help="lease server (not ported: ROADMAP item 18)")
    sv.add_argument("--input", default=None)
    sv.add_argument("--port", type=int, default=None)
    sv.set_defaults(fn=_not_ported("serve"))

    wk = sub.add_parser("work", help="lease client (not ported: ROADMAP item 18)")
    wk.add_argument("--host", default=None)
    wk.add_argument("--port", type=int, default=None)
    wk.add_argument("--transport", default=None)
    wk.add_argument("--max-seconds", type=float, default=3600.0)
    wk.set_defaults(fn=_not_ported("work"))

    nl = sub.add_parser("new-links", help="anti-join of scraped urls "
                        "(not ported: ROADMAP item 18)")
    nl.add_argument("input")
    nl.add_argument("output")
    nl.add_argument("done", nargs="+")
    nl.set_defaults(fn=_not_ported("new-links"))

    sp = sub.add_parser("split", help="round-robin shard split (not ported: ROADMAP item 18)")
    sp.add_argument("input")
    sp.add_argument("-n", "--parts", type=int, required=True)
    sp.add_argument("--done", nargs="*", default=[])
    sp.add_argument("--template", default="part_{i}.csv")
    sp.set_defaults(fn=_not_ported("split"))

    xd = sub.add_parser("xdedup", help="cross-source dedup over CSVs and sqlite stores")
    xd.add_argument("sources", nargs="+")
    xd.add_argument("-o", "--output", default="xdedup_manifest.csv")
    xd.set_defaults(fn=_cmd_xdedup)

    st = sub.add_parser("selftest", help="integration ladder (not ported: ROADMAP item 18)")
    st.add_argument("--live", action="store_true")
    st.add_argument("--prefix", default="aa")
    st.add_argument("--live-url", default="https://example.com/")
    st.set_defaults(fn=_not_ported("selftest"))

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
