"""The port's CLI (``advanced_scrapper_tpu_torch/cli.py``) against the JAX
package's ``astpu``, both run in this process (``main(argv)``), the port
with ``--device cpu``: the configuration JSON under ``ASTPU_*`` knobs,
``dedup``'s output byte for byte (the whole corpus, ``--stream`` with an
exact and a bloom index), its short-line rule and its untouched output
on a failing input, ``xdedup``'s manifest, ``match``'s flags and CSV
trees, ``harvest`` (both engines), ``new-links``, ``split``, ``serve`` and
``work``'s files, and ``enrich``, ``poll`` and ``selftest``."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from advanced_scrapper_tpu import cli as ref_cli
from advanced_scrapper_tpu import config as ref_config
from advanced_scrapper_tpu.pipeline import matcher as ref_matcher
from advanced_scrapper_tpu_torch import cli, config
from advanced_scrapper_tpu_torch.pipeline import matcher
from test_torch_matcher import adversarial_csv, tree
from test_match_dispatch import _entities

CPU = ["--device", "cpu"]


def run_both(argv: list[str], capsys) -> tuple[tuple, tuple]:
    """``(rc, stdout, stderr)`` of the reference's and the port's main."""
    out = []
    for main, pre in ((ref_cli.main, []), (cli.main, CPU)):
        rc = main(pre + argv)
        got = capsys.readouterr()
        out.append((rc, got.out, got.err))
    return out[0], out[1]


def run_both_to(argv: list[str], tmp_path, capsys) -> tuple[tuple, tuple]:
    """:func:`run_both` with ``argv`` ending in ``-o`` and the output path
    ``ref.txt`` or ``port.txt`` under ``tmp_path``."""
    out = []
    for main, pre, name in ((ref_cli.main, [], "ref.txt"), (cli.main, CPU, "port.txt")):
        rc = main(pre + argv + [str(tmp_path / name)])
        got = capsys.readouterr()
        out.append((rc, got.out, got.err))
    return out[0], out[1]


KNOBS = {"ASTPU_MATCH_PACKED": "0", "ASTPU_MATCH_FUZZY_THRESHOLD": "90.5",
         "ASTPU_DEDUP_STREAM_INDEX": "bloom", "ASTPU_DEDUP_RERANK": "off",
         "ASTPU_ENRICH_COOLDOWN_EVERY3": "1.5, 2,", "ASTPU_FEED_PORT": "9000",
         "ASTPU_SCRAPER_WEBSITE": "other", "ASTPU_MESH_SEQ_PARALLEL": "2"}


@pytest.mark.parametrize("knobs", [False, True])
def test_config_json_equals_reference(capsys, monkeypatch, knobs):
    if knobs:
        for k, v in KNOBS.items():
            monkeypatch.setenv(k, v)
    want, got = run_both(["config"], capsys)
    assert got == want and got[0] == 0
    cfg = json.loads(got[1])
    assert set(cfg) == {"scraper", "harvest", "enrich", "match", "dedup", "mesh", "feed"}
    if knobs:
        assert cfg["match"]["packed"] is False and cfg["enrich"]["cooldown_every3"] == [1.5, 2.0]
        assert cfg["dedup"]["rerank"] is False and cfg["feed"]["port"] == 9000


@pytest.mark.parametrize("section", ["scraper", "harvest", "enrich", "match", "dedup", "mesh",
                                     "feed"])
def test_config_sections_are_the_references(section, monkeypatch):
    for k, v in KNOBS.items():
        monkeypatch.setenv(k, v)
    want = getattr(ref_config.default_config(), section)
    got = getattr(config.default_config(), section)
    assert [(f.name, f.default) for f in dataclasses.fields(got)] == [
        (f.name, f.default) for f in dataclasses.fields(want)]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert config.from_env(type(got), section, port=None) == got
    assert getattr(config.Config().replace(**{section: got}), section) is got


def test_version_equals_reference(capsys):
    want, got = run_both(["version"], capsys)
    assert got == want and got[1].strip()


def corpus(path, seed: int = 0, n: int = 240) -> None:
    """Lines of words with near and exact copies, blank lines, repeated
    lines shorter than a shingle, and non-ASCII lines."""
    rng = np.random.RandomState(seed)
    lines: list[str] = []
    for i in range(n):
        u = rng.rand()
        if i > 8 and u < 0.3:
            t = lines[rng.randint(len(lines))]
            if t and rng.rand() < 0.5:
                c = list(t)
                c[rng.randint(len(c))] = "x"
                t = "".join(c)
        elif u < 0.36:
            t = ["", "ab", "abcd", "é"][rng.randint(4)]
        elif u < 0.4:
            t = "Zürich " * int(rng.randint(2, 30))
        else:
            t = " ".join("".join(chr(97 + c) for c in rng.randint(0, 26, rng.randint(2, 8)))
                         for _ in range(rng.randint(5, 60)))
        lines.append(t)
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")


@pytest.mark.parametrize("mode", [[], ["--stream"], ["--stream", "--index", "bloom"]],
                         ids=["whole", "stream", "stream_bloom"])
def test_dedup_output_byte_equal(tmp_path, capsys, mode):
    corpus(tmp_path / "in.txt")
    argv = ["dedup", str(tmp_path / "in.txt"), *mode, "-o"]
    want, got = run_both_to(argv, tmp_path, capsys)
    assert got == want and got[0] == 0
    a, b = (tmp_path / "ref.txt").read_bytes(), (tmp_path / "port.txt").read_bytes()
    assert a == b and 0 < a.count(b"\n") < 240
    kept = a.decode().split("\n")[:-1]
    for short in ("", "ab", "abcd", "é"):  # shorter than a shingle: one copy each streamed
        assert (kept.count(short) <= 1) == bool(mode)


def test_dedup_short_lines(tmp_path, capsys):
    """Lines shorter than a shingle: the whole-corpus engine keeps each
    (they have no signature), the stream merges them by content; both as
    the reference does."""
    text = "ab\n\nab\nlong enough line one\n\nab\nx\n"
    (tmp_path / "in.txt").write_text(text, "utf-8")
    for mode, kept in (([], text), (["--stream"], "ab\n\nlong enough line one\nx\n")):
        want, got = run_both_to(["dedup", str(tmp_path / "in.txt"), *mode, "-o"],
                                tmp_path, capsys)
        assert got == want
        assert (tmp_path / "port.txt").read_text() == kept


@pytest.mark.parametrize("mode", [[], ["--stream"]], ids=["whole", "stream"])
def test_dedup_failing_input_leaves_the_old_output(tmp_path, mode):
    for main, pre in ((ref_cli.main, []), (cli.main, CPU)):
        out = tmp_path / "out.txt"
        out.write_text("old output\n")
        with pytest.raises(FileNotFoundError):
            main(pre + ["dedup", str(tmp_path / "missing.txt"), *mode, "-o", str(out)])
        assert out.read_text() == "old output\n"


def test_dedup_index_needs_stream(tmp_path, capsys):
    corpus(tmp_path / "in.txt", n=10)
    want, got = run_both(["dedup", str(tmp_path / "in.txt"), "--index", "bloom"], capsys)
    assert got == want and got[0] == 2


def test_xdedup_manifest_byte_equal(tmp_path, capsys):
    import csv

    rng = np.random.RandomState(4)
    texts = [" ".join("".join(chr(97 + c) for c in rng.randint(0, 26, 6)) for _ in range(40))
             for _ in range(30)]
    for k, name in enumerate(("a.csv", "b.csv")):
        with open(tmp_path / name, "w", newline="", encoding="utf-8") as f:
            w = csv.writer(f)
            w.writerow(["url", "article", "title"])
            for i in range(20):
                t = texts[(i + 7 * k) % 30]
                w.writerow([f"https://{name}/{i}", t if i % 6 else t[::-1], f"t{i}"])
    srcs = [str(tmp_path / "a.csv"), str(tmp_path / "b.csv")]
    want, got = run_both_to(["xdedup", *srcs, "-o"], tmp_path, capsys)
    assert got == want and got[0] == 0
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "ref.txt").read_bytes()
    stats = json.loads(got[1])
    assert stats["total"] == 40 and stats["kept"] < 40


FLAGS = [[], ["--no-screen"], ["--refine"], ["--no-refine"], ["--workers", "3"],
         ["--no-screen", "--no-refine", "--workers", "0"], ["--refine", "--no-screen"]]


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: " ".join(f) or "none")
def test_match_flags_map_as_the_reference(monkeypatch, capsys, flags):
    seen = []

    def fake(cfg, **kw):
        seen.append((dataclasses.asdict(cfg), {k: v for k, v in kw.items() if k != "device"}))
        return 0

    monkeypatch.setattr(ref_matcher, "run_matcher", fake)
    monkeypatch.setattr(matcher, "run_matcher", fake)
    want, got = run_both(["match", *flags], capsys)
    assert got == want
    assert seen[:1] == seen[1:]
    if got[0] == 2:
        assert not seen and "--refine requires the screen" in got[1]


def test_match_refine_conflicts_are_refused(capsys):
    for main, pre in ((ref_cli.main, []), (cli.main, CPU)):
        with pytest.raises(SystemExit) as e:
            main(pre + ["match", "--refine", "--no-refine"])
        assert e.value.code == 2


def test_match_writes_the_reference_trees(tmp_path, monkeypatch, capsys):
    info = tmp_path / "info"
    info.mkdir()
    (info / "a.json").write_text(json.dumps(_entities(6)))
    adversarial_csv(str(tmp_path / "articles.csv"), np.random.RandomState(3), n=40)
    monkeypatch.setenv("ASTPU_MATCH_INFO_DIR", str(info))
    monkeypatch.setenv("ASTPU_MATCH_ARTICLES_CSV", str(tmp_path / "articles.csv"))
    monkeypatch.setenv("ASTPU_MATCH_CHUNK_SIZE", "16")
    for main, pre, name in ((ref_cli.main, [], "ref"), (cli.main, CPU, "port")):
        monkeypatch.setenv("ASTPU_MATCH_SOURCE_NAME", str(tmp_path / name))
        assert main(pre + ["match", "--refine", "--workers", "1"]) == 0
    capsys.readouterr()
    want = tree(str(tmp_path / "ref_ticker_matched_articles"))
    assert tree(str(tmp_path / "port_ticker_matched_articles")) == want and want


UNPORTED = [["enrich", "--crypto"], ["poll", "--rounds", "1"], ["selftest"]]


@pytest.mark.parametrize("argv", UNPORTED, ids=lambda a: a[0])
def test_unported_commands_name_their_item(argv, tmp_path, monkeypatch, capsys):
    """The commands ported last (ROADMAP item 18d) take the reference's
    arguments and, with nothing to read, give its exit code and output:
    ``enrich`` without its symbols CSV, ``poll`` with a mock transport
    that has no page, ``selftest`` offline."""
    ref_parser = ref_cli.build_parser()
    assert vars(cli.build_parser().parse_args(argv)).keys() - {"device"} == \
        vars(ref_parser.parse_args(argv)).keys()
    monkeypatch.chdir(tmp_path)
    extra = ["--transport", "mock", "--interval", "0"] if argv[0] == "poll" else []
    want, got = run_both(argv + extra, capsys)
    assert got == want and got[0] == (1 if argv[0] == "enrich" else 0)


def walk_tree(root: str) -> dict[str, bytes]:
    """Every file under ``root`` by its path there, with its bytes."""
    import os

    out = {}
    for here, _dirs, files in os.walk(root):
        for name in files:
            with open(os.path.join(here, name), "rb") as f:
                out[os.path.relpath(os.path.join(here, name), root)] = f.read()
    return out


def enrich_fixture(tmp_path, monkeypatch):
    """Both packages' ``create_session`` answer a ``SparqlFake`` over a
    few companies (no request leaves the process), and a symbols CSV and
    a crypto list under ``tmp_path``."""
    import csv

    import chip_smoke
    from advanced_scrapper_tpu.pipeline import enrich as ref_enrich
    from advanced_scrapper_tpu_torch.pipeline import enrich

    entities = chip_smoke.sp500_entities(np.random.RandomState(17))[:8]
    for mod in (ref_enrich, enrich):
        monkeypatch.setattr(mod, "create_session", lambda hardened=True: chip_smoke.SparqlFake(
            entities, 3, faults=0.3))
    for name, rows in (("sp500list.csv", entities[:6]), ("crypto_list.csv", entities[6:])):
        with open(tmp_path / name, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["Symbol", "Security"])
            w.writerows([[e["ticker"], e["id_label"]] for e in rows])
    monkeypatch.setenv("ASTPU_ENRICH_BASE_DELAY", "0")
    monkeypatch.setenv("ASTPU_ENRICH_COOLDOWN_EVERY3", "0,0")
    monkeypatch.setenv("ASTPU_ENRICH_COOLDOWN_EVERY10", "0,0")


@pytest.mark.parametrize("flags", [[], ["--simple"], ["--crypto"]], ids=lambda f: f[0] if f else "hardened")
def test_enrich_writes_the_reference_files(tmp_path, monkeypatch, capsys, flags):
    """``enrich`` of each package over the same fake endpoint: the same
    info files, ledger and exit code (the politeness sleeps, whose
    lengths are drawn at random, are skipped here)."""
    import time

    enrich_fixture(tmp_path, monkeypatch)
    monkeypatch.setattr(time, "sleep", lambda _s: None)
    trees = []
    for main, pre, name in ((ref_cli.main, [], "ref"), (cli.main, CPU, "port")):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        for f in ("sp500list.csv", "crypto_list.csv"):
            (tmp_path / name / f).write_bytes((tmp_path / f).read_bytes())
        assert main(pre + ["enrich"] + flags) == 0
        trees.append(walk_tree(str(tmp_path / name)))
    assert trees[1] == trees[0]
    out = capsys.readouterr().out
    assert out.count("Enrichment finished: 6 symbols attempted.") == 2 * (flags != ["--crypto"])
    infos = [k for k in trees[0] if k.endswith("_info.json")]
    assert infos and ("progress.json" in trees[0]) == (flags == [])


def test_poll_writes_the_reference_rows(tmp_path, monkeypatch, capsys):
    """``poll --rounds 2 --drain --mirror-csv`` of each package over the
    same topic pages (their ``make_transport`` a mock site), the clock
    fixed: the same store rows, mirror CSV and summary."""
    import sqlite3
    import time

    import chip_smoke
    from advanced_scrapper_tpu.net import transport as ref_transport
    from advanced_scrapper_tpu_torch.net import transport

    urls, pages, _planted, _titleless, limited = chip_smoke.scrape_pages(
        np.random.RandomState(41), 64, body_cap=400)
    topics, fresh = chip_smoke.topic_pages(np.random.RandomState(44),
                                           [u for u in urls if u != limited], rounds=2, links=16)
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    for mod in (ref_transport, transport):
        monkeypatch.setattr(mod, "make_transport", lambda *a, mod=mod, **k: mod.MockTransport(
            {**pages, chip_smoke.POLL_TOPIC: lambda _u, it=iter(topics): next(it)}))
    views = []
    for main, pre, name in ((ref_cli.main, [], "ref"), (cli.main, CPU, "port")):
        db, mirror = str(tmp_path / f"{name}.db"), str(tmp_path / f"{name}.csv")
        assert main(pre + ["poll", "--rounds", "2", "--drain", "--interval", "0", "--db", db,
                           "--topic", chip_smoke.POLL_TOPIC, "--mirror-csv", mirror]) == 0
        conn = sqlite3.connect(db)
        rows = [conn.execute(f"SELECT * FROM {t} ORDER BY url").fetchall()
                for t in ("links", "articles")]
        conn.close()
        views.append((rows, open(mirror, "rb").read(),
                      capsys.readouterr().out.replace(db, "DB")))
    assert views[1] == views[0]
    assert f"{len(fresh)} new links" in views[0][2] and len(views[0][0][1]) > 0


@pytest.mark.parametrize("live", [False, True], ids=["offline", "live-without-env"])
def test_selftest_reports_as_the_reference(capsys, monkeypatch, live):
    """Without ``ASTPU_LIVE=1`` only the harness rung runs, on ``Soup``;
    the live rungs read ``skipped (…)`` and no request is sent."""
    monkeypatch.delenv("ASTPU_LIVE", raising=False)
    want, got = run_both(["selftest"] + (["--live"] if live else []), capsys)
    assert got == want and got[0] == 0
    report = json.loads(got[1])
    assert report["harness"] == "ok" and report["ok"] is True
    reason = "ASTPU_LIVE=1 not set" if live else "pass --live and set ASTPU_LIVE=1"
    assert report["cdx"] == report["fetch"] == report["extract"] == f"skipped ({reason})"


HOST_PLANE_ARGVS = [["harvest"], ["harvest", "--engine", "async"], ["serve"], ["work"],
                    ["new-links", "a", "b", "c"], ["split", "a", "-n", "2"]]


@pytest.mark.parametrize("argv", HOST_PLANE_ARGVS, ids=lambda a: "-".join(a))
def test_host_plane_commands_take_the_reference_arguments(argv):
    ref_parser = ref_cli.build_parser()
    assert vars(cli.build_parser().parse_args(argv)).keys() - {"device"} == \
        vars(ref_parser.parse_args(argv)).keys()


def cdx_site(url: str) -> str:
    """A CDX page for a few prefixes, nothing for the rest."""
    prefix = url.split("news/")[-1].rstrip("*")
    if prefix in ("aa", "b7", "$_"):
        rows = [f"k 2023010100000{i} http://finance.yahoo.com:80/news/{prefix}-{i % 3}.html t"
                for i in range(6)] + [f"k 20230101 https://x/news/%20{prefix}.html"]
        return "<html><body><pre>" + "\n".join(rows) + "</pre></body></html>"
    return ""


@pytest.mark.parametrize("engine", ["threads", "async"])
def test_harvest_writes_the_reference_files(engine, tmp_path, monkeypatch, capsys):
    """Both CLIs over the same pages (their transport and async fetch
    pointed at a mock site): equal shard directories and url CSVs."""
    from advanced_scrapper_tpu.net import transport as ref_transport
    from advanced_scrapper_tpu.pipeline import harvest_async as ref_async
    from advanced_scrapper_tpu_torch.net import transport
    from advanced_scrapper_tpu_torch.pipeline import harvest_async

    for mod in (ref_transport, transport):
        monkeypatch.setattr(mod, "make_transport",
                            lambda *a, mod=mod, **k: mod.MockTransport(cdx_site))
    for mod in (ref_async, harvest_async):
        async def fetch(url):
            return cdx_site(url)

        monkeypatch.setattr(mod, "_default_fetch", lambda fetch=fetch: fetch)
    monkeypatch.setenv("ASTPU_HARVEST_NUM_WORKERS", "3")
    trees = []
    for main, pre, name in ((ref_cli.main, [], "ref"), (cli.main, CPU, "port")):
        monkeypatch.setenv("ASTPU_HARVEST_SHARD_DIR", str(tmp_path / name / "shards"))
        monkeypatch.setenv("ASTPU_HARVEST_OUTPUT_CSV", str(tmp_path / name / "urls.csv"))
        assert main(pre + ["harvest", "--engine", engine]) == 0
        trees.append({**tree(str(tmp_path / name / "shards")),
                      "urls.csv": (tmp_path / name / "urls.csv").read_bytes()})
    capsys.readouterr()
    assert trees[1] == trees[0] and len(trees[0]) == 1521 + 3 + 1
    assert trees[0]["urls.csv"].count(b"\n") == 1 + 9


def test_harvest_async_refuses_a_transport(capsys):
    assert cli.main(CPU + ["harvest", "--engine", "async", "--transport", "mock"]) == 2
    assert ref_cli.main(["harvest", "--engine", "async", "--transport", "mock"]) == 2
    out = capsys.readouterr().out
    assert out.count("--engine async is plain-HTTP only") == 2


def test_new_links_and_split_write_the_reference_files(tmp_path, capsys):
    rng = np.random.RandomState(8)
    urls = [f"https://x/{i}.html" for i in rng.randint(0, 40, 60)]
    (tmp_path / "all.csv").write_text("url,date_time\n" + "".join(
        f"{u},{2023 + i}\n" for i, u in enumerate(urls)))
    (tmp_path / "done.csv").write_text("url,title\n" + "".join(f"{u},t\n" for u in urls[::7]))
    outs = []
    for main, pre, name in ((ref_cli.main, [], "ref"), (cli.main, CPU, "port")):
        d = tmp_path / name
        d.mkdir()
        assert main(pre + ["new-links", str(tmp_path / "all.csv"), str(d / "new.csv"),
                           str(tmp_path / "done.csv")]) == 0
        assert main(pre + ["split", str(tmp_path / "all.csv"), "-n", "3", "--done",
                           str(tmp_path / "done.csv"), "--template",
                           str(d / "part_{i}.csv")]) == 0
        outs.append((tree(str(d)), capsys.readouterr().out.replace(name, "")))
    assert outs[1] == outs[0] and len(outs[0][0]) == 4


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_and_work_write_the_reference_csvs(tmp_path, monkeypatch, capsys):
    """``serve`` and ``work`` of each package on loopback: the same success
    and failed CSVs from the same pages (one fetch thread, so results
    arrive in lease order)."""
    import os
    import threading

    from advanced_scrapper_tpu.net import transport as ref_transport
    from advanced_scrapper_tpu_torch.net import transport

    article = open(os.path.join(os.path.dirname(__file__), "fixtures",
                                "yfin_article.html")).read()
    urls = [f"https://x/{i}.html" for i in range(8)]
    pages = {u: article.replace("Apple Reports", f"Apple {i} Reports")
             for i, u in enumerate(urls) if i != 5}
    for mod in (ref_transport, transport):
        monkeypatch.setattr(mod, "make_transport",
                            lambda *a, mod=mod, **k: mod.MockTransport(dict(pages)))
    (tmp_path / "urls.csv").write_text("url\n" + "".join(u + "\n" for u in urls))
    monkeypatch.setenv("ASTPU_SCRAPER_INPUT_CSV", str(tmp_path / "urls.csv"))
    monkeypatch.setenv("ASTPU_FEED_CLIENT_THREADS", "1")
    monkeypatch.setenv("ASTPU_FEED_CLIENT_RATE", "200")
    monkeypatch.setenv("ASTPU_FEED_HOST", "127.0.0.1")
    trees = []
    for main, pre, name in ((ref_cli.main, [], "ref"), (cli.main, CPU, "port")):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        port = str(free_port())
        rc = {}
        serve = threading.Thread(target=lambda: rc.setdefault("serve", main(
            pre + ["serve", "--port", port])))
        serve.start()
        assert main(pre + ["work", "--host", "127.0.0.1", "--port", port,
                           "--transport", "mock", "--max-seconds", "30"]) == 0
        serve.join(timeout=30)
        assert not serve.is_alive() and rc["serve"] == 0
        trees.append(tree(str(tmp_path / name)))
    out = capsys.readouterr().out
    assert trees[1] == trees[0] and set(trees[0]) == {"success_articles_yfin.csv",
                                                      "failed_articles_yfin.csv"}
    assert out.count("Parsed results: 7 success, 1 failed") == 2


def test_smoke_on_the_cpu(capsys):
    assert cli.main(CPU + ["smoke"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["ok"] and report["dedup"]["reps"] == [0, 0, 2]
    assert set(report["native"]) == {"fastmatch", "hostbatch", "exactdedup", "csvscan"}
    assert report["transport"] == {"mock": "ok"}


def test_device_defaults_to_the_card(tmp_path):
    assert cli.build_parser().parse_args(["version"]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    corpus(tmp_path / "in.txt", n=5)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["dedup", str(tmp_path / "in.txt"), "-o", str(tmp_path / "o.txt")])
    assert not (tmp_path / "o.txt").exists()
    assert cli.main(["smoke"]) == 1


def test_cli_scrape_matches_the_reference(tmp_path, monkeypatch, capsys):
    """``astpu scrape --transport mock`` against ``astpu-torch --device cpu
    scrape``: the mock transport has no pages, so every url is a failed
    row; one fetch thread keeps the order."""
    for name in ("ref", "port"):
        root = tmp_path / name
        root.mkdir()
        (root / "urls.csv").write_text("url\n" + "".join(f"https://x/{i}\n" for i in range(6)))
    monkeypatch.setenv("ASTPU_SCRAPER_MAX_THREADS", "1")
    monkeypatch.setenv("ASTPU_SCRAPER_DESIRED_REQUEST_RATE", "1000")
    monkeypatch.setenv("ASTPU_SCRAPER_RESULT_TIMEOUT", "10")
    outs = {}
    for name, main, pre in (("ref", ref_cli.main, []), ("port", cli.main, ["--device", "cpu"])):
        monkeypatch.setenv("ASTPU_SCRAPER_INPUT_CSV", str(tmp_path / name / "urls.csv"))
        monkeypatch.setenv("ASTPU_SCRAPER_OUT_DIR", str(tmp_path / name))
        assert main(pre + ["scrape", "--transport", "mock"]) == 0
        outs[name] = [ln for ln in capsys.readouterr().out.splitlines()
                      if ln.startswith(("Total", "Already", "Remaining", "Scraping"))]
    want, got = ({k: v for k, v in tree(str(tmp_path / name)).items() if k.endswith(".csv")}
                 for name in ("ref", "port"))
    assert got == want and outs["port"] == outs["ref"] and len(want) == 4
    assert want["failed_articles_yfin.csv"].count(b"no fixture for") == 6
