"""The port's scrape plane against the JAX package's, on the CPU.

``run_scraper`` at one fetch thread (so the rows come in one order) over
the same mock pages: successes, pages without a title, a rate-limit
sentinel page, a fetch error and a fetch error with a network fingerprint
write byte-equal success, failed and annotation CSVs, print the same
summary, and a resume over the same directory stays byte-equal.  The
elastic modes are held on outcomes (row sets and counts).  The resume
readers of
``storage/csvio.py`` (native scanner and csv module), the stats tracker,
the console and the rate controllers equal the reference's."""

from __future__ import annotations

import csv
import io
import os
import shutil
import time

import numpy as np
import pytest

import chip_smoke
from advanced_scrapper_tpu.config import ScraperConfig as RefScraperConfig
from advanced_scrapper_tpu.extractors import load_extractor as ref_load_extractor
from advanced_scrapper_tpu.net import transport as ref_transport
from advanced_scrapper_tpu.obs import console as ref_console
from advanced_scrapper_tpu.obs import stats as ref_stats
from advanced_scrapper_tpu.pipeline import controllers as ref_controllers
from advanced_scrapper_tpu.pipeline import scraper as ref_scraper
from advanced_scrapper_tpu.storage import csvio as ref_csvio
from advanced_scrapper_tpu_torch.config import ScraperConfig
from advanced_scrapper_tpu_torch.cpu import csvnative, native
from advanced_scrapper_tpu_torch.extractors import load_extractor
from advanced_scrapper_tpu_torch.net import transport
from advanced_scrapper_tpu_torch.obs import console, stats
from advanced_scrapper_tpu_torch.pipeline import controllers, scraper
from advanced_scrapper_tpu_torch.storage import csvio

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
ARTICLE_HTML = open(os.path.join(FIXTURES, "yfin_article.html"), encoding="utf-8").read()
PORT = dict(cfg=ScraperConfig, tr=transport, scraper=scraper, extractor=load_extractor,
            console=console, device={"device": "cpu"})
REF = dict(cfg=RefScraperConfig, tr=ref_transport, scraper=ref_scraper,
           extractor=ref_load_extractor, console=ref_console, device={})


def site_pages(pkg) -> tuple[list[str], dict]:
    """Seeded yfin pages (``chip_smoke.scrape_pages``: near-dup copies,
    pages without a title, a rate-limit sentinel), the fixture article
    twice, a fetch error and one with a network fingerprint."""
    urls, pages, _planted, _titleless, _limited = chip_smoke.scrape_pages(
        np.random.RandomState(11), 40, body_cap=300)
    pages = dict(pages)
    extra = {"https://x/fixture-a.html": ARTICLE_HTML, "https://x/fixture-b.html": ARTICLE_HTML,
             "https://x/reset.html": pkg["tr"].FetchError("connection reset"),
             "https://x/blocked.html": pkg["tr"].FetchError("about:neterror (blocked)")}
    order = urls[:12] + list(extra) + urls[12:]
    pages.update(extra)
    return order, pages


def scrape_once(pkg, root: str, capsys) -> tuple[dict, str]:
    """``run_scraper`` at one fetch thread into ``root``: its CSV files
    and the summary lines it printed."""
    urls, pages = site_pages(pkg)
    input_csv = os.path.join(root, "urls.csv")
    if not os.path.exists(input_csv):
        with open(input_csv, "w") as f:
            f.write("url\n" + "\n".join(urls) + "\n")
    cfg = pkg["cfg"](input_csv=input_csv, out_dir=root, max_threads=1,
                     desired_request_rate=5000.0, rate_limit_wait=0.01, result_timeout=10.0)
    rc = pkg["scraper"].run_scraper(cfg, transport_factory=lambda: pkg["tr"].MockTransport(pages),
                                    show_stats=False, **pkg["device"])
    assert rc == 0
    out = capsys.readouterr().out
    summary = [ln for ln in out.splitlines()
               if ln.startswith(("Total URLs", "Already", "Remaining", "Scraping completed"))]
    return chip_smoke.csv_tree(root), "\n".join(summary)


def test_run_scraper_writes_the_reference_csvs_and_resumes(tmp_path, capsys):
    ref_root, port_root = str(tmp_path / "ref"), str(tmp_path / "port")
    os.makedirs(ref_root)
    os.makedirs(port_root)
    want, want_summary = scrape_once(REF, ref_root, capsys)
    got, got_summary = scrape_once(PORT, port_root, capsys)
    assert set(got) == {"urls.csv", "success_articles_yfin.csv", "failed_articles_yfin.csv",
                        "dedup_annotations_yfin.csv"}
    assert got == want and got_summary == want_summary
    assert "1 rate-limited, 2 rate-limit trips" in got_summary
    failed = got["failed_articles_yfin.csv"].decode()
    assert "Title is empty" in failed and "about:neterror (blocked)" in failed
    ann = list(csv.DictReader(io.StringIO(got["dedup_annotations_yfin.csv"].decode())))
    assert {"https://x/fixture-b.html"} <= {r["url"] for r in ann if r["near_dup_of"]}
    assert sum(1 for r in ann if r["near_dup_of"]) >= 2
    # resume: only the rate-limited url is fetched again; no row changes
    again_want, again_want_summary = scrape_once(REF, ref_root, capsys)
    again, again_summary = scrape_once(PORT, port_root, capsys)
    assert again == again_want == want and again_summary == again_want_summary
    assert "Remaining URLs to scrape: 1" in again_summary


def test_run_scraper_on_the_card_by_default(tmp_path):
    """``device=None`` is the card: the backend raises here, and nothing
    catches it to go on without the card."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    cfg = ScraperConfig(max_threads=1, result_timeout=1.0, out_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        scraper.run_scraper(cfg, urls=[], transport_factory=lambda: transport.MockTransport({}),
                            show_stats=False)


def test_a_backend_error_ends_the_run(tmp_path, monkeypatch):
    """A backend whose batch fails mid-run (a launch error, an
    out-of-memory) ends the run with its error: the batch is not dropped
    and the scrape does not go on without its dedup."""
    from advanced_scrapper_tpu_torch.extractors.tpu_batch import TpuBatchBackend

    def failing_process(self):
        self._buffer = []
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(TpuBatchBackend, "_process", failing_process)
    monkeypatch.setenv("ASTPU_DEDUP_BATCH_SIZE", "4")
    urls, pages = site_pages(PORT)
    cfg = ScraperConfig(max_threads=1, desired_request_rate=5000.0, rate_limit_wait=0.01,
                        result_timeout=10.0, out_dir=str(tmp_path))
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="illegal memory access"):
        scraper.run_scraper(cfg, urls=urls, transport_factory=lambda: transport.MockTransport(pages),
                            show_stats=False, device="cpu")
    assert time.perf_counter() - t0 < 5.0  # the fleet is torn down, no result timeout
    ok = chip_smoke.csv_tree(str(tmp_path))["success_articles_yfin.csv"].decode()
    assert len(ok.splitlines()) < len(urls)  # the run stopped at the failed batch


@pytest.mark.parametrize("mode", ["elastic-p", "elastic-pid"])
def test_elastic_modes_match_the_reference_on_outcomes(tmp_path, mode):
    got = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        urls, pages = site_pages(pkg)
        cfg = pkg["cfg"](desired_request_rate=5000.0, max_threads=3, rate_limit_wait=0.01,
                         result_timeout=10.0)
        # the controller's interval (0.5 / 0.8 s) and the pause sleep in
        # short steps, so stopping the pool does not wait one out; a console
        # the engine does not own, drained at the end with no thread
        eng = pkg["scraper"].ScraperEngine(cfg, pkg["extractor"]("yfin"),
                                           lambda p=pages, tr=pkg["tr"]: tr.MockTransport(p),
                                           console=pkg["console"].ConsoleMux(out=io.StringIO()),
                                           sleep=lambda s: time.sleep(min(s, 0.02)))
        ok, bad = str(tmp_path / f"{name}-ok.csv"), str(tmp_path / f"{name}-bad.csv")
        s = eng.run(urls, ok, bad, mode=mode)
        rows = []
        for path in (ok, bad):
            with open(path, newline="", encoding="utf-8") as f:
                rows.append(sorted(tuple(r.items()) for r in csv.DictReader(f)))
        got[name] = (rows, (s.total_urls, s.attempted, s.succeeded, s.failed,
                            s.rate_limited_skipped, s.rate_limit_trips, s.errors))
    assert got["port"] == got["ref"]
    assert got["port"][1][2] > 0 and got["port"][1][4] == 1


def test_unknown_mode_is_refused(tmp_path):
    for pkg in (REF, PORT):
        eng = pkg["scraper"].ScraperEngine(pkg["cfg"](result_timeout=1.0),
                                           pkg["extractor"]("yfin"),
                                           lambda tr=pkg["tr"]: tr.MockTransport({}))
        with pytest.raises(ValueError, match="unknown mode 'warp'"):
            eng.run(["u"], str(tmp_path / "a.csv"), str(tmp_path / "b.csv"), mode="warp")


# -- the resume readers --------------------------------------------------------

CSV_CASES = {
    "clean": "url,x\nhttps://a,1\nhttps://b,2\n",
    "quoted": 'x,url\n1,"https://a,b"\n2,"say ""hi""\nthere"\n\n3,plain\n',
    "torn": 'url,article\nhttps://a,"done"\nhttps://b,"half writ',
    "torn_unquoted": "url,article\nhttps://a,done\nhttps://b,no newline",
    "missing_column": "link,x\nhttps://a,1\n",
    "nul": "url,x\nhttps://a\x00b,1\nhttps://c,2\n",
    "short_rows": "url,x,y\nhttps://a\n,\nhttps://b,1,2,3\n",
    "dup_header": "url,url\nfirst,second\n",
    "header_only": "url,article\n",
    "empty": "",
}


def read_all(mod, path: str) -> tuple:
    def outcome(fn, *a, **kw):
        try:
            return ("ok", fn(*a, **kw))
        except Exception as e:  # noqa: BLE001 - the outcome is the comparison
            return (type(e).__name__,)

    rows = (outcome(mod.read_url_column, path), outcome(mod.count_rows, path, repair=False),
            outcome(mod.read_url_column, path, column="x"),
            outcome(mod.read_url_column, path, repair=True), outcome(mod.scraped_url_set, path),
            outcome(mod.count_rows, path))
    side = path + ".quarantine"
    files = tuple(open(p, "rb").read() if os.path.exists(p) else None for p in (path, side))
    return rows, files


@pytest.mark.parametrize("case", list(CSV_CASES))
def test_csv_readers_match_the_reference(tmp_path, case, monkeypatch):
    served = []
    scan = csvnative.scan_column
    monkeypatch.setattr(csvnative, "scan_column",
                        lambda p, c: served.append(scan(p, c) is not None) or scan(p, c))
    got = {}
    for name, mod in (("ref", ref_csvio), ("port", csvio)):
        path = str(tmp_path / f"{name}.csv")
        with open(path, "w", newline="", encoding="utf-8") as f:
            f.write(CSV_CASES[case])
        got[name] = read_all(mod, path)
    assert got["port"] == got["ref"]
    if case == "clean":
        assert got["port"][0][0] == ("ok", ["https://a", "https://b"]) and all(served)
    if case in ("nul", "missing_column"):
        assert not served[0]  # the csv module's route
    if case == "torn":
        assert got["port"][1][1] is not None  # the torn bytes quarantined


def test_csv_reader_on_bad_utf8_matches_the_reference(tmp_path):
    got = {}
    for name, mod in (("ref", ref_csvio), ("port", csvio)):
        path = tmp_path / f"{name}.csv"
        path.write_bytes(b"url\nhttps://a\xff\xfe,\n")
        got[name] = read_all(mod, str(path))
    assert got["port"] == got["ref"]


def test_native_scanner_build_failure_raises(tmp_path, monkeypatch):
    path = tmp_path / "a.csv"
    path.write_text("url\nhttps://a\n")
    monkeypatch.setattr(csvnative, "_lib", None)

    def broken(*a, **kw):
        raise RuntimeError("g++ failed on csvscan.cpp")

    monkeypatch.setattr(native, "build", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        csvio.read_url_column(str(path))


def test_scanner_fuzz_matches_the_reference(tmp_path):
    rng = np.random.RandomState(3)
    alphabet = list('ab ,"\n\r\té統')
    for i in range(20):
        path = tmp_path / f"f{i}.csv"
        with open(path, "w", newline="", encoding="utf-8") as f:
            w = csv.writer(f)
            w.writerow(["x", "url", "y"][: rng.randint(1, 4)])
            for _ in range(rng.randint(0, 30)):
                w.writerow(["".join(rng.choice(alphabet, rng.randint(0, 12)))
                            for _ in range(rng.randint(0, 5))])
        assert csvio.read_url_column(str(path)) == ref_csvio.read_url_column(str(path))
        assert csvio.count_rows(str(path), repair=False) == ref_csvio.count_rows(
            str(path), repair=False)


# -- stats, console, controllers ----------------------------------------------


class Clock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def stats_script(mod) -> list:
    clock = Clock()
    st, rs = mod.StatsTracker(window=10.0, clock=clock), mod.RateStats(window=5.0, clock=clock)
    out = [st.get_actual_rate()]
    for step in range(40):
        clock.t += 0.37 * (step % 5)
        (st.record_success if step % 3 else st.record_fail)()
        rs.record_request()
        if step % 2:
            rs.record_response()
        out.append((st.get_stats(), st.get_actual_rate(), st.get_cumulative_stats(), rs.rates()))
    return out


def console_script(mod) -> list[str]:
    outs = []
    for threaded in (False, True):
        buf = io.StringIO()
        mux = mod.ConsoleMux(out=buf)
        if threaded:
            mux.start()
        mux.event("plain")
        mux.success("SUCCESS: a")
        mux.stats("Threads: 1 | Requests: 2.00/s")
        mux.failure("FAIL b : x")
        mux.stats("Threads: 1 | Requests: 3.00/s")
        mux.event("after")
        if threaded:
            mux.stop()
        mux.drain()
        outs.append(buf.getvalue())
    return outs


def controller_script(mod, stats_mod) -> list:
    clk = iter([0.0, 1.0, 2.0, 3.5, 4.0, 7.0, 7.5]).__next__
    pid = mod.PIDController(setpoint=8.0, kp_accel=0.5, ki_accel=0.1, kd_accel=0.05,
                            kp_decel=1.0, ki_decel=0.2, kd_decel=0.1, clock=clk)
    p = mod.PController(setpoint=7.0, kp=0.5)
    out = [[pid.compute(r) for r in (4.0, 10.0, 8.0, 2.0, 12.0, 7.5, 0.0)],
           [p.compute(r) for r in (1.0, 9.0, 7.0)]]
    pool = mod.ElasticWorkerPool(mod.PController(setpoint=20.0, kp=0.5),
                                 stats_mod.StatsTracker(window=10.0, clock=lambda: 100.0),
                                 lambda ev: ev.wait(5), limits=mod.PoolLimits(1, 4))
    with pool._lock:
        pool._spawn()
    out.append((pool.size, pool.step(), pool.size))

    class Hot:
        def get_actual_rate(self):
            return 100.0

    pool.stats, pool.controller = Hot(), mod.PController(setpoint=1.0, kp=0.5)
    out.append((pool.step(), pool.size))
    pool.stop()
    out.append(pool.size)
    return out


def test_stats_console_and_controllers_match_the_reference():
    assert stats_script(stats) == stats_script(ref_stats)
    assert console_script(console) == console_script(ref_console)
    assert console.green("x") == ref_console.green("x") and console.red("x") == ref_console.red("x")
    assert controller_script(controllers, stats) == controller_script(ref_controllers, ref_stats)


def test_stats_line_and_pause_match_the_reference():
    got = []
    for pkg in (REF, PORT):
        eng = pkg["scraper"].ScraperEngine(pkg["cfg"](max_threads=3, stats_time_window=10.0),
                                           pkg["extractor"]("yfin"),
                                           lambda tr=pkg["tr"]: tr.MockTransport({}))
        eng.stats.record_success()
        eng.stats.record_fail()
        line = eng._stats_line(10, 2)
        eng.pause.trigger(30.0)
        paused = eng._stats_line(10, 2)
        got.append((line.split("| Requests")[0], line.split("Count:")[1], "PAUSED" in paused,
                    eng._classify("u", ARTICLE_HTML), eng._classify("u", "<p>x</p>"),
                    pkg["scraper"]._RATE_LIMIT_FINGERPRINTS, pkg["scraper"].SUCCESS_FIELDS))
    assert got[1] == got[0]
    assert got[1][2] and got[1][4] == ("failed", {"url": "u", "error": "Title is empty"})


def test_resume_copies_stay_independent(tmp_path):
    """A reader's repair never touches another file: the quarantine lands
    beside the file it repaired (a copy made before stays whole)."""
    src = tmp_path / "a.csv"
    src.write_text('url,x\nhttps://a,1\nhttps://b,"torn')
    copy = tmp_path / "b.csv"
    shutil.copy(src, copy)
    assert csvio.scraped_url_set(str(src)) == {"https://a"}
    assert copy.read_text().endswith('"torn') and (tmp_path / "a.csv.quarantine").exists()
