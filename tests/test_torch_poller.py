"""The port's topic poller (``pipeline/poller.py``, on ``core/soup.py``)
against the JAX package's (on bs4).

The same topic pages (the reference's fixture and seeded ones from
``chip_smoke.topic_pages`` over ``scrape_pages``' article pages) go to
both packages' ``poll_links`` and ``drain_unscraped``, each into a sqlite
link and article store of its own, the clock fixed: the links found, the
mirror CSV bytes, the poll counts and the stored rows must be equal."""

from __future__ import annotations

import os
import sqlite3
import time

import numpy as np
import pytest

import chip_smoke
from advanced_scrapper_tpu.extractors import load_extractor as ref_load_extractor
from advanced_scrapper_tpu.net.transport import MockTransport as RefMockTransport
from advanced_scrapper_tpu.pipeline import poller as ref_poller
from advanced_scrapper_tpu.storage import stores as ref_stores
from advanced_scrapper_tpu_torch.extractors import load_extractor
from advanced_scrapper_tpu_torch.net.transport import MockTransport
from advanced_scrapper_tpu_torch.pipeline import poller
from advanced_scrapper_tpu_torch.storage import stores

#: package → (poller, stores, MockTransport, load_extractor)
PKGS = {"jax": (ref_poller, ref_stores, RefMockTransport, ref_load_extractor),
        "port": (poller, stores, MockTransport, load_extractor)}
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
TOPIC_HTML = """
<html><body><div id="Fin-Stream">
  <a href="https://finance.yahoo.com/news/btc-surges-123.html">BTC surges</a>
  <a href="https://finance.yahoo.com/news/eth-dips-456.html?src=rss">ETH dips</a>
  <a href="/news/relative-link.html">relative (no https)</a>
  <a href="https://finance.yahoo.com/videos/not-news.html">video</a>
  <a href="https://finance.yahoo.com/news/no-extension">no .html</a>
  <a name="no-href">no href</a>
  <a href="https://finance.yahoo.com/news/amp&amp;x.html">entity</a>
  <a HREF="https://finance.yahoo.com/news/upper-case-attr.html">attribute case</a>
</div></body></html>
"""
NOW = 1_700_000_000.25


@pytest.fixture(scope="module")
def site():
    """``scrape_pages``' small pages (seed 41, bodies cut at 600 bytes),
    the rate-limit sentinel left out, and seeded topic pages over them."""
    urls, pages, _planted, titleless, limited = chip_smoke.scrape_pages(
        np.random.RandomState(41), 160, body_cap=600)
    urls = [u for u in urls if u != limited]
    topics, fresh = chip_smoke.topic_pages(np.random.RandomState(43), urls, rounds=12, links=16)
    return pages, titleless, topics, fresh


@pytest.mark.parametrize("name", ["topic", "yfin_article.html", "yfin_headerless_table.html",
                                  "yfin_rate_limited.html"])
def test_topic_links_equal_reference(name):
    html = TOPIC_HTML if name == "topic" else open(os.path.join(FIXTURES, name)).read()
    assert poller.extract_topic_links(html) == ref_poller.extract_topic_links(html)


def test_seeded_topic_links_equal_reference(site):
    _pages, _titleless, topics, _fresh = site
    for html in topics:
        got = poller.extract_topic_links(html)
        assert got == ref_poller.extract_topic_links(html) and len(got) == 16


def run_pkg(pkg: str, root, pages, topics, *, drain_rounds=1, mirror=True):
    """The CLI's loop (a poll and a drain a round) over ``topics``."""
    mod, st, mock, load = PKGS[pkg]
    os.makedirs(root, exist_ok=True)
    db = str(root / "news.db")
    links, articles = st.LinkStore(db), st.ArticleStore(db)
    rounds = iter(topics)
    transport = mock({**pages, chip_smoke.POLL_TOPIC: lambda _u: next(rounds)})
    mirror_csv = str(root / "mirror.csv") if mirror else None
    new = stored = 0
    sleeps: list[float] = []
    for _ in topics:
        new += mod.poll_links(links, transport, topic_url=chip_smoke.POLL_TOPIC,
                              max_iterations=1, sleep=sleeps.append, mirror_csv=mirror_csv)
        stored += mod.drain_unscraped(links, articles, transport, load("yfin"),
                                      max_rounds=drain_rounds, sleep=sleeps.append)
    conn = sqlite3.connect(db)
    rows = (conn.execute("SELECT * FROM links ORDER BY url").fetchall(),
            conn.execute("SELECT * FROM articles ORDER BY url").fetchall())
    conn.close()
    csv_bytes = open(mirror_csv, "rb").read() if mirror else b""
    return new, stored, sleeps, sorted(links.unscraped()), rows, csv_bytes


@pytest.mark.parametrize("drain_rounds", [1, 2])
def test_poll_and_drain_equal_reference(tmp_path, monkeypatch, site, capsys, drain_rounds):
    pages, titleless, topics, fresh = site
    monkeypatch.setattr(time, "time", lambda: NOW)
    got = {pkg: run_pkg(pkg, tmp_path / pkg, pages, topics, drain_rounds=drain_rounds)
           for pkg in PKGS}
    assert got["port"] == got["jax"]
    new, stored, sleeps, unscraped, (link_rows, article_rows), mirror = got["port"]
    titled = [u for u in fresh if u not in titleless]
    assert new == len(fresh) and stored == len(titled) == len(article_rows)
    assert unscraped == sorted(set(fresh) & titleless) and unscraped
    assert mirror.decode().splitlines()[1:] == [f"{u},2023-11-14 22:13:20" for u in fresh]
    assert sleeps == ([15.0] * len(topics) if drain_rounds == 2 else [])
    assert {r[0] for r in link_rows} == set(fresh)
    assert capsys.readouterr().out.count("poll error") == 0


def test_poll_errors_and_scroll_equal_reference(tmp_path, monkeypatch, capsys):
    """A failing fetch is logged and the loop goes on; ``scroll=True`` on
    a transport without ``fetch_scrolled`` warns once and polls the first
    page; with it, the scrolled page is read."""
    monkeypatch.setattr(time, "time", lambda: NOW)
    out = {}
    for pkg, (mod, st, mock, _load) in PKGS.items():
        flaky = iter([RuntimeError("boom"), TOPIC_HTML, TOPIC_HTML])

        def page(_u, flaky=flaky):
            item = next(flaky)
            if isinstance(item, Exception):
                raise item
            return item

        class Scrolling(mock):
            def fetch_scrolled(self, url):
                return TOPIC_HTML.replace(
                    "</div>", '<a href="https://finance.yahoo.com/news/lazy-7.html">l</a></div>')

        links = st.LinkStore(str(tmp_path / f"{pkg}.db"))
        sleeps: list[float] = []
        n1 = mod.poll_links(links, mock(page), max_iterations=3, sleep=sleeps.append,
                            interval=2.5, scroll=True)
        text1 = capsys.readouterr().out
        n2 = mod.poll_links(links, Scrolling(lambda _u: TOPIC_HTML), max_iterations=1,
                            sleep=sleeps.append, scroll=True)
        out[pkg] = (n1, n2, sleeps, text1, capsys.readouterr().out, sorted(links.unscraped()))
    assert out["port"] == out["jax"]
    n1, n2, sleeps, text1, _text2, _links = out["port"]
    assert (n1, n2) == (4, 1) and sleeps == [2.5, 2.5]
    assert text1.count("cannot scroll") == 1 and "poll error: boom" in text1


def test_drain_keeps_failed_links_equal_reference(tmp_path):
    """A missing page is logged and stays unscraped; an article store in a
    file of its own leaves the link flags alone, so each round stores the
    fetched pages again (an upsert: one row each)."""
    article = open(os.path.join(FIXTURES, "yfin_article.html")).read()
    pages = {"https://x/news/a.html": article,
             "https://x/news/t.html": article.replace("<h1", "<h6").replace("</h1>", "</h6>")}
    out = {}
    for pkg, (mod, st, mock, load) in PKGS.items():
        links = st.LinkStore(str(tmp_path / f"{pkg}-links.db"))
        arts = st.ArticleStore(str(tmp_path / f"{pkg}-arts.db"))
        links.add_links(["https://x/news/a.html", "https://x/news/t.html",
                         "https://x/news/gone.html"], now=1.0)
        stored = mod.drain_unscraped(links, arts, mock(pages), load("yfin"), max_rounds=3,
                                     sleep=lambda _s: None)
        conn = sqlite3.connect(str(tmp_path / f"{pkg}-arts.db"))
        rows = conn.execute("SELECT * FROM articles").fetchall()
        conn.close()
        out[pkg] = (stored, sorted(links.unscraped()), rows)
    assert out["port"] == out["jax"]
    stored, unscraped, rows = out["port"]
    assert len(unscraped) == 3 and len(rows) == 2 and stored == 3 * len(rows)
