"""The port's extractors (``extractors/__init__.py``, ``yfin.py``,
``template.py``) on its HTML tree, against the JAX package's on bs4.

The yfin extractor and ``extract_ticker_symbols`` return the reference's
dicts on the three fixtures, on seeded yfin pages (the generator of
``chip_smoke.py``'s ``scrape_path``: paragraphs, lists, tables, quote
links, script, style, comments, pages without a title) and on seeded
random markup; the template extractor returns the reference's dicts for
the templates of the reference's tests and for generated ones, and the
template store writes the reference's JSON."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
from bs4 import BeautifulSoup

import chip_smoke
from advanced_scrapper_tpu import extractors as ref_extractors
from advanced_scrapper_tpu.extractors import template as ref_template
from advanced_scrapper_tpu.extractors import yfin as ref_yfin
from advanced_scrapper_tpu_torch import extractors
from advanced_scrapper_tpu_torch.core.soup import Soup
from advanced_scrapper_tpu_torch.extractors import template, yfin
from test_torch_soup import FIXTURE_PAGES, TRAPS, random_document


def seeded_pages() -> dict[str, str]:
    rng = np.random.RandomState(5)
    _urls, pages, _planted, titleless, limited = chip_smoke.scrape_pages(rng, 48)
    assert titleless and limited in pages
    return pages


PAGES = {**FIXTURE_PAGES, **{f"page{i}": p for i, p in enumerate(seeded_pages().values())},
         **{f"random{i}": random_document(np.random.RandomState(100 + i), 200)
            for i in range(12)},
         **{f"trap{i}": t for i, t in enumerate(TRAPS)}}


def test_plugin_boundary_matches_the_reference():
    assert extractors.SUCCESS_FIELDS == ref_extractors.SUCCESS_FIELDS
    assert extractors.FAILED_FIELDS == ref_extractors.FAILED_FIELDS
    assert extractors.load_extractor("yfin") is yfin.extract_article_data
    extractors.register("nullsite", lambda soup: {"title": ""})
    assert extractors.load_extractor("nullsite")(None) == {"title": ""}
    with pytest.raises(ModuleNotFoundError):
        extractors.load_extractor("no_such_site")


@pytest.mark.parametrize("name", list(PAGES))
def test_yfin_matches_the_reference(name):
    page = PAGES[name]
    ref_soup, soup = BeautifulSoup(page, "html.parser"), Soup(page)
    want = ref_yfin.extract_article_data(ref_soup)
    assert yfin.extract_article_data(soup) == want
    assert yfin.extract_ticker_symbols(soup) == ref_yfin.extract_ticker_symbols(ref_soup)
    if name == "yfin_article.html":
        assert want["title"].startswith("Apple") and want["ticker_symbols"] == ["AAPL", "MSFT"]
    if name == "yfin_rate_limited.html":
        assert want["error"] == "rate_limit_reached"


TEMPLATES = [
    {"title": "div.cover-title",
     "date": {"selector": "time", "attribute": "datetime", "index": [0]},
     "bullets": {"selector": "ul li"}, "second_bullet": {"selector": "ul li", "index": [1]},
     "missing": "div.does-not-exist", "missing_dict": {"selector": "div.does-not-exist"},
     "links": {"selector": "div.body p", "inner": {"selector": "a", "attribute": "href"}}},
    {"title": 'h1[data-test-locator="headline"]', "author": "span.caas-author-byline-collapse",
     "date": {"selector": "time", "attribute": "datetime", "index": [0]},
     "article": "div.caas-body",
     "ticker_symbols": {"selector": "div.caas-body-content", "attribute": "data-symbol",
                        "index": [0], "inner": {"selector": "fin-ticker", "attribute": "symbol"}}},
    {"x": {"selector": "ul li", "index": [99]}, "classes": {"selector": "a", "attribute": "class"},
     "rows": {"selector": "table tr", "inner": {"selector": "td", "index": [1, 0]}},
     "quote": {"selector": "div.body-wrap a[href*=quote]", "attribute": "href"},
     "first_p": "div.body > p", "after_ul": {"selector": "ul ~ p"}, "adjacent": "ul + ol li",
     "either": {"selector": "h1, div.cover-title"}, "ids": {"selector": "[id]", "attribute": "id"},
     "starts": {"selector": "a[href^='https://www']", "attribute": "aria-label"},
     "ends": {"selector": "a[href$=AAPL]"}, "bad_type": "h1 >", "no_selector": {"index": [0]}},
]


@pytest.mark.parametrize("t", range(len(TEMPLATES)))
@pytest.mark.parametrize("name", ["yfin_article.html", "yfin_headerless_table.html",
                                  "page0", "page1", "random3"])
def test_template_extractor_matches_the_reference(name, t):
    page, tpl = PAGES[name], TEMPLATES[t]
    want = ref_template.make_template_extractor(tpl)(BeautifulSoup(page, "html.parser"))
    assert template.make_template_extractor(tpl)(Soup(page)) == want
    assert template.extract_with_template(Soup(page), tpl) == want
    with pytest.raises(TypeError):
        template.extract_with_template(Soup(page), {"bad": 3})


def test_template_store_matches_the_reference(tmp_path):
    for name, mod in (("ref", ref_template), ("port", template)):
        store = mod.TemplateStore(str(tmp_path / f"{name}.json"))
        store.add("mysite", TEMPLATES[0])
        store.add("other", {"title": "div.cover-title"})
        assert store.names() == ["mysite", "other"] and store.get("other") == {
            "title": "div.cover-title"}
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    again = template.TemplateStore(str(tmp_path / "ref.json"))
    again.register_all()
    page = FIXTURE_PAGES["yfin_article.html"]
    assert extractors.load_extractor("mysite")(Soup(page)) == \
        ref_template.make_template_extractor(TEMPLATES[0])(BeautifulSoup(page, "html.parser"))
    assert json.loads((tmp_path / "port.json").read_text())["other"] == {
        "title": "div.cover-title"}
    assert os.path.exists(tmp_path / "port.json")
