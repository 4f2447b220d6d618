"""Yahoo Finance article extractor.

The port's copy of the reference's ``extractors/yfin.py``, on the port's
own HTML tree (``core/soup.py``) in place of bs4.  Behavioural contract
re-implemented from the original plugin (``extractors/yfin.py:7-163``) —
same selectors, same output fields, same rate-limit sentinels — so
downstream CSV schemas and the rate-limit circuit breaker behave
identically:

- ``title``        ``div.cover-title`` text (``:13-17``)
- ``error``        ``"rate_limit_reached"`` when the page is Yahoo's outage/
                   throttle interstitial (``:18-21``)
- ``author``       ``div.byline-attr-author`` text (``:24-28``)
- ``datetime``     first ``<time datetime=...>`` attribute (``:31-35``)
- ``article``      structural walk of ``div.body`` — paragraphs, bullet/
                   numbered lists, tables-as-JSON (``:38-125``)
- ``ticker_symbols`` symbols from ``finance.yahoo.com/quote/...`` hrefs under
                   ``div.body-wrap`` (``:149-163``)
- ``source``/``source_url`` from ``a.subtle-link.fin-size-small``
                   aria-label / href (``:134-145``)

One deliberate divergence: ``ticker_symbols`` preserves first-seen document
order (the reference materialises a ``set``, whose order varies per process
with hash randomisation) — deterministic output is required for stable CSV
golden tests.
"""

from __future__ import annotations

import json
import re

_QUOTE_RE = re.compile(r"https://finance\.yahoo\.com/quote/([^/?]+)")

_RATE_LIMIT_NEEDLES = (
    "Thank you for your patience.",
    "Our engineers are working quickly to resolve the issue.",
)
_EDGE_NOT_FOUND = "Edge: Not Found"

_LIST_TAGS = ("ul", "ol")


def _text(el) -> str:
    return el.get_text(strip=True)


def _table_to_json(table) -> str | None:
    rows = table.find_all("tr")
    if not rows:
        return None
    headers = [_text(c) for c in rows[0].find_all(["th", "td"])]
    data_rows = rows[1:] if any(headers) else rows
    if not any(headers):
        headers = []
    out = []
    for row in data_rows:
        cells = [_text(c) for c in row.find_all(["th", "td"])]
        out.append(dict(zip(headers, cells)) if headers and len(headers) == len(cells) else cells)
    return json.dumps(out)


def _walk_body(el, parts: list[str]) -> None:
    name = getattr(el, "name", None)
    if name == "p":
        t = _text(el)
        if t:
            parts.append(t)
    elif name in _LIST_TAGS:
        ordered = name == "ol"
        for idx, li in enumerate(el.find_all("li", recursive=False), 1):
            t = _text(li)
            if t:
                parts.append(f"{idx}. {t}" if ordered else f"• {t}")
    elif name == "li":
        t = _text(el)
        if t:
            parts.append(f"• {t}")
    elif name == "table":
        tj = _table_to_json(el)
        if tj:
            parts.append(tj)
    else:
        for child in el.contents:
            if not isinstance(child, str):
                _walk_body(child, parts)


def _is_rate_limited(soup) -> bool:
    page_text = soup.get_text()
    return (
        all(n in page_text for n in _RATE_LIMIT_NEEDLES)
        or _EDGE_NOT_FOUND in page_text
    )


def extract_ticker_symbols(soup) -> list[str]:
    section = soup.select_one("div.body-wrap")
    if section is None:
        return []
    seen: dict[str, None] = {}
    for link in section.find_all("a", href=True):
        m = _QUOTE_RE.search(link["href"])
        if m:
            seen.setdefault(m.group(1))
    return list(seen)


def extract_article_data(soup) -> dict:
    data: dict = {}

    title_el = soup.select_one("div.cover-title")
    if title_el is not None:
        data["title"] = _text(title_el)
    else:
        data["title"] = ""
        if _is_rate_limited(soup):
            data["error"] = "rate_limit_reached"

    author_el = soup.select_one("div.byline-attr-author")
    data["author"] = _text(author_el) if author_el is not None else ""

    time_el = soup.find("time")
    data["datetime"] = (
        time_el["datetime"] if time_el is not None and time_el.has_attr("datetime") else ""
    )

    body_el = soup.select_one("div.body")
    if body_el is not None:
        parts: list[str] = []
        _walk_body(body_el, parts)
        data["article"] = "\n".join(parts)
    else:
        data["article"] = ""

    data["ticker_symbols"] = extract_ticker_symbols(soup)

    source_el = soup.select_one("a.subtle-link.fin-size-small")
    data["source"] = (
        source_el["aria-label"]
        if source_el is not None and source_el.has_attr("aria-label")
        else ""
    )
    data["source_url"] = (
        source_el["href"] if source_el is not None and source_el.has_attr("href") else ""
    )
    return data
