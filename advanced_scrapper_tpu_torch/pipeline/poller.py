"""Live topic poller: discover new article links on a rolling basis.

The port's copy of the reference's ``pipeline/poller.py``.  One change:
pages are parsed by the port's HTML tree (``core/soup.py:Soup``) where the
reference uses ``BeautifulSoup(html, "html.parser")``; the links, the
mirror CSV and the stored rows are the reference's.

Re-implements the reference's live-news loops (``experiental/04_crypto_1.py``
/ ``09_btc_links.py`` + the article side of ``05``/``10``):

- poll a topic page (default the crypto feed) every ``interval`` seconds;
- keep links passing the reference's filter — contains ``/news/`` AND
  ``.html`` AND ``https:`` (``04:75``);
- insert-or-ignore into the link store (``is_scraped`` flag resume);
- optionally drain unscraped links through an extractor into the article
  store, re-queueing whatever fails so the loop retries it forever
  (``10:248-268``).

Transport/clock/sleep are injectable; ``max_iterations`` makes the infinite
reference loop testable and cron-able.

Two reference behaviours kept:

- **mirror CSV** — ``04_crypto_1.py:76-80`` writes every new link to
  Postgres *and* a CSV; ``poll_links(mirror_csv=...)`` does the same.
- **scroll-to-load** — ``04:57-63`` scrolls the topic page to force lazy
  loading before collecting links.  ``poll_links(scroll=True)`` uses the
  transport's ``fetch_scrolled`` when it has one (``SeleniumTransport``
  scrolls until the page height stabilises); plain-HTTP transports have no
  scroll analogue — discovery coverage is then the first page only, and
  the fallback is logged once so the difference is visible.
"""

from __future__ import annotations

import csv
import os
import time
from datetime import datetime, timezone
from typing import Callable

from advanced_scrapper_tpu_torch.core.soup import Soup
from advanced_scrapper_tpu_torch.storage.stores import ArticleStore, LinkStore

DEFAULT_TOPIC_URL = "https://finance.yahoo.com/topic/crypto/"


def extract_topic_links(html: str) -> list[str]:
    """All hrefs passing the reference link filter (ref 04:74-75)."""
    soup = Soup(html)
    out = []
    for a in soup.find_all("a", href=True):
        link = a["href"]
        if "/news/" in link and ".html" in link and "https:" in link:
            out.append(link)
    return out


def _mirror_new_links(path: str, urls: list[str], now: float) -> None:
    """Append new links to the mirror CSV (ref 04:76-80 writes url + time)."""
    utc = datetime.fromtimestamp(now, timezone.utc).strftime("%Y-%m-%d %H:%M:%S")
    header = not os.path.exists(path) or os.path.getsize(path) == 0
    with open(path, "a", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        if header:
            w.writerow(["url", "first_seen_utc"])
        for u in urls:
            w.writerow([u, utc])
        f.flush()


def poll_links(
    store: LinkStore,
    transport,
    *,
    topic_url: str = DEFAULT_TOPIC_URL,
    interval: float = 3.0,       # ref 04 polls every 3 s
    max_iterations: int | None = None,
    sleep: Callable[[float], None] = time.sleep,
    on_new: Callable[[list[str]], None] | None = None,
    mirror_csv: str | None = None,
    scroll: bool = False,
) -> int:
    """Poll loop; returns total NEW links discovered."""
    total_new = 0
    i = 0
    scroll_warned = False
    while max_iterations is None or i < max_iterations:
        i += 1
        try:
            if scroll and hasattr(transport, "fetch_scrolled"):
                html = transport.fetch_scrolled(topic_url)
            else:
                if scroll and not scroll_warned:
                    scroll_warned = True
                    print(
                        f"poll: transport {type(transport).__name__} cannot "
                        "scroll; lazy-loaded links beyond the first page "
                        "will not be discovered"
                    )
                html = transport.fetch(topic_url)
            links = extract_topic_links(html)
            now = time.time()
            fresh = store.add_links(links, now=now)
            total_new += len(fresh)
            if fresh and mirror_csv is not None:
                _mirror_new_links(mirror_csv, fresh, now)
            if fresh and on_new is not None:
                on_new(fresh)
        except Exception as e:
            print(f"poll error: {e}")
        if max_iterations is None or i < max_iterations:
            sleep(interval)
    return total_new


def drain_unscraped(
    link_store: LinkStore,
    article_store: ArticleStore,
    transport,
    extractor: Callable,
    *,
    max_rounds: int = 1,
    sleep: Callable[[float], None] = time.sleep,
    round_interval: float = 15.0,  # ref 10 re-queues unscraped every pass
) -> int:
    """Scrape every unscraped link into the article store; failed links stay
    flagged unscraped and are retried next round (ref 10:248-268)."""
    stored = 0
    for r in range(max_rounds):
        todo = link_store.unscraped()
        if not todo:
            break
        for url in todo:
            try:
                html = transport.fetch(url)
                data = extractor(Soup(html))
                if not data.get("title"):
                    continue  # stays unscraped → retried
                article_store.store(url, data)
                stored += 1
            except Exception as e:
                print(f"drain error for {url}: {e}")
        if r < max_rounds - 1 and link_store.unscraped():
            sleep(round_interval)
    return stored
