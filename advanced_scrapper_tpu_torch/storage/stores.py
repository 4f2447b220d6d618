"""Link/article stores with DB-flag resume, over a pluggable DB backend.

The port's copy of the reference's ``storage/stores.py``.  One change: an
article's date is parsed with ``core.dates.parse_date`` in place of
``dateutil.parser.parse`` (which the card's host does not have); where it
gives ``None`` the row keeps NULL dates, as the reference's ``except``
leaves them where dateutil refuses.  Module names below are the
reference's.

Re-implements the reference's live-poller persistence across BOTH of its
database stacks (``storage/backends.py``):

- SQLite (``experiental/09_btc_links.py:15-27``, ``10_btc_articles.py:48-112``)
  — the default;
- Postgres (``04_crypto_1.py:14-34``: ``CREATE DATABASE`` bootstrap,
  ``INSERT … ON CONFLICT DO NOTHING``) — same store code over a DBAPI
  driver.

Schema:

- ``links(url PRIMARY KEY, first_seen_utc, first_seen_unix,
  is_scraped DEFAULT 0)`` — insert-or-ignore discovery; the ``is_scraped``
  flag is the resume checkpoint (SURVEY.md §5.4 flavor 4);
- ``articles(url PRIMARY KEY, title, author, datetime_utc, datetime_unix,
  content, ticker_symbols)`` — upsert + flag flip in one transaction.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from datetime import datetime, timezone

from advanced_scrapper_tpu_torch.core.dates import parse_date
from advanced_scrapper_tpu_torch.storage.backends import make_backend

_LINK_COLS = ["url", "first_seen_utc", "first_seen_unix"]
_ARTICLE_COLS = [
    "url", "title", "author", "content",
    "datetime_utc", "datetime_unix", "ticker_symbols",
]


class _StoreBase:
    def __init__(self, target, *, driver=None):
        # target: sqlite path, postgres DSN, or a prebuilt backend object
        if isinstance(target, str):
            self.backend = make_backend(target, driver=driver)
        else:
            self.backend = target
        self.db_path = getattr(self.backend, "path", getattr(self.backend, "dsn", ""))

    @contextmanager
    def _conn(self):
        conn = self.backend.connect()
        try:
            with conn:  # one transaction per store operation (both DBAPIs)
                yield conn
        finally:
            conn.close()


class LinkStore(_StoreBase):
    """links table: discovery + is_scraped checkpoint."""

    def __init__(self, target, *, driver=None):
        super().__init__(target, driver=driver)
        with self._conn() as conn:
            conn.cursor().execute(
                """
                CREATE TABLE IF NOT EXISTS links (
                    url TEXT PRIMARY KEY,
                    first_seen_utc TIMESTAMP,
                    first_seen_unix INTEGER,
                    is_scraped INTEGER DEFAULT 0
                )
                """
            )

    def add_links(self, urls: list[str], now: float | None = None) -> list[str]:
        """Insert-or-ignore; returns the urls that were NEW (in input order).

        The reference's Postgres poller relies on exactly this
        insert-or-ignore semantics (``04_crypto_1.py:76-80``)."""
        ts = now if now is not None else time.time()
        utc = datetime.fromtimestamp(ts, timezone.utc).strftime("%Y-%m-%d %H:%M:%S")
        sql = self.backend.insert_ignore_sql("links", _LINK_COLS, "url")
        new: list[str] = []
        with self._conn() as conn:
            cur = conn.cursor()
            for u in urls:
                cur.execute(sql, (u, utc, int(ts)))
                if cur.rowcount:
                    new.append(u)
        return new

    def unscraped(self) -> list[str]:
        with self._conn() as conn:
            cur = conn.cursor()
            cur.execute("SELECT url FROM links WHERE is_scraped = 0")
            return [r[0] for r in cur.fetchall()]

    def mark_scraped(self, url: str) -> None:
        p = self.backend.paramstyle
        with self._conn() as conn:
            conn.cursor().execute(
                f"UPDATE links SET is_scraped = 1 WHERE url = {p}", (url,)
            )

    def counts(self) -> tuple[int, int]:
        with self._conn() as conn:
            cur = conn.cursor()
            cur.execute("SELECT COUNT(*) FROM links")
            total = cur.fetchone()[0]
            cur.execute("SELECT COUNT(*) FROM links WHERE is_scraped = 1")
            done = cur.fetchone()[0]
        return total, done


class ArticleStore(_StoreBase):
    """articles table: extractor-record upsert + link flag flip."""

    def __init__(self, target, *, driver=None):
        super().__init__(target, driver=driver)
        with self._conn() as conn:
            conn.cursor().execute(
                """
                CREATE TABLE IF NOT EXISTS articles (
                    url TEXT PRIMARY KEY,
                    title TEXT,
                    author TEXT,
                    datetime_utc TIMESTAMP,
                    datetime_unix INTEGER,
                    content TEXT,
                    ticker_symbols TEXT
                )
                """
            )

    def store(self, url: str, data: dict) -> None:
        """Upsert one extracted record and flip the link flag (ref 10:81-112)."""
        raw_dt = data.get("datetime") or None
        dt_utc = dt_unix = None
        if raw_dt:
            parsed = parse_date(str(raw_dt))
            if parsed is not None:
                try:
                    dt_utc = parsed.strftime("%Y-%m-%d %H:%M:%S")
                    dt_unix = int(parsed.timestamp())
                except (ValueError, OverflowError):
                    pass  # as the reference: dt_utc may stay set
        sql = self.backend.upsert_sql("articles", _ARTICLE_COLS, "url")
        with self._conn() as conn:
            cur = conn.cursor()
            cur.execute(
                sql,
                (
                    url,
                    str(data.get("title")) if data.get("title") is not None else None,
                    str(data.get("author")) if data.get("author") is not None else None,
                    str(data.get("article")) if data.get("article") is not None else None,
                    dt_utc,
                    dt_unix,
                    json.dumps(data.get("ticker_symbols"))
                    if data.get("ticker_symbols") is not None
                    else None,
                ),
            )
            # flip the link flag only when this DB also hosts a links table
            # (the reference shares one file; independent files are legal here
            # and must not roll back the article insert)
            if self.backend.has_table(conn, "links"):
                p = self.backend.paramstyle
                cur.execute(
                    f"UPDATE links SET is_scraped = 1 WHERE url = {p}", (url,)
                )

    def all_texts(self):
        """Yield (url, content) pairs — the cross-source dedup feed.

        Lazy: rows stream off the cursor so a multi-GB store never
        materialises on the host at once.
        """
        with self._conn() as conn:
            cur = conn.cursor()
            cur.execute("SELECT url, COALESCE(content, '') FROM articles")
            for r in cur:
                yield (r[0], r[1])

    def count(self) -> int:
        with self._conn() as conn:
            cur = conn.cursor()
            cur.execute("SELECT COUNT(*) FROM articles")
            return cur.fetchone()[0]
