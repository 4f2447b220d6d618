"""DB backend seam for the link/article stores.

The port's copy of the reference's ``storage/backends.py``, unchanged below
this paragraph: stdlib ``sqlite3`` by default, and psycopg2 imported only
when a Postgres store is opened without a driver (the card's host has
none).  Module names below are the reference's.

The reference runs TWO database stacks side by side: Postgres for the live
crypto pollers (``experiental/04_crypto_1.py:14-34`` — ``CREATE DATABASE``
bootstrap, ``INSERT … ON CONFLICT DO NOTHING``) and SQLite for the BTC
poller (``09_btc_links.py:15-27``).  Round 1 collapsed both onto sqlite
with no way back; this seam restores the dual-store reality:

- :class:`SqliteBackend` — stdlib, the default.
- :class:`PostgresBackend` — same store code over a DBAPI driver
  (psycopg2 when installed; any compatible module can be injected, which
  is also how the seam is tested in an environment without Postgres).

The stores speak a small dialect surface (paramstyle, insert-or-ignore,
upsert, has_table) rather than hardcoding SQL strings per engine — both
engines support the modern ``ON CONFLICT`` form, so the differences are
genuinely small.
"""

from __future__ import annotations

import sqlite3


class SqliteBackend:
    """Default backend: one sqlite file (or ':memory:')."""

    paramstyle = "?"

    def __init__(self, path: str):
        self.path = path

    def connect(self):
        return sqlite3.connect(self.path)

    def insert_ignore_sql(self, table: str, cols: list[str], conflict_col: str) -> str:
        ph = ", ".join([self.paramstyle] * len(cols))
        return (
            f"INSERT INTO {table} ({', '.join(cols)}) VALUES ({ph}) "
            f"ON CONFLICT ({conflict_col}) DO NOTHING"
        )

    def upsert_sql(self, table: str, cols: list[str], conflict_col: str) -> str:
        ph = ", ".join([self.paramstyle] * len(cols))
        updates = ", ".join(
            f"{c} = excluded.{c}" for c in cols if c != conflict_col
        )
        return (
            f"INSERT INTO {table} ({', '.join(cols)}) VALUES ({ph}) "
            f"ON CONFLICT ({conflict_col}) DO UPDATE SET {updates}"
        )

    def has_table(self, conn, name: str) -> bool:
        cur = conn.execute(
            "SELECT 1 FROM sqlite_master WHERE type='table' AND name=?", (name,)
        )
        return cur.fetchone() is not None


class PostgresBackend:
    """Postgres over a DBAPI driver (psycopg2-compatible).

    ``driver`` may be injected (tests, alternative drivers); by default
    psycopg2 is imported lazily and a missing install raises with a clear
    message — matching the reference's hard psycopg2 dependency
    (``04_crypto_1.py:6``).
    """

    paramstyle = "%s"

    def __init__(self, dsn: str, driver=None):
        if driver is None:
            try:
                import psycopg2 as driver  # type: ignore[no-redef]
            except ImportError as e:
                raise RuntimeError(
                    "Postgres store requires psycopg2 (not installed); "
                    "install it, inject a DBAPI driver, or use a sqlite path"
                ) from e
        self.driver = driver
        self.dsn = dsn

    def connect(self):
        return self.driver.connect(self.dsn)

    def ensure_database(self, name: str, admin_dsn: str) -> None:
        """``CREATE DATABASE`` bootstrap (ref 04_crypto_1.py:14-34): connect
        to an admin database, create ``name`` if absent."""
        conn = self.driver.connect(admin_dsn)
        try:
            conn.autocommit = True  # CREATE DATABASE cannot run in a txn
            cur = conn.cursor()
            cur.execute("SELECT 1 FROM pg_database WHERE datname = %s", (name,))
            if cur.fetchone() is None:
                cur.execute(f'CREATE DATABASE "{name}"')
        finally:
            conn.close()

    def insert_ignore_sql(self, table: str, cols: list[str], conflict_col: str) -> str:
        ph = ", ".join([self.paramstyle] * len(cols))
        return (
            f"INSERT INTO {table} ({', '.join(cols)}) VALUES ({ph}) "
            f"ON CONFLICT ({conflict_col}) DO NOTHING"
        )

    def upsert_sql(self, table: str, cols: list[str], conflict_col: str) -> str:
        ph = ", ".join([self.paramstyle] * len(cols))
        updates = ", ".join(
            f"{c} = excluded.{c}" for c in cols if c != conflict_col
        )
        return (
            f"INSERT INTO {table} ({', '.join(cols)}) VALUES ({ph}) "
            f"ON CONFLICT ({conflict_col}) DO UPDATE SET {updates}"
        )

    def has_table(self, conn, name: str) -> bool:
        cur = conn.cursor()
        cur.execute(
            "SELECT 1 FROM information_schema.tables WHERE table_name = %s",
            (name,),
        )
        return cur.fetchone() is not None


def make_backend(target: str, *, driver=None):
    """``postgres://``/``postgresql://`` DSN → Postgres; anything else is a
    sqlite path."""
    if target.startswith(("postgres://", "postgresql://")):
        return PostgresBackend(target, driver=driver)
    return SqliteBackend(target)
