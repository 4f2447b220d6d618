"""psycopg2-compatible DBAPI fake with REAL transactional semantics.

The port's copy of the reference's ``storage/pgfake.py``, on the
standard library's ``sqlite3``; the port's
:class:`~advanced_scrapper_tpu_torch.storage.backends.PostgresBackend`
runs over it as the reference's does.  Module names below are the
reference's.

This environment has neither a Postgres server nor psycopg2, yet the
reference's crypto pollers are Postgres-first (``CREATE DATABASE``
bootstrap + ``INSERT … ON CONFLICT DO NOTHING``,
``experiental/04_crypto_1.py:14-34,76-80``).  To keep
:class:`~advanced_scrapper_tpu.storage.backends.PostgresBackend` honest
beyond object stubs, this module emulates the psycopg2 surface the stores
use — module ``connect()``, connections with ``autocommit`` /
``commit()`` / ``rollback()`` / context-manager transaction blocks,
cursors with ``rowcount`` — over per-database sqlite files in WAL mode
(temp-dir backed, removed on ``close()``), with the Postgres dialect
translated per statement:

- ``%s`` placeholders → ``?`` — textually, EVERY occurrence: a literal
  ``%s`` inside a quoted string constant or LIKE pattern would be
  rewritten too (none of the store surface does this; revisit with a
  quote-aware scanner if store SQL grows string literals);
- ``SELECT … FROM pg_database WHERE datname = %s`` → the server registry;
- ``CREATE DATABASE "x"`` → a new shared in-memory database, refused
  inside a transaction exactly like the real server
  (psycopg2 ``ActiveSqlTransaction``);
- ``SELECT … FROM information_schema.tables WHERE table_name = %s`` →
  ``sqlite_master``.

Transactions are genuine: with ``autocommit = False`` (the DBAPI default)
writes stay invisible to other connections until ``commit()``, and
``rollback()`` discards them — the semantics the store's
one-transaction-per-operation contract (``stores.py::_StoreBase._conn``)
relies on.  Every connection to the same DSN database name sees one shared
database, so separate store operations round-trip like they would against
a server.

This is an offline stand-in, not a Postgres implementation: only the
dialect surface above is translated.  Against a real server the same
store code runs through psycopg2 unchanged.
"""

from __future__ import annotations

import re
import sqlite3
import threading


class Error(Exception):
    """DBAPI base error (psycopg2.Error shape)."""


class ProgrammingError(Error):
    pass


class ActiveSqlTransaction(ProgrammingError):
    """CREATE DATABASE inside a transaction — refused like the server."""


class OperationalError(Error):
    """Connecting to a database that does not exist."""


class FakePostgresServer:
    """Registry of named databases ("the server").

    Each database is one sqlite file in WAL mode inside a private temp
    dir: WAL gives Postgres-like snapshot behaviour — readers on other
    connections see the last COMMITTED state while a writer's transaction
    is open, instead of shared-cache sqlite's table-level read locks.
    """

    def __init__(self):
        import tempfile

        self._dir = tempfile.mkdtemp(prefix="pgfake-")
        self._dbs: set[str] = set()
        self._lock = threading.Lock()
        self.ensure("postgres")  # the admin database always exists

    def _path(self, name: str) -> str:
        import os

        return os.path.join(self._dir, f"{name}.db")

    def ensure(self, name: str) -> None:
        with self._lock:
            if name not in self._dbs:
                conn = sqlite3.connect(self._path(name))
                conn.execute("PRAGMA journal_mode=WAL")
                conn.close()
                self._dbs.add(name)

    def exists(self, name: str) -> bool:
        with self._lock:
            return name in self._dbs

    def close(self) -> None:
        import shutil

        with self._lock:
            self._dbs.clear()
            shutil.rmtree(self._dir, ignore_errors=True)

    # -- DBAPI module surface (inject the server itself as the driver) ----
    paramstyle = "pyformat"

    def connect(self, dsn: str):
        name = dbname_from_dsn(dsn)
        if not self.exists(name):
            raise OperationalError(f'database "{name}" does not exist')
        raw = sqlite3.connect(
            self._path(name), check_same_thread=False, timeout=10.0
        )
        return FakeConnection(raw, self)


def dbname_from_dsn(dsn: str) -> str:
    """Database name from a ``postgresql://…/dbname`` URL or a
    ``dbname=x host=y`` keyword DSN (both psycopg2 forms)."""
    m = re.search(r"dbname\s*=\s*(\S+)", dsn)
    if m:
        return m.group(1)
    m = re.match(r"postgres(?:ql)?://[^/]*/([^/?\s]+)", dsn)
    if m:
        return m.group(1)
    return "postgres"


_CREATE_DB = re.compile(r'^\s*CREATE\s+DATABASE\s+"?([A-Za-z0-9_]+)"?\s*$', re.I)
_PG_DATABASE = re.compile(r"\bpg_database\b", re.I)
_INFO_TABLES = re.compile(r"\binformation_schema\.tables\b", re.I)


class FakeConnection:
    def __init__(self, raw: sqlite3.Connection, server: FakePostgresServer):
        # isolation handled here, not by the sqlite3 module: BEGIN on the
        # first statement of a transaction, so autocommit toggling and
        # commit/rollback visibility behave like psycopg2
        raw.isolation_level = None
        self._raw = raw
        self._server = server
        self._closed = False
        self._in_txn = False
        self.autocommit = False

    # psycopg2's `with conn:` commits/rolls back but does NOT close
    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.commit()
        else:
            self.rollback()
        return False

    def cursor(self):
        if self._closed:
            raise Error("connection already closed")
        return FakeCursor(self)

    def _begin_if_needed(self) -> None:
        if not self.autocommit and not self._in_txn:
            self._raw.execute("BEGIN")
            self._in_txn = True

    def commit(self) -> None:
        if self._in_txn:
            self._raw.execute("COMMIT")
            self._in_txn = False

    def rollback(self) -> None:
        if self._in_txn:
            self._raw.execute("ROLLBACK")
            self._in_txn = False

    def close(self) -> None:
        if not self._closed:
            # psycopg2 discards an open transaction on close
            self.rollback()
            self._raw.close()
            self._closed = True


class FakeCursor:
    def __init__(self, conn: FakeConnection):
        self._conn = conn
        self._cur = conn._raw.cursor()
        self.rowcount = -1

    def execute(self, sql: str, params=()):
        conn = self._conn
        if conn._closed:
            raise Error("connection already closed")

        m = _CREATE_DB.match(sql)
        if m:
            if not conn.autocommit:
                # server behaviour: CREATE DATABASE cannot run inside a
                # transaction block (the bootstrap code must set
                # autocommit first, ref backends.py::ensure_database)
                raise ActiveSqlTransaction(
                    "CREATE DATABASE cannot run inside a transaction block"
                )
            conn._server.ensure(m.group(1))
            self.rowcount = -1
            return self

        translated = sql.replace("%s", "?")
        if _PG_DATABASE.search(translated):
            name = params[0] if params else None
            self._rows = [(1,)] if name and conn._server.exists(name) else []
            # psycopg2 reports the SELECT's row count, not -1
            self.rowcount = len(self._rows)
            self._from_list = True
            return self
        self._from_list = False
        translated = _INFO_TABLES.sub(
            "(SELECT name AS table_name FROM sqlite_master WHERE type='table')",
            translated,
        )
        conn._begin_if_needed()
        try:
            self._cur.execute(translated, tuple(params))
        except sqlite3.Error as e:
            raise ProgrammingError(str(e)) from e
        self.rowcount = self._cur.rowcount
        return self

    def fetchone(self):
        if getattr(self, "_from_list", False):
            return self._rows.pop(0) if self._rows else None
        return self._cur.fetchone()

    def fetchall(self):
        if getattr(self, "_from_list", False):
            rows, self._rows = self._rows, []
            return rows
        return self._cur.fetchall()

    def __iter__(self):
        if getattr(self, "_from_list", False):
            rows, self._rows = self._rows, []
            return iter(rows)
        return iter(self._cur)

    def close(self) -> None:
        self._cur.close()
