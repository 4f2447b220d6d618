"""The port's psycopg2-shaped fake (``storage/pgfake.py``) against the JAX
package's: the same SQL scripts give the same rows, row counts and error
class names, transactions behave the same, and the port's link and
article stores run on the Postgres backend over either package's fake with
the rows the reference's stores write."""

from __future__ import annotations

import os

import numpy as np
import pytest

from advanced_scrapper_tpu.storage import backends as ref_backends
from advanced_scrapper_tpu.storage import pgfake as ref_pgfake
from advanced_scrapper_tpu.storage import stores as ref_stores
from advanced_scrapper_tpu_torch.storage import backends, pgfake, stores

#: package → (pgfake, backends, stores)
PKGS = {"jax": (ref_pgfake, ref_backends, ref_stores), "port": (pgfake, backends, stores)}
DSN = "postgresql://localhost/crypto_links"
ADMIN = "postgresql://localhost/postgres"


def fake_server(pkg: str):
    """A fake server of ``pkg`` with the application database made."""
    srv = PKGS[pkg][0].FakePostgresServer()
    PKGS[pkg][1].PostgresBackend(DSN, driver=srv).ensure_database("crypto_links", ADMIN)
    return srv


def script(rng: np.random.RandomState) -> list[tuple[str, tuple]]:
    """A seeded SQL script in the store's dialect: DDL, inserts with and
    without conflicts, upserts, updates, selects, an unknown table, a
    syntax error, the catalogue probes and CREATE DATABASE."""
    out = [("CREATE TABLE IF NOT EXISTS t (k TEXT PRIMARY KEY, v INTEGER, s TEXT)", ())]
    for _ in range(40):
        k = f"k{rng.randint(12)}"
        u = rng.rand()
        if u < 0.3:
            out.append(("INSERT INTO t (k, v, s) VALUES (%s, %s, %s) ON CONFLICT (k) DO NOTHING",
                        (k, int(rng.randint(100)), "x" * int(rng.randint(4)))))
        elif u < 0.5:
            out.append(("INSERT INTO t (k, v, s) VALUES (%s, %s, %s) ON CONFLICT (k) DO UPDATE "
                        "SET v = excluded.v, s = excluded.s", (k, int(rng.randint(100)), "y")))
        elif u < 0.6:
            out.append(("UPDATE t SET v = v + 1 WHERE k = %s", (k,)))
        elif u < 0.7:
            out.append(("DELETE FROM t WHERE v < %s", (int(rng.randint(20)),)))
        elif u < 0.8:
            out.append(("SELECT k, v, s FROM t ORDER BY k", ()))
        elif u < 0.85:
            out.append(("SELECT 1 FROM information_schema.tables WHERE table_name = %s",
                        (["t", "nope"][rng.randint(2)],)))
        elif u < 0.9:
            out.append(("SELECT 1 FROM pg_database WHERE datname = %s",
                        (["crypto_links", "other"][rng.randint(2)],)))
        elif u < 0.95:
            out.append(("SELECT * FROM missing_table", ()))
        else:
            out.append(("SELEC broken", ()))
    out.append(('CREATE DATABASE "fresh"', ()))
    return out


def run_script(srv, steps, autocommit: bool):
    conn = srv.connect(DSN)
    conn.autocommit = autocommit
    got = []
    for sql, params in steps:
        cur = conn.cursor()
        try:
            cur.execute(sql, params)
        except Exception as e:  # the error's class is what is compared
            got.append(("error", type(e).__name__))
            conn.rollback()
            continue
        rows = cur.fetchall() if sql.lstrip().upper().startswith("SELECT") else None
        got.append((cur.rowcount, rows))
    conn.commit()
    conn.close()
    return got, srv.exists("fresh")


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("autocommit", [False, True])
def test_scripts_give_the_reference_rows(seed, autocommit):
    steps = script(np.random.RandomState(seed))
    out = {}
    for pkg in PKGS:
        srv = fake_server(pkg)
        try:
            out[pkg] = run_script(srv, steps, autocommit)
        finally:
            srv.close()
    assert out["port"] == out["jax"]
    errors = {e[1] for e in out["port"][0] if e[0] == "error"}
    assert errors <= {"ProgrammingError", "ActiveSqlTransaction"}
    assert out["port"][1] is autocommit  # CREATE DATABASE runs only outside a transaction


def test_errors_and_dsns_equal_reference():
    for dsn in ("postgresql://h:5432/db1", "postgres://u:p@h/db2?sslmode=x",
                "dbname=db3 host=h", "host=h", "postgresql://h"):
        assert pgfake.dbname_from_dsn(dsn) == ref_pgfake.dbname_from_dsn(dsn)
    for pkg in PKGS:
        mod = PKGS[pkg][0]
        assert [c.__name__ for c in mod.ActiveSqlTransaction.__mro__[:4]] == [
            "ActiveSqlTransaction", "ProgrammingError", "Error", "Exception"]
        srv = mod.FakePostgresServer()
        try:
            with pytest.raises(mod.OperationalError, match='database "nope" does not exist'):
                srv.connect("postgresql://localhost/nope")
            conn = srv.connect(ADMIN)
            conn.close()
            with pytest.raises(mod.Error, match="closed"):
                conn.cursor()
        finally:
            srv.close()


def test_transactions_equal_reference():
    """Uncommitted writes are invisible to another connection, a rollback
    drops them, ``with conn`` commits, close discards an open
    transaction."""
    out = {}
    for pkg in PKGS:
        srv = fake_server(pkg)
        try:
            a, b = srv.connect(DSN), srv.connect(DSN)
            seen = []

            def count(conn):
                cur = conn.cursor()
                cur.execute("SELECT COUNT(*) FROM t")
                n = cur.fetchone()[0]
                conn.commit()
                return n

            with a:
                a.cursor().execute("CREATE TABLE t (x INTEGER)")
            a.cursor().execute("INSERT INTO t (x) VALUES (%s)", (1,))
            seen.append(count(b))
            a.rollback()
            seen.append(count(b))
            with a:
                a.cursor().execute("INSERT INTO t (x) VALUES (%s)", (2,))
            seen.append(count(b))
            a.cursor().execute("INSERT INTO t (x) VALUES (%s)", (3,))
            a.close()
            seen.append(count(b))
            b.close()
            out[pkg] = seen
        finally:
            srv.close()
    assert out["port"] == out["jax"] == [0, 0, 1, 1]


ARTICLES = [
    ("https://x/news/a.html", {"title": "A", "author": "Ann", "article": "alpha body",
                               "datetime": "2024-01-02T03:04:05Z", "ticker_symbols": ["AAPL"]}),
    ("https://x/news/b.html", {"title": "B", "author": None, "article": "beta body",
                               "datetime": "not a date", "ticker_symbols": None}),
    ("https://x/news/a.html", {"title": "A2", "author": "Ann", "article": "alpha again",
                               "datetime": "2024-01-02", "ticker_symbols": []}),
]


def store_run(st, srv):
    links = st.LinkStore(DSN, driver=srv)
    arts = st.ArticleStore(DSN, driver=srv)
    got = [links.add_links(["https://x/news/a.html", "https://x/news/b.html", "u3"], now=1000.0),
           links.add_links(["u3", "u4"], now=1001.0)]
    for url, data in ARTICLES:
        arts.store(url, data)
    links.mark_scraped("u4")
    got += [sorted(links.unscraped()), links.counts(), arts.count(), sorted(arts.all_texts())]
    conn = srv.connect(DSN)
    cur = conn.cursor()
    cur.execute("SELECT * FROM articles ORDER BY url")
    got.append(cur.fetchall())
    cur.execute("SELECT url, first_seen_utc, first_seen_unix, is_scraped FROM links ORDER BY url")
    got.append(cur.fetchall())
    conn.close()
    return got


@pytest.mark.parametrize("fake", ["jax", "port"])
def test_port_stores_run_on_each_fake(fake):
    """The port's stores on the Postgres backend over either package's
    fake write what the reference's stores write over the reference's."""
    ref_srv, srv = fake_server("jax"), fake_server(fake)
    try:
        want = store_run(ref_stores, ref_srv)
        assert store_run(stores, srv) == want
    finally:
        ref_srv.close()
        srv.close()
    assert want[4] == 2 and want[3] == (4, 3)


def test_server_close_removes_its_files():
    for pkg in PKGS:
        srv = PKGS[pkg][0].FakePostgresServer()
        path = srv._dir
        assert os.path.isdir(path)
        srv.close()
        assert not os.path.exists(path)
