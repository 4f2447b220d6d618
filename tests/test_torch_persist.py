"""The port's persist-mode slice on the CPU against the JAX package's: the
wide keys' host twin (``ops/rerank.py:band_keys_wide_host``), the stream
backend's persist mode across two sessions (annotations, stats, docmap and
index directories), its crash ordering and legacy npz import, the engine's
``dedup_against_index`` and ``open_stream_index``, the rerank tier's index
re-probe, and cross-source dedup with its stores and append CSV
(``storage/backends.py``, ``stores.py``, ``csvio.py``,
``pipeline/cross_source.py``).  Exact equality throughout; batches of 64
records, cuts of a few hundred postings."""

from __future__ import annotations

import copy
import os
import sqlite3
import time

import numpy as np
import pytest
import torch

from advanced_scrapper_tpu.config import DedupConfig as RefConfig
from advanced_scrapper_tpu.core.hashing import make_params as ref_make_params
from advanced_scrapper_tpu.extractors import tpu_batch as ref_tb
from advanced_scrapper_tpu.index import PersistentIndex as RefIndex
from advanced_scrapper_tpu.ops import rerank as ref_rerank
from advanced_scrapper_tpu.pipeline import cross_source as ref_cs
from advanced_scrapper_tpu.pipeline.dedup import NearDupEngine as RefEngine
from advanced_scrapper_tpu.storage import csvio as ref_csvio
from advanced_scrapper_tpu.storage import pgfake
from advanced_scrapper_tpu.storage import stores as ref_stores
from advanced_scrapper_tpu.storage.fsio import SimulatedCrash
from advanced_scrapper_tpu_torch.config import DedupConfig
from advanced_scrapper_tpu_torch.core.hashing import make_params
from advanced_scrapper_tpu_torch.extractors import tpu_batch
from advanced_scrapper_tpu_torch.index import PersistentIndex
from advanced_scrapper_tpu_torch.ops import lsh, rerank
from advanced_scrapper_tpu_torch.pipeline import cross_source
from advanced_scrapper_tpu_torch.pipeline.dedup import NearDupEngine
from advanced_scrapper_tpu_torch.storage import backends, csvio, stores

BATCH = 64
N_RECORDS = 384  # 6 batches of 64
SPLIT = 3 * BATCH  # session 1 takes three batches
PERSIST = dict(batch_size=BATCH, stream_index="persist", index_cut_postings=300,
               index_compact_segments=3)


def _mutate(rng: np.random.RandomState, text: str, rate: float) -> str:
    chars = list(text)
    for _ in range(max(1, int(len(chars) * rate))):
        chars[rng.randint(len(chars))] = chr(rng.randint(97, 123))
    return "".join(chars)


def _words(rng: np.random.RandomState, lo: int, hi: int) -> str:
    words = rng.randint(97, 123, size=(int(rng.randint(lo, hi)), 6))
    return " ".join("".join(map(chr, w[: rng.randint(2, 7)])) for w in words)


def stream_records(seed: int, n: int = N_RECORDS) -> list[dict]:
    """Records with urls: near-dups of earlier texts (edit rates around
    the 0.7 bar), exact copies, texts shorter than a shingle, empty and
    non-ASCII texts, repeated, missing and empty urls."""
    rng = np.random.RandomState(seed)
    texts: list[str] = []
    recs = []
    for i in range(n):
        u = rng.rand()
        if i > 8 and u < 0.25:
            text = _mutate(rng, texts[rng.randint(i)], rng.uniform(0.005, 0.05))
        elif i > 8 and u < 0.32:
            text = texts[rng.randint(i)]
        elif u < 0.35:
            text = "abc"
        elif u < 0.37:
            text = ""
        elif u < 0.40:
            text = "é€ü" * int(rng.randint(2, 60))
        else:
            text = _words(rng, 15, 120)
        texts.append(text or "x")
        v = rng.rand()
        url = (None if v < 0.03 else "" if v < 0.05
               else f"https://news.example/{rng.randint(i)}.html" if v < 0.13 and i
               else f"https://news.example/{i}.html")
        recs.append({"url": url, "article": text, "i": i})
    return recs


def run_stream(backend, records) -> list[tuple]:
    out = []
    for rec in copy.deepcopy(records):
        out += backend.submit(rec)
    out += backend.flush()
    return [(r["i"], r["dup_of"], r["near_dup_of"]) for r in out]


def _tree(d: str) -> dict[str, bytes]:
    out = {}
    for root, _dirs, files in os.walk(d):
        for f in files:
            p = os.path.join(root, f)
            out[os.path.relpath(p, d)] = open(p, "rb").read()
    return out


def _stats(b) -> tuple:
    s = b.stats
    return (s.submitted, s.batches, s.exact_dups, s.near_dups, s.kept)


@pytest.fixture(scope="module")
def records():
    return stream_records(31)


@pytest.fixture(scope="module")
def ref_engine():
    """One JAX engine for the module's engine-level tests."""
    return RefEngine(RefConfig(rerank=False))


# -- keys ------------------------------------------------------------------------


def test_band_keys_wide_host_equals_reference_and_device(ref_engine, records):
    sigs = ref_engine.signatures([r["article"] for r in records[:150]])
    salt = make_params(128, 16, 5, 1).band_salt
    got = rerank.band_keys_wide_host(sigs, salt)
    want = ref_rerank.band_keys_wide_host(sigs, ref_make_params(128, 16, 5, 1).band_salt)
    dev = lsh.band_keys_wide(torch.from_numpy(sigs.view(np.int32)).view(torch.uint32), salt)
    assert got.dtype == np.uint32 and got.shape == (150, 16, 2)
    assert np.array_equal(got, want) and np.array_equal(got, dev.numpy().astype(np.uint32))


# -- the backend's persist mode ----------------------------------------------------


def _persist_pair(tmp_path, tag: str, **over):
    """A JAX and a port persist backend over their own directories, with
    compaction inline so that both directories are deterministic."""
    out = []
    for name, make, cfg in (("jax", ref_tb.TpuBatchBackend, RefConfig),
                            ("port", tpu_batch.TpuBatchBackend, DedupConfig)):
        kw = {} if name == "jax" else {"device": "cpu"}
        b = make(cfg(**{**PERSIST, **over}), index_dir=str(tmp_path / name / tag), **kw)
        b._pindex.compact_inline = b._pindex_urls.compact_inline = True
        out.append(b)
    return out


def test_persist_backend_equals_reference_across_two_sessions(tmp_path, records):
    """Session 1 takes three batches and is dropped without a close (the
    WAL is all that is durable), session 2 reopens and takes the rest:
    both packages give the annotations, stats, docmaps and directory
    bytes of each other, and of one unbroken session."""
    got = {}
    for session in (0, 1):
        pair = _persist_pair(tmp_path, "two")
        part = records[:SPLIT] if session == 0 else records[SPLIT:]
        for name, b in zip(("jax", "port"), pair):
            got.setdefault(name, []).extend(run_stream(b, part))
            if session:
                got[name + "_stats"] = (_stats(b), b._pindex.stats(), b._pindex_urls.stats())
                compactions = b._pindex.compactions if name == "port" else None
                b.close()
    assert got["port"] == got["jax"] and got["port_stats"] == got["jax_stats"]
    assert compactions and got["port_stats"][1]["segments"] >= 1
    port_tree, jax_tree = _tree(str(tmp_path / "port" / "two")), _tree(str(tmp_path / "jax" / "two"))
    assert port_tree == jax_tree
    assert any(n.endswith(".seg") for n in port_tree) and "bands/docmap.log" in port_tree
    one = _persist_pair(tmp_path, "one")[1]
    assert run_stream(one, records) == got["port"]
    one.close()
    marks = [a for row in got["port"] for a in row[1:] if a]
    assert marks and all(m.startswith("doc:") for m in marks)
    assert any(row[2] for row in got["port"][SPLIT:]), "session 2 must catch near-dups"


def test_persist_marks_resolve_through_the_docmap(tmp_path, records):
    _ref, port = _persist_pair(tmp_path, "names")
    ann = run_stream(port, records)
    ids = {int(m.split(":")[1]) for row in ann for m in row[1:] if m}
    names = port._pindex.lookup_names(ids)
    assert set(names) == ids and all(v.startswith("https://news.example/") for v in names.values())
    clock = port.last_clock.seconds
    assert list(clock) == ["exact_stage", "signatures_and_keys", "persist"]
    port.close()
    _ref.close()


def test_persist_without_exact_stage_and_with_a_sink(tmp_path, records):
    seen = {"jax": [], "port": []}
    outs = []
    for name, make, cfg in (("jax", ref_tb.TpuBatchBackend, RefConfig),
                            ("port", tpu_batch.TpuBatchBackend, DedupConfig)):
        kw = {} if name == "jax" else {"device": "cpu"}
        b = make(cfg(**PERSIST), index_dir=str(tmp_path / name), exact_stage=False,
                 sink=lambda r, _n=name: seen[_n].append(r["i"]), **kw)
        outs.append((run_stream(b, records[:200]), _stats(b)))
        b.close()
    assert outs[0] == outs[1] and seen["jax"] == seen["port"] == list(range(200))
    assert _tree(str(tmp_path / "jax" / "bands")).get("docmap.log") == \
        _tree(str(tmp_path / "port" / "bands")).get("docmap.log")


def test_persist_url_postings_land_after_band_postings(tmp_path, records):
    """A crash on the first write of the urls sub-index's WAL: the band
    postings of the batch are already durable."""
    port = tpu_batch.TpuBatchBackend(DedupConfig(**PERSIST), index_dir=str(tmp_path / "p"),
                                     device="cpu")

    class DeadFh:
        def tell(self):
            return 0

        def write(self, data):
            raise SimulatedCrash("crash inside the urls WAL append")

    port._pindex_urls._wal._fh.close()
    port._pindex_urls._wal._fh = DeadFh()
    with pytest.raises(SimulatedCrash):
        for rec in copy.deepcopy(records[:BATCH]):
            port.submit(rec)
    bands = PersistentIndex(str(tmp_path / "p" / "bands"), read_only=True)
    assert len(bands.dump_postings()[0]) >= 16 * 10
    bands.close()
    urls = PersistentIndex(str(tmp_path / "p" / "urls"), read_only=True)
    assert len(urls.dump_postings()[0]) == 0
    urls.close()


@pytest.fixture(scope="module")
def legacy_npz(tmp_path_factory, records):
    """An exact-mode and a bloom-mode npz of the first three batches,
    written by the JAX backend."""
    d = tmp_path_factory.mktemp("legacy")
    out = {}
    for mode in ("exact", "bloom"):
        b = ref_tb.TpuBatchBackend(RefConfig(batch_size=BATCH, stream_index=mode))
        run_stream(b, records[:SPLIT])
        out[mode] = str(d / f"{mode}.npz")
        b.save_index(out[mode])
    return out


def test_legacy_exact_npz_imports_once_as_the_reference(tmp_path, legacy_npz, records, capsys):
    got = []
    for name, b in zip(("jax", "port"), _persist_pair(tmp_path, "imp")):
        ck = str(tmp_path / f"{name}.npz")
        open(ck, "wb").write(open(legacy_npz["exact"], "rb").read())
        assert b.load_index_if_valid(ck) is True
        assert os.path.exists(ck + ".imported") and not os.path.exists(ck)
        got.append((run_stream(b, records[SPLIT:]), _stats(b)))
        b.close()
    assert got[0] == got[1]
    assert any(row[1] or row[2] for row in got[1][0])
    assert _tree(str(tmp_path / "jax" / "imp")) == _tree(str(tmp_path / "port" / "imp"))
    again = tpu_batch.TpuBatchBackend(DedupConfig(**PERSIST), index_dir=str(tmp_path / "port" / "imp"),
                                      device="cpu")
    open(str(tmp_path / "port.npz"), "wb").write(open(legacy_npz["exact"], "rb").read())
    assert again.load_index_if_valid(str(tmp_path / "port.npz")) is False  # never twice
    again.close()
    assert capsys.readouterr().err.count("imported legacy stream-index checkpoint") == 2


def test_legacy_bloom_npz_and_config_mismatch(tmp_path, legacy_npz, capsys):
    port = tpu_batch.TpuBatchBackend(DedupConfig(**PERSIST), index_dir=str(tmp_path / "a"),
                                     device="cpu")
    assert port.load_index_if_valid(legacy_npz["bloom"]) is False
    assert os.path.exists(legacy_npz["bloom"])
    assert "bloom stream index" in capsys.readouterr().err
    with pytest.raises(ValueError, match="no npz checkpoint"):
        port.load_index(legacy_npz["exact"])
    port.close()
    wrong = tpu_batch.TpuBatchBackend(DedupConfig(**{**PERSIST, "seed": 99}),
                                      index_dir=str(tmp_path / "b"), device="cpu")
    with pytest.raises(tpu_batch.IndexFingerprintError):
        wrong.load_index_if_valid(legacy_npz["exact"])
    assert os.path.exists(legacy_npz["exact"])
    assert wrong.load_index_if_valid(str(tmp_path / "missing.npz")) is False
    wrong.close()


def test_persist_checkpoint_and_save_index(tmp_path, records):
    """``checkpoint`` and ``save_index`` in persist mode fsync and cut a
    due segment, as the reference's do; buffered records refuse a save."""
    pair = _persist_pair(tmp_path, "ck", index_cut_postings=100)
    for b in pair:
        for rec in copy.deepcopy(records[:BATCH + 5]):
            b.submit(rec)
        with pytest.raises(ValueError, match="flush"):
            b.save_index("unused")
        b.flush()
        b.checkpoint("unused")
        b.save_index("unused")
        b.close()
    assert _tree(str(tmp_path / "jax" / "ck")) == _tree(str(tmp_path / "port" / "ck"))


# -- the engine ------------------------------------------------------------------


def test_dedup_against_index_equals_reference(tmp_path, ref_engine, records):
    """Corpus 2 dedups against everything corpus 1 posted, across a
    reopen; sub-shingle rows never probe; given doc ids are used."""
    eng = NearDupEngine(DedupConfig(rerank=False), device="cpu")
    texts = [r["article"] for r in records]
    outs = []
    for name, e, make in (("jax", ref_engine, None), ("port", eng, None)):
        d = str(tmp_path / name)
        idx = (RefEngine.open_stream_index(ref_engine, d) if name == "jax"
               else eng.open_stream_index(d))
        first = e.dedup_against_index(texts[:200] + ["ab"], idx)
        idx.close()
        idx = RefIndex(d) if name == "jax" else PersistentIndex(d)
        second = e.dedup_against_index(texts[200:] + [texts[3]], idx,
                                       doc_ids=np.arange(500, 500 + len(texts) - 199))
        outs.append((first.tolist(), second.tolist(), idx.stats()))
        idx.close()
    assert outs[0] == outs[1]
    first, second, _ = outs[1]
    assert first[-1] == -1 and any(a >= 0 for a in first) and any(a >= 0 for a in second)
    assert _tree(str(tmp_path / "jax")) == _tree(str(tmp_path / "port"))
    assert eng.dedup_against_index([], None).shape == (0,)


# -- the rerank tier's re-probe ----------------------------------------------------


class _Recorder:
    """Wraps a tier: records the matrix it returns."""

    authoritative = True

    def __init__(self, tier):
        self.tier = tier
        self.out = None

    def __call__(self, *args):
        self.out = np.asarray(self.tier(*args)).copy()
        return self.out


def test_tier_reprobe_equals_reference(tmp_path):
    """Borderline pairs past a small exact cap are re-probed over the
    persistent index: equal ``reprobes``, provenance, rewritten matrix
    and representatives."""
    rng = np.random.RandomState(5)
    base = [_words(rng, 60, 120) for _ in range(60)]
    texts = base + [_mutate(rng, base[rng.randint(60)], rng.uniform(0.02, 0.05))
                    for _ in range(140)]
    cfg = dict(rerank_exact_cap=2, rerank_sketch=128)
    got = []
    for name in ("jax", "port"):
        eng = (RefEngine(RefConfig(**cfg)) if name == "jax"
               else NearDupEngine(DedupConfig(**cfg), device="cpu"))
        idx = (RefIndex if name == "jax" else PersistentIndex)(str(tmp_path / name))
        eng.dedup_against_index(texts[:120], idx)
        eng.rerank_tier.index = idx
        rec = _Recorder(eng.rerank_tier)
        eng.rerank_hook = rec
        reps = np.asarray(eng.dedup_reps(texts))
        tier = eng.rerank_tier
        got.append((reps.tolist(), rec.out.tolist(),
                    {k: v for k, v in tier.stats.items() if k not in ("tiles", "launches",
                                                                        "h2d_bytes")},
                    sorted(tier.last_provenance.items())))
        idx.close()
    assert got[0] == got[1]
    assert got[1][2]["reprobes"] > 0
    assert "reprobe" in {v for _k, v in got[1][3]}


# -- storage and cross-source dedup -------------------------------------------------

DATES = ["June 1, 2020", "2020-06-01 3:45 PM", "Mon, 01 Jun 2020 12:00:00 GMT+2", "not a date",
         "Mon, 01 Jun 2020 12:00:00 +2400", "June 2020 03", "1/6 0330", "", None, "06/01/2020"]


@pytest.fixture
def utc(monkeypatch):
    monkeypatch.setenv("TZ", "UTC")
    time.tzset()
    yield
    monkeypatch.undo()
    time.tzset()


def _rows(db: str, table: str) -> list:
    con = sqlite3.connect(db)
    try:
        return con.execute(f"SELECT * FROM {table} ORDER BY url").fetchall()
    finally:
        con.close()


def test_article_and_link_stores_write_the_reference_rows(tmp_path, utc):
    for name, mod in (("jax", ref_stores), ("port", stores)):
        db = str(tmp_path / f"{name}.db")
        links = mod.LinkStore(db)
        assert links.add_links(["u0", "u1", "u0", "u2"], now=1_600_000_000) == ["u0", "u1", "u2"]
        arts = mod.ArticleStore(db)
        for i, raw in enumerate(DATES):
            arts.store(f"u{i}", {"title": f"t{i}", "author": None, "article": f"body {i}",
                                 "datetime": raw, "ticker_symbols": ["X"] if i % 2 else None})
        links.mark_scraped("u9")
        assert arts.count() == len(DATES)
        assert links.counts() == (3, 3) and links.unscraped() == []
        assert list(arts.all_texts())[:2] == [("u0", "body 0"), ("u1", "body 1")]
    assert _rows(str(tmp_path / "port.db"), "articles") == _rows(str(tmp_path / "jax.db"), "articles")
    assert _rows(str(tmp_path / "port.db"), "links") == _rows(str(tmp_path / "jax.db"), "links")
    rows = {r[0]: r for r in _rows(str(tmp_path / "port.db"), "articles")}
    assert rows["u3"][3] is None and rows["u4"][3] is not None and rows["u4"][4] is None


#: free-text dates the port's parser once left unread (NULL in the store)
FREE_TEXT_DATES = ["June 1 03 -04:30", "Jun 1, 2020, 3:04 PM", "June 1, 2020 at 3:04 PM",
                   "on June 1 2020", "1st of June 2020", "June 1 2020 and 3pm",
                   "3:04 PM June 1 2020"]


def test_article_store_keeps_free_text_dates(tmp_path, utc):
    """``ArticleStore.store`` writes the datetime the reference's
    ``dateparser.parse`` reads from jump words, a comma after the year and
    a time before the date, never NULL."""
    for name, mod in (("jax", ref_stores), ("port", stores)):
        arts = mod.ArticleStore(str(tmp_path / f"{name}.db"))
        for i, raw in enumerate(FREE_TEXT_DATES):
            arts.store(f"u{i}", {"title": "t", "article": f"b{i}", "datetime": raw})
    got = _rows(str(tmp_path / "port.db"), "articles")
    assert got == _rows(str(tmp_path / "jax.db"), "articles")
    assert len(got) == len(FREE_TEXT_DATES)
    assert all(r[3] is not None and r[4] is not None for r in got)  # datetime_utc, _unix


def test_postgres_backend_through_an_injected_driver(utc):
    """The stores over ``PostgresBackend`` with the JAX package's
    psycopg2-compatible fake server as the driver: the reference's
    database bootstrap and rows."""
    from advanced_scrapper_tpu.storage import backends as ref_backends

    out = []
    for mod, bk in ((ref_stores, ref_backends), (stores, backends)):
        srv = pgfake.FakePostgresServer()
        try:
            backend = bk.PostgresBackend("postgresql://localhost/news", driver=srv)
            backend.ensure_database("news", "postgresql://localhost/postgres")
            arts = mod.ArticleStore(backend)
            links = mod.LinkStore(backend)
            links.add_links(["u0", "u1"], now=1_600_000_000)
            for i, raw in enumerate(DATES[:4]):
                arts.store(f"u{i}", {"title": "t", "article": f"b{i}", "datetime": raw})
            out.append((sorted(arts.all_texts()), links.counts(), arts.count()))
        finally:
            srv.close()
    assert out[0] == out[1] and out[1][1] == (2, 2)
    assert isinstance(backends.make_backend("x.db"), backends.SqliteBackend)
    assert isinstance(backends.make_backend("postgres://h/db", driver=pgfake),
                      backends.PostgresBackend)
    try:
        import psycopg2  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="psycopg2"):
            backends.PostgresBackend("postgres://h/db")


def test_append_csv_repairs_a_torn_tail_as_the_reference(tmp_path):
    torn = b'url,status\r\nhttps://a,keep\r\n"https://b\nwith newline",near\r\nhttps://c,ke'
    for name, mod in (("jax", ref_csvio), ("port", csvio)):
        path = str(tmp_path / f"{name}.csv")
        open(path, "wb").write(torn)
        assert mod.repair_torn_tail(path) == len(b"https://c,ke")
        assert mod.repair_torn_tail(path) == 0
        with mod.AppendCsv(path, ["url", "status"]) as out:
            out.write_row({"url": "https://d", "status": "keep"})
            out.write_row({"url": 'q"uote'})
        fresh = str(tmp_path / f"{name}-fresh.csv")
        with mod.AppendCsv(fresh, ["url", "status"]) as out:
            out.write_row({"url": "https://e", "status": "keep"})
    for suffix in (".csv", ".csv.quarantine", "-fresh.csv"):
        assert open(str(tmp_path / f"port{suffix}"), "rb").read() == \
            open(str(tmp_path / f"jax{suffix}"), "rb").read(), suffix
    assert csvio.repair_torn_tail(str(tmp_path / "missing.csv")) == 0


def _sources(root, rng: np.random.RandomState) -> list[str]:
    """Two success CSVs and a sqlite store (written by the port's
    ``ArticleStore``); the second CSV and the store hold verbatim and
    mutated copies of the first CSV's articles under other urls."""
    import csv

    first = [(f"https://a.example/{i}", _words(rng, 20, 90)) for i in range(150)]
    second = []
    for i in range(90):
        j = rng.randint(len(first))
        text = (first[j][1] if i % 3 == 0 else _mutate(rng, first[j][1], 0.01) if i % 3 == 1
                else _words(rng, 20, 90))
        second.append((f"https://b.example/{i}", text))
    second.append(("https://a.example/3", first[3][1]))  # an url seen before
    paths = []
    for name, rows in (("success_a.csv", first), ("success_b.csv", second)):
        p = os.path.join(root, name)
        with open(p, "w", newline="", encoding="utf-8") as f:
            w = csv.writer(f)
            w.writerow(["url", "title", "article"])
            for url, text in rows:
                w.writerow([url, "t", text])
        paths.append(p)
    db = os.path.join(root, "store.db")
    arts = stores.ArticleStore(db)
    for i in range(80):
        j = rng.randint(len(first))
        text = first[j][1] if i % 4 == 0 else _words(rng, 20, 90)
        arts.store(f"https://c.example/{i}", {"article": text, "datetime": "2020-06-01"})
    arts.store("https://c.example/none", {"article": None})
    return paths + [db]


def test_cross_source_manifest_equals_reference(tmp_path):
    sources = _sources(str(tmp_path), np.random.RandomState(3))
    cfg = dict(batch_size=BATCH)
    for name in ("jax", "port"):
        out = str(tmp_path / f"{name}_manifest.csv")
        open(out, "w").write("stale\n")
        if name == "jax":
            stats = ref_cs.cross_source_dedup(sources, out, cfg=RefConfig(**cfg))
        else:
            stats_p = cross_source.cross_source_dedup(sources, out, cfg=DedupConfig(**cfg),
                                                      device="cpu")
    assert stats_p == stats
    port = open(str(tmp_path / "port_manifest.csv"), "rb").read()
    assert port == open(str(tmp_path / "jax_manifest.csv"), "rb").read()
    assert stats["total"] == 150 + 91 + 81 and stats["near_dups"] and stats["exact_dups"]
    assert set(stats["by_source"]) == {"success_a.csv", "success_b.csv", "store.db"}
    docs = list(cross_source.load_source(sources[2]))
    assert docs[0] == cross_source.SourceDoc("store.db", "https://c.example/0",
                                             next(ref_cs.load_source(sources[2])).text)


def test_cross_source_persist_mode_equals_reference(tmp_path):
    """The same sources through the persist mode: equal manifests."""
    sources = _sources(str(tmp_path), np.random.RandomState(4))
    outs = []
    for name in ("jax", "port"):
        cfg = dict(batch_size=BATCH, stream_index="persist", index_dir=str(tmp_path / f"ix-{name}"))
        out = str(tmp_path / f"{name}.csv")
        if name == "jax":
            outs.append(ref_cs.cross_source_dedup(sources, out, cfg=RefConfig(**cfg)))
        else:
            outs.append(cross_source.cross_source_dedup(sources, out, cfg=DedupConfig(**cfg),
                                                        device="cpu"))
    assert outs[0] == outs[1]
    assert open(str(tmp_path / "port.csv"), "rb").read() == open(str(tmp_path / "jax.csv"), "rb").read()


# -- still raising -----------------------------------------------------------------


def test_fleet_and_mesh_still_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="9c"):
        tpu_batch.TpuBatchBackend(DedupConfig(**PERSIST, index_fleet="h:1|h:2"),
                                  index_dir=str(tmp_path), device="cpu")
    eng = NearDupEngine(DedupConfig(rerank=False), device="cpu")
    with pytest.raises(NotImplementedError, match="item 15"):
        eng.dedup_against_index(["abcdefgh"], None, mesh=object())
    with pytest.raises(NotImplementedError, match="9c"):
        NearDupEngine(DedupConfig(rerank=False, index_fleet="h:1"),
                      device="cpu").open_stream_index(str(tmp_path))
