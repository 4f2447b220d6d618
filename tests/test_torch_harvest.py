"""The port's CDX harvest (``pipeline/harvest.py``, ``harvest_async.py``)
against the JAX package's.

The same numpy-seeded CDX pages go through both packages' ``persist_shard``
and ``merge_shards``: the shard ``.txt`` and ``.csv`` bytes and the merged
CSV must be equal, including pandas' traps — the regex split and match of
``.html``, a double-space row that shifts its fields and turns the shard's
``date_time`` float64, a short row (NA url, dropped), extra fields, a
non-numeric timestamp, a ``"`` inside a field, a short first row, and the
merge's dtype promotion across shards (a float shard makes every merged
``date_time`` float; a header-only shard makes it ``object``).  The
end-to-end runs (threaded and async engines, resume, transport ownership)
hold both packages' shard directories and outputs equal byte for byte."""

from __future__ import annotations

import asyncio
import contextlib
import io
import os
import sys
import threading

import numpy as np
import pytest

from advanced_scrapper_tpu.config import HarvestConfig as RefHarvestConfig
from advanced_scrapper_tpu.net.transport import MockTransport as RefMockTransport
from advanced_scrapper_tpu.pipeline import harvest as ref
from advanced_scrapper_tpu.pipeline import harvest_async as ref_async
from advanced_scrapper_tpu_torch.config import HarvestConfig
from advanced_scrapper_tpu_torch.cpu import csvframe
from advanced_scrapper_tpu_torch.net.transport import MockTransport
from advanced_scrapper_tpu_torch.pipeline import harvest
from advanced_scrapper_tpu_torch.pipeline import harvest_async

#: (harvest module, async module, HarvestConfig, MockTransport, merge kwargs)
PKGS = {
    "jax": (ref, ref_async, RefHarvestConfig, RefMockTransport, {}),
    "port": (harvest, harvest_async, HarvestConfig, MockTransport, {"device": "cpu"}),
}

#: what each dump of the sweep plants, besides the ordinary rows
TRAPS = ("double_space", "short_row", "extra_fields", "non_numeric", "quote",
         "short_first", "no_html", "plain")


def cdx_row(rng, pool: list[str], trap: str | None = None) -> str:
    if pool and rng.random() < 0.2:  # a repeat, under another scheme or port
        u = pool[int(rng.integers(len(pool)))]
        u = u.replace("https:", "http:") if rng.random() < 0.5 else u.replace(".com/", ".com:80/")
    else:
        slug = "".join(rng.choice(list("abcdefghij-_0123456789"), int(rng.integers(2, 10))))
        host = rng.choice(["finance.yahoo.com", "finance.yahoo.com:80", "www.finance.yahoo.com"])
        mid = rng.choice(["news/", "news/", "news/", "news/%20", "news/'", "video/"])
        tail = rng.choice([".html", ".html", ".html?src=rss", "html_a.html", "xhtml", ".png", ""])
        u = f"{rng.choice(['http', 'https'])}://{host}/{mid}{slug}{tail}"
        pool.append(u)
    ts = str(20200101000000 + int(rng.integers(0, 10**9)))
    if trap == "non_numeric":
        ts += "x"
    if trap == "quote":
        u = u.replace("news/", 'news/a"b', 1)
    fields = [f"com,yahoo,finance)/{u[-6:]}", ts, u, "text/html", "200", "DIGEST", "123"]
    if trap == "double_space":
        return fields[0] + "  " + " ".join(fields[1:])
    if trap in ("short_row", "short_first"):
        return " ".join(fields[:2])
    if trap == "extra_fields":
        fields += ["extra", "fields"]
    return " ".join(fields)


def cdx_page(rng, n: int, trap: str) -> str:
    pool: list[str] = []
    rows = [cdx_row(rng, pool) for _ in range(n)]
    if trap == "no_html":
        rows = [r.replace("html", "png") for r in rows]
    elif trap == "short_first":
        rows[0] = cdx_row(rng, pool, trap)
    elif trap != "plain":
        rows[int(rng.integers(n))] = cdx_row(rng, pool, trap)
    return "<html><body><pre>" + "\n".join(rows) + "\n</pre></body></html>"


def shard_files(d: str) -> dict[str, bytes]:
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


def persist_and_merge(pkg: str, pages: list[str], root: str, use_tpu: bool = True):
    mod, _a, cfg_cls, _t, kw = PKGS[pkg]
    cfg = cfg_cls(shard_dir=os.path.join(root, "shards"), output_csv=os.path.join(root, "urls.csv"))
    os.makedirs(cfg.shard_dir)
    raised = []
    with contextlib.redirect_stdout(io.StringIO()):
        for i, page in enumerate(pages):
            try:
                mod.persist_shard(f"{i:03d}", page, cfg)
                raised.append(None)
            except Exception:
                raised.append(i)  # the shard fails and leaves no checkpoint
        n = mod.merge_shards(cfg, use_tpu=use_tpu, **kw)
    out = open(cfg.output_csv, "rb").read() if os.path.exists(cfg.output_csv) else None
    return raised, shard_files(cfg.shard_dir), n, out


@pytest.mark.parametrize("block", range(3))
def test_cdx_sweep_equals_pandas(block, tmp_path):
    """20 seeded shard directories a block of 2-8 dumps each, about 300
    dumps in all (empty pages and header-only shards among them): every
    trap of the list above, each in many shard directories."""
    seen = set()
    for seed in range(block * 20, block * 20 + 20):
        rng = np.random.default_rng(seed)
        pages = []
        for j in range(int(rng.integers(2, 9))):
            trap = TRAPS[(seed + j) % len(TRAPS)]
            seen.add(trap)
            pages.append("" if rng.random() < 0.05 else cdx_page(rng, int(rng.integers(1, 24)), trap))
        got = persist_and_merge("port", pages, str(tmp_path / f"p{seed}"))
        want = persist_and_merge("jax", pages, str(tmp_path / f"j{seed}"))
        assert got == want, seed
    assert seen == set(TRAPS)


def test_the_named_traps(tmp_path):
    """The traps one by one, with what pandas makes of each."""
    head = "k 20230101000000 "
    pages = {
        "regex": head + "https://x/foohtml_a.html\n" + head + "https://x/ahtml t",
        "float": head + "https://x/a.html\nk  20230101000001 https://x/b.html",
        "int": head + "https://x/a.html\n" + head + "https://x/c.html",
        "text": "k 2023x https://x/d.html\n" + head + "https://x/e.html",
        "empty": head + "https://x/a.png",
    }
    got = persist_and_merge("port", list(pages.values()), str(tmp_path / "p"))
    assert got == persist_and_merge("jax", list(pages.values()), str(tmp_path / "j"))
    raised, files, n, out = got
    assert files["yahoo_000.csv"] == (b"date_time,url\n20230101000000,https://x/fo.html\n"
                                      b"20230101000000,https://x/.html\n")
    assert files["yahoo_001.csv"] == b"date_time,url\n20230101000000.0,https://x/a.html\n"
    assert files["yahoo_004.csv"] == b"date_time,url\n"
    # the header-only shard makes the merged column object: each value as
    # its shard had it, so the float shard's row keeps its .0 alone
    assert b"20230101000000.0,https://x/a.html\n20230101000000,https://x/c.html\n" in out
    assert raised == [None] * 5 and n == 6
    # without the header-only and the text shards, the float shard
    # promotes every row
    for d in ("p", "j"):
        os.remove(tmp_path / d / "shards" / "yahoo_003.csv")
        os.remove(tmp_path / d / "shards" / "yahoo_004.csv")
    for pkg in ("port", "jax"):
        mod, _a, cfg_cls, _t, kw = PKGS[pkg]
        root = tmp_path / ("p" if pkg == "port" else "j")
        with contextlib.redirect_stdout(io.StringIO()):
            mod.merge_shards(cfg_cls(shard_dir=str(root / "shards"),
                                     output_csv=str(root / "urls.csv")), **kw)
    out = open(tmp_path / "p" / "urls.csv", "rb").read()
    assert out == open(tmp_path / "j" / "urls.csv", "rb").read()
    assert out == (b"date_time,url\n20230101000000.0,https://x/fo.html\n"
                   b"20230101000000.0,https://x/.html\n20230101000000.0,https://x/a.html\n"
                   b"20230101000000.0,https://x/c.html\n")


def test_frame_kinds_under_concat():
    f = csvframe.Frame(["a"], [("int", [1])])
    assert csvframe.concat([f, csvframe.Frame(["a"], [("float", [2.5])])]).columns == [
        ("float", [1.0, 2.5])]
    assert csvframe.concat([f, csvframe.Frame(["a"], [("object", [])])]).columns == [
        ("object", [1])]
    with pytest.raises(ValueError):
        csvframe.concat([f, csvframe.Frame(["b"], [("int", [1])])])


def test_char_list_prefixes_and_query_url(tmp_path):
    assert harvest.CHAR_LIST == ref.CHAR_LIST and len(harvest.CHAR_LIST) == 39
    d = str(tmp_path)
    assert harvest.shard_prefixes(d) == ref.shard_prefixes(d) and len(harvest.shard_prefixes(d)) == 1521
    open(os.path.join(d, "yahoo_ab.txt"), "w").close()
    assert harvest.shard_prefixes(d) == ref.shard_prefixes(d) and "ab" not in harvest.shard_prefixes(d)
    for cfg in ({}, {"cdx_base": "http://127.0.0.1/cdx", "target_pattern": "x/{prefix}/y"}):
        assert harvest.cdx_query_url("$-", HarvestConfig(**cfg)) == \
            ref.cdx_query_url("$-", RefHarvestConfig(**cfg))


def sample_pages(seed: int):
    """A page for a few prefixes, empty text for the rest, one failing."""
    rng = np.random.default_rng(seed)
    pages = {p: cdx_page(rng, 12, TRAPS[i % len(TRAPS)])
             for i, p in enumerate(("aa", "ms", "q1", "$$", "-_", "z9"))}

    def page(url):
        prefix = url.split("news/")[-1].rstrip("*")
        if prefix == "zz":
            raise RuntimeError("simulated shard failure")
        return pages.get(prefix, "")

    return page


def run_engine(pkg: str, engine: str, root: str, page, **kw):
    mod, amod, cfg_cls, mock, mkw = PKGS[pkg]
    cfg = cfg_cls(shard_dir=os.path.join(root, "shards"), output_csv=os.path.join(root, "urls.csv"),
                  num_workers=kw.pop("workers", 3))
    fetched = []
    with contextlib.redirect_stdout(io.StringIO()):
        if engine == "threads":
            t = mock(page)
            mod.run_harvest(cfg, transport=t, **mkw, **kw)
            fetched = t.fetched
        else:
            async def fetch(url):
                fetched.append(url)
                return page(url)

            amod.run_harvest_async(cfg, fetch=fetch, **mkw, **kw)
    return shard_files(cfg.shard_dir), open(cfg.output_csv, "rb").read(), sorted(fetched)


@pytest.mark.parametrize("engine", ["threads", "async"])
def test_run_harvest_end_to_end_equals_reference(engine, tmp_path):
    page = sample_pages(5)
    got = run_engine("port", engine, str(tmp_path / "p"), page)
    want = run_engine("jax", engine, str(tmp_path / "j"), page)
    assert got == want
    files, out, fetched = got
    assert len(fetched) == 1521 and "yahoo_zz.txt" not in files
    # "z9" plants a short first row: pandas reads every url NA, the shard fails
    assert "yahoo_z9.txt" not in files and "yahoo_ms.csv" in files
    # the resume fetches only the failed shards, and the output stays
    again = run_engine("port", engine, str(tmp_path / "p"), page, use_tpu=False)
    assert again[2] == sorted(harvest.cdx_query_url(p, HarvestConfig()) for p in ("z9", "zz"))
    assert again[1] == out
    assert again[:2] == run_engine("jax", engine, str(tmp_path / "j"), page, use_tpu=False)[:2]


def test_engines_write_the_same_shards(tmp_path):
    page = sample_pages(6)
    threads = run_engine("port", "threads", str(tmp_path / "t"), page, workers=2)
    asynced = run_engine("port", "async", str(tmp_path / "a"), page, workers=8)
    assert threads == asynced


def test_failed_shard_leaves_no_checkpoint(tmp_path):
    class Boom:
        def fetch(self, url):
            raise RuntimeError("boom")

    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert harvest.process_shard("aa", Boom(), HarvestConfig(shard_dir=str(tmp_path))) is None
    assert os.listdir(tmp_path) == [] and "Error scraping" in out.getvalue()


def test_checkpoint_is_written_after_the_csv(tmp_path):
    order = []

    class Recording:
        def __init__(self):
            from advanced_scrapper_tpu_torch.storage.fsio import OsFs

            self.inner = OsFs()

        def __getattr__(self, name):
            return getattr(self.inner, name)

        def replace(self, src, dst):
            order.append(os.path.basename(dst))
            self.inner.replace(src, dst)

    cfg = HarvestConfig(shard_dir=str(tmp_path))
    harvest.persist_shard("aa", "k 2023 https://x/a.html", cfg, fs=Recording())
    assert order == ["yahoo_aa.csv", "yahoo_aa.txt"]


def test_shared_transport_not_closed_by_workers(tmp_path):
    made = []

    class Closable(MockTransport):
        def __init__(self):
            super().__init__(lambda u: "")
            self.closed = 0
            made.append(self)

        def close(self):
            self.closed += 1

    shared = Closable()
    cfg = HarvestConfig(shard_dir=str(tmp_path / "s"), output_csv=str(tmp_path / "o.csv"),
                        num_workers=4)
    with contextlib.redirect_stdout(io.StringIO()):
        harvest.run_harvest(cfg, transport=shared, device="cpu")
        assert shared.closed == 0  # caller-owned
        os.remove(tmp_path / "s" / "yahoo_aa.txt")
        os.remove(tmp_path / "s" / "yahoo_ab.txt")
        harvest.run_harvest(cfg, transport_factory=Closable, device="cpu")
    assert [t.closed for t in made[1:]] == [1, 1]  # each worker closes the one it made


def test_async_engine_bounds_concurrency(tmp_path):
    state = {"now": 0, "peak": 0}

    async def fetch(url):
        state["now"] += 1
        state["peak"] = max(state["peak"], state["now"])
        await asyncio.sleep(0)
        state["now"] -= 1
        return ""

    cfg = HarvestConfig(shard_dir=str(tmp_path / "s"), num_workers=4)
    assert asyncio.run(harvest_async.harvest_shards_async(cfg, fetch=fetch, concurrency=4)) == 1521
    assert 1 <= state["peak"] <= 4


def test_async_fetch_without_aiohttp_is_a_transport_per_thread(monkeypatch):
    from advanced_scrapper_tpu_torch.net import transport

    made = []

    class Fake:
        def __init__(self, timeout):
            self.thread = threading.get_ident()
            self.closed = False
            made.append(self)

        def fetch(self, url):
            assert threading.get_ident() == self.thread
            return url.upper()

        def close(self):
            self.closed = True

    monkeypatch.setitem(sys.modules, "aiohttp", None)  # import fails
    monkeypatch.setattr(transport, "RequestsTransport", Fake)
    fetch = harvest_async._default_fetch()

    async def many():
        return await asyncio.gather(*(fetch(f"u{i}") for i in range(40)))

    assert asyncio.run(many()) == [f"U{i}" for i in range(40)]
    assert len({t.thread for t in made}) == len(made) >= 1
    fetch.close()
    assert all(t.closed for t in made)


def test_lazy_imports_and_the_card_by_default(tmp_path):
    import subprocess

    code = ("import sys, advanced_scrapper_tpu_torch.pipeline.harvest_async, "
            "advanced_scrapper_tpu_torch.utils.setops; "
            "print(sorted(m for m in ('aiohttp', 'requests', 'torch', 'pandas', 'bs4') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         timeout=60)
    assert out.stdout.strip() == "[]", out.stderr
    shards = tmp_path / "s"
    shards.mkdir()
    (shards / "yahoo_aa.csv").write_text("date_time,url\n1,https://x/a.html\n")
    cfg = HarvestConfig(shard_dir=str(shards), output_csv=str(tmp_path / "o.csv"))
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            harvest.merge_shards(cfg)
    with contextlib.redirect_stdout(io.StringIO()):
        assert harvest.merge_shards(cfg, use_tpu=False) == 1
