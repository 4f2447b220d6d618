"""The port's matcher (``pipeline/matcher.py`` and what it stands on)
against the JAX package's: the parsing helpers and the date parser, the
host verify library, the refine race, the screen stage's masks and
prunes, ``match_chunk`` in every mode, and ``run_matcher``'s CSV trees,
byte for byte, on adversarial fields; and the pandas-free CSV layer
against pandas.  Everything runs on the CPU (``device="cpu"``)."""

from __future__ import annotations

import csv
import dataclasses
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
from dateutil import parser as dateparser

from advanced_scrapper_tpu.config import MatchConfig as RefConfig
from advanced_scrapper_tpu.cpu import fuzz as ref_fuzz
from advanced_scrapper_tpu.cpu import native as ref_native
from advanced_scrapper_tpu.pipeline import matcher as ref
from advanced_scrapper_tpu_torch.config import MatchConfig
from advanced_scrapper_tpu_torch.core.dates import parse_date
from advanced_scrapper_tpu_torch.cpu import csvframe, fuzz, native
from advanced_scrapper_tpu_torch.ops import editdist
from advanced_scrapper_tpu_torch.pipeline import matcher
from test_match_dispatch import _chunk, _entities, _norm, _overlong_frame

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def indexes():
    ents = _entities(12)
    return (ref.EntityIndex(ref.process_json_data(ents)),
            matcher.EntityIndex(matcher.process_json_data(ents)))


def same_date(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return a.replace(tzinfo=None) == b.replace(tzinfo=None) and a.utcoffset() == b.utcoffset()


# -- configuration, parsing, dates --------------------------------------------


def test_config_copy_and_unported_fields():
    """The copy's fields and defaults are the reference's; ``packed=False``,
    once unported, now runs (the legacy screen)."""
    want = {f.name: f.default for f in dataclasses.fields(RefConfig)}
    assert {f.name: f.default for f in dataclasses.fields(MatchConfig)} == want
    assert matcher.match_chunk([{"article_text": "x"}], matcher.EntityIndex({}), packed=False,
                               device="cpu") == []


DATES = [
    "2020-06-01T00:00:00Z", "2020-06-01T00:00:00.000Z", "2020-06-01T12:30:00.123456789Z",
    "2020-06-01 12:30:00", "2020-06-01T12:30:00+05:30", "2020-06-01T12:30:00-04:00",
    "2020-06-01", "2011-08-24", " 2020-06-01 ", "2020-06-01T12:30", "2020-06-01T12",
    "2020-06-01T12:30:00+0000", "2020-06-01T12:30:00+00", "2020-06-01T12:30:00 Z",
    "2020-06-01T12:30:00UTC", "2020-06-01t00:00:00z", "2020-6-1", "20200601",
    "2020-06-01T25:00:00Z", "2020-13-01", "2020-02-30", "2011-08-24T12:00:00Z)", "",
]


@pytest.mark.parametrize("raw", DATES)
def test_parse_date_agrees_with_dateutil(raw):
    try:
        want = dateparser.parse(raw)
    except (ValueError, OverflowError):
        want = None
    assert same_date(parse_date(raw), want)


def test_parsing_helpers_equal_reference(tmp_path):
    names = ["Tim Cook (Start: 2011-08-24T00:00:00Z)",
             "Steve Jobs (Start: 1997-09-16T00:00:00Z) (End: 2011-08-24T00:00:00Z)",
             "No Dates Co", "Odd (Start: 2011-08-24T12:00:00Z)", " (Start: 2001-01-01T00:00:00Z)"]
    want, got = ref.extract_time_periods(names), matcher.extract_time_periods(names)
    assert list(got) == list(want)
    for k in want:
        assert all(same_date(g, w) for g, w in zip(got[k], want[k])), k
    assert list(matcher.extract_time_periods("Apple Inc.")) == ["Apple Inc."]
    days = [None, parse_date("2015-01-01T00:00:00Z"), parse_date("2011-08-24"),
            parse_date("2020-01-01T00:00:00+05:00"), parse_date("2012-01-01")]
    for a in days:
        for s in days:
            for e in days:
                assert matcher.is_within_period(a, s, e) == ref.is_within_period(a, s, e)
    us = {"ticker": "AAPL", "country": ["United States"], "aliases": ["AAPL"]}
    de = {"ticker": "SAP", "country": ["Germany"], "aliases": ["SAP"]}
    for data in ([us, de], [de], [us]):
        assert set(matcher.process_json_data(data)) == set(ref.process_json_data(data))
    # utf-8, gbk and latin1 info files, and one that fails all three
    ent = dict(_entities(1)[0], id_label="中文公司")
    (tmp_path / "a_utf8.json").write_text(json.dumps([ent], ensure_ascii=False), "utf-8")
    (tmp_path / "b_gbk.json").write_bytes(
        json.dumps([dict(ent, ticker="GBK1")], ensure_ascii=False).encode("gbk"))
    (tmp_path / "c_latin1.json").write_bytes(
        json.dumps([dict(_entities(1)[0], ticker="LAT1", id_label="ZürichÜ")],
                   ensure_ascii=False).encode("latin1"))
    (tmp_path / "d_bad.json").write_text("not json")
    (tmp_path / "e.txt").write_text("ignored")
    got, want = matcher.read_info_dir(str(tmp_path)), ref.read_info_dir(str(tmp_path))
    assert set(got) == set(want) == {"TK00", "GBK1", "LAT1"}
    assert [(e.ticker, e.attribute, e.name, e.is_exact_upper)
            for e in matcher.EntityIndex(got).entries] == [
        (e.ticker, e.attribute, e.name, e.is_exact_upper) for e in ref.EntityIndex(want).entries]


# -- the host verify library --------------------------------------------------


def test_host_library_builds_in_the_port_and_scores_as_the_reference():
    lib = native.library_path()
    assert lib.parent.name == "host" and lib.parent.parent.name == "build"
    assert native.SOURCE.parent.parent.name == "advanced_scrapper_tpu_torch"
    rng = np.random.RandomState(4)
    alpha = list("abcdefgh ") + ["é", "ü", "中"]
    words = ["".join(rng.choice(alpha, size=rng.randint(0, 14))) for _ in range(60)]
    hays = ["".join(rng.choice(alpha, size=rng.randint(0, 120))) for _ in range(12)]
    for h in hays[:6]:
        for w in words[:20]:
            assert native.partial_ratio(h, w) == ref_native.partial_ratio(h, w)
            assert native.ratio(h, w) == ref_native.ratio(h, w)
            assert fuzz.partial_ratio(h, w) == ref_fuzz.partial_ratio(h, w)
    arena, ref_arena = native.CutoffArena(words), ref_native.CutoffArena(words)
    for h in hays + [h.encode() for h in hays[:3]]:
        for cut in (0.0, 60.0, 95.0):
            rows = rng.randint(0, len(words), size=15)
            assert np.array_equal(arena.scores(h, rows, cut), ref_arena.scores(h, rows, cut))
    pats = [b"AAPL", b"IBM", b"AA", b"APL"]
    mp, ref_mp = native.MultiPattern(pats), ref_native.MultiPattern(pats)
    text = b"AAPL IBM xAAPLx AAAPL IBM,AA"
    for a, b in zip(mp.scan(text), ref_mp.scan(text)):
        assert np.array_equal(a, b)
    assert mp.available


def test_refine_controller_race():
    c = matcher.RefineController()
    assert c.next_mode() is False
    c.record(False, 1.0)
    assert c.next_mode() is True
    c.record(True, 0.99)
    assert c.verdict() is False  # within the 5% band: the simpler mode
    c.record(True, 0.5)
    assert c.verdict() is True
    modes = []
    for _ in range(matcher.RefineController.PROBE_EVERY + 2):
        m = c.next_mode()
        modes.append(m)
        c.record(m, 0.5 if m else 1.0)
    assert False in modes and modes.count(False) <= 2
    c.record(False, 50.0)
    assert c.verdict() is True


# -- the screen stage and match_chunk -----------------------------------------


@pytest.mark.parametrize("use_refine", [False, True])
def test_screen_chunk_equals_reference_tiles(indexes, use_refine):
    """Bit 0 equal to the reference's packed tiles for every row; the
    prunes equal the reference's sets restricted to the survivors."""
    ref_ix, ix = indexes
    df = _chunk(80, seed=5, pad_every=9)
    rows = [(r["article_text"], r["title"], None, r) for r in df.to_dict("records")]
    want_m, want_p = ref._packed_screen(rows, ref_ix, use_refine=use_refine, threshold=95.0,
                                        screen_block=2048, tile_bytes=1 << 21, window=0,
                                        put_workers=1)
    got_m, got_p = matcher.screen_chunk(rows, ix, use_refine=use_refine, threshold=95.0,
                                        screen_block=2048, device=CPU)
    assert [m is None for m in got_m] == [m is None for m in want_m]
    assert any(m is None for m in got_m)  # the padded rows are overlong
    for g, w in zip(got_m, want_m):
        assert g is None or np.array_equal(g, w)
    n_pruned = 0
    for g, w, m in zip(got_p, want_p, want_m):
        survivors = set() if m is None else set(np.flatnonzero(m).tolist())
        assert (g or set()) == (w or set()) & survivors
        n_pruned += len(g or ())
    assert (n_pruned > 0) == use_refine
    assert set(ix.last_screen_clock.seconds) >= {"encode_join", "copy", "screen", "scatter"}


@pytest.mark.parametrize("mode", ["screen_only", "forced_refine", "unscreened", "overlong",
                                  "records"])
def test_match_chunk_equals_reference(indexes, mode):
    ref_ix, ix = indexes
    df, kw = _chunk(64, seed=11, pad_every=13), {}
    if mode == "forced_refine":
        kw = dict(use_refine=True)
    elif mode == "unscreened":
        kw = dict(use_screen=False)
    elif mode == "overlong":
        df, kw = _overlong_frame(), dict(screen_block=4096, use_refine=True)
    want = _norm(ref.match_chunk(df, ref_ix, **kw))
    chunk = df.to_dict("records") if mode == "records" else df
    got = _norm(matcher.match_chunk(chunk, ix, device="cpu", **kw))
    assert got == want and len(want) >= 3


def test_match_chunk_pooled_equals_reference(indexes):
    ref_ix, ix = indexes
    df = _chunk(48, seed=29, pad_every=11)
    pool = matcher.make_verify_pool(ix, workers=3)
    if pool is None:
        pytest.skip("host refuses worker processes")
    try:
        assert len(pool._processes) == 3  # all started up front, none on the first chunk
        got = _norm(matcher.match_chunk(df, ix, pool=pool, use_refine=True, device="cpu"))
    finally:
        pool.shutdown()
    assert got == _norm(ref.match_chunk(df, ref_ix, use_screen=False))


def test_verify_workers_load_no_torch():
    """What a verify worker imports (the matcher module) leaves torch out."""
    code = ("import sys, advanced_scrapper_tpu_torch.pipeline.matcher\n"
            "assert 'torch' not in sys.modules\n")
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parents[1])}
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)


def test_screening_on_a_card_that_is_absent_raises(indexes):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        matcher.match_chunk(_chunk(4), indexes[1])


# -- the legacy screen (packed=False) ------------------------------------------


def same_masks(got, want) -> bool:
    return [g is None for g in got] == [w is None for w in want] and all(
        g is None or np.array_equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("use_refine", [False, True])
def test_legacy_screen_equals_reference(indexes, use_refine):
    """Batches of 32 rows: the screen's masks (None for the rows over a
    2,048-byte ``screen_block``) and the refine's prune sets, exactly."""
    ref_ix, ix = indexes
    df = _chunk(80, seed=5, pad_every=9)
    rows = [(r["article_text"], r["title"], None, r) for r in df.to_dict("records")]
    kw = dict(use_refine=use_refine, threshold=95.0, screen_batch=32, screen_block=2048)
    want_m, want_p = ref._legacy_screen(rows, ref_ix, **kw)
    got_m, got_p = matcher._legacy_screen(rows, ix, device=CPU, **kw)
    assert same_masks(got_m, want_m) and any(m is None for m in got_m)
    assert got_p == want_p
    assert any(got_p) == use_refine


@pytest.mark.parametrize("mode", ["screen_only", "forced_refine", "overlong", "pooled"])
def test_legacy_match_chunk_equals_reference(indexes, mode):
    ref_ix, ix = indexes
    df = _chunk(64, seed=11, pad_every=13)
    kw = dict(packed=False, screen_batch=32, screen_block=2048)
    if mode == "forced_refine":
        kw["use_refine"] = True
    elif mode == "overlong":
        df, kw = _overlong_frame(), dict(kw, screen_block=4096, use_refine=True)
    want = _norm(ref.match_chunk(df, ref_ix, **kw))
    pool = None
    if mode == "pooled":
        pool = matcher.make_verify_pool(ix, workers=2)
        if pool is None:
            pytest.skip("host refuses worker processes")
    try:
        got = _norm(matcher.match_chunk(df, ix, device="cpu", pool=pool,
                                        **dict(kw, use_refine=True) if pool else kw))
    finally:
        if pool is not None:
            pool.shutdown()
    assert got == want and len(want) >= 3


def test_legacy_refine_compares_in_float64():
    """A 10-character name and a text whose best substring is one of its
    characters (d = 9): at threshold 55 the reference's float64 compare
    keeps the pair, where the fused step's float32 compare would prune it;
    the legacy refine follows the reference."""
    ent = {"id_label": "Qwertyuiop", "ticker": "QQ", "country": ["United States"],
           "aliases": ["Qwertyuiop"], "products": [], "subsidiaries": [],
           "owned_entities": [], "ceos": [], "board_members": []}
    ref_ix = ref.EntityIndex(ref.process_json_data([ent]))
    ix = matcher.EntityIndex(matcher.process_json_data([ent]))
    texts = ["#############Q", "zzz Qwert zzz", "abc Qwertyuiop"]
    rows = [(t, "x", None, {"article_text": t}) for t in texts]
    for threshold in (55.0, 95.0):
        kw = dict(use_refine=True, threshold=threshold, screen_batch=32, screen_block=2048)
        want = ref._legacy_screen(rows, ref_ix, **kw)
        got = matcher._legacy_screen(rows, ix, device=CPU, **kw)
        assert same_masks(got[0], want[0]) and got[1] == want[1]
        assert (got[1][0] is None) == (threshold == 55.0)
    d = torch.tensor([[9]], dtype=torch.int32)
    assert bool(editdist.bound_pruned(d, torch.tensor([10], dtype=torch.int32), 55.0))


def test_match_cfg_follows_the_environment(indexes, monkeypatch):
    """``packed=None`` reads ``ASTPU_MATCH_PACKED`` on every call."""
    ref_ix, ix = indexes
    calls = []
    legacy = matcher._legacy_screen
    monkeypatch.setattr(matcher, "_legacy_screen",
                        lambda *a, **k: calls.append(k["screen_batch"]) or legacy(*a, **k))
    df = _chunk(24, seed=3)
    monkeypatch.setenv("ASTPU_MATCH_PACKED", "0")
    assert matcher._match_cfg().packed is False
    got = _norm(matcher.match_chunk(df, ix, device="cpu", screen_batch=8))
    assert calls == [8] and got == _norm(ref.match_chunk(df, ref_ix, screen_batch=8))
    monkeypatch.setenv("ASTPU_MATCH_PACKED", "1")
    matcher.match_chunk(df, ix, device="cpu")
    assert calls == [8]


def test_prewarm_launches_each_kernel_of_the_mode(indexes):
    _ref_ix, ix = indexes
    for packed in (True, False):
        assert matcher.prewarm_screen(ix, packed=packed, device="cpu") == 2
        assert matcher.prewarm_screen(ix, use_refine=True, packed=packed, device="cpu") == 2
        assert matcher.prewarm_screen(ix, use_refine=False, packed=packed, device="cpu") == 1
    assert matcher.prewarm_screen(matcher.EntityIndex({}), device="cpu") == 0
    no_refine = matcher.EntityIndex(matcher.process_json_data(
        [dict(_entities(1)[0], aliases=["TK00"], id_label="TK00", products=[], ceos=[])]))
    assert matcher.prewarm_screen(no_refine, device="cpu") == 1


# -- run_matcher: byte-equal CSV trees -----------------------------------------

TITLES = ["NA", "null", "None", "nan", "", "123", "007", "1.50", "-3", " 7", "True", "false",
          'He said "hi", then', "multi\nline", "Ünïcode tìtle", "TK01 leads", "1e5", "inf"]
DATE_FORMS = ["2020-06-01T00:00:00Z", "2020-06-01T00:00:00Z", "2019-01-01T12:00:00+02:00",
              "2021-03-04", "2020-06-01 10:00:00", "garbage", "", "2010-01-01T00:00:00Z"]


def adversarial_csv(path: str, rng: np.random.RandomState, n: int = 70) -> None:
    """Articles with NA-token, numeric and boolean titles, quotes, commas
    and newlines in the text, non-ASCII names and text, tied and
    unparseable dates; the last rows' titles all numeric (a chunk and a
    ticker file whose title column is numbers, and one with numbers and
    blanks)."""
    rows = []
    for i in range(n):
        e = rng.randint(6)
        body = " ".join(["lorem", f"Company{e}", "Corp.", 'quote " and , comma', "TK%02d" % e,
                         "Ceo", f"Person{e}", "Zürich Bank" if i % 7 == 0 else "plain"])
        if i % 5 == 0:
            body += "\nsecond line, with comma"
        title = TITLES[i % len(TITLES)] if i < 40 else str(5 + i % 5)
        if i >= 60:
            body = body.replace(f"Company{e}", "Company5")
            title = "" if i % 3 == 0 else str(i)
        rows.append([body, title, DATE_FORMS[i % len(DATE_FORMS)], f"https://x/{i}",
                     "src" if i % 3 else "NA", "su" if i % 4 else ""])
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["article_text", "title", "date_time", "url", "source", "source_url"])
        w.writerows(rows)


def tree(path: str) -> dict[str, bytes]:
    return {f: open(os.path.join(path, f), "rb").read() for f in sorted(os.listdir(path))}


@pytest.mark.parametrize("use_refine,prewarm", [(True, 0), ("auto", 1)])
def test_run_matcher_legacy_trees_byte_equal(tmp_path, monkeypatch, use_refine, prewarm):
    """``ASTPU_MATCH_PACKED=0`` (the legacy screen, read through
    ``from_env``) gives the reference's CSV trees, byte for byte; with
    ``prewarm`` too."""
    from advanced_scrapper_tpu.config import from_env as ref_from_env
    from advanced_scrapper_tpu_torch.config import from_env

    info = tmp_path / "info"
    info.mkdir()
    ents = _entities(6)
    ents[0]["aliases"].append("Zürich Bank")
    (info / "a.json").write_text(json.dumps(ents))
    adversarial_csv(str(tmp_path / "articles.csv"), np.random.RandomState(7))
    monkeypatch.setenv("ASTPU_MATCH_PACKED", "0")
    monkeypatch.setenv("ASTPU_MATCH_CHUNK_SIZE", "16")
    monkeypatch.setenv("ASTPU_MATCH_PREWARM", str(prewarm))
    for name, read, mod, kw in (("ref", ref_from_env, ref, {}),
                                ("port", from_env, matcher, {"device": "cpu"})):
        cfg = read(RefConfig if name == "ref" else MatchConfig, "match",
                   source_name=str(tmp_path / name), info_dir=str(info), verify_workers=1)
        assert cfg.packed is False and cfg.chunk_size == 16 and cfg.prewarm == prewarm
        assert mod.run_matcher(cfg, articles_csv=str(tmp_path / "articles.csv"),
                               use_refine=use_refine, **kw) == 0
    want = tree(str(tmp_path / "ref_ticker_matched_articles"))
    got = tree(str(tmp_path / "port_ticker_matched_articles"))
    assert list(got) == list(want) and len(want) == 6
    for f in want:
        assert got[f] == want[f], f


@pytest.mark.parametrize("chunk_size,workers,use_refine", [(5, 1, "auto"), (16, 2, True)])
def test_run_matcher_trees_byte_equal(tmp_path, chunk_size, workers, use_refine):
    info = tmp_path / "info"
    info.mkdir()
    ents = _entities(6)
    ents[0]["aliases"].append("Zürich Bank")
    (info / "a.json").write_text(json.dumps(ents))
    adversarial_csv(str(tmp_path / "articles.csv"), np.random.RandomState(chunk_size))
    for name, cfg_cls, mod, kw in (("ref", RefConfig, ref, {}),
                                   ("port", MatchConfig, matcher, {"device": "cpu"})):
        cfg = cfg_cls(source_name=str(tmp_path / name), info_dir=str(info),
                      chunk_size=chunk_size, verify_workers=workers)
        assert mod.run_matcher(cfg, articles_csv=str(tmp_path / "articles.csv"),
                               use_refine=use_refine, **kw) == 0
    want = tree(str(tmp_path / "ref_ticker_matched_articles"))
    got = tree(str(tmp_path / "port_ticker_matched_articles"))
    assert list(got) == list(want) and len(want) == 6
    for f in want:
        assert got[f] == want[f], f
    assert b"7.0" in want["TK05_match.csv"] or b".0," in b"".join(want.values())


# -- the CSV layer against pandas ---------------------------------------------


def test_na_tokens_are_pandas_defaults():
    from pandas._libs.parsers import STR_NA_VALUES

    assert csvframe.NA_VALUES == frozenset(STR_NA_VALUES)


COLUMN_CASES = [
    ["7", "8"], [" 7", "8 "], ["+7", "-0"], ["007", "1"], ["7", ""], ["1.5", "1.50"],
    [".5", "5."], ["1e5", "1E5"], ["inf", "-inf"], ["Infinity", "INF"], ["1,000", "2"],
    ["0x10", "1"], ["1_000", "2"], ["True", "false"], ["TRUE", ""], ["yes", "no"],
    ["9223372036854775807", "1"], ["9223372036854775808", "1"], ["18446744073709551616", "1"],
    ["-9223372036854775809", "1"], ["1e309", "1"], ["   ", "1"], ["1", "a"], [" 1.5", "2.5 "],
    ["", ""], ["None", "1"], ["nan", "x"], ["True", "1"], ["-1.5", "+2.5"],
    ["0.1", "0.30000000000000004"], ["3.14159265358979323846", "2"], ["1e-5", "1e16"],
    ["-0.0", "1"], ["1e", "2"], ["1e+", "2"], ["12345678901234567890123", "1.5"],
    ["1.7976931348623157e308", "2.2250738585072014e-308"], ["4.9e-324", "1e-400"],
    ["1.5", "12345678901234567890123"], ["9223372036854775808", "1.5"], ["-1", "9223372036854775808"],
    ["-9223372036854775809", "1.5"], ["9223372036854775808", "NA"], ["18446744073709551616", "NA"],
]


def test_column_typing_and_writing_match_pandas(tmp_path):
    """Each column typed as pandas types it (the ``str`` of every value the
    matcher reads), and written back as ``to_csv`` writes it."""
    rng = np.random.RandomState(8)
    cases = COLUMN_CASES + [
        [f"{rng.uniform(-1e6, 1e6):.{rng.randint(0, 19)}f}" for _ in range(3)] for _ in range(30)
    ] + [[f"{rng.uniform(0, 10):.{rng.randint(1, 20)}e}" for _ in range(2)] for _ in range(30)]
    width = max(len(c) for c in cases)
    cols = [c + [""] * (width - len(c)) if len(c) < width else c for c in cases]
    path = tmp_path / "cols.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow([f"c{i}" for i in range(len(cols))])
        w.writerows(zip(*cols))
    want = pd.read_csv(path)
    names, typed = next(csvframe.read_csv_columns(str(path)))
    assert names == list(want.columns)
    recs = want.to_dict("records")
    for j, (name, (_kind, values)) in enumerate(zip(names, typed)):
        for r, v in zip(recs, values):
            w_na, g_na = csvframe.is_na(r[name]) or r[name] is pd.NA, csvframe.is_na(v)
            assert w_na == g_na and (g_na or str(v) == str(r[name])), (cols[j], v, r[name])
    out = io.StringIO()
    want.to_csv(out, index=False)
    csvframe.write_rows(str(tmp_path / "back.csv"),
                        [list(r) for r in zip(*[v for _k, v in typed])], header=names)
    assert (tmp_path / "back.csv").read_text() == out.getvalue()


def test_records_reader_matches_pandas_chunks(tmp_path):
    adversarial_csv(str(tmp_path / "a.csv"), np.random.RandomState(2), n=45)
    want = [c.to_dict("records") for c in pd.read_csv(tmp_path / "a.csv", chunksize=7)]
    got = list(csvframe.read_csv_records(str(tmp_path / "a.csv"), 7))
    assert len(got) == len(want)
    for gc, wc in zip(got, want):
        for g, w in zip(gc, wc):
            assert list(g) == list(w)
            for k in w:
                assert matcher._get_col(g, k) == ref._get_col(w, k), (k, g[k], w[k])
