"""The port's Wikidata enrichment (``pipeline/enrich.py``) and progress
ledger (``storage/progress.py``) against the JAX package's.

Both packages get the same fake SPARQL endpoint (``chip_smoke.SparqlFake``:
companies from ``sp500_entities``, seeded 429s, 503s and raised
exceptions on the first call of a (symbol, query)), the same
``random.Random(seed)`` and a sleep recorder, so nothing waits.  The info
JSON bytes, the ledger bytes and the sleep lists must be equal, for the
hardened and the simple pass, the crypto flow, a run cut mid-list and
resumed, and the artifact repair; the sleeps must also be the ladder's
(``chip_smoke.enrich_ladder``)."""

from __future__ import annotations

import csv
import os
import random

import numpy as np
import pytest

import chip_smoke
from advanced_scrapper_tpu.config import EnrichConfig as RefEnrichConfig
from advanced_scrapper_tpu.pipeline import enrich as ref_enrich
from advanced_scrapper_tpu.storage import progress as ref_progress
from advanced_scrapper_tpu_torch.config import EnrichConfig
from advanced_scrapper_tpu_torch.pipeline import enrich
from advanced_scrapper_tpu_torch.storage import progress

#: package → (enrich, progress, EnrichConfig)
PKGS = {"jax": (ref_enrich, ref_progress, RefEnrichConfig),
        "port": (enrich, progress, EnrichConfig)}
SYMBOLS = 24
FAULTS = 0.25  # enough injected failures that every kind shows in 24 symbols


@pytest.fixture(scope="module")
def entities() -> list[dict]:
    return chip_smoke.sp500_entities(np.random.RandomState(17))[:SYMBOLS]


def tree(path: str) -> dict[str, bytes]:
    out = {}
    for root, _dirs, files in os.walk(path):
        for name in files:
            full = os.path.join(root, name)
            with open(full, "rb") as f:
                out[os.path.relpath(full, path)] = f.read()
    return out


def cfg_of(pkg: str, root, **kw):
    base = dict(out_dir=str(root / "info" / "ticker"), progress_file=str(root / "progress.json"),
                crypto_out_dir=str(root / "info" / "crypto"),
                crypto_progress_file=str(root / "progress_crypto.json"),
                crypto_symbols_csv=str(root / "crypto_list.csv"),
                symbols_csv=str(root / "sp500list.csv"))
    base.update(kw)
    return PKGS[pkg][2](**base)


def run_pkg(pkg: str, root, entities, *, seed=5, fake_seed=9, cut=None, symbols=None,
            crypto=False, **cfg_kw):
    """One ``run_enrich`` (or ``run_crypto_enrich``) of ``pkg`` under
    ``root``; returns ``(rc, sleeps, fake)``, ``rc`` None when the fake cut
    the run."""
    os.makedirs(root, exist_ok=True)
    fake = chip_smoke.SparqlFake(entities, fake_seed, faults=FAULTS, cut=cut)
    sleeps: list[float] = []
    mod = PKGS[pkg][0]
    run = mod.run_crypto_enrich if crypto else mod.run_enrich
    try:
        rc = run(cfg_of(pkg, root, **cfg_kw), session=fake, sleep=sleeps.append,
                 rng=random.Random(seed), symbols=symbols)
    except chip_smoke.EnrichCut:
        rc = None
    return rc, sleeps, fake


def both(tmp_path, entities, **kw):
    out = {}
    for pkg in PKGS:
        rc, sleeps, fake = run_pkg(pkg, tmp_path / pkg, entities, **kw)
        out[pkg] = (rc, sleeps, fake.queried, fake.injected, tree(str(tmp_path / pkg)))
    return out


@pytest.mark.parametrize("symbol", ["aapl", "BRK.B", "x'y", "MSFT"])
def test_queries_equal_reference(symbol):
    assert enrich.build_queries(symbol) == ref_enrich.build_queries(symbol)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_zip_results_equal_reference(seed):
    rng = np.random.RandomState(seed)

    def bindings(fields):
        return {"results": {"bindings": [
            {f: {"value": "| | |".join(chip_smoke.letters(rng, 0, 6)
                                        for _ in range(rng.randint(0, 4)))}
             for f in fields if rng.rand() < 0.8}
            for _ in range(rng.randint(0, 4))]}}

    d1 = bindings(("idLabels", "ticker", "aliases", "industries", "countries", "products"))
    d2 = bindings(("subsidiaries", "ownedEntities"))
    d3 = bindings(("ceosWithTerms", "boardMembersWithTerms"))
    assert enrich.zip_results(d1, d2, d3, "SYM") == ref_enrich.zip_results(d1, d2, d3, "SYM")
    assert enrich.empty_entry("Q") == ref_enrich.empty_entry("Q")


def test_hardened_pass_equals_reference(tmp_path, entities):
    symbols = [e["ticker"] for e in entities] + ["NOPE"]  # an unknown symbol: placeholder
    got = both(tmp_path, entities, symbols=symbols)
    assert got["port"] == got["jax"]
    rc, sleeps, queried, injected, files = got["port"]
    assert rc == 0 and {k for _s, _q, k in injected} == {"429", "503", "raise"}
    cfg = cfg_of("port", tmp_path / "port")
    assert sleeps == chip_smoke.enrich_ladder(
        chip_smoke.SparqlFake(entities, 9, faults=FAULTS).fault, symbols, cfg, random.Random(5))
    for e in entities:
        assert files[f"info/ticker/{e['ticker']}_info.json"].decode() == chip_smoke.info_json(e)
    assert files["info/ticker/NOPE_info.json"].decode() == chip_smoke.info_json(
        enrich.empty_entry("NOPE"))
    assert len({s for s, _q in queried}) == len(symbols)


def test_simple_pass_equals_reference(tmp_path, entities):
    """``hardened=False``: one attempt, no sleeps, no ledger; a symbol
    whose first attempt failed has no artifact."""
    symbols = [e["ticker"] for e in entities]
    got = both(tmp_path, entities, symbols=symbols, hardened=False)
    assert got["port"] == got["jax"]
    rc, sleeps, queried, injected, files = got["port"]
    failed = {s for s, _q, _k in injected}
    assert rc == 0 and sleeps == [] and failed
    assert set(files) == {f"info/ticker/{s}_info.json" for s in symbols if s not in failed}
    assert len(queried) <= 3 * len(symbols)


def test_crypto_flow_equals_reference(tmp_path, entities):
    for pkg in PKGS:
        os.makedirs(tmp_path / pkg)
        with open(tmp_path / pkg / "crypto_list.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["Symbol", "Name"])
            w.writerows([[e["ticker"], "coin"] for e in entities[:7]] + [["", "blank"]])
    got = both(tmp_path, entities, crypto=True)
    assert got["port"] == got["jax"]
    files = got["port"][4]
    assert got["port"][0] == 0 and "progress_crypto.json" in files
    assert sorted(f for f in files if f.startswith("info/")) == sorted(
        f"info/crypto/{e['ticker']}_info.json" for e in entities[:7])


def test_missing_symbols_csv_equals_reference(tmp_path, entities, capsys):
    got = both(tmp_path, entities)
    assert got["port"] == got["jax"] and got["port"][0] == 1
    out = capsys.readouterr().out
    assert out.count("not found") == 2


@pytest.mark.parametrize("cut_at", [5, 13])
def test_cut_resume_and_repair_equal_reference(tmp_path, entities, cut_at):
    """A run cut at symbol ``cut_at``, one finished artifact deleted, then
    a resumed run: the same files, ledger bytes, sleeps and queried symbols
    in each package; the resumed run queries exactly the deleted symbol
    and the unfinished ones."""
    symbols = [e["ticker"] for e in entities]
    lost = symbols[cut_at // 2]
    runs = {}
    for pkg in PKGS:
        root = tmp_path / pkg
        rc, sleeps1, _fake = run_pkg(pkg, root, entities, cut=symbols[cut_at], symbols=symbols)
        assert rc is None
        ledger = PKGS[pkg][1].ProgressLedger(str(root / "progress.json"))
        assert ledger.processed == set(symbols[:cut_at]) and not ledger.failed
        first = tree(str(root))
        os.remove(root / "info" / "ticker" / f"{lost}_info.json")
        rc, sleeps2, fake = run_pkg(pkg, root, entities, seed=6, fake_seed=10, symbols=symbols)
        assert rc == 0
        runs[pkg] = (first, sleeps1, sleeps2, fake.queried, tree(str(root)))
    assert runs["port"] == runs["jax"]
    _first, sleeps1, sleeps2, queried, final = runs["port"]
    cfg = cfg_of("port", tmp_path / "port")
    want = [lost] + symbols[cut_at:]
    assert list(dict.fromkeys(s for s, _q in queried)) == want
    assert sleeps1 == chip_smoke.enrich_ladder(
        chip_smoke.SparqlFake(entities, 9, faults=FAULTS).fault, symbols[:cut_at], cfg,
        random.Random(5))
    assert sleeps2 == chip_smoke.enrich_ladder(
        chip_smoke.SparqlFake(entities, 10, faults=FAULTS).fault, want, cfg, random.Random(6))
    assert sorted(f for f in final if f.startswith("info/")) == sorted(
        f"info/ticker/{s}_info.json" for s in symbols)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_progress_ledger_bytes_equal_reference(tmp_path, seed):
    """A seeded sequence of marks, skips (with and without the artifact)
    and reopens gives the same answers and ledger bytes."""
    rng = np.random.RandomState(seed)
    keys = [f"K{i}" for i in range(12)]
    ops = [(rng.randint(4), keys[rng.randint(len(keys))], bool(rng.rand() < 0.5))
           for _ in range(60)]
    out = {}
    for pkg in PKGS:
        mod = PKGS[pkg][1]
        path = str(tmp_path / f"{pkg}.json")
        ledger = mod.ProgressLedger(path)
        answers = []
        for op, key, present in ops:
            if op == 0:
                ledger.mark_processed(key)
            elif op == 1:
                ledger.mark_failed(key)
            elif op == 2:
                answers.append(ledger.should_skip(key, lambda p=present: p))
            else:
                ledger = mod.ProgressLedger(path)
        with open(path, "rb") as f:
            out[pkg] = (answers, f.read(), sorted(ledger.processed), sorted(ledger.failed))
        assert not os.path.exists(path + ".tmp")
    assert out["port"] == out["jax"]

