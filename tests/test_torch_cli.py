"""The port's CLI (``advanced_scrapper_tpu_torch/cli.py``) against the JAX
package's ``astpu``, both run in this process (``main(argv)``), the port
with ``--device cpu``: the configuration JSON under ``ASTPU_*`` knobs,
``dedup``'s output byte for byte (the whole corpus, ``--stream`` with an
exact and a bloom index), its short-line rule and its untouched output
on a failing input, ``xdedup``'s manifest, ``match``'s flags and CSV
trees, and the commands that are not ported."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from advanced_scrapper_tpu import cli as ref_cli
from advanced_scrapper_tpu import config as ref_config
from advanced_scrapper_tpu.pipeline import matcher as ref_matcher
from advanced_scrapper_tpu_torch import cli, config
from advanced_scrapper_tpu_torch.pipeline import matcher
from test_torch_matcher import adversarial_csv, tree
from test_match_dispatch import _entities

CPU = ["--device", "cpu"]


def run_both(argv: list[str], capsys) -> tuple[tuple, tuple]:
    """``(rc, stdout, stderr)`` of the reference's and the port's main."""
    out = []
    for main, pre in ((ref_cli.main, []), (cli.main, CPU)):
        rc = main(pre + argv)
        got = capsys.readouterr()
        out.append((rc, got.out, got.err))
    return out[0], out[1]


def run_both_to(argv: list[str], tmp_path, capsys) -> tuple[tuple, tuple]:
    """:func:`run_both` with ``argv`` ending in ``-o`` and the output path
    ``ref.txt`` or ``port.txt`` under ``tmp_path``."""
    out = []
    for main, pre, name in ((ref_cli.main, [], "ref.txt"), (cli.main, CPU, "port.txt")):
        rc = main(pre + argv + [str(tmp_path / name)])
        got = capsys.readouterr()
        out.append((rc, got.out, got.err))
    return out[0], out[1]


KNOBS = {"ASTPU_MATCH_PACKED": "0", "ASTPU_MATCH_FUZZY_THRESHOLD": "90.5",
         "ASTPU_DEDUP_STREAM_INDEX": "bloom", "ASTPU_DEDUP_RERANK": "off",
         "ASTPU_ENRICH_COOLDOWN_EVERY3": "1.5, 2,", "ASTPU_FEED_PORT": "9000",
         "ASTPU_SCRAPER_WEBSITE": "other", "ASTPU_MESH_SEQ_PARALLEL": "2"}


@pytest.mark.parametrize("knobs", [False, True])
def test_config_json_equals_reference(capsys, monkeypatch, knobs):
    if knobs:
        for k, v in KNOBS.items():
            monkeypatch.setenv(k, v)
    want, got = run_both(["config"], capsys)
    assert got == want and got[0] == 0
    cfg = json.loads(got[1])
    assert set(cfg) == {"scraper", "harvest", "enrich", "match", "dedup", "mesh", "feed"}
    if knobs:
        assert cfg["match"]["packed"] is False and cfg["enrich"]["cooldown_every3"] == [1.5, 2.0]
        assert cfg["dedup"]["rerank"] is False and cfg["feed"]["port"] == 9000


@pytest.mark.parametrize("section", ["scraper", "harvest", "enrich", "match", "dedup", "mesh",
                                     "feed"])
def test_config_sections_are_the_references(section, monkeypatch):
    for k, v in KNOBS.items():
        monkeypatch.setenv(k, v)
    want = getattr(ref_config.default_config(), section)
    got = getattr(config.default_config(), section)
    assert [(f.name, f.default) for f in dataclasses.fields(got)] == [
        (f.name, f.default) for f in dataclasses.fields(want)]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert config.from_env(type(got), section, port=None) == got
    assert getattr(config.Config().replace(**{section: got}), section) is got


def test_version_equals_reference(capsys):
    want, got = run_both(["version"], capsys)
    assert got == want and got[1].strip()


def corpus(path, seed: int = 0, n: int = 240) -> None:
    """Lines of words with near and exact copies, blank lines, repeated
    lines shorter than a shingle, and non-ASCII lines."""
    rng = np.random.RandomState(seed)
    lines: list[str] = []
    for i in range(n):
        u = rng.rand()
        if i > 8 and u < 0.3:
            t = lines[rng.randint(len(lines))]
            if t and rng.rand() < 0.5:
                c = list(t)
                c[rng.randint(len(c))] = "x"
                t = "".join(c)
        elif u < 0.36:
            t = ["", "ab", "abcd", "é"][rng.randint(4)]
        elif u < 0.4:
            t = "Zürich " * int(rng.randint(2, 30))
        else:
            t = " ".join("".join(chr(97 + c) for c in rng.randint(0, 26, rng.randint(2, 8)))
                         for _ in range(rng.randint(5, 60)))
        lines.append(t)
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")


@pytest.mark.parametrize("mode", [[], ["--stream"], ["--stream", "--index", "bloom"]],
                         ids=["whole", "stream", "stream_bloom"])
def test_dedup_output_byte_equal(tmp_path, capsys, mode):
    corpus(tmp_path / "in.txt")
    argv = ["dedup", str(tmp_path / "in.txt"), *mode, "-o"]
    want, got = run_both_to(argv, tmp_path, capsys)
    assert got == want and got[0] == 0
    a, b = (tmp_path / "ref.txt").read_bytes(), (tmp_path / "port.txt").read_bytes()
    assert a == b and 0 < a.count(b"\n") < 240
    kept = a.decode().split("\n")[:-1]
    for short in ("", "ab", "abcd", "é"):  # shorter than a shingle: one copy each streamed
        assert (kept.count(short) <= 1) == bool(mode)


def test_dedup_short_lines(tmp_path, capsys):
    """Lines shorter than a shingle: the whole-corpus engine keeps each
    (they have no signature), the stream merges them by content; both as
    the reference does."""
    text = "ab\n\nab\nlong enough line one\n\nab\nx\n"
    (tmp_path / "in.txt").write_text(text, "utf-8")
    for mode, kept in (([], text), (["--stream"], "ab\n\nlong enough line one\nx\n")):
        want, got = run_both_to(["dedup", str(tmp_path / "in.txt"), *mode, "-o"],
                                tmp_path, capsys)
        assert got == want
        assert (tmp_path / "port.txt").read_text() == kept


@pytest.mark.parametrize("mode", [[], ["--stream"]], ids=["whole", "stream"])
def test_dedup_failing_input_leaves_the_old_output(tmp_path, mode):
    for main, pre in ((ref_cli.main, []), (cli.main, CPU)):
        out = tmp_path / "out.txt"
        out.write_text("old output\n")
        with pytest.raises(FileNotFoundError):
            main(pre + ["dedup", str(tmp_path / "missing.txt"), *mode, "-o", str(out)])
        assert out.read_text() == "old output\n"


def test_dedup_index_needs_stream(tmp_path, capsys):
    corpus(tmp_path / "in.txt", n=10)
    want, got = run_both(["dedup", str(tmp_path / "in.txt"), "--index", "bloom"], capsys)
    assert got == want and got[0] == 2


def test_xdedup_manifest_byte_equal(tmp_path, capsys):
    import csv

    rng = np.random.RandomState(4)
    texts = [" ".join("".join(chr(97 + c) for c in rng.randint(0, 26, 6)) for _ in range(40))
             for _ in range(30)]
    for k, name in enumerate(("a.csv", "b.csv")):
        with open(tmp_path / name, "w", newline="", encoding="utf-8") as f:
            w = csv.writer(f)
            w.writerow(["url", "article", "title"])
            for i in range(20):
                t = texts[(i + 7 * k) % 30]
                w.writerow([f"https://{name}/{i}", t if i % 6 else t[::-1], f"t{i}"])
    srcs = [str(tmp_path / "a.csv"), str(tmp_path / "b.csv")]
    want, got = run_both_to(["xdedup", *srcs, "-o"], tmp_path, capsys)
    assert got == want and got[0] == 0
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "ref.txt").read_bytes()
    stats = json.loads(got[1])
    assert stats["total"] == 40 and stats["kept"] < 40


FLAGS = [[], ["--no-screen"], ["--refine"], ["--no-refine"], ["--workers", "3"],
         ["--no-screen", "--no-refine", "--workers", "0"], ["--refine", "--no-screen"]]


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: " ".join(f) or "none")
def test_match_flags_map_as_the_reference(monkeypatch, capsys, flags):
    seen = []

    def fake(cfg, **kw):
        seen.append((dataclasses.asdict(cfg), {k: v for k, v in kw.items() if k != "device"}))
        return 0

    monkeypatch.setattr(ref_matcher, "run_matcher", fake)
    monkeypatch.setattr(matcher, "run_matcher", fake)
    want, got = run_both(["match", *flags], capsys)
    assert got == want
    assert seen[:1] == seen[1:]
    if got[0] == 2:
        assert not seen and "--refine requires the screen" in got[1]


def test_match_refine_conflicts_are_refused(capsys):
    for main, pre in ((ref_cli.main, []), (cli.main, CPU)):
        with pytest.raises(SystemExit) as e:
            main(pre + ["match", "--refine", "--no-refine"])
        assert e.value.code == 2


def test_match_writes_the_reference_trees(tmp_path, monkeypatch, capsys):
    info = tmp_path / "info"
    info.mkdir()
    (info / "a.json").write_text(json.dumps(_entities(6)))
    adversarial_csv(str(tmp_path / "articles.csv"), np.random.RandomState(3), n=40)
    monkeypatch.setenv("ASTPU_MATCH_INFO_DIR", str(info))
    monkeypatch.setenv("ASTPU_MATCH_ARTICLES_CSV", str(tmp_path / "articles.csv"))
    monkeypatch.setenv("ASTPU_MATCH_CHUNK_SIZE", "16")
    for main, pre, name in ((ref_cli.main, [], "ref"), (cli.main, CPU, "port")):
        monkeypatch.setenv("ASTPU_MATCH_SOURCE_NAME", str(tmp_path / name))
        assert main(pre + ["match", "--refine", "--workers", "1"]) == 0
    capsys.readouterr()
    want = tree(str(tmp_path / "ref_ticker_matched_articles"))
    assert tree(str(tmp_path / "port_ticker_matched_articles")) == want and want


UNPORTED = [["harvest"], ["scrape"], ["enrich", "--crypto"], ["poll", "--rounds", "1"],
            ["serve"], ["work"], ["new-links", "a", "b", "c"], ["split", "a", "-n", "2"],
            ["selftest"]]


@pytest.mark.parametrize("argv", UNPORTED, ids=lambda a: a[0])
def test_unported_commands_name_their_item(argv):
    with pytest.raises(SystemExit) as e:
        cli.main(CPU + argv)
    assert "item 18" in str(e.value.code)
    ref_parser = ref_cli.build_parser()
    assert vars(cli.build_parser().parse_args(argv)).keys() - {"device"} == \
        vars(ref_parser.parse_args(argv)).keys()


def test_smoke_on_the_cpu(capsys):
    assert cli.main(CPU + ["smoke"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["ok"] and report["dedup"]["reps"] == [0, 0, 2]
    assert set(report["native"]) == {"fastmatch", "hostbatch", "exactdedup"}
    assert "item 18" in report["transport"]


def test_device_defaults_to_the_card(tmp_path):
    assert cli.build_parser().parse_args(["version"]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    corpus(tmp_path / "in.txt", n=5)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["dedup", str(tmp_path / "in.txt"), "-o", str(tmp_path / "o.txt")])
    assert not (tmp_path / "o.txt").exists()
    assert cli.main(["smoke"]) == 1
