"""The port's CSV set algebra (``utils/setops.py``) against the JAX
package's: the same numpy-seeded CSVs (url columns of text, integers and
floats, NA tokens, quoted fields, extra columns of mixed kinds) give the
same anti-join rows, the same ``new_links`` bytes and the same
round-robin shard files."""

from __future__ import annotations

import os

import numpy as np
import pytest

from advanced_scrapper_tpu.utils import setops as ref
from advanced_scrapper_tpu_torch.utils import setops


def write_csv(path: str, rng, n: int, kind: str) -> None:
    rows = ["url,date_time,score"]
    for _ in range(n):
        if kind == "int":
            u = str(int(rng.integers(0, 20)))
        elif kind == "float":
            u = str(rng.choice(["1.5", "2", "", "3.0", "1e16"]))
        else:
            u = str(rng.choice([f"https://x/{int(rng.integers(0, 30))}.html", "", "NA",
                                'a "q"', "a,b", "é/ü.html"]))
            if '"' in u or "," in u:
                u = '"' + u.replace('"', '""') + '"'
        d = str(rng.choice(["20230101", "", "2.5", "x", "True"]))
        rows.append(f"{u},{d},{int(rng.integers(0, 5))}")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(rows) + "\n")


def outputs(mod, d: str, tag: str, parts: int):
    inp, done = os.path.join(d, "in.csv"), os.path.join(d, "done.csv")
    n = mod.new_links(inp, os.path.join(d, f"{tag}.csv"), done, os.path.join(d, "missing.csv"))
    paths = mod.round_robin_split(inp, parts, done, output_template=os.path.join(d, tag + "_{i}.csv"))
    return n, open(os.path.join(d, f"{tag}.csv"), "rb").read(), [open(p, "rb").read() for p in paths]


@pytest.mark.parametrize("block", range(2))
def test_setops_sweep_equals_reference(block, tmp_path):
    for seed in range(block * 60, block * 60 + 60):
        rng = np.random.default_rng(seed)
        kind = str(rng.choice(["str", "str", "int", "float"]))
        d = str(tmp_path / str(seed))
        os.makedirs(d)
        write_csv(os.path.join(d, "in.csv"), rng, int(rng.integers(0, 30)), kind)
        write_csv(os.path.join(d, "done.csv"), rng, int(rng.integers(0, 10)), kind)
        parts = int(rng.integers(1, 5))
        assert outputs(setops, d, "p", parts) == outputs(ref, d, "r", parts), seed


def test_anti_join_rows_and_split_order(tmp_path):
    (tmp_path / "all.csv").write_text("url,date_time\n" + "".join(f"u{i},{i}\n" for i in range(10)))
    (tmp_path / "done1.csv").write_text("url\nu1\nu3\n")
    (tmp_path / "done2.csv").write_text("url\nu5\n")
    out = setops.anti_join_csv(str(tmp_path / "all.csv"), str(tmp_path / "done1.csv"),
                               str(tmp_path / "done2.csv"))
    assert out.column("url")[1] == ["u0", "u2", "u4", "u6", "u7", "u8", "u9"]
    assert out.column("date_time") == ("int", [0, 2, 4, 6, 7, 8, 9])
    paths = setops.round_robin_split(str(tmp_path / "all.csv"), 3, str(tmp_path / "done1.csv"),
                                     output_template=str(tmp_path / "part_{i}.csv"))
    assert [open(p).read().split()[1:] for p in paths] == [
        ["u0,0", "u5,5", "u8,8"], ["u2,2", "u6,6", "u9,9"], ["u4,4", "u7,7"]]


def test_split_refuses_what_the_reference_refuses(tmp_path):
    (tmp_path / "a.csv").write_text("url\nx\n")
    for mod in (setops, ref):
        with pytest.raises(ValueError, match="n_parts"):
            mod.round_robin_split(str(tmp_path / "a.csv"), 0)
        with pytest.raises(ValueError, match="placeholder"):
            mod.round_robin_split(str(tmp_path / "a.csv"), 2, output_template="same.csv")
    with pytest.raises(KeyError):
        setops.anti_join_csv(str(tmp_path / "a.csv"), column="nope")


def test_done_csvs_are_read_without_repair(tmp_path):
    """A hand-kept done CSV with a torn tail is read as it stands and
    never rewritten."""
    (tmp_path / "all.csv").write_text("url\nhttps://a\nhttps://b\n")
    torn = b"url\nhttps://a\nhttps://b"
    (tmp_path / "done.csv").write_bytes(torn)
    got = setops.anti_join_csv(str(tmp_path / "all.csv"), str(tmp_path / "done.csv"))
    assert len(got) == 0 and (tmp_path / "done.csv").read_bytes() == torn
    assert not (tmp_path / "done.csv.quarantine").exists()
