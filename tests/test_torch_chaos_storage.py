"""The port's storage fault injection (``storage/fsio.py``: ``ChaosFs``,
``ChaosFile``, ``SimulatedCrash`` and the ``ASTPU_CHAOS_FS`` spec)
against the JAX package's.

Each fault is a pure function of (seed, path, per-path op index), so the
same seed and the same operations must give equal outcomes, ledgers,
injection counts and bytes on disk in both packages; the port's
persistence sites (``atomic_replace``, ``AppendCsv``, the harvest shard
files, the index segments) keep the torn-write-safety contract under it."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

from advanced_scrapper_tpu.storage import fsio as ref_fsio
from advanced_scrapper_tpu_torch.config import HarvestConfig
from advanced_scrapper_tpu_torch.storage import fsio
from advanced_scrapper_tpu_torch.storage.csvio import AppendCsv, read_url_column

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATES = [
    {"short_write_rate": 0.25, "eio_flush_rate": 0.2, "fsync_error_rate": 0.2, "crash_rate": 0.1},
    {"crash_rate": 0.5, "short_write_rate": 0.2},
    {"bitflip_rate": 0.3, "short_write_rate": 0.1},
    {"eio_flush_rate": 0.5, "bitflip_rate": 0.5, "only": "keep-"},
]


@pytest.fixture(autouse=True)
def _reset_default_fs():
    yield
    fsio.set_default_fs(None)
    ref_fsio.set_default_fs(None)


def drive(mod, root: str, seed: int, rates: dict):
    """A fixed sequence of appends, whole-file commits and text writes
    through ``mod``'s ChaosFs; returns what a caller and the disk see."""
    fs = mod.ChaosFs(seed=seed, **rates)
    rng = np.random.default_rng(seed)
    outcomes = []
    for i in range(40):
        name = ("keep-" if i % 3 else "skip-") + ("log.bin" if i % 2 else "ckpt.bin")
        path = os.path.join(root, name)
        payload = bytes(rng.integers(0, 256, int(rng.integers(1, 64)), dtype=np.uint8))
        try:
            if i % 4 == 0:
                mod.atomic_replace(path, payload, fs=fs)
            elif i % 4 == 3:
                with fs.open(path + ".txt", "a", encoding="utf-8") as fh:
                    fh.write(payload.hex() + "\n")
                    fh.flush()
            else:
                with fs.open(path, "ab") as fh:
                    fh.write(payload)
                    fh.flush()
                    fs.fsync(fh)
            outcomes.append("ok")
        except mod.SimulatedCrash:
            outcomes.append("crash")
        except OSError as e:
            outcomes.append(f"eio:{e.errno}")
    disk = {f.replace(f"tmp-{os.getpid()}", "tmp-PID"): open(os.path.join(root, f), "rb").read()
            for f in sorted(os.listdir(root))}
    return outcomes, list(fs.ledger), dict(fs.injected), disk


@pytest.mark.parametrize("rates", RATES, ids=lambda r: "+".join(sorted(r)))
@pytest.mark.parametrize("seed", [0, 9])
def test_ledger_outcomes_and_bytes_equal_reference(rates, seed, tmp_path):
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    got = drive(fsio, str(tmp_path / "p"), seed, rates)
    assert got == drive(ref_fsio, str(tmp_path / "j"), seed, rates)
    assert sum(got[2].values()) > 0, "chaos must actually fire"


def test_simulated_crash_is_not_an_exception():
    assert issubclass(fsio.SimulatedCrash, BaseException)
    assert not issubclass(fsio.SimulatedCrash, Exception)
    assert fsio.ChaosFs.KINDS == ref_fsio.ChaosFs.KINDS


def test_atomic_replace_whole_or_previous_under_crash(tmp_path):
    path = str(tmp_path / "ckpt.bin")
    fsio.atomic_replace(path, b"generation-0" * 100, fs=fsio.OsFs())
    crashed = 0
    for seed in range(12):
        fs = fsio.ChaosFs(seed=seed, crash_rate=0.5, short_write_rate=0.2)
        try:
            fsio.atomic_replace(path, b"generation-1" * 100, fs=fs)
        except (fsio.SimulatedCrash, OSError):
            crashed += 1
            assert open(path, "rb").read() in (b"generation-0" * 100, b"generation-1" * 100)
    assert crashed > 0
    # a simulated death leaves its torn tmp behind, like a SIGKILL; the next
    # commit of the same target sweeps the orphans of other pids
    fsio.atomic_replace(path, b"generation-2", fs=fsio.OsFs())
    assert open(path, "rb").read() == b"generation-2"


def test_persist_shard_checkpoint_whole_or_absent(tmp_path):
    from advanced_scrapper_tpu_torch.core.soup import Soup
    from advanced_scrapper_tpu_torch.pipeline.harvest import persist_shard

    cfg = HarvestConfig(shard_dir=str(tmp_path), output_csv=str(tmp_path / "o.csv"))
    page = "<html><body><pre>a 20200101 https://x/a.html t 200 H 1</pre></body></html>"
    expected = Soup(page).get_text("\n", strip=True)
    crashed = 0
    for seed in range(10):
        try:
            persist_shard("aa", page, cfg, fs=fsio.ChaosFs(seed=seed, crash_rate=0.4,
                                                          short_write_rate=0.2))
        except (fsio.SimulatedCrash, OSError):
            crashed += 1
        txt = tmp_path / "yahoo_aa.txt"
        if txt.exists():
            assert txt.read_text(encoding="utf-8") == expected, "torn checkpoint"
            assert (tmp_path / "yahoo_aa.csv").exists(), "checkpoint before its csv"
    assert crashed > 0
    persist_shard("aa", page, cfg)
    assert (tmp_path / "yahoo_aa.txt").read_text(encoding="utf-8") == expected


def test_append_csv_under_short_writes_resumes_whole(tmp_path):
    """Short writes tear the success CSV's tail; the resume read
    quarantines the tail and never reports a torn url as done."""
    path = str(tmp_path / "success.csv")
    fs = fsio.ChaosFs(seed=4, short_write_rate=0.3, only="success")
    written = []
    for i in range(30):
        url = f"https://x/{i}.html"
        try:
            with AppendCsv(path, ["url", "title"], fs=fs) as c:
                c.write_row({"url": url, "title": f"t{i}"})
            written.append(url)
        except OSError:
            pass
    assert fs.injected["short_write"] > 0
    done = read_url_column(path, repair=True)
    assert set(done) <= set(written) and done == [u for u in written if u in set(done)]


def test_env_spec_equals_reference(monkeypatch, tmp_path):
    spec = "seed=7,short_write=0.05,eio_flush=0.02,fsync=0.02,crash=0.01,bitflip=0.5,only=success"
    got, want = fsio._parse_env_spec(spec), ref_fsio._parse_env_spec(spec)
    assert got._seed == want._seed == 7 and got._rates == want._rates and got._only == want._only
    assert got._on_crash is None
    with pytest.raises(ValueError, match="unknown ASTPU_CHAOS_FS key"):
        fsio._parse_env_spec("seed=1,nope=2")
    monkeypatch.setenv("ASTPU_CHAOS_FS", spec)
    fsio.set_default_fs(None)
    fs = fsio.default_fs()
    assert isinstance(fs, fsio.ChaosFs) and fs._rates == want._rates
    assert fsio.default_fs() is fs  # evaluated once


def test_env_spec_exit_is_a_real_death(tmp_path):
    """``exit=1`` makes the crash fault ``os._exit(73)``: no cleanup runs."""
    code = (
        "import os, sys\n"
        "from advanced_scrapper_tpu_torch.storage.fsio import default_fs\n"
        "fs = default_fs()\n"
        "try:\n"
        "    with fs.open(sys.argv[1], 'ab') as fh:\n"
        "        fh.write(b'x' * 100)\n"
        "finally:\n"
        "    print('cleanup ran')\n"
    )
    env = dict(os.environ, ASTPU_CHAOS_FS="seed=1,crash=1.0,exit=1", PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path / "f.bin")], env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 73 and "cleanup ran" not in out.stdout
    assert 0 < (tmp_path / "f.bin").stat().st_size < 100  # the prefix was flushed


def test_bitflip_is_silent_seeded_and_binary_only(tmp_path):
    payload = bytes(range(256)) * 8

    def run(mod, seed):
        fs = mod.ChaosFs(mod.OsFs(), seed=seed, bitflip_rate=1.0)
        path = str(tmp_path / f"rot-{seed}.bin")
        with fs.open(path, "wb") as fh:
            assert fh.write(payload) == len(payload)
        data = open(path, "rb").read()
        os.unlink(path)
        return data, list(fs.ledger)

    data, ledger = run(fsio, 3)
    assert (data, ledger) == run(ref_fsio, 3)
    assert sum(a != b for a, b in zip(data, payload)) == 1 and ledger[0][2] == "bitflip"
    fs = fsio.ChaosFs(fsio.OsFs(), seed=3, bitflip_rate=1.0)
    with fs.open(str(tmp_path / "rot.txt"), "w") as fh:
        fh.write("hello text plane")
    assert (tmp_path / "rot.txt").read_text() == "hello text plane" and fs.injected["bitflip"] == 0


def test_bitflip_caught_by_segment_integrity(tmp_path):
    from advanced_scrapper_tpu_torch.index.segment import (
        Segment,
        SegmentCorruption,
        file_digest,
        write_segment,
    )

    caught = 0
    for seed in range(6):
        fs = fsio.ChaosFs(fsio.OsFs(), seed=seed, bitflip_rate=0.3, only="seg-")
        path = str(tmp_path / f"seg-{seed:08d}.seg")
        keys = np.arange(2000, dtype=np.uint64)
        digest = write_segment(path, keys, keys, seed=seed, fs=fs)
        if not fs.injected["bitflip"]:
            continue
        try:
            Segment(path).verify_all()
        except (SegmentCorruption, ValueError):
            caught += 1
            continue
        assert file_digest(path) != digest
        caught += 1
    assert caught >= 2
