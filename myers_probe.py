"""Variants of the Myers-bound kernel on the card: a tuning probe.

    python3 myers_probe.py [--parent DIR]

Builds copies of ``advanced_scrapper_tpu_torch/csrc/editdist.cu`` with
other values of its constants (chains a thread, unroll, blocks an SM;
:data:`VARIANTS`, applied by text substitution) into
``build/kernels/probe/``, and, with ``--parent``, the ``editdist.cu`` of
another checkout (an earlier design with the same C interface, e.g. the
parent commit unpacked with ``git archive``), all at once, one nvcc each.
Then, on the matcher cell's chunk of ``chip_smoke.py`` (S&P scale: 500
tickers, 20,000 articles), it holds the shipped kernel bit-equal to
``myers_bound_plain`` on the chunk's first rows and on the edge cases of
``chip_smoke.check_match_vs_plain``, holds every variant's mask bits and
distances equal to the shipped kernel's, and times each (gated mode, as
the matcher launches it) with CUDA events over 5 launches after a warm
one, twice (every variant in order, then in reverse), the SM clock read
before and after each.  One JSON line per variant, with its SASS
instructions per Myers step (``ops/sass.py``).  Needs one card and
``nvcc``; run it from the repo's root.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from advanced_scrapper_tpu_torch.ops import _build

CHAINS = "constexpr int kChains = 4;"
UNROLL = "constexpr int kUnroll = 8;"
MIN_BLOCKS = "constexpr int kMinBlocks = 4;"

#: name -> [(text in the source, its replacement)]; "shipped" is the source
VARIANTS = {
    "shipped": [],
    "t2": [(CHAINS, "constexpr int kChains = 2;")],
    "t5": [(CHAINS, "constexpr int kChains = 5;")],
    "t8": [(CHAINS, "constexpr int kChains = 8;"), (MIN_BLOCKS, "constexpr int kMinBlocks = 3;")],
    "unroll_4": [(UNROLL, "constexpr int kUnroll = 4;")],
}


def patched(source: str, edits: list[tuple[str, str]]) -> str:
    """``source`` with each edit applied; raises if a text is not there
    exactly once."""
    for old, new in edits:
        if source.count(old) != 1:
            raise ValueError(f"not once in editdist.cu: {old!r}")
        source = source.replace(old, new)
    return source


def build_variants(parent: Path | None) -> dict[str, Path]:
    """Every variant (and the parent's source) compiled at once, one nvcc
    each; name -> library."""
    outdir = _build.BUILD_DIR / "probe"
    outdir.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC_DIR / "editdist.cu").read_text()
    srcs = {}
    for name, edits in VARIANTS.items():
        srcs[name] = outdir / f"editdist-{name}.cu"
        srcs[name].write_text(patched(source, edits))
    if parent is not None:
        srcs["parent"] = parent / "advanced_scrapper_tpu_torch" / "csrc" / "editdist.cu"
    procs, libs = {}, {}
    for name, src in srcs.items():
        libs[name] = outdir / f"libeditdist-{name}.so"
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, "-o", str(libs[name]),
             str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{out[-2000:]}")
        regs = re.findall(r"Used (\d+) registers", out)
        print(json.dumps({"variant": name, "registers": [int(r) for r in regs]}), flush=True)
    return libs


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    p = ctypes.c_void_p
    lib.astt_myers_bound.argtypes = [p, p, p, p, p, ctypes.c_longlong, p, p, p, p,
                                     ctypes.c_int, ctypes.c_float, p, ctypes.c_int, p, p]
    lib.astt_myers_bound.restype = ctypes.c_int
    return lib


def launch(lib: ctypes.CDLL, t: dict, mask: torch.Tensor, dist: torch.Tensor | None) -> None:
    """One launch of a variant on the tensors ``t`` (checked once by the
    shipped wrapper on the same tensors)."""
    hmt = np.float32(100.0) - np.float32(t["threshold"])
    err = lib.astt_myers_bound(
        t["text"].data_ptr(), t["off"].data_ptr(), t["len"].data_ptr(), t["tl"].data_ptr(),
        t["fl"].data_ptr(), t["off"].numel(), t["masks"].data_ptr(), t["plens"].data_ptr(),
        t["ok"].data_ptr(), t["cols"].data_ptr(), t["plens"].numel(), float(hmt),
        mask.data_ptr(), mask.shape[1], None if dist is None else dist.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"variant launch failed: CUDA error {err}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, help="a checkout whose editdist.cu to time beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("myers_probe runs on the card", file=sys.stderr)
        return 2
    import chip_smoke as cs  # the chunk, the edge cases and the timers of the smoke run

    from advanced_scrapper_tpu_torch.ops import editdist_cuda
    from advanced_scrapper_tpu_torch.ops.editdist import myers_bound_plain
    from advanced_scrapper_tpu_torch.ops.sass import sass_step_counts
    from advanced_scrapper_tpu_torch.pipeline.matcher import (
        EntityIndex,
        join_rows,
        process_json_data,
    )

    card = cs.nvidia_smi("name,power.limit")
    print(json.dumps({"card": card}), flush=True)
    libs = build_variants(args.parent)
    dev = torch.device("cuda")
    print(json.dumps({"phase": "match_kernel_vs_plain", **cs.check_match_vs_plain(dev)}),
          flush=True)

    rng = np.random.RandomState(17)
    entities = cs.sp500_entities(rng)
    records, _planted = cs.sp500_articles(rng, entities, cs.MATCH_ARTICLES)
    index = EntityIndex(process_json_data(entities))
    rows = [(r["article_text"], r["title"], None, r) for r in records]
    eligible, text, off, ln, tl, _ttl, fl = join_rows(rows, 1 << 16, dev)
    screen, (masks, plens, ok, cols) = index.device_tables(dev)
    n_names = screen["kept"].numel()
    t = dict(text=text, off=off, len=ln, tl=tl, fl=fl, masks=masks, plens=plens, ok=ok,
             cols=cols, threshold=95.0)
    base = (torch.rand((eligible.size, n_names), device=dev) < 0.05).to(torch.uint8)

    # the shipped kernel against the plain version on the chunk's first rows
    few = 256
    sub = [x[:few].contiguous() for x in (off, ln, tl, fl)]
    got, want = base[:few].clone(), base[:few].clone()
    editdist_cuda.myers_bound(text, *sub, masks, plens, ok, cols, 95.0, got)
    myers_bound_plain(text, *sub, masks, plens, ok, cols, 95.0, want, rows_per_batch=256)
    torch.cuda.synchronize()
    assert torch.equal(got, want), "myers_bound differs from plain on the chunk's first rows"

    shipped = base.clone()
    editdist_cuda.myers_bound(text, off, ln, tl, fl, masks, plens, ok, cols, 95.0, shipped)
    want_dist = torch.empty((eligible.size, plens.numel()), dtype=torch.int32, device=dev)
    launch(load(libs["shipped"]), t, base.clone(), want_dist)
    torch.cuda.synchronize()
    loaded, times = {}, {name: [] for name in libs}
    for name, path in libs.items():
        lib = loaded[name] = load(path)
        mask = base.clone()
        dist = torch.empty_like(want_dist)
        launch(lib, t, mask, dist)
        torch.cuda.synchronize()
        equal = bool(torch.equal(mask, shipped)) and bool(torch.equal(dist, want_dist))
        assert equal, f"variant {name} differs from the shipped kernel"
    # each variant timed twice, in order and then in reverse, so that a drift
    # of the card's speed over the call shows as a spread
    for name in [*libs, *reversed(libs)]:
        clock_before = cs.nvidia_smi("clocks.sm")
        ms = cs.cuda_ms(lambda lib=loaded[name]: launch(lib, t, base, None), 5)
        times[name].append((ms, clock_before, cs.nvidia_smi("clocks.sm")))
    for name, path in libs.items():
        try:
            sass = sass_step_counts(path)
        except (RuntimeError, subprocess.SubprocessError, OSError) as e:
            sass = {"error": str(e)[:200]}
        ms = [x[0] for x in times[name]]
        print(json.dumps({"variant": name, "ms": ms, "ms_mean": sum(ms) / len(ms),
                          "equal_to_shipped": True,
                          "clock_sm": [c for x in times[name] for c in x[1:]], "sass": sass,
                          "rows": int(eligible.size), "patterns": int(plens.numel()),
                          "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
