"""A reader of a built kernel's SASS (``cuobjdump -sass``): the
instructions one step of its innermost loop issues, by opcode and by pipe.

Used by ``chip_smoke.py`` (the ``myers_bound``, ``match_screen`` and
``myers_pairs`` rows of ``kernel_timing``, the OPH fold's rows of
``oph_kernel_timing``), ``myers_probe.py`` and ``oph_probe.py``;
:func:`sass_step_counts`, :func:`pairs_sass`, :func:`screen_sass` and
:func:`oph_sass` need ``cuobjdump`` beside ``nvcc``, so on the card's
machine only.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
from collections import Counter
from pathlib import Path

from advanced_scrapper_tpu_torch.ops import _build

#: opcode -> the Hopper pipe it issues on, for the opcodes of the Myers step
#: and the screen's probe (the 32-bit logic, shift, add and min ops on the
#: ALU pipe, integer multiply-adds on the FMA pipe, shared and global loads
#: on MIO); other opcodes, such as the loop's compares and branch, are
#: "other"
PIPES = {"LOP3": "alu", "LEA": "alu", "VIMNMX": "alu", "SHF": "alu", "IADD3": "alu",
         "IMAD": "fma", "LDS": "mio", "LDG": "mio"}

#: the OPH fold's hash loop also issues byte permutes and compares on the
#: ALU pipe and shared atomics on MIO
OPH_PIPES = {**PIPES, "PRMT": "alu", "ISETP": "alu", "ATOMS": "mio"}

_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\b")


def parse_sass(text: str, function: str | None = None) -> list[tuple[int, str, str]]:
    """``(address, opcode, operands)`` of every instruction in ``cuobjdump
    -sass`` output, with branch targets given as labels turned into
    addresses (``BRA `(.L_x_3)``` or ``BRA 0x1a0``).  ``function``: only
    the functions whose (mangled) name holds it; addresses restart in each
    function, so a library of several kernels is read one kernel at a
    time."""
    instrs, labels, pending = [], {}, []
    keep = function is None
    for line in text.splitlines():
        head = _FUNCTION.match(line)
        if head and function is not None:
            keep = function in head.group(1)
            continue
        if not keep:
            continue
        lab = _LABEL.match(line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = _INSTR.search(line)
        if m:
            addr = int(m.group(1), 16)
            for name in pending:
                labels[name] = addr
            pending = []
            instrs.append((addr, m.group(3), m.group(4)))
    out = []
    for addr, op, rest in instrs:
        if op.startswith("BRA"):
            t = _TARGET.search(rest)
            if t:
                rest = hex(labels[t.group(1)]) if t.group(1) else t.group(2)
        out.append((addr, op, rest))
    return out


def step_loop(instrs: list[tuple[int, str, str]], step: str = "LDS.U8",
              global_loads: bool = False, pipes: dict[str, str] = PIPES) -> dict:
    """The kernel's main step loop in parsed SASS: of the innermost loops
    (a backward branch with no other backward branch inside), the one with
    the most ``step`` instructions (one a step: ``LDS.U8``, the Myers
    step's byte load from shared memory, by default; ``LDS``, the screen's
    bitmap load) and with global loads or none, as ``global_loads`` says
    (the Myers step's branch-free instance has none; the screen's probe
    loads its gram).  Its instructions per step, in all, by opcode and by
    pipe (``pipes``, :data:`PIPES` by default)."""
    loops = []
    for i, (addr, op, rest) in enumerate(instrs):
        if op.startswith("BRA") and rest.strip().startswith("0x"):
            target = int(rest.strip(), 16)
            if target < addr:
                j0 = next(j for j, x in enumerate(instrs) if x[0] >= target)
                loops.append((j0, i))
    inner = [(a, b) for a, b in loops
             if not any((c, d) != (a, b) and a <= c and d <= b for c, d in loops)]
    best = None
    for a, b in inner:
        ops = [op for _addr, op, _r in instrs[a:b + 1]]
        steps = sum(op == step or op.startswith(step + ".") for op in ops)
        if steps and any(op.startswith("LDG") for op in ops) == global_loads:
            if best is None or steps > best[0]:
                best = (steps, ops)
    if best is None:
        raise RuntimeError("no step loop found in the SASS")
    steps, ops = best
    kinds = Counter(op.split(".")[0] for op in ops if op != "NOP")
    by_pipe = Counter()
    for kind, n in kinds.items():
        by_pipe[pipes.get(kind, "other")] += n
    return {"steps_in_loop": steps, "instructions_in_loop": sum(kinds.values()),
            "per_step": sum(kinds.values()) / steps,
            "by_opcode_per_step": {k: v / steps for k, v in sorted(kinds.items())},
            "by_pipe_per_step": {k: v / steps for k, v in sorted(by_pipe.items())}}


def work_per_step(loop: dict) -> float:
    """The ALU and FMA pipes' instructions per step of a :func:`step_loop`:
    the arithmetic, without the loads, the compares and the branch."""
    pipes = loop["by_pipe_per_step"]
    return pipes.get("alu", 0.0) + pipes.get("fma", 0.0)


def screen_loops(instrs: list[tuple[int, str, str]], rows: int) -> dict:
    """The q-gram screen's two per-item loops in parsed SASS: the probe
    loop (one bitmap load from shared memory and one gram load a probe,
    which answers the ``rows`` rows of a block), by opcode and by pipe, with
    its instructions and its ALU and FMA instructions per (row, gram); and
    the mask's write-out loop (one byte store a (row, name) pair), with its
    ALU and FMA instructions per pair."""
    probe = step_loop(instrs, step="LDS", global_loads=True)
    write = step_loop(instrs, step="STG", global_loads=False)
    return {**probe, "rows_per_block": rows, "per_row_gram": probe["per_step"] / rows,
            "work_per_row_gram": work_per_step(probe) / rows,
            "write_per_pair": write["per_step"], "write_work_per_pair": work_per_step(write),
            "write_by_opcode_per_pair": write["by_opcode_per_step"]}


def dump_sass(lib: Path) -> str:
    """``cuobjdump -sass`` of a built library."""
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    return subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=120).stdout


def sass_step_counts(lib: Path, step: str = "LDS.U8", global_loads: bool = False,
                     function: str | None = "bound_kernel") -> dict:
    """:func:`step_loop` of a built library's SASS, of the functions whose
    name holds ``function`` (the Myers bound's kernel by default:
    ``editdist.cu`` also holds ``myers_pairs``)."""
    return step_loop(parse_sass(dump_sass(lib), function), step, global_loads)


def pairs_loop(instrs: list[tuple[int, str, str]]) -> dict:
    """``myers_pairs``' step loop in parsed SASS (one LDS.U8 a step): the
    window unrolled whole, which holds the next window's global loads, or,
    where a variant keeps a window a loop of passes, that loop."""
    try:
        return step_loop(instrs, global_loads=True)
    except RuntimeError:
        return step_loop(instrs)


def pairs_sass(lib: Path) -> dict:
    """:func:`pairs_loop` of a built ``editdist.cu``'s ``myers_pairs``
    kernel; or the reason there is none."""
    try:
        return pairs_loop(parse_sass(dump_sass(lib), "pairs_kernel"))
    except (RuntimeError, subprocess.SubprocessError, OSError) as e:
        return {"error": str(e)[:300]}


def screen_sass(lib: Path) -> dict:
    """:func:`screen_loops` of a built ``match.cu`` (its rows a block from
    the library); or the reason there are none."""
    try:
        rows = ctypes.CDLL(str(lib)).astt_match_rows_per_block()
        return screen_loops(parse_sass(dump_sass(lib)), rows)
    except (RuntimeError, subprocess.SubprocessError, OSError) as e:
        return {"error": str(e)[:300]}


def oph_loop(instrs: list[tuple[int, str, str]]) -> dict:
    """The OPH fold's hash loop in parsed SASS, per shingle (:data:`OPH_PIPES`):
    the loop with global loads and one ``LDS`` a shingle where the shared
    atomic is filtered by a read of its bin (``oph_probe.py``'s
    ``filter``), else one ``ATOMS`` a shingle (the shipped fold, PR 14's)."""
    try:
        return step_loop(instrs, step="LDS", global_loads=True, pipes=OPH_PIPES)
    except RuntimeError:
        return step_loop(instrs, step="ATOMS", global_loads=True, pipes=OPH_PIPES)


def oph_sass(lib: Path, units: str = "SegmentUnits") -> dict:
    """:func:`oph_loop` of a built ``oph.cu``'s fold at k = 5 in the
    addressing mode whose unit type is ``units`` (``SegmentUnits`` or
    ``TileUnits``); or the reason there is none."""
    try:
        return oph_loop(parse_sass(dump_sass(lib), f"{units}ELi5E"))
    except (RuntimeError, subprocess.SubprocessError, OSError) as e:
        return {"error": str(e)[:300]}
