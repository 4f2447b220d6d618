"""A reader of a built kernel's SASS (``cuobjdump -sass``): the
instructions one step of its innermost loop issues, by opcode and by pipe.

Used by ``chip_smoke.py`` (the ``myers_bound`` row of ``kernel_timing``)
and ``myers_probe.py``; needs ``cuobjdump`` beside ``nvcc``, so on the card's
machine only.
"""

from __future__ import annotations

import re
import subprocess
from collections import Counter
from pathlib import Path

from advanced_scrapper_tpu_torch.ops import _build

#: opcode -> the Hopper pipe it issues on, for the opcodes of the Myers step
#: (the 32-bit logic, shift-add and min ops on the ALU pipe, integer
#: multiply-adds on the FMA pipe, shared loads on MIO); other opcodes, such
#: as the loop's counters and branch, are "other"
PIPES = {"LOP3": "alu", "LEA": "alu", "VIMNMX": "alu", "IMAD": "fma", "LDS": "mio"}

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\b")


def parse_sass(text: str) -> list[tuple[int, str, str]]:
    """``(address, opcode, operands)`` of every instruction in ``cuobjdump
    -sass`` output, with branch targets given as labels turned into
    addresses (``BRA `(.L_x_3)``` or ``BRA 0x1a0``)."""
    instrs, labels, pending = [], {}, []
    for line in text.splitlines():
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


def step_loop(instrs: list[tuple[int, str, str]]) -> dict:
    """The kernel's main step loop in parsed SASS: of the innermost loops
    (a backward branch with no other backward branch inside), the one with
    the most byte loads from shared memory (``LDS.U8``, one a step) and no
    global load (the branch-free instance).  Its instructions per step, in
    all, by opcode and by pipe (:data:`PIPES`)."""
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
        steps = sum(op.startswith("LDS.U8") for op in ops)
        if steps and not any(op.startswith("LDG") for op in ops):
            if best is None or steps > best[0]:
                best = (steps, ops)
    if best is None:
        raise RuntimeError("no step loop found in the SASS")
    steps, ops = best
    kinds = Counter(op.split(".")[0] for op in ops if op != "NOP")
    pipes = Counter()
    for kind, n in kinds.items():
        pipes[PIPES.get(kind, "other")] += n
    return {"steps_in_loop": steps, "instructions_in_loop": sum(kinds.values()),
            "per_step": sum(kinds.values()) / steps,
            "by_opcode_per_step": {k: v / steps for k, v in sorted(kinds.items())},
            "by_pipe_per_step": {k: v / steps for k, v in sorted(pipes.items())}}


def sass_step_counts(lib: Path) -> dict:
    """:func:`step_loop` of a built library's SASS."""
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                         check=True, timeout=120).stdout
    return step_loop(parse_sass(out))
