"""The PyTorch port stands alone: no module of ``advanced_scrapper_tpu_torch``
and not ``chip_smoke.py`` imports ``jax`` or the JAX package."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "advanced_scrapper_tpu_torch"
FILES = sorted(
    str(p.relative_to(ROOT)) for p in [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]
)
FORBIDDEN = ("jax", "jaxlib", "advanced_scrapper_tpu")


def _imported_modules(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", None))
            in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            yield str(node.args[0].value)


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_port_files_found():
    assert "chip_smoke.py" in FILES
    assert "advanced_scrapper_tpu_torch/pipeline/dedup.py" in FILES
    assert "advanced_scrapper_tpu_torch/ops/minhash_cuda.py" in FILES


@pytest.mark.parametrize("rel", FILES)
def test_no_jax_or_reference_import(rel):
    tree = ast.parse((ROOT / rel).read_text(), filename=rel)
    bad = [m for m in _imported_modules(tree) if _forbidden(m)]
    assert not bad, f"{rel} imports {bad}"


def test_importing_the_port_loads_no_jax():
    """Every port module imported in a fresh interpreter leaves ``jax`` and
    the JAX package out of ``sys.modules``."""
    mods = sorted(
        ".".join(Path(rel).with_suffix("").parts)
        for rel in FILES
        if rel.startswith("advanced_scrapper_tpu_torch")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'advanced_scrapper_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
