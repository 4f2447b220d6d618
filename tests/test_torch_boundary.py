"""The PyTorch port stands alone: no module of ``advanced_scrapper_tpu_torch``
and not ``chip_smoke.py`` imports ``jax``, the JAX package, ``pandas`` or
``dateutil`` (the card's host has neither), or ``psycopg2`` at module level
(the Postgres backend imports it when it is opened), or names a path into
the JAX package from which a native source or library could be loaded."""

from __future__ import annotations

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "advanced_scrapper_tpu_torch"
FILES = sorted(
    str(p.relative_to(ROOT)) for p in [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]
)
FORBIDDEN = ("jax", "jaxlib", "advanced_scrapper_tpu", "pandas", "dateutil")
#: a path into the JAX package that names native code
LOADABLE = re.compile(
    r"advanced_scrapper_tpu(?!_torch)[/\\](?:native\b|.*\.(?:cpp|cc|h|so|cu)\b)")


#: the port's host C++ sources and headers
NATIVE = ("fastmatch.cpp", "exactdedup.cpp", "hostbatch.cpp", "bytehash.h")


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
    for rel in ("config.py", "core/dates.py", "cpu/fuzz.py", "cpu/native.py",
                "cpu/csvframe.py", "ops/match.py", "ops/match_cuda.py", "ops/editdist.py",
                "ops/editdist_cuda.py", "pipeline/matcher.py", "extractors/tpu_batch.py",
                "utils/bloom.py", "storage/fsio.py", "ops/exact.py", "cpu/exactdedup.py",
                "index/__init__.py", "index/wal.py", "index/segment.py", "index/store.py",
                "index/repair.py", "storage/backends.py", "storage/stores.py",
                "storage/csvio.py", "pipeline/cross_source.py", "entry.py", "cli.py",
                "__main__.py"):
        assert f"advanced_scrapper_tpu_torch/{rel}" in FILES, rel
    for name in NATIVE:
        assert (PORT / "native" / name).exists(), name


@pytest.mark.parametrize("rel", FILES)
def test_no_jax_or_reference_import(rel):
    tree = ast.parse((ROOT / rel).read_text(), filename=rel)
    bad = [m for m in _imported_modules(tree) if _forbidden(m)]
    assert not bad, f"{rel} imports {bad}"


#: drivers a module may import only inside the function that needs them
LAZY = ("psycopg2",)


@pytest.mark.parametrize("rel", FILES)
def test_no_module_level_driver_import(rel):
    """A database driver is imported where a store opens it, never when a
    port module is imported (the card's host has none)."""
    tree = ast.parse((ROOT / rel).read_text(), filename=rel)
    top = [n for n in tree.body if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                                      ast.ClassDef))]
    for cls in (n for n in tree.body if isinstance(n, ast.ClassDef)):
        top += [n for n in cls.body if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    names = [m for n in top for m in _imported_modules(n)]
    assert not [m for m in names if m.split(".")[0] in LAZY], f"{rel} imports {names}"


@pytest.mark.parametrize("rel", FILES)
def test_no_path_into_the_reference_package(rel):
    """No string in a port file's code (docstrings aside) is the JAX
    package's directory as a path component or a path to its native
    sources and libraries."""
    tree = ast.parse((ROOT / rel).read_text(), filename=rel)
    docs = {
        id(n.body[0].value) for n in ast.walk(tree)
        if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef))
        and n.body and isinstance(n.body[0], ast.Expr) and isinstance(n.body[0].value, ast.Constant)
    }
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docs:
            assert node.value != "advanced_scrapper_tpu", f"{rel}: a path component"
            assert not LOADABLE.search(node.value), f"{rel}: {node.value!r}"


def test_host_library_is_the_ports_own():
    from advanced_scrapper_tpu_torch.cpu import exactdedup, native

    ref = ROOT / "advanced_scrapper_tpu"
    for p in (native.SOURCE, native.library_path(), native.BUILD_DIR, exactdedup.SOURCE,
              native.library_path(exactdedup.SOURCE)):
        assert ref not in Path(p).resolve().parents, p
    assert native.SOURCE.resolve().is_relative_to(PORT)
    assert exactdedup.SOURCE.resolve().is_relative_to(PORT)


@pytest.mark.parametrize("name", NATIVE)
def test_native_sources_include_only_the_ports_headers(name):
    """A quoted ``#include`` of a port native source names a header beside
    it in the port's ``native/``, never one of the JAX package's."""
    text = (PORT / "native" / name).read_text()
    for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"', text, re.M):
        assert "/" not in inc and "\\" not in inc, inc
        assert (PORT / "native" / inc).exists(), inc
    assert not LOADABLE.search(text.replace("advanced_scrapper_tpu_torch", ""))


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
        "('jax', 'jaxlib', 'advanced_scrapper_tpu', 'pandas', 'dateutil', 'psycopg2')]\n"
        "assert not bad, bad\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
