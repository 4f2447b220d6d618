"""The PyTorch port stands alone: no module of ``advanced_scrapper_tpu_torch``
and no card script beside it (``chip_smoke.py``, the probes) imports
``jax``, the JAX package, ``pandas``, ``dateutil`` or ``bs4`` (the card's
host has none of them), or ``psycopg2``, ``requests``, ``urllib3``,
``aiohttp``, ``selenium`` or ``undetected_chromedriver`` at module level
(the Postgres backend, the fetch transports, the async harvest and the
enrichment's session import their driver when they are opened), or names a
path into the JAX package from which a native source or library could be
loaded."""

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
#: the card scripts beside the package: the smoke run and the probes
SCRIPTS = ("chip_smoke.py", "myers_probe.py", "stream_probe.py", "oph_probe.py", "quality_probe.py",
           "lsh_probe.py", "join_probe.py")
FILES = sorted(
    str(p.relative_to(ROOT)) for p in [*PORT.rglob("*.py"), *(ROOT / s for s in SCRIPTS)]
)
FORBIDDEN = ("jax", "jaxlib", "advanced_scrapper_tpu", "pandas", "dateutil", "bs4",
             "soupsieve")
#: a path into the JAX package that names native code
LOADABLE = re.compile(
    r"advanced_scrapper_tpu(?!_torch)[/\\](?:native\b|.*\.(?:cpp|cc|h|so|cu)\b)")


#: the port's host C++ sources and headers
NATIVE = ("fastmatch.cpp", "exactdedup.cpp", "hostbatch.cpp", "csvscan.cpp", "bytehash.h")


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
    assert all(s in FILES and (ROOT / s).exists() for s in SCRIPTS)
    assert "advanced_scrapper_tpu_torch/pipeline/dedup.py" in FILES
    assert "advanced_scrapper_tpu_torch/ops/minhash_cuda.py" in FILES
    for rel in ("config.py", "core/dates.py", "cpu/fuzz.py", "cpu/native.py",
                "cpu/csvframe.py", "ops/match.py", "ops/match_cuda.py", "ops/editdist.py",
                "ops/editdist_cuda.py", "pipeline/matcher.py", "extractors/tpu_batch.py",
                "utils/bloom.py", "storage/fsio.py", "ops/exact.py", "cpu/exactdedup.py",
                "index/__init__.py", "index/wal.py", "index/segment.py", "index/store.py",
                "index/repair.py", "storage/backends.py", "storage/stores.py",
                "storage/csvio.py", "pipeline/cross_source.py", "entry.py", "cli.py",
                "__main__.py", "runtime/graph.py", "pipeline/dispatch.py",
                "pipeline/feed.py", "obs/perfdb.py", "ops/oph.py", "ops/oph_cuda.py",
                "obs/telemetry.py", "obs/trace.py", "obs/stages.py", "obs/devprof.py",
                "obs/profiler.py", "net/__init__.py", "net/rpc.py", "index/remote.py",
                "index/fleet.py", "index/reshard.py", "runtime/autoscaler.py",
                "service/__init__.py", "service/tenancy.py", "service/gateway.py",
                "core/mesh.py", "parallel/__init__.py", "parallel/collectives.py",
                "parallel/sharded.py", "parallel/sharded_packed.py", "parallel/ring.py",
                "parallel/dist.py", "core/soup.py", "extractors/__init__.py",
                "extractors/yfin.py", "extractors/template.py", "obs/stats.py",
                "obs/console.py", "cpu/csvnative.py", "net/webdriver.py", "net/transport.py",
                "pipeline/controllers.py", "pipeline/scraper.py", "pipeline/harvest.py",
                "pipeline/harvest_async.py", "utils/setops.py", "net/lease.py",
                "net/control.py", "net/pipe_pool.py", "net/pipe_worker.py", "net/chaos.py",
                "storage/progress.py", "storage/pgfake.py", "pipeline/enrich.py",
                "pipeline/poller.py", "obs/collector.py", "ops/exact_cuda.py",
                "ops/ring_cuda.py"):
        assert f"advanced_scrapper_tpu_torch/{rel}" in FILES, rel
    for name in NATIVE:
        assert (PORT / "native" / name).exists(), name


@pytest.mark.parametrize("rel", FILES)
def test_no_jax_or_reference_import(rel):
    tree = ast.parse((ROOT / rel).read_text(), filename=rel)
    bad = [m for m in _imported_modules(tree) if _forbidden(m)]
    assert not bad, f"{rel} imports {bad}"


#: drivers a module may import only inside the function that needs them
LAZY = ("psycopg2", "requests", "urllib3", "aiohttp", "selenium", "undetected_chromedriver")


def _reference_lint():
    """The reference's layer rules (``tools/lint_imports.py``, stdlib only)."""
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import lint_imports
    finally:
        sys.path.pop(0)
    return lint_imports


#: the layers whose rules the port holds as the reference's; ``ops/`` is a
#: known difference (``ops/_build.py`` counts builds on the obs plane)
LINT_LAYERS = ("index", "net", "parallel", "runtime", "service")
LINTED = [rel for rel in FILES if rel.startswith("advanced_scrapper_tpu_torch/")
          and Path(rel).parts[1] in LINT_LAYERS]


def _banned_imports(rel: str, text: str | None = None) -> list[str]:
    """The imports of port file ``rel`` that the reference's rules ban for
    its twin: the layer's banned layers (less the layer's allowed
    modules), or the stricter per-module rule where the reference has one;
    ``tools`` modules are banned to every port module.  ``text`` stands
    in for the file's source."""
    lint = _reference_lint()
    pkg = "advanced_scrapper_tpu_torch"
    inner = str(Path(*Path(rel).parts[1:]))
    layer = Path(rel).parts[1]
    banned = lint.RULES.get(layer, ())
    allowed = tuple(a.replace(lint.PACKAGE, pkg, 1) for a in lint.ALLOW.get(layer, ()))
    rule = lint.MODULE_RULES.get(inner)
    if rule is not None:
        extra, honor_allow = rule
        banned = tuple(dict.fromkeys(banned + extra))
        allowed = allowed if honor_allow else ()
    tree = ast.parse((ROOT / rel).read_text() if text is None else text, filename=rel)
    bad = []
    for mod in _imported_modules(tree):
        if mod == "tools" or mod.startswith("tools.") or mod in ("lint_imports", "loadgen"):
            bad.append(mod)
            continue
        if any(mod == a or mod.startswith(a + ".") for a in allowed):
            continue
        bad += [mod for t in banned if mod == f"{pkg}.{t}" or mod.startswith(f"{pkg}.{t}.")]
    return bad


@pytest.mark.parametrize("rel", sorted(set(LINTED) | {
    f"advanced_scrapper_tpu_torch/{m}" for m in ("ops/rerank.py", "obs/decisions.py",
                                                  "obs/canary.py", "core/mesh.py",
                                                  "core/soup.py")}))
def test_reference_layer_rules_hold(rel):
    assert not _banned_imports(rel), f"{rel} imports {_banned_imports(rel)}"


def test_elastic_modules_keep_their_stricter_rules():
    """``index/reshard.py`` imports nothing from ``net/`` (not even the
    ``net.rpc`` the rest of ``index/`` uses), ``runtime/autoscaler.py``
    nothing from ``index/``, ``net/`` or ``tools/``, and
    ``service/tenancy.py`` nothing from ``net/``, ``storage/`` or ``obs/``;
    the rules bite (a banned import planted in a copy is reported)."""
    lint = _reference_lint()
    for inner, must in (("index/reshard.py", ("net",)),
                        ("runtime/autoscaler.py", ("index", "net")),
                        ("service/tenancy.py", ("net", "storage", "obs"))):
        extra, honor_allow = lint.MODULE_RULES[inner]
        assert set(must) <= set(extra) and not honor_allow, inner
        assert not _banned_imports(f"advanced_scrapper_tpu_torch/{inner}")
    planted = ("from advanced_scrapper_tpu_torch.net.rpc import RpcClient\n"
               "import tools.loadgen\n")
    assert _banned_imports("advanced_scrapper_tpu_torch/index/reshard.py", planted) == [
        "advanced_scrapper_tpu_torch.net.rpc", "tools.loadgen"]
    assert _banned_imports("advanced_scrapper_tpu_torch/index/fleet.py", planted) == [
        "tools.loadgen"]


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
    from advanced_scrapper_tpu_torch.cpu import csvnative

    for p in (native.SOURCE, native.library_path(), native.BUILD_DIR, exactdedup.SOURCE,
              native.library_path(exactdedup.SOURCE), csvnative.SOURCE,
              native.library_path(csvnative.SOURCE)):
        assert ref not in Path(p).resolve().parents, p
    assert native.SOURCE.resolve().is_relative_to(PORT)
    assert exactdedup.SOURCE.resolve().is_relative_to(PORT)
    assert csvnative.SOURCE.resolve().is_relative_to(PORT)


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
        "('jax', 'jaxlib', 'advanced_scrapper_tpu', 'pandas', 'dateutil', 'psycopg2', "
        "'bs4', 'soupsieve', 'requests', 'selenium', 'undetected_chromedriver')]\n"
        "assert not bad, bad\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_parallel_imports_only_core_and_ops():
    """The mesh's ``parallel/`` is device math: like the reference's, it
    imports nothing of ``pipeline``, ``net``, ``index`` or ``runtime``
    (the rule bites on a planted import), and in fact only ``core``,
    ``ops``, ``config`` and itself of the port."""
    lint = _reference_lint()
    assert set(lint.RULES["parallel"]) == {"pipeline", "net", "index", "runtime"}
    planted = ("from advanced_scrapper_tpu_torch.pipeline.dispatch import PipelinedDispatcher\n"
               "import advanced_scrapper_tpu_torch.runtime.graph\n")
    assert _banned_imports("advanced_scrapper_tpu_torch/parallel/sharded.py", planted) == [
        "advanced_scrapper_tpu_torch.pipeline.dispatch", "advanced_scrapper_tpu_torch.runtime.graph"]
    pkg = "advanced_scrapper_tpu_torch"
    for rel in (r for r in FILES if r.startswith(f"{pkg}/parallel/")):
        tree = ast.parse((ROOT / rel).read_text(), filename=rel)
        for mod in _imported_modules(tree):
            if mod.startswith(pkg + "."):
                assert mod.split(".")[1] in ("core", "ops", "config", "parallel"), (rel, mod)
