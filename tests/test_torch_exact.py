"""The port's exact dedup on the CPU against the JAX package's:
``ops/exact.py:ExactHasher`` (hashes bit-equal across block lengths and on
documents of several blocks), ``pipeline/dedup.py:ExactDedup`` (kept
indices, masks and ``last_path`` equal to the JAX package's and to pandas
``drop_duplicates`` on every tier, the forced grouping path included), the
two native tiers, and the port's host C++ builder."""

from __future__ import annotations

import shutil

import numpy as np
import pandas as pd
import pytest
import torch

import advanced_scrapper_tpu.cpu.exactdedup as ref_zero_copy
from advanced_scrapper_tpu.cpu.hostbatch import exact_keep_first_native as ref_blob
from advanced_scrapper_tpu.ops.exact import ExactHasher as RefHasher
from advanced_scrapper_tpu.pipeline.dedup import ExactDedup as RefExactDedup
from advanced_scrapper_tpu_torch.cpu import exactdedup, native
from advanced_scrapper_tpu_torch.cpu.hostbatch import exact_keep_first_native
from advanced_scrapper_tpu_torch.ops.exact import MAX_DOC_LEN, ExactHasher
from advanced_scrapper_tpu_torch.pipeline.dedup import ExactDedup


class AllCollide:
    """A degenerate hasher: every row in one hash group, which forces the
    grouping path and its string confirm."""

    def hash_docs(self, raw, *, block_len=4096):
        return np.zeros((len(raw), 4), np.uint32)


def _pandas_keep(items) -> list[int]:
    return pd.DataFrame({"u": items}).drop_duplicates(subset=["u"]).index.tolist()


def _pandas_holds(items) -> bool:
    """pandas' string columns hold neither bytes nor lone surrogates."""
    return all(isinstance(x, str) for x in items) and not any(
        0xD800 <= ord(c) <= 0xDFFF for x in items for c in x)


def _first_seen(items) -> list[int]:
    seen: set = set()
    return [i for i, x in enumerate(items) if x not in seen and not seen.add(x)]


def _urls(rng: np.random.RandomState, n: int) -> list[str]:
    pool = [f"https://ex.com/{i}/{'x' * int(rng.randint(0, 9))}" for i in range(n // 2)]
    return [pool[rng.randint(len(pool))] for _ in range(n)]


# -- ExactHasher ---------------------------------------------------------------


@pytest.fixture(scope="module")
def hashers():
    return RefHasher(), ExactHasher(device="cpu")


@pytest.mark.parametrize("block_len", [8, 16, 64, 128, 1024, 4096])
def test_hash_docs_equals_reference(hashers, block_len):
    """Documents of 0 to 9,000 bytes, many spanning several blocks."""
    rng = np.random.RandomState(block_len)
    raw = [rng.randint(0, 256, size=int(rng.choice([0, 1, 5, 63, 64, 65, 700, 9000])),
                       dtype=np.uint8).tobytes() for _ in range(60)]
    raw += [b"", b"\x00", b"ab", b"ab\x00", b"x" * 5000]
    ref, port = hashers
    got = port.hash_docs(raw, block_len=block_len)
    assert got.dtype == np.uint32 and got.shape == (len(raw), 4)
    assert np.array_equal(got, ref.hash_docs(raw, block_len=block_len))


def test_hash_docs_does_not_depend_on_the_block_length(hashers):
    _ref, port = hashers
    raw = [b"y" * 123, b"z" * 4097, b"", b"q"]
    first = port.hash_docs(raw, block_len=16)
    for bl in (32, 256, 8192):
        assert np.array_equal(port.hash_docs(raw, block_len=bl), first)


def test_row_hash_equals_reference(hashers):
    import jax.numpy as jnp

    ref, port = hashers
    rng = np.random.RandomState(3)
    tok = rng.randint(0, 256, size=(40, 96), dtype=np.uint8)
    lens = rng.randint(0, 97, size=40).astype(np.int32)
    tok[np.arange(96)[None, :] >= lens[:, None]] = 0
    want = np.asarray(ref(jnp.asarray(tok), jnp.asarray(lens)))
    got = port(tok, lens)
    assert got.dtype == torch.uint32
    assert np.array_equal(got.view(torch.int32).numpy().view(np.uint32), want)


def test_hash_docs_rejects_an_item_past_max_doc_len():
    with pytest.raises(ValueError, match="MAX_DOC_LEN"):
        ExactHasher(device="cpu").hash_docs([b"x" * (MAX_DOC_LEN + 1)])


def test_default_hasher_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ExactHasher()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ExactDedup()


# -- ExactDedup ------------------------------------------------------------------

#: the cases of the JAX package's exact-dedup tests: unicode, lone
#: surrogates, mixed str/bytes, items past the block width, truncated
#: prefixes, collision groups
CASES = {
    "surrogates": ["a\ud800", "a\ud801", "a\ud800"],
    "accents": ["é", "e", "é", "é"],
    "long-unicode": ["ü" * 3000, "ü" * 3000 + "x", "ü" * 3000],
    "bytes": [b"a", b"b", b"a"],
    "mixed": ["a", b"a", "a", b"a"],
    "beyond-block": ["z" * 40 + "tail", "short", "z" * 40 + "tail", "z" * 40 + "tai!", "short"],
    "truncated-prefix": ["p" * 100 + "alpha", "p" * 100 + "beta", "p" * 100 + "alpha", "p" * 100],
    "collisions": ["a", "b", "a", "c", "b", "a", "d", "c"],
    "empty-strings": ["", "a", "", "a", ""],
    "urls": _urls(np.random.RandomState(5), 400),
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("route", ["default", "max_len=16", "all-collide"])
def test_exact_dedup_equals_reference_and_pandas(name, route):
    items = CASES[name]
    if route == "all-collide":
        ref, port = RefExactDedup(hasher=AllCollide()), ExactDedup(hasher=AllCollide())
    elif route == "max_len=16":
        ref, port = RefExactDedup(max_len=16), ExactDedup(max_len=16, device="cpu")
    else:
        ref, port = RefExactDedup(), ExactDedup(device="cpu")
    want = ref.keep_indices(items)
    got = port.keep_indices(items)
    assert got == want == _first_seen(items)
    if _pandas_holds(items):
        assert got == _pandas_keep(items)
    assert port.last_path == ref.last_path
    mask = port.keep_mask(items)
    assert mask.dtype == bool and np.array_equal(mask, ref.keep_mask(items))


def test_grouping_path_with_the_ports_hasher():
    """A caller-supplied hasher pins the grouping path; collisions of
    ``to_bytes`` (lone surrogates) are settled by the string compare."""
    for name, items in sorted(CASES.items()):
        port = ExactDedup(hasher=ExactHasher(device="cpu"), max_len=16)
        assert port.keep_indices(items) == _first_seen(items), name
        assert port.last_path == "grouping"


def test_last_path_per_route():
    eng = ExactDedup(device="cpu")
    assert eng.keep_indices([]) == [] and eng.last_path == ""
    eng.keep_indices(["a", "b", "a"])
    assert eng.last_path == ("zero-copy" if exactdedup.exactdedup_backend() == "native" else "blob")
    eng.keep_indices(("a", "b", "a"))  # not a list: the blob tier
    assert eng.last_path == "blob"
    eng.keep_indices(["a", b"a"])  # mixed: the grouping path
    assert eng.last_path == "grouping"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_tiers_equal_reference(seed):
    items = _urls(np.random.RandomState(seed), 3000)
    want = _pandas_keep(items)
    got_blob = exact_keep_first_native(items)
    assert got_blob.dtype == np.uint8
    assert np.flatnonzero(got_blob).tolist() == want
    assert np.array_equal(got_blob, ref_blob(items))
    got_zero = exactdedup.keep_first_list(items)
    assert np.flatnonzero(got_zero).tolist() == want
    assert np.array_equal(got_zero, ref_zero_copy.keep_first_list(items))


def test_native_tiers_route_inputs_on():
    assert exactdedup.keep_first_list(("a", "b")) is None  # a non-list
    assert exactdedup.keep_first_list(["a", b"a"]) is None  # mixed
    assert exactdedup.keep_first_list(["a\ud800"]) is None  # no UTF-8 view
    assert exact_keep_first_native(["a", b"a"]) is None
    assert np.flatnonzero(exact_keep_first_native(CASES["surrogates"])).tolist() == [0, 1]


def test_zero_copy_tier_is_live_here():
    assert exactdedup.exactdedup_backend() == "native"
    assert exactdedup.backend_reason() == ""


def test_missing_headers_turn_the_zero_copy_tier_off(monkeypatch):
    monkeypatch.setattr(exactdedup, "_backend", "unloaded")
    monkeypatch.setattr(exactdedup, "_lib", None)
    monkeypatch.setattr(exactdedup.sysconfig, "get_paths", lambda: {"include": "/nonexistent"})
    assert exactdedup.keep_first_list(["a", "a"]) is None
    assert "Python.h" in exactdedup.backend_reason()
    eng = ExactDedup(device="cpu")
    assert eng.keep_indices(["a", "b", "a"]) == [0, 1]
    assert eng.last_path == "blob"


# -- the host C++ builder --------------------------------------------------------


@pytest.mark.parametrize("name,extra", [
    ("fastmatch.cpp", []), ("hostbatch.cpp", []), ("exactdedup.cpp", ["include"]),
])
def test_builder_builds_each_named_source_under_a_hashed_name(tmp_path, name, extra):
    """A copy of the source (and its quoted headers) in ``tmp_path`` builds
    into ``build/host/`` as ``lib<stem>-<hash>.so``; the hash covers the
    source, its headers and the flags."""
    src_dir = native.PACKAGE_DIR / "native"
    for f in [name, *([] if name == "fastmatch.cpp" else ["bytehash.h"])]:
        shutil.copy(src_dir / f, tmp_path / f)
    src = tmp_path / name
    flags = exactdedup.flags() if extra else native.CXX_FLAGS
    lib = native.build(src, flags)
    assert lib == native.library_path(src, flags)
    assert lib.parent == native.BUILD_DIR and lib.exists()
    stem, digest = lib.stem.rsplit("-", 1)
    assert stem == f"lib{src.stem}" and len(digest) == 16
    assert native.library_path(src_dir / name, flags) == lib  # same bytes, same name
    assert native.library_path(src, [*flags, "-DX"]) != lib
    if name != "fastmatch.cpp":
        (tmp_path / "bytehash.h").write_text("// edited\n" + (src_dir / "bytehash.h").read_text())
        assert native.library_path(src, flags) != lib  # an edited header rebuilds


def test_builder_raises_on_a_broken_source(tmp_path, monkeypatch):
    """A source that fails to compile raises with g++'s output, and the
    zero-copy tier raises with it rather than routing to the blob tier."""
    src = tmp_path / "exactdedup.cpp"
    src.write_text((native.PACKAGE_DIR / "native" / "exactdedup.cpp").read_text()
                   + "\nthis is not C++;\n")
    shutil.copy(native.PACKAGE_DIR / "native" / "bytehash.h", tmp_path / "bytehash.h")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on exactdedup.cpp"):
        native.build(src, exactdedup.flags())
    assert not native.library_path(src, exactdedup.flags()).exists()
    monkeypatch.setattr(exactdedup, "SOURCE", src)
    monkeypatch.setattr(exactdedup, "_backend", "unloaded")
    monkeypatch.setattr(exactdedup, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        ExactDedup(device="cpu").keep_indices(["a", "b", "a"])


def test_build_dir_is_git_ignored():
    root = native.PACKAGE_DIR.parent
    assert native.BUILD_DIR.relative_to(root).parts[0] == "build"
    lines = (root / ".gitignore").read_text().split()
    assert "build/" in lines, "build/host/ must stay out of git"
