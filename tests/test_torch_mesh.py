"""The port's device mesh (``core/mesh.py``), its axis collectives
(``parallel/collectives.py``) and the single-candidate LSH helpers
(``ops/lsh.py``: ``duplicate_reps``, ``resolve_reps``,
``bucket_histogram``) on the CPU, against the JAX package and numpy:
``build_mesh(4, 2, devices=["cpu"] * 8)`` is the port's counterpart of
the reference tests' 8-device virtual mesh."""

from __future__ import annotations

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_scrapper_tpu.core.mesh import build_mesh as ref_build_mesh
from advanced_scrapper_tpu.core.mesh import parse_mesh_shape as ref_parse
from advanced_scrapper_tpu.ops import lsh as ref_lsh
from advanced_scrapper_tpu_torch.core.hashing import make_params
from advanced_scrapper_tpu_torch.core.mesh import (
    ShardedArray,
    build_mesh,
    parse_mesh_shape,
    place,
)
from advanced_scrapper_tpu_torch.ops import lsh
from advanced_scrapper_tpu_torch.ops.minhash import minhash_signatures
from advanced_scrapper_tpu_torch.parallel import collectives as C

CPU8 = ["cpu"] * 8
#: the uint32 edge values the wire's sign-flip order must keep in order
EDGES = np.array([0, 2**31 - 1, 2**31, 2**32 - 1], np.uint32)



@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread for this module's torch work: the suite runs
    several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def u32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32)).view(torch.uint32)


def host(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32).numpy().view(np.uint32) if t.dtype == torch.uint32 else t.numpy()


@pytest.mark.parametrize("shape", [(4, 2), (8, 1), (2, 4), (1, 8), (-1, 1), (-1, 2)])
def test_build_mesh_shapes_match_the_reference(devices8, shape):
    ref = ref_build_mesh(*shape)
    got = build_mesh(*shape, devices=CPU8)
    assert dict(got.shape) == dict(ref.shape) and got.axis_names == ref.axis_names
    assert got.size == 8 and got.local == list(range(8))
    assert [s.device.type for s in got.shards] == ["cpu"] * 8
    assert got == build_mesh(*shape, devices=CPU8) and hash(got) == hash(build_mesh(
        *shape, devices=CPU8))


@pytest.mark.parametrize("shape", [(3, 2), (-1, 3), (5, 1), (2, 0)])
def test_build_mesh_errors_match_the_reference(devices8, shape):
    with pytest.raises(ValueError) as ref:
        ref_build_mesh(*shape)
    with pytest.raises(ValueError) as got:
        build_mesh(*shape, devices=CPU8)
    assert str(got.value) == str(ref.value)


def test_build_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_mesh(1, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_mesh(1, 1, devices=["cuda:0"])
    with pytest.raises(ValueError, match="unsupported device"):
        build_mesh(1, 1, devices=["meta"])


@pytest.mark.parametrize("spec", ["2x4", "8X1", " 1x1 ", "x", "2x", "axb", "0x4", "2x-1", "2x4x1"])
def test_parse_mesh_shape_matches_the_reference(spec):
    try:
        want = ref_parse(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_mesh_shape(spec)
        assert str(got.value) == str(e)
    else:
        assert parse_mesh_shape(spec) == want


@pytest.mark.parametrize("shape", [(4, 2), (8, 1), (2, 4), (1, 1)])
def test_place_and_numpy_round_trip(shape):
    mesh = build_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))
    x = np.arange(8 * 16, dtype=np.uint32).reshape(8, 16) * np.uint32(0x9E3779B1)
    for spec in [("data", None), ("data", "seq"), (None, "seq"), (("data", "seq"), None), ()]:
        a = place(mesh, x, spec)
        assert a.dtype == torch.uint32 and np.array_equal(a.numpy(), x), spec
    if mesh.size > 1:
        with pytest.raises(ValueError, match="does not split"):
            place(mesh, np.zeros((3, 16), np.uint8), (("data", "seq"), None))


def _shard_values(mesh, rng, dtype=np.uint32, shape=(4, 6)):
    """One array a shard: random words with the uint32 edge values mixed in."""
    vals = []
    for _ in range(mesh.size):
        a = rng.randint(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
        a.reshape(-1)[: len(EDGES)] = rng.permutation(EDGES)
        vals.append(a.astype(dtype))
    return vals


def _axis_groups(mesh, axes):
    """Numpy's view of the axis groups: global shard → its group's members."""
    out = {}
    for g in range(mesh.size):
        c = dict(zip(mesh.axis_names, mesh.coords(g)))
        key = tuple(c[a] for a in mesh.axis_names if a not in axes)
        out.setdefault(key, []).append(g)
    return {g: members for members in out.values() for g in members}


@pytest.mark.parametrize("shape", [(4, 2), (8, 1), (1, 1), (2, 4)])
@pytest.mark.parametrize("axes", [("data",), ("seq",), ("data", "seq")])
@pytest.mark.parametrize("op", ["min", "max", "sum"])
def test_reductions_match_numpy(shape, axes, op):
    mesh = build_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))
    rng = np.random.RandomState(zlib.crc32(repr((shape, axes, op)).encode()))
    if op == "sum":
        vals = [v.view(np.int32) for v in _shard_values(mesh, rng)]
        xs = [torch.from_numpy(v.copy()) for v in vals]
        got = C.psum(mesh, xs, axes)
        reduce = lambda arrs: np.sum(np.stack(arrs).astype(np.int64), 0).astype(np.int32)  # noqa: E731
    else:
        vals = _shard_values(mesh, rng)
        xs = [u32(v) for v in vals]
        got = (C.pmin if op == "min" else C.pmax)(mesh, xs, axes)
        reduce = (lambda arrs: np.min(np.stack(arrs), 0)) if op == "min" \
            else (lambda arrs: np.max(np.stack(arrs), 0))
    groups = _axis_groups(mesh, axes)
    for g in range(mesh.size):
        want = reduce([vals[m] for m in groups[g]])
        assert got[g].dtype == xs[g].dtype and np.array_equal(host(got[g]), want), (g, op)


def test_reductions_of_bool_int64_and_the_uint32_edges():
    mesh = build_mesh(4, 2, devices=CPU8)
    xs = [u32(np.roll(EDGES, g)) for g in range(8)]
    got = C.pmin(mesh, xs, "data")
    assert host(got[0]).tolist() == [0, 2**31 - 1, 0, 2**31 - 1]
    got = C.pmax(mesh, xs, ("data", "seq"))
    assert host(got[5]).tolist() == [2**32 - 1] * 4
    flags = [torch.tensor([g == 3, False]) for g in range(8)]
    assert [C.pmax(mesh, flags, "data")[g].tolist() for g in (0, 1)] == [[False, False],
                                                                        [True, False]]
    big = [torch.tensor([2**40 + g], dtype=torch.int64) for g in range(8)]
    assert int(C.psum(mesh, big, ("data", "seq"))[0]) == 8 * 2**40 + 28
    with pytest.raises(TypeError, match="psum of uint32"):
        C.psum(mesh, xs, "data")
    with pytest.raises(ValueError, match="no axis"):
        C.pmin(mesh, xs, "model")


@pytest.mark.parametrize("shape", [(4, 2), (8, 1), (2, 4), (1, 1)])
def test_all_gather_ppermute_and_axis_index(shape):
    mesh = build_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))
    dp, sp = shape
    rng = np.random.RandomState(5)
    vals = _shard_values(mesh, rng, shape=(3, 5))
    xs = [u32(v) for v in vals]
    for axis, n in (("data", dp), ("seq", sp)):
        a = mesh.axis_names.index(axis)
        idx = C.axis_index(mesh, axis)
        assert idx == [mesh.coords(g)[a] for g in range(mesh.size)]
        gathered = C.all_gather(mesh, xs, axis)
        groups = _axis_groups(mesh, (axis,))
        perm = [(i, (i + 1) % n) for i in range(n)]
        moved = C.ppermute(mesh, xs, axis, perm)
        partial = C.ppermute(mesh, xs, axis, perm[:1])  # one pair: the rest get zeros
        for g in range(mesh.size):
            want = np.concatenate([vals[m] for m in groups[g]])
            assert np.array_equal(host(gathered[g]), want)
            c = list(mesh.coords(g))
            c[a] = (c[a] - 1) % n
            assert np.array_equal(host(moved[g]), vals[mesh.index(c)])
            if mesh.coords(g)[a] == 1 % n:
                assert np.array_equal(host(partial[g]), vals[mesh.index(c)])
            else:
                assert not host(partial[g]).any()
    assert mesh.stats["calls"] == {} and mesh.stats["wire_bytes"] == 0  # one process


@pytest.fixture(scope="module")
def sigs_and_keys():
    """Signatures and coarse keys of a corpus with planted near copies,
    from the port's plain signatures (held to the reference's elsewhere)."""
    rng = np.random.RandomState(3)
    tok = rng.randint(32, 127, size=(96, 200)).astype(np.uint8)
    lens = rng.randint(0, 201, size=(96,)).astype(np.int32)
    lens[:4] = [0, 3, 4, 5]
    for a, b in ((10, 40), (11, 41), (12, 90), (40, 70)):
        tok[b] = tok[a]
        tok[b, 150:160] = rng.randint(32, 127, size=10)
        lens[b] = lens[a] = 200
    params = make_params()
    sig = minhash_signatures(torch.from_numpy(tok), torch.from_numpy(lens), params)
    keys = lsh.band_keys(sig, params.band_salt)
    return sig, keys, torch.from_numpy(lens >= params.shingle_k)


def test_duplicate_and_resolve_reps_match_the_reference(sigs_and_keys):
    sig, keys, valid = sigs_and_keys
    ref_keys = jnp.asarray(keys.numpy().astype(np.uint32))
    ref_valid = jnp.asarray(valid.numpy())
    want = np.asarray(ref_lsh.duplicate_reps(ref_keys, ref_valid))
    got = lsh.duplicate_reps(keys, valid)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert (want != np.arange(len(want))).sum() >= 4
    ref_sig = jnp.asarray(host(sig))
    for thr, rounds in ((0.7, 7), (0.5, 3), (0.95, 7), (0.0, 1)):
        want_r = np.asarray(ref_lsh.resolve_reps(jnp.asarray(want), ref_sig, ref_valid, thr,
                                                 jump_rounds=rounds))
        got_r = lsh.resolve_reps(got, sig, valid, thr, jump_rounds=rounds)
        assert got_r.dtype == torch.int32 and np.array_equal(got_r.numpy(), want_r), thr


@pytest.mark.parametrize("nbins", [1 << 16, 1 << 10, 7])
def test_bucket_histogram_matches_the_reference(sigs_and_keys, nbins):
    _sig, keys, valid = sigs_and_keys
    want = np.asarray(ref_lsh.bucket_histogram(
        jnp.asarray(keys.numpy().astype(np.uint32)), jnp.asarray(valid.numpy()), nbins=nbins))
    got = lsh.bucket_histogram(keys, valid, nbins=nbins)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert int(got.sum()) == int(valid.sum()) * keys.shape[1]


def test_sharded_array_rejects_a_wrong_piece_count():
    mesh = build_mesh(2, 1, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="pieces for"):
        ShardedArray(mesh, ("data",), [torch.zeros(2)], (4,))
