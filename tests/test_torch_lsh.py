"""The port's LSH stages against the JAX package's ``ops.lsh``: band keys,
coarse+fine keys, per-band candidates (tied keys, invalid rows), fine-edge
thresholds and union-find resolution.  All exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_scrapper_tpu.core.hashing import make_params as ref_make_params
from advanced_scrapper_tpu.ops import lsh as ref_lsh
from advanced_scrapper_tpu_torch.core.hashing import make_params
from advanced_scrapper_tpu_torch.ops import lsh

B = 256
NUM_COARSE = 16


@pytest.fixture(scope="module")
def data():
    """Signatures with exact duplicates (tied keys in every band), near
    copies (ties in some bands only) and invalid rows."""
    rng = np.random.RandomState(0)
    sig = rng.randint(0, 1 << 32, size=(B, 128), dtype=np.uint64).astype(np.uint32)
    for i in range(8, B):
        r = rng.rand()
        if r < 0.15:
            sig[i] = sig[rng.randint(0, i)]
        elif r < 0.45:
            src = rng.randint(0, i)
            keep = rng.rand(128) < rng.uniform(0.55, 0.95)
            sig[i] = np.where(keep, sig[src], sig[i])
    sig[5] = sig[3]  # both invalid below: must not merge
    valid = rng.rand(B) > 0.05
    valid[[3, 5]] = False
    return sig, valid


def _t(sig: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(sig.view(np.int32).copy()).view(torch.uint32)


def test_band_keys_and_candidate_keys(data):
    sig, _ = data
    ref = ref_make_params()
    salt = make_params().band_salt
    got = lsh.band_keys(_t(sig), salt)
    want = ref_lsh.band_keys(jnp.asarray(sig), jnp.asarray(ref.band_salt))
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    assert np.array_equal(lsh.subband_salt(32), ref_lsh.subband_salt(32))
    for cs in (0, 32):
        fine = lsh.subband_salt(cs) if cs else np.zeros((0,), np.uint32)
        got = lsh._coarse_fine_keys(_t(sig), salt, fine)
        want = ref_lsh.candidate_keys(jnp.asarray(sig), ref.band_salt, cs)
        assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64)), cs


@pytest.fixture(scope="module")
def keyed(data):
    sig, valid = data
    salt = make_params().band_salt
    keys = lsh._coarse_fine_keys(_t(sig), salt, lsh.subband_salt(32))
    return sig, valid, keys


def test_duplicate_rep_bands(keyed):
    sig, valid, keys = keyed
    got = lsh.duplicate_rep_bands(keys, torch.from_numpy(valid))
    want = ref_lsh.duplicate_rep_bands(
        jnp.asarray(keys.numpy().astype(np.uint32)), jnp.asarray(valid)
    )
    assert got.dtype == torch.int32 and got.shape == (B, 3 * 48)
    assert np.array_equal(got.numpy(), np.asarray(want))
    # every row keeps itself as a candidate only when invalid or unmatched
    assert (got.numpy()[~valid] == np.arange(B)[~valid, None]).all()


@pytest.mark.parametrize("fine_margin", [0.0, 0.05])
def test_fine_edge_thresholds(keyed, fine_margin):
    sig, valid, keys = keyed
    rb = lsh.duplicate_rep_bands(keys, torch.from_numpy(valid))
    got = lsh.fine_edge_thresholds(rb, keys, 0.7, fine_margin, num_coarse=NUM_COARSE)
    want = ref_lsh.fine_edge_thresholds(
        jnp.asarray(rb.numpy()), jnp.asarray(keys.numpy().astype(np.uint32)),
        0.7, fine_margin, num_coarse=NUM_COARSE,
    )
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want))
    if fine_margin:
        assert (got.numpy() > np.float32(0.7)).any()  # some fine-only edges


@pytest.mark.parametrize("threshold", [0.7, 0.5, "per_edge"])
def test_resolve_rep_bands(keyed, threshold):
    sig, valid, keys = keyed
    rb = lsh.duplicate_rep_bands(keys, torch.from_numpy(valid))
    if threshold == "per_edge":
        thr = lsh.fine_edge_thresholds(rb, keys, 0.7, 0.05, num_coarse=NUM_COARSE)
        ref_thr = jnp.asarray(thr.numpy())
    else:
        thr = ref_thr = threshold
    got = lsh.resolve_rep_bands(rb, _t(sig), torch.from_numpy(valid), thr, jump_rounds=8)
    want = ref_lsh.resolve_rep_bands(
        jnp.asarray(rb.numpy()), jnp.asarray(sig), jnp.asarray(valid), ref_thr,
        jump_rounds=8,
    )
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != np.arange(B)).sum() > 10  # real merges happened
    assert got[5] == 5 and got[3] == 3  # invalid twins stay apart
    keep = lsh.keep_mask(got)
    assert np.array_equal(keep.numpy(), np.asarray(ref_lsh.keep_mask(jnp.asarray(got.numpy()))))


@pytest.mark.parametrize("fine_margin", [0.0, 0.05])
def test_fused_resolve_epilogue(data, fine_margin):
    sig, valid = data
    ref = ref_make_params()
    kw = dict(num_coarse=NUM_COARSE, jump_rounds=8, use_fine_margin=bool(fine_margin))
    got = lsh.fused_resolve_epilogue(
        _t(sig), torch.from_numpy(valid), make_params().band_salt,
        lsh.subband_salt(32), 0.7, fine_margin, **kw,
    )
    want = ref_lsh.fused_resolve_epilogue(
        jnp.asarray(sig), jnp.asarray(valid), np.asarray(ref.band_salt),
        ref_lsh.subband_salt(32), 0.7, fine_margin, densify_oph=False, **kw,
    )
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cand_subbands", [32, 0])
def test_fused_candidate_epilogue(data, cand_subbands):
    sig, valid = data
    fine = lsh.subband_salt(cand_subbands) if cand_subbands else np.zeros((0,), np.uint32)
    got_sig, got_keys, got_rb = lsh.fused_candidate_epilogue(
        _t(sig), torch.from_numpy(valid), make_params().band_salt, fine
    )
    want_sig, want_keys, want_rb = ref_lsh.fused_candidate_epilogue(
        jnp.asarray(sig), jnp.asarray(valid), np.asarray(ref_make_params().band_salt),
        fine, densify_oph=False,
    )
    assert np.array_equal(got_sig.view(torch.int32).numpy().view(np.uint32), np.asarray(want_sig))
    assert np.array_equal(got_keys.numpy(), np.asarray(want_keys).astype(np.int64))
    assert got_rb.dtype == torch.int32
    assert np.array_equal(got_rb.numpy(), np.asarray(want_rb))


@pytest.mark.parametrize("cand_subbands", [32, 0])
def test_borderline_edge_mask_and_resolve_from_ok(data, cand_subbands):
    """Exact verify's device half at band 0.72: the flagged and verified
    edge matrices, then resolution of an ``ok`` matrix edited on the host
    (every third flagged edge refuted)."""
    sig, valid = data
    fine = lsh.subband_salt(cand_subbands) if cand_subbands else np.zeros((0,), np.uint32)
    keys = lsh._coarse_fine_keys(_t(sig), make_params().band_salt, fine)
    rb = lsh.duplicate_rep_bands(keys, torch.from_numpy(valid))
    need, ok = lsh.borderline_edge_mask(
        rb, _t(sig), keys, torch.from_numpy(valid), 0.7, 0.72, num_coarse=NUM_COARSE
    )
    ref_args = (
        jnp.asarray(rb.numpy()), jnp.asarray(sig),
        jnp.asarray(keys.numpy().astype(np.uint32)), jnp.asarray(valid), 0.7, 0.72,
    )
    want_need, want_ok = ref_lsh.borderline_edge_mask(*ref_args, num_coarse=NUM_COARSE)
    assert need.dtype == ok.dtype == torch.bool
    assert np.array_equal(need.numpy(), np.asarray(want_need))
    assert np.array_equal(ok.numpy(), np.asarray(want_ok))
    assert need.any() and (ok & ~need).any()
    edited = ok.numpy().copy()
    r, c = np.nonzero(need.numpy())
    edited[r[::3], c[::3]] = False
    got = lsh.resolve_rep_bands_from_ok(
        rb, torch.from_numpy(edited), torch.from_numpy(valid), jump_rounds=8
    )
    want = ref_lsh.resolve_rep_bands_from_ok(
        jnp.asarray(rb.numpy()), jnp.asarray(edited), jnp.asarray(valid), jump_rounds=8
    )
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
