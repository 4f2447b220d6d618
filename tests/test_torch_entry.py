"""The port's entry point (``advanced_scrapper_tpu_torch/entry.py``)
against the JAX package's ``__graft_entry__.entry``: the same example
batch, and the dedup step's representatives equal to the jitted
reference's on the CPU, the planted copy resolved to its source."""

from __future__ import annotations

import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import __graft_entry__ as graft  # noqa: E402
import advanced_scrapper_tpu as ref_pkg  # noqa: E402
import advanced_scrapper_tpu_torch as port_pkg  # noqa: E402
from advanced_scrapper_tpu_torch import entry  # noqa: E402


def test_example_batch_is_the_reference_batch():
    for seed in (0, 3):
        for got, want in zip(entry._example_batch(64, 256, seed),
                             graft._example_batch(64, 256, seed)):
            assert got.dtype == want.dtype and np.array_equal(got, want)


def test_entry_equals_the_jitted_reference():
    fn, (tok, lengths) = entry.entry(device="cpu")
    ref_fn, ref_args = graft.entry()
    assert tok.device.type == "cpu" and tok.shape == (256, 1024) and tok.dtype == torch.uint8
    assert np.array_equal(tok.numpy(), ref_args[0])
    assert np.array_equal(lengths.numpy(), ref_args[1])
    out = fn(tok, lengths)
    want = np.asarray(jax.jit(ref_fn)(*ref_args))
    assert out.dtype == torch.int32 and np.array_equal(out.numpy(), want)
    assert int(out[128]) == 0 and (out.numpy() != np.arange(256)).sum() == 1


def test_entry_on_an_absent_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.entry()


def test_dryrun_multichip_names_its_slice():
    """The sharded dry run, once a raise naming the mesh slice: on CPU
    shards the sharded step and the packed plane equal the one-shard
    results and every planted family resolves; without a card the default
    device raises."""
    report = entry.dryrun_multichip(4, device="cpu")
    assert report["shards"] == 4 and report["distinct_devices"] == 1
    assert report["devices"] == ["cpu"] and report["dups"] == 48
    assert report["hist_sum"] == 256 * 16 and report["tile_groups"] >= 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry.dryrun_multichip(4)


def test_version_is_the_references():
    assert port_pkg.__version__ == ref_pkg.__version__
