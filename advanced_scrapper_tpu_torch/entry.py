"""The port's entry point, the counterpart of the reference's
``__graft_entry__.py``.

:func:`entry` returns ``(fn, example_args)``: the flagship dedup step of
one batch (MinHash signatures → coarse + fine candidate keys → per-band
candidate representatives → verified union-find labels) and a batch of
256 rows of 1,024 bytes from ``RandomState(0)``, row 128 a copy of row 0.
On the card the signatures are one launch of the CUDA kernel
``minhash_sig`` (``csrc/minhash.cu``); the epilogue is plain PyTorch, as
the engine runs it.  ``device="cpu"`` runs every stage's plain version.
"""

from __future__ import annotations

import numpy as np

from advanced_scrapper_tpu_torch.pipeline.dedup import SLICE_MESH


def _example_batch(batch: int, block: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """``uint8[batch, block]`` printable bytes and ``int32[batch]`` lengths
    in ``[block/2, block)``, row ``batch // 2`` a copy of row 0."""
    rng = np.random.RandomState(seed)
    tok = rng.randint(32, 127, size=(batch, block)).astype(np.uint8)
    lengths = rng.randint(block // 2, block, size=(batch,)).astype(np.int32)
    tok[batch // 2] = tok[0]
    lengths[batch // 2] = lengths[0]
    return tok, lengths


def entry(device=None):
    """``(fn, (tokens, lengths))``: ``fn(tokens, lengths)`` gives each
    row's representative, ``int32[256]``, the planted copy's its source's.
    ``device`` None means ``cuda`` (and raises without a card)."""
    import torch

    from advanced_scrapper_tpu_torch import resolve_device
    from advanced_scrapper_tpu_torch.config import DedupConfig
    from advanced_scrapper_tpu_torch.core.hashing import make_params
    from advanced_scrapper_tpu_torch.ops.lsh import (
        candidate_keys,
        duplicate_rep_bands,
        resolve_rep_bands,
    )
    from advanced_scrapper_tpu_torch.ops.minhash import minhash_signatures

    dev = resolve_device(device)
    params = make_params()
    n_subbands = DedupConfig().cand_subbands  # in lockstep with the engine

    def dedup_step(tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        sig = minhash_signatures(tokens, lengths, params)
        keys = candidate_keys(sig, params.band_salt, n_subbands)
        valid = lengths >= params.shingle_k
        rep_bands = duplicate_rep_bands(keys, valid)
        return resolve_rep_bands(rep_bands, sig, valid, 0.7, jump_rounds=8)

    tok, lengths = _example_batch(batch=256, block=1024)
    return dedup_step, (torch.from_numpy(tok).to(dev), torch.from_numpy(lengths).to(dev))


def dryrun_multichip(n_devices: int) -> None:
    """The reference's sharded dry run over an ``n_devices`` mesh."""
    raise NotImplementedError(f"dryrun_multichip is {SLICE_MESH}")
