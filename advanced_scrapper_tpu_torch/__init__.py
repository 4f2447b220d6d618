"""PyTorch and CUDA port of the near-duplicate dedup path, the streaming
dedup backend with its persistent index, cross-source dedup and the
ticker→article matcher, for one NVIDIA H100, with the reference's entry
points: ``entry.py:entry()`` and the CLI ``cli.py`` (``astpu-torch``).

The JAX package ``advanced_scrapper_tpu`` is the reference; this package
mirrors its module names (``config``, ``core``, ``cpu``, ``ops``,
``pipeline``, ``extractors``, ``index``, ``storage``) so each counterpart
is easy to find, and imports nothing of
it.  Four hand-written CUDA sources live in ``csrc/``: ``minhash.cu``
(the MinHash fold, in place of the Pallas kernel
``ops/pallas_minhash.py:_minhash_kernel``), ``rerank.cu`` (the rerank
tier's sketch-Jaccard settle), ``match.cu`` (the matcher's q-gram screen)
and ``editdist.cu`` (the matcher's Myers bound over every pattern, and
per pair for the legacy screen); the last three replace jnp device code
of the reference.

``core/mesh.py`` and ``parallel/`` run the sharded paths over a
``(data, seq)`` mesh of shards, in one process or a ``torch.distributed``
world.

Entry points run on the card: a ``device`` of ``None`` means ``"cuda"``
and raises when CUDA is not available.  Pass ``device="cpu"`` to run the
plain PyTorch versions of every kernel, as the tests do.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

__version__ = "0.5.0"

if TYPE_CHECKING:
    import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → ``cuda``; a CUDA device without a card raises (the port
    never drops to the CPU on its own)."""
    import torch  # here, not at the top: the matcher's verify workers never load it

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU; pass "
            "device='cpu' to run its plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use cuda or cpu")
    return dev
