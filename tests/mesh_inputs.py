"""Inputs of the mesh parity tests, made from fixed seeds so that a
test process and each rank of a world (``torch_multihost_worker.py``)
make the same arrays."""

from __future__ import annotations

import numpy as np

from advanced_scrapper_tpu_torch.core.tokenizer import encode_batch, encode_blocks


def multihost_batch(ranks: int, b_local: int = 8, width: int = 256) -> tuple[np.ndarray, int]:
    """The reference worker's batch: ``ranks × b_local`` rows from seed 7,
    the last rank's row 4 a copy of rank 0's row 3."""
    rng = np.random.RandomState(7)
    corpus = rng.randint(32, 127, size=(ranks * b_local, width)).astype(np.uint8)
    dup_row = (ranks - 1) * b_local + 4
    corpus[dup_row] = corpus[3]
    return corpus, dup_row


def batch() -> tuple[np.ndarray, np.ndarray]:
    """32 rows of a 256-byte block: copies across data shards, an empty
    and a sub-shingle row, rows ending inside every seq shard."""
    rng = np.random.RandomState(9)
    texts = [rng.randint(32, 127, size=int(rng.randint(30, 257)), dtype=np.uint8).tobytes()
             for _ in range(32)]
    texts[10], texts[25], texts[30], texts[31] = texts[4], texts[2][:-9] + b"x" * 9, b"", b"abc"
    return encode_batch(texts, block_len=256)


def blocks() -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Blockwise rows of 24 ragged articles in 128-byte blocks, padded to
    128 rows owned by the scratch article 32."""
    rng = np.random.RandomState(4)
    docs = [rng.randint(32, 127, size=int(rng.randint(0, 400)), dtype=np.uint8).tobytes()
            for _ in range(24)]
    docs[13], docs[20] = docs[2], docs[9]
    tok, lens, owners = encode_blocks(docs, 128, overlap=4)
    pad = 128 - tok.shape[0]
    return (np.concatenate([tok, np.zeros((pad, 128), np.uint8)]),
            np.concatenate([lens, np.zeros((pad,), np.int32)]),
            np.concatenate([owners.astype(np.int32), np.full((pad,), 32, np.int32)]), 32)


def ring_batch() -> tuple[np.ndarray, np.ndarray]:
    """64 full rows with exact and near copies across shards, a chain and
    two short rows."""
    rng = np.random.RandomState(0)
    tok = rng.randint(32, 127, size=(64, 256)).astype(np.uint8)
    lens = np.full((64,), 256, np.int32)
    for a, b in ((0, 9), (3, 40), (17, 63), (20, 21), (2, 30), (30, 55)):
        tok[b] = tok[a]
        if (a + b) % 2:
            tok[b, -4:] = rng.randint(32, 127, size=4)
    lens[5], lens[6] = 0, 3
    return tok, lens


def corpus(n: int = 48) -> list[bytes]:
    """Ragged documents: edge lengths, blockwise ones, planted copies."""
    rng = np.random.RandomState(3)
    docs: list[bytes] = []
    for i, ln in enumerate([0, 1, 4, 63, 64, 65, 128, 2049] + [None] * (n - 8)):
        if ln is None and rng.rand() < 0.25:
            docs.append(docs[rng.randint(0, i)])
            continue
        ln = int(rng.randint(5, 3000)) if ln is None else ln
        docs.append(rng.randint(32, 127, size=ln, dtype=np.uint8).tobytes())
    return docs
