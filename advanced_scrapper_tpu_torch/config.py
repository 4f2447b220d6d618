"""Configuration of the port: copies of the reference's ``DedupConfig`` and
``MatchConfig``.

Same fields, same defaults (``advanced_scrapper_tpu/config.py``), so a
configuration moves between the two packages unchanged.  The defaults run:
the rerank tier (``rerank=True``), the one-shot exact verify
(``exact_verify_band``) and the estimator-only path (``rerank=False,
exact_verify_band=0``).  The engine raises ``NotImplementedError`` for the
fields whose slice is still to come (``backend="oph"``,
``packed_h2d=False``, ``prewarm``, ``index_fleet``) rather than
approximating them; the dispatcher fields and the fleet's timeouts are
read by nothing yet.
``from_env`` (the ``ASTPU_*`` environment knobs) and the other subsystems'
configs are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class DedupConfig:
    """MinHash+LSH near-dup engine (BASELINE.json north star)."""

    shingle_k: int = 5       # k=5 byte shingles
    num_perm: int = 128      # 128 permutations
    num_bands: int = 16      # 16 coarse LSH bands
    block_len: int = 4096    # bytes per device block (bucketed padding)
    batch_size: int = 1024   # peak device bytes per tile = batch_size × block_len
    sim_threshold: float = 0.70  # signature-agreement verification threshold
    cand_subbands: int = 32  # extra fine candidate bands (0 disables)
    fine_margin: float = 0.0  # extra estimator bar on fine-only edges
    exact_verify_band: float = 0.72  # one-shot exact-Jaccard band
    exact_verify_cap: int = 8192
    rerank: bool = True      # rerank precision tier
    rerank_sketch: int = 1024
    rerank_margin: float = 0.04
    rerank_precision_target: float = 0.96
    rerank_recall_floor: float = 0.955
    rerank_exact_cap: int = 8192
    rerank_tile_rows: int = 1024  # the reference's pair tiles (unused: no tiles here)
    rerank_pair_cap: int = 1 << 16
    seed: int = 1            # datasketch's default seed for oracle parity
    backend: str = "scan"    # scan | pallas (both: the CUDA kernel) | oph
    put_workers: int = 0     # pipelined dispatcher (later slice)
    dispatch_window: int = 0  # pipelined dispatcher (later slice)
    packed_h2d: bool = True  # one packed buffer per tile (the only transport)
    prewarm: int = 0         # shape-set warmup (later slice)
    stream_index: str = "exact"  # stream index (later slice)
    bloom_bits: int = 1 << 24
    bloom_hashes: int = 4
    index_dir: str = ""
    index_cut_postings: int = 1 << 16
    index_compact_segments: int = 8
    index_fleet: str = ""
    index_fleet_timeout: float = 5.0
    index_fleet_retries: int = 2
    index_fleet_health_checks: int = 2
    ckpt_every_batches: int = 16


@dataclass(frozen=True)
class MatchConfig:
    """Entity→article matching (ref match_keywords.py).

    Same fields and defaults as the reference's.  The port screens a chunk
    as one ragged buffer on the card (``pipeline/matcher.py``), so it has
    no tile plane: ``packed=False`` (the reference's legacy per-batch
    loop) and ``prewarm`` raise ``NotImplementedError``, and
    ``dispatch_window``, ``put_workers`` and ``screen_tile_bytes`` are
    read by nothing.
    """

    source_name: str = "yahoo"          # ref :222
    info_dir: str = "info/Icahn_filter"  # ref :223
    articles_csv: str = "datasets/yahoo_articles_all.csv"
    chunk_size: int = 20000             # ref :227
    fuzzy_threshold: float = 95.0       # ref :175 (partial_ratio > 95)
    use_tpu: bool = True     # screen on the device (the card here)
    out_dir_suffix: str = "_ticker_matched_articles"  # ref :129
    verify_workers: int = 0  # exact-verify processes; 0 = cpu_count, 1 = inline
    packed: bool = True      # one ragged buffer per chunk (False: later slice)
    dispatch_window: int = 0  # read by nothing (no tile plane)
    put_workers: int = 0     # read by nothing (no tile plane)
    screen_tile_bytes: int = 1 << 21  # read by nothing (no tile plane)
    prewarm: int = 0         # screen shape-set warmup (later slice)
