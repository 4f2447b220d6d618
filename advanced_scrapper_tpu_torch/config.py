"""Configuration of the port: copies of the reference's config module.

Same dataclasses, fields and defaults as ``advanced_scrapper_tpu/config.py``
(``ScraperConfig``, ``HarvestConfig``, ``EnrichConfig``, ``MatchConfig``,
``DedupConfig``, ``MeshConfig``, ``FeedConfig`` and ``Config``), so a
configuration moves between the two packages unchanged and ``astpu
config`` prints the same JSON from either; :func:`from_env` reads the
``ASTPU_<SECTION>_<FIELD>`` environment knobs as the reference does.

The dedup engine runs its defaults: the rerank tier, the one-shot exact
verify and the estimator-only path.  It raises ``NotImplementedError`` for
the fields whose slice is still to come (``backend="oph"``,
``packed_h2d=False``, ``prewarm``, ``index_fleet``) rather than
approximating them; the dispatcher fields and the fleet's timeouts are
read by nothing yet.  The matcher runs every ``MatchConfig`` field it
reads, ``packed=False`` and ``prewarm`` included.  The acquisition,
enrichment, mesh and feed sections are here for ``Config`` and the CLI:
their planes are not ported.
"""

from __future__ import annotations

import dataclasses
import os
import typing
from dataclasses import dataclass, field, fields
from typing import Any, Type, TypeVar

T = TypeVar("T")

_ENV_PREFIX = "ASTPU_"


def _coerce(raw: str, typ: Any) -> Any:
    if typ is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(raw)
    if typ is float:
        return float(raw)
    if typ is tuple or typing.get_origin(typ) is tuple:
        return tuple(float(part) for part in raw.split(",") if part.strip())
    return raw


def from_env(cls: Type[T], section: str = "", **overrides: Any) -> T:
    """Build a config dataclass from ``ASTPU_<SECTION>_<FIELD>`` env vars,
    then ``overrides`` (those that are not None)."""
    kwargs: dict[str, Any] = {}
    # postponed annotations make ``field.type`` a string: resolve the real
    # types so _coerce's identity checks work
    hints = typing.get_type_hints(cls)
    prefix = _ENV_PREFIX + (section.upper() + "_" if section else "")
    for f in fields(cls):  # type: ignore[arg-type]
        env_key = prefix + f.name.upper()
        if env_key in os.environ:
            kwargs[f.name] = _coerce(os.environ[env_key], hints.get(f.name, str))
    kwargs.update({k: v for k, v in overrides.items() if v is not None})
    return cls(**kwargs)  # type: ignore[call-arg]


@dataclass(frozen=True)
class ScraperConfig:
    """Constant-rate acquisition engine (ref constant_rate_scrapper.py:17-28)."""

    website: str = "yfin"
    input_csv: str = "yfin_urls.csv"
    desired_request_rate: float = 5.8
    max_threads: int = 16
    stats_time_window: float = 10.0
    rate_limit_wait: float = 200.0
    page_load_timeout: float = 30.0
    ready_state_timeout: float = 10.0
    result_timeout: float = 60.0
    transport: str = "auto"
    out_dir: str = "."


@dataclass(frozen=True)
class HarvestConfig:
    """CDX URL-discovery shard sweep (ref yahoo_links_selenium.py:19-34)."""

    num_workers: int = 10
    shard_dir: str = "yahoo_links_1"
    output_csv: str = "yfin_urls.csv"
    cdx_base: str = "http://web.archive.org/cdx/search/"
    target_pattern: str = "https://www.finance.yahoo.com/news/{prefix}*"
    ready_state_timeout: float = 3.0
    transport: str = "auto"


@dataclass(frozen=True)
class EnrichConfig:
    """Wikidata SPARQL enrichment (ref ticker_symbol_query*.py)."""

    endpoint: str = "https://query.wikidata.org/sparql"
    symbols_csv: str = "sp500list.csv"
    out_dir: str = "info/ticker"
    hardened: bool = True
    max_retries: int = 5
    base_delay: float = 5.0
    connect_timeout: float = 15.0
    read_timeout: float = 60.0
    progress_file: str = "progress.json"
    crypto_symbols_csv: str = "crypto_list.csv"
    crypto_out_dir: str = "info/crypto"
    crypto_progress_file: str = "progress_crypto.json"
    cooldown_every3: tuple = (15.0, 25.0)
    cooldown_every10: tuple = (60.0, 120.0)


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
    put_workers: int = 0     # read by nothing yet (the pipelined dispatcher, item 7)
    dispatch_window: int = 0  # read by nothing yet (the pipelined dispatcher, item 7)
    packed_h2d: bool = True  # one packed buffer per tile (the only transport)
    prewarm: int = 0         # raises in the engine (item 7)
    stream_index: str = "exact"  # exact | bloom | persist
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
    no tile plane: ``dispatch_window``, ``put_workers`` and
    ``screen_tile_bytes`` are read by nothing.  ``packed=False`` runs the
    legacy per-batch screen, ``prewarm`` a warm launch of each kernel.
    """

    source_name: str = "yahoo"          # ref :222
    info_dir: str = "info/Icahn_filter"  # ref :223
    articles_csv: str = "datasets/yahoo_articles_all.csv"
    chunk_size: int = 20000             # ref :227
    fuzzy_threshold: float = 95.0       # ref :175 (partial_ratio > 95)
    use_tpu: bool = True     # screen on the device (the card here)
    out_dir_suffix: str = "_ticker_matched_articles"  # ref :129
    verify_workers: int = 0  # exact-verify processes; 0 = cpu_count, 1 = inline
    packed: bool = True      # one ragged buffer per chunk; False: the legacy per-batch screen
    dispatch_window: int = 0  # read by nothing (no tile plane)
    put_workers: int = 0     # read by nothing (no tile plane)
    screen_tile_bytes: int = 1 << 21  # read by nothing (no tile plane)
    prewarm: int = 0         # a warm launch of each screen kernel at run start


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout (the reference's; the port runs on one card)."""

    data_axis: str = "data"
    seq_axis: str = "seq"
    data_parallel: int = -1  # -1: all devices
    seq_parallel: int = 1


@dataclass(frozen=True)
class FeedConfig:
    """Host feed scheduler / distributed lease protocol
    (ref server1.py:20,102-138, client1.py:17-24,209-234)."""

    host: str = "localhost"
    port: int = 8000
    max_clients: int = 5
    batch_size: int = 20
    min_queue_length: int = 10
    client_threads: int = 8
    client_rate: float = 8.0
    lease_ttl: float = 30.0
    heartbeat_interval: float = 0.0
    max_frame_bytes: int = 16 << 20
    connect_retries: int = 5
    connect_backoff: float = 0.05


@dataclass(frozen=True)
class Config:
    scraper: ScraperConfig = field(default_factory=ScraperConfig)
    harvest: HarvestConfig = field(default_factory=HarvestConfig)
    enrich: EnrichConfig = field(default_factory=EnrichConfig)
    match: MatchConfig = field(default_factory=MatchConfig)
    dedup: DedupConfig = field(default_factory=DedupConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    feed: FeedConfig = field(default_factory=FeedConfig)

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)


def default_config() -> Config:
    """Every section from its ``ASTPU_<SECTION>_<FIELD>`` knobs."""
    return Config(
        scraper=from_env(ScraperConfig, "scraper"),
        harvest=from_env(HarvestConfig, "harvest"),
        enrich=from_env(EnrichConfig, "enrich"),
        match=from_env(MatchConfig, "match"),
        dedup=from_env(DedupConfig, "dedup"),
        mesh=from_env(MeshConfig, "mesh"),
        feed=from_env(FeedConfig, "feed"),
    )
