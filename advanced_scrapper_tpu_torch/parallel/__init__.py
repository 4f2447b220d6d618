"""The device mesh's parallel paths (the reference's ``parallel/``):
batch, block and sequence sharding (``sharded``), the packed tile plane
over a mesh (``sharded_packed``), the ring pass (``ring``), the
multi-process world (``dist``) and the axis collectives they share
(``collectives``).  Imports only ``core`` and ``ops``."""

from advanced_scrapper_tpu_torch.parallel.dist import initialize_multihost
from advanced_scrapper_tpu_torch.parallel.sharded import (
    make_seq_sharded_signatures,
    make_sharded_dedup,
    seq_sharded_signatures,
    shard_batch,
    sharded_dedup_step,
)
from advanced_scrapper_tpu_torch.parallel.sharded_packed import (
    make_sharded_fused_tile_step,
    make_sharded_keys_epilogue,
    make_sharded_resolve_epilogue,
)

__all__ = [
    "sharded_dedup_step",
    "seq_sharded_signatures",
    "make_seq_sharded_signatures",
    "make_sharded_dedup",
    "make_sharded_fused_tile_step",
    "make_sharded_keys_epilogue",
    "make_sharded_resolve_epilogue",
    "shard_batch",
    "initialize_multihost",
]
