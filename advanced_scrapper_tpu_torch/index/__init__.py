"""The persistent corpus index: durable, log-structured LSH postings.

The port's copy of the reference's ``index/`` package, host code over
numpy and the standard library: an on-disk index of ``(band-key, doc-id)``
postings with bounded resident memory, so a restarted run dedups incoming
articles against everything it has already seen.  Either package reopens
the other's directory.

- :mod:`.wal` — torn-tail-safe write-ahead log of posting batches.
- :mod:`.segment` — immutable sorted segment files with per-segment Blooms.
- :mod:`.store` — :class:`PersistentIndex`: WAL → memtable → segment cut →
  compaction, crash-safe via manifest swap.
- :mod:`.repair` — the key-space helpers the store calls.

The index fleet (``remote``, ``fleet``, ``reshard`` and the anti-entropy
digests) comes with ROADMAP item 9c.
"""

from advanced_scrapper_tpu_torch.index.segment import (
    Segment,
    SegmentCorruption,
    file_digest,
    write_segment,
)
from advanced_scrapper_tpu_torch.index.store import PersistentIndex
from advanced_scrapper_tpu_torch.index.wal import WriteAheadLog, replay_wal

__all__ = [
    "PersistentIndex",
    "Segment",
    "SegmentCorruption",
    "file_digest",
    "write_segment",
    "WriteAheadLog",
    "replay_wal",
]
