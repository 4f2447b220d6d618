"""Streaming host → card feed: host batcher → prefetch → MinHash kernel.

A copy of the reference's ``pipeline/feed.py`` on the port's stage graph.
Producers push raw documents into :class:`cpu.hostbatch.HostBatcher`; the
``stage`` stage of :class:`DeviceFeed` pops fixed-shape tiles and copies
them to the device ahead of use (``depth`` of them staged), so batch
assembly, copy and compute overlap.  Tags (``uint64``, caller-chosen) ride
along so results map back to records.

This is the firehose path: documents truncate at the feed's block length
(the queue's fixed row shape).  For full blockwise coverage of long texts
use :class:`pipeline.dedup.NearDupEngine`.  ``sharding=mesh`` splits each
tile's rows over the mesh's data axis: every local shard gets its rows,
copied to its device, as :class:`core.mesh.ShardedArray` s that the
mesh's steps (``parallel.sharded``) take as they are.

Telemetry, as the reference's: ``astpu_feed_batches_total``,
``astpu_feed_docs_total``, ``astpu_feed_partial_tiles_total``, the
``astpu_feed_fill_ratio`` gauge and scrape-time gauges of the batcher's
depth, arena and rejected pushes and the staged tiles (per ``feed``
label); each pull's pop and copy land in the ``encode`` and ``h2d``
stages and in :attr:`DeviceFeed.timer` (a ``StepTimer`` mirrored into
``astpu_feed_step_seconds``), each copy on the ``feed`` plane's
device-put counters, and a ``feed.stage`` trace record per tile.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Iterable, Iterator

import numpy as np
import torch

from advanced_scrapper_tpu_torch import resolve_device
from advanced_scrapper_tpu_torch.config import DedupConfig
from advanced_scrapper_tpu_torch.core.hashing import make_params
from advanced_scrapper_tpu_torch.core.mesh import Mesh, ShardedArray, piece_slices
from advanced_scrapper_tpu_torch.cpu.hostbatch import HostBatcher
from advanced_scrapper_tpu_torch.obs import stages, telemetry, trace
from advanced_scrapper_tpu_torch.obs.profiler import StepTimer
from advanced_scrapper_tpu_torch.ops.lsh import band_keys
from advanced_scrapper_tpu_torch.ops.minhash import minhash_signatures
from advanced_scrapper_tpu_torch.ops.shingle import to_u32, u32_values
from advanced_scrapper_tpu_torch.pipeline.dispatch import auto_h2d_workers
from advanced_scrapper_tpu_torch.runtime import DONE, RETRY, StageGraph


def resolve_prefetch_depth(depth: int | None) -> int:
    """Effective prefetch depth (batches staged on the device ahead of
    use): an explicit positive ``depth`` wins, else ``ASTPU_FEED_PREFETCH``,
    else 2 (double buffering).  A non-positive depth means the default:
    it would make the staging edge unbounded."""
    if depth is not None and depth > 0:
        return depth
    env = int(os.environ.get("ASTPU_FEED_PREFETCH") or 0)
    return env if env > 0 else 2


class DeviceFeed:
    """Prefetching consumer of a :class:`HostBatcher`, run as a stage graph.

    The ``stage`` stage's workers pop host tiles and copy them to the
    device; the ``staged`` edge keeps up to ``depth`` batches.  Iterate to
    receive ``(n, tokens_dev, lengths_dev, tags)``; iteration ends when the
    batcher is closed and drained, and raises when a worker died.

    Pops wait (up to ``poll_timeout_ms``) for a full tile (``min_fill``,
    default ``batch_size``): a partial tile pays a full-shape kernel.  A
    timeout or a closed queue still yields partial tiles.  ``workers > 1``
    runs several pull workers; batches may then arrive out of order, and
    tags ride with their batch.  ``workers`` ``None``/0 = the transport
    default (1); ``depth`` ``None``/0 = ``ASTPU_FEED_PREFETCH`` (2).

    On the card a worker pins each tile and copies it on the feed's own
    copy stream, so a copy never waits for the kernels queued on the
    consumer's stream, and records an event after its copies.  The
    consumer's current stream waits on that event when the batch is
    handed over, and the batch's device tensors are recorded on it, so
    the caching allocator keeps their blocks until the consumer's work
    on them is done.  PyTorch's pinned cache keeps a pinned tile out of
    reuse until its copy has completed.  ``device=None`` means the card
    (and raises without one); ``device="cpu"`` stages host tensors.

    ``sharding`` (a :class:`core.mesh.Mesh`; the reference takes the
    mesh's ``(P(data, None), P(data))`` shardings) splits each tile's rows
    over the data axis: each local shard's rows are copied to its device
    (one copy of the tokens and one of the lengths a shard, counted with
    ``shard=``), one copy stream and event per card, and the batch comes
    as two :class:`core.mesh.ShardedArray` s.  ``batch_size`` must split
    over the data axis; ``device`` is then unused.
    """

    def __init__(
        self,
        batcher: HostBatcher,
        batch_size: int,
        *,
        depth: int | None = None,
        sharding=None,
        poll_timeout_ms: int = 200,
        workers: int | None = None,
        min_fill: int | None = None,
        device: str | torch.device | None = None,
    ):
        if sharding is not None:
            if not isinstance(sharding, Mesh):
                raise TypeError(f"sharding must be a core.mesh.Mesh, got {type(sharding).__name__}")
            data = sharding.axis_names[0]
            if batch_size % sharding.shape[data]:
                raise ValueError(
                    f"batch_size {batch_size} does not split over {sharding.shape[data]} data shards"
                )
            devices = [sharding.shards[g].device for g in sharding.local]
        else:
            devices = [resolve_device(device)]
        self.sharding = sharding
        self.device = devices[0]
        self.batcher = batcher
        self.batch_size = batch_size
        self.poll_timeout_ms = poll_timeout_ms
        self.min_fill = batch_size if min_fill is None else min_fill
        #: one copy stream a card the tiles land on
        self._copy_streams = {d: torch.cuda.Stream(d) for d in devices if d.type == "cuda"}
        self._graph = StageGraph("feed")
        self._instrument()
        self._out = self._graph.edge("staged", resolve_prefetch_depth(depth))
        self._graph.stage(
            "stage", source=self._pull, out_edge=self._out,
            workers=max(1, workers or auto_h2d_workers()),
        )
        self._graph.start()

    _seq_lock = threading.Lock()
    _seq = 0

    def _instrument(self) -> None:
        """Telemetry handles (no-ops while disabled), the scrape-time
        gauges and the pull loop's ``StepTimer``."""
        with DeviceFeed._seq_lock:
            feed_id = str(DeviceFeed._seq)
            DeviceFeed._seq += 1
        self._m_batches = telemetry.counter(
            "astpu_feed_batches_total", "tiles popped and staged on device"
        )
        self._m_docs = telemetry.counter("astpu_feed_docs_total", "documents staged on device")
        self._m_partial = telemetry.counter(
            "astpu_feed_partial_tiles_total",
            "tiles dispatched below batch_size (timeout/close drains)",
        )
        self._m_fill = telemetry.gauge(
            "astpu_feed_fill_ratio", "last tile's rows / batch_size", feed=feed_id
        )
        self.timer = StepTimer(
            histogram=telemetry.histogram(
                "astpu_feed_step_seconds", "pop→device_put cycle latency"
            )
        )
        for name, fn, help in (
            ("astpu_feed_queue_depth", lambda feed: feed.batcher.size(),
             "documents buffered in the host batcher"),
            ("astpu_feed_arena_used_bytes", lambda feed: feed.batcher.arena_used(),
             "host batcher arena occupancy"),
            ("astpu_feed_rejected_pushes", lambda feed: feed.batcher.stats()["rejected"],
             "pushes rejected by doc/arena backpressure"),
            ("astpu_feed_staged_depth", lambda feed: feed._out.qsize(),
             "device-staged tiles awaiting the consumer"),
        ):
            telemetry.gauge_fn(name, fn, owner=self, help=help, feed=feed_id)

    def summary(self) -> dict:
        """Rolling per-tile step latency/throughput (``StepTimer.summary``)."""
        return self.timer.summary()

    def _put_device(self, arr: np.ndarray, device: torch.device | None = None) -> torch.Tensor:
        """``arr`` on ``device`` (the feed's by default)."""
        t = torch.from_numpy(arr)
        device = device or self.device
        stream = self._copy_streams.get(device)
        if stream is None:
            return t
        # from pinned memory the copy is asynchronous; from pageable memory
        # it could wait for the stream's queued work
        with torch.cuda.stream(stream):
            return t.pin_memory().to(device, non_blocking=True)

    def _put(self, tok: np.ndarray, lens: np.ndarray):
        """One tile's copies: ``(tokens, lengths)`` on the feed's device,
        or each local shard's rows on its device as ``ShardedArray`` s."""
        mesh = self.sharding
        if mesh is None:
            tok_dev, lens_dev = self._put_device(tok), self._put_device(lens)
            stages.count_device_put(tok.nbytes, "feed")
            stages.count_device_put(lens.nbytes, "feed")
            return tok_dev, lens_dev
        data = mesh.axis_names[0]
        pt, pl = [], []
        for g in mesh.local:
            rows = piece_slices(mesh, (data,), lens.shape, g)
            dev = mesh.shards[g].device
            pt.append(self._put_device(np.ascontiguousarray(tok[rows]), dev))
            pl.append(self._put_device(np.ascontiguousarray(lens[rows]), dev))
            stages.count_device_put(pt[-1].numel(), "feed", shard=g)
            stages.count_device_put(4 * pl[-1].numel(), "feed", shard=g)
        return (ShardedArray(mesh, (data, None), pt, tok.shape),
                ShardedArray(mesh, (data,), pl, lens.shape))

    def _pull(self):
        """One pop → copy cycle, the ``stage`` stage's source, shared by
        every pull worker: a staged tuple, :data:`RETRY` on an empty poll,
        or :data:`DONE` once the batcher is closed and drained."""
        t0 = time.perf_counter()
        with stages.timed("encode"):  # a slow producer's waits land here too
            n, tok, lens, tags = self.batcher.pop_batch(
                self.batch_size, timeout_ms=self.poll_timeout_ms, min_fill=self.min_fill
            )
        if n == 0:
            # close() is one-way, so this check is race-free
            if self.batcher.closed() and self.batcher.size() == 0:
                return DONE
            return RETRY
        with stages.timed("h2d"):
            tok_dev, lens_dev = self._put(tok, lens)
        copied = []
        for dev, stream in self._copy_streams.items():
            event = torch.cuda.Event()
            event.record(stream)
            copied.append((dev, event))
        self.timer.add(time.perf_counter() - t0, n)
        self._m_batches.inc()
        self._m_docs.inc(n)
        self._m_fill.set(n / self.batch_size)
        if n < self.batch_size:
            self._m_partial.inc()
        if trace.RECORDER.active:
            trace.record(
                "span", "feed.stage", batch=int(tags[0]), rows=n,
                dur_ms=round((time.perf_counter() - t0) * 1e3, 3),
            )
        return (n, tok_dev, lens_dev, tags, copied)

    def __iter__(self) -> Iterator[tuple[int, torch.Tensor, torch.Tensor, np.ndarray]]:
        while True:
            item = self._out.pop()
            if item is DONE:
                # the closed edge makes termination idempotent
                if self._graph.error is not None:
                    raise RuntimeError("DeviceFeed worker died mid-stream") from self._graph.error
                return
            n, tok, lens, tags, copied = item
            for dev, event in copied:
                stream = torch.cuda.current_stream(dev)
                stream.wait_event(event)
                for x in (tok.pieces + lens.pieces) if self.sharding is not None else (tok, lens):
                    if x.device == dev:
                        x.record_stream(stream)
            yield n, tok, lens, tags

    def close(self) -> None:
        """Stop the workers without draining (for a consumer that leaves)."""
        self._graph.stop()

    def join(self, timeout: float | None = 30.0) -> None:
        """Wait for every stage worker; ``timeout`` bounds the total wait."""
        self._graph.join(timeout, raise_error=False)


def stream_signatures(
    docs: Iterable[str | bytes],
    *,
    cfg: DedupConfig | None = None,
    block: int | None = None,
    batch_size: int | None = None,
    prefer_native: bool = True,
    sig_bits: int = 32,
    feed_workers: int | None = None,
    device: str | torch.device | None = None,
) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Stream ``(tags, signatures, band_keys)`` batches for a document feed.

    A producer graph pushes ``docs`` through a :class:`HostBatcher` while
    this generator's thread runs the kernels on prefetched tiles: per
    batch, ``minhash_signatures`` (``minhash_sig`` on the card) and
    ``band_keys`` (plain PyTorch), ``uint32[n, num_perm]`` and
    ``uint32[n, num_bands]``.  The readback is one deep: batch i's copy to
    pinned host memory runs while batch i + 1 computes.

    ``sig_bits=16`` returns only the low 16 bits of each signature lane
    (``uint16``); band keys stay full ``uint32``.  ``feed_workers > 1``
    runs several pull workers (batches may arrive out of order; tags ride
    with their batch).  A dead producer or feed worker raises here; on any
    exit the batcher closes, so the producer stops promptly.  ``device``
    as :class:`DeviceFeed`.
    """
    if sig_bits not in (16, 32):
        raise ValueError(f"sig_bits must be 16 or 32, got {sig_bits}")
    cfg = cfg or DedupConfig()
    block = block or cfg.block_len
    batch_size = batch_size or cfg.batch_size
    params = make_params(
        num_perm=cfg.num_perm, num_bands=cfg.num_bands, shingle_k=cfg.shingle_k, seed=cfg.seed,
    )
    dev = resolve_device(device)
    batcher = HostBatcher(block, prefer_native=prefer_native)
    feed = DeviceFeed(batcher, batch_size, workers=feed_workers, device=dev)

    # the producer pump is a one-stage graph of its own: feed() runs once
    # inside the source, the batcher's close rides its finally, and a pump
    # death is kept on producer.error
    def produce_once():
        try:
            batcher.feed(docs)
        finally:
            batcher.close()
        return DONE

    producer = StageGraph("stream_signatures")
    producer.stage("produce", source=produce_once)
    producer.start()

    def readback(sig: torch.Tensor, keys: torch.Tensor):
        """Start the copies of one batch's results to the host; returns
        them and an event to wait on (None off the card)."""
        if dev.type != "cuda":
            return sig, keys, None
        host = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True) for x in (sig, keys)]
        for h, x in zip(host, (sig, keys)):
            h.copy_(x, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host[0], host[1], done

    def finish(pending):
        tags, n, sig, keys, done = pending
        if done is not None:
            done.synchronize()
        return tags[:n], sig[:n].numpy(), keys[:n].numpy()

    pending = None
    try:
        for n, tok_dev, len_dev, tags in feed:
            sig = minhash_signatures(tok_dev, len_dev, params)
            keys = to_u32(band_keys(sig, params.band_salt)).view(torch.int32)
            if sig_bits == 16:  # the low 16 bits, cast exactly through their signed value
                sig = ((u32_values(sig) + 0x8000 & 0xFFFF) - 0x8000).to(torch.int16)
            else:
                sig = sig.view(torch.int32)
            sig, keys, done = readback(sig, keys)
            if pending is not None:
                yield _as_unsigned(*finish(pending))
            pending = (tags, n, sig, keys, done)
        if pending is not None:
            yield _as_unsigned(*finish(pending))
        # a dead pump means the stream above was silently truncated (the
        # closed batcher ends the feed cleanly): the consumer must hear it
        producer.join(timeout=30, raise_error=False)
        if producer.error is not None:
            raise RuntimeError("stream_signatures producer died mid-corpus") from producer.error
    finally:
        # on any exit (exhaustion, a dead feed worker, a consumer that left)
        # stop the producer: a closed batcher rejects pushes, so feed()
        # returns instead of buffering the rest of `docs`
        batcher.close()
        feed.close()
        producer.join(timeout=30, raise_error=False)
        feed.join()


def _as_unsigned(tags: np.ndarray, sig: np.ndarray, keys: np.ndarray):
    """The batch's signed host views as the reference's unsigned arrays."""
    return tags, sig.view(np.uint16 if sig.dtype == np.int16 else np.uint32), keys.view(np.uint32)
