"""L1 alternative engine: asyncio CDX harvester.

The port's copy of the reference's ``pipeline/harvest_async.py``: the same
shard enumeration, resume semantics, normalisation chain and byte-identical
shard files as ``pipeline/harvest.py`` (both engines call
``persist_shard``), driven by one asyncio event loop with
semaphore-bounded concurrency.

Engine choice is an operational trade, not a capability one:

- ``threads`` (default): one transport per worker thread — required when
  the transport is a real browser (Selenium/wire client), which cannot
  be awaited;
- ``async``: one aiohttp session, hundreds of in-flight HTTP requests on
  one thread — the right shape when archive.org is the bottleneck and
  plain HTTP suffices.  Without ``aiohttp`` it fetches through the
  reference's thread-wrapped ``RequestsTransport``, one per thread.
  ``aiohttp`` (and ``requests``) are imported only inside the fetch.

Both funnel into the same ``merge_shards`` exact dedup, on ``device``.
"""

from __future__ import annotations

import asyncio
import os
from typing import Awaitable, Callable

from advanced_scrapper_tpu_torch.config import HarvestConfig
from advanced_scrapper_tpu_torch.pipeline.harvest import (
    cdx_query_url,
    merge_shards,
    persist_shard,
    shard_prefixes,
)

#: browser-ish UA, same contract as net.transport.RequestsTransport
from advanced_scrapper_tpu_torch.net.transport import USER_AGENT


def _default_fetch() -> Callable[[str], Awaitable[str]]:
    """aiohttp-backed fetch; without aiohttp, the sync transport wrapped
    in ``asyncio.to_thread``, one per thread."""
    try:
        import aiohttp
    except ImportError:
        import threading

        from advanced_scrapper_tpu_torch.net.transport import RequestsTransport

        # one transport PER to_thread worker thread: requests.Session is
        # not thread-safe, and the threaded engine's one-transport-per-
        # worker invariant must hold here too
        local = threading.local()
        transports: list[RequestsTransport] = []
        reg_lock = threading.Lock()

        def fetch_in_thread(url: str) -> str:
            t = getattr(local, "t", None)
            if t is None:
                t = local.t = RequestsTransport(timeout=30.0)
                with reg_lock:
                    transports.append(t)
            return t.fetch(url)

        async def fetch_sync(url: str) -> str:
            return await asyncio.to_thread(fetch_in_thread, url)

        def close_all() -> None:
            for t in transports:
                t.close()

        fetch_sync.close = close_all  # type: ignore[attr-defined]
        return fetch_sync

    session: dict = {}

    async def fetch(url: str) -> str:
        if "s" not in session:
            session["s"] = aiohttp.ClientSession(
                headers={"User-Agent": USER_AGENT},
                timeout=aiohttp.ClientTimeout(total=30.0),
            )
        async with session["s"].get(url) as resp:
            resp.raise_for_status()
            return await resp.text()

    async def close() -> None:
        if "s" in session:
            await session["s"].close()

    fetch.aclose = close  # type: ignore[attr-defined]
    return fetch


async def harvest_shards_async(
    cfg: HarvestConfig,
    *,
    fetch: Callable[[str], Awaitable[str]] | None = None,
    concurrency: int | None = None,
) -> int:
    """Sweep all pending shards with bounded async concurrency; returns
    the number of shards that succeeded.  ``fetch`` is an injectable
    ``async (url) -> str`` (tests use a local fixture server / closure).
    Parsing+persist runs in worker threads (``asyncio.to_thread``) so a
    large shard's parse never stalls the event loop's I/O."""
    os.makedirs(cfg.shard_dir, exist_ok=True)
    prefixes = shard_prefixes(cfg.shard_dir)
    if not prefixes:
        return 0
    owns = fetch is None
    if fetch is None:
        fetch = _default_fetch()
    sem = asyncio.Semaphore(concurrency or max(1, cfg.num_workers))
    done = 0

    async def one(prefix: str) -> bool:
        url = cdx_query_url(prefix, cfg)
        try:
            # the semaphore is held across fetch AND persist: a fetched
            # page only releases its slot once it is on disk, so the
            # number of pages resident in memory is bounded by the
            # concurrency (a persist stage falling behind on a slow disk
            # can no longer balloon RSS with completed fetches; persist
            # still runs in a worker thread, so the event loop keeps
            # serving the other slots' I/O)
            async with sem:
                page = await fetch(url)
                await asyncio.to_thread(persist_shard, prefix, page, cfg)
            return True
        except Exception as e:
            # same per-shard containment as the threaded engine: a
            # failed shard logs, leaves NO checkpoint, and the sweep
            # continues (resume retries it next run)
            print(f"Error scraping {url}: {e}")
            return False

    try:
        for ok in await asyncio.gather(*(one(p) for p in prefixes)):
            done += int(ok)
    finally:
        if owns:
            closer = getattr(fetch, "aclose", None)
            if closer is not None:
                await closer()
            else:
                sync_close = getattr(fetch, "close", None)
                if sync_close is not None:
                    sync_close()
    return done


def run_harvest_async(
    cfg: HarvestConfig,
    *,
    fetch: Callable[[str], Awaitable[str]] | None = None,
    concurrency: int | None = None,
    use_tpu: bool = True,
    device=None,
) -> int:
    """CLI entry: async shard sweep + the same merge, on ``device``."""
    n = asyncio.run(
        harvest_shards_async(cfg, fetch=fetch, concurrency=concurrency)
    )
    print(f"Async harvest: {n} shards fetched")
    merge_shards(cfg, use_tpu=use_tpu, device=device)
    return 0
