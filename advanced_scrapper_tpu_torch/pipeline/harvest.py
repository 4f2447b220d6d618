"""L1: Internet-Archive CDX URL harvest → deduplicated ``yfin_urls.csv``.

The port's copy of the reference's ``pipeline/harvest.py``, on the
standard library: the page's text comes from the port's HTML tree
(``core/soup.py``) where the reference uses bs4, and the CDX frame from
``cpu/csvframe.py`` where it uses pandas.  Its files are the reference's
byte for byte:

- shard space: every 2-character prefix over the 39-character alphabet
  (a-z, 0-9, ``-``, ``_``, ``$``) → one CDX query per prefix;
- **shard-file resume**: prefixes whose ``yahoo_<pfx>.txt`` exists are
  skipped — the shard files are the checkpoint;
- per-shard parse of the space-delimited CDX dump as pandas' C parser
  reads it (columns 1-2 → ``date_time,url``; a run of spaces is a run of
  empty fields, so a double space shifts that row and turns the shard's
  ``date_time`` float) and the normalisation chain with pandas' pattern
  semantics: ``str.contains(".html")`` and ``str.split(".html")`` are
  regex (a pattern longer than one character), so ``.`` is any character;
  ``:80`` stripped, ``http:``→``https:``, ``news/%`` and ``news/'`` junk
  dropped; per-shard keep-first dedup;
- **merge**: each shard CSV read back with pandas' typing, concatenated
  with its dtype promotion (one float shard makes every ``date_time``
  float; a header-only shard makes the column ``object``, each value as
  its shard had it), and a global keep-first exact dedup through
  ``pipeline.dedup.ExactDedup`` on ``device`` (``None`` is the card), or
  with ``use_tpu=False`` by the url string.
"""

from __future__ import annotations

import glob
import io
import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

from advanced_scrapper_tpu_torch.config import HarvestConfig
from advanced_scrapper_tpu_torch.cpu.csvframe import (
    Frame,
    concat,
    read_delimited_text,
    read_frame,
)

CHAR_LIST = list("abcdefghijklmnopqrstuvwxyz") + list("1234567890") + ["-", "_", "$"]

#: pandas reads ``".html"`` as a regex in ``str.contains`` and ``str.split``
_HTML = re.compile(".html")


def _atomic_write_df(path: str, frame: Frame, fs=None) -> None:
    """``frame.to_csv`` streamed straight into the atomic tmp+fsync+rename
    commit — no whole-file string buffer (the merged url CSV can be
    hundreds of MB)."""
    from advanced_scrapper_tpu_torch.storage.fsio import atomic_write

    def write(fh):
        wrapper = io.TextIOWrapper(fh, encoding="utf-8", newline="")
        try:
            frame.write(wrapper)
            wrapper.flush()
        finally:
            try:
                wrapper.detach()  # flush without closing the tmp handle
            except Exception:
                pass  # a failed write already owns the propagating error

    atomic_write(path, write, fs=fs)


def shard_prefixes(shard_dir: str) -> list[str]:
    """All 2-char prefixes without an existing shard file (resume)."""
    done = set(os.listdir(shard_dir)) if os.path.isdir(shard_dir) else set()
    out = []
    for c0 in CHAR_LIST:
        for c1 in CHAR_LIST:
            if f"yahoo_{c0}{c1}.txt" not in done:
                out.append(c0 + c1)
    return out


def cdx_query_url(prefix: str, cfg: HarvestConfig) -> str:
    target = cfg.target_pattern.format(prefix=prefix)
    return f"{cfg.cdx_base}?url={target}"


def normalize_cdx_frame(frame: Frame) -> Frame:
    """The reference's normalisation chain with pandas' semantics: a url
    column of no string kind raises as the ``.str`` accessor does; an NA
    url drops."""
    kind, urls = frame.column("url")
    if kind == "object":  # every url NA past the row width: NaN in the mask
        raise ValueError("Cannot mask with non-boolean array containing NA / NaN values")
    if kind != "str":
        raise AttributeError(f"Can only use .str accessor with string values, not {kind}")
    rows, kept, seen = [], [], set()
    for i, u in enumerate(urls):
        if not isinstance(u, str):
            continue
        m = _HTML.search(u)
        if m is None:
            continue
        u = (u[: m.start()] + ".html").replace(":80", "").replace("http:", "https:")
        if "news/%" in u or "news/'" in u or u in seen:
            continue
        seen.add(u)
        rows.append(i)
        kept.append(u)
    out = frame.take(rows)
    out.columns[out.names.index("url")] = ("str", kept)
    return out


def parse_cdx_text(text: str) -> Frame:
    """Space-delimited CDX dump → (date_time, url) frame."""
    return read_delimited_text(text, delimiter=" ", usecols=[1, 2], names=["date_time", "url"])


def persist_shard(prefix: str, page: str, cfg: HarvestConfig, fs=None) -> str | None:
    """Parse + persist one fetched CDX shard page — the engine-independent
    half shared by the threaded and async harvesters, so their shard files
    are byte-identical by construction.

    Both files commit via ``fsio.atomic_replace`` (tmp+fsync+rename), the
    ``.csv`` first: the ``.txt`` is the resume checkpoint
    ``shard_prefixes`` keys on, so it is written only once the shard fully
    succeeded, and a torn one can never mark an unfinished shard done."""
    from advanced_scrapper_tpu_torch.core.soup import Soup
    from advanced_scrapper_tpu_torch.storage.fsio import atomic_replace

    text = Soup(page).get_text("\n", strip=True)
    csv_path = None
    if text.strip():
        frame = normalize_cdx_frame(parse_cdx_text(text))
        csv_path = os.path.join(cfg.shard_dir, f"yahoo_{prefix}.csv")
        _atomic_write_df(csv_path, frame, fs=fs)
    txt_path = os.path.join(cfg.shard_dir, f"yahoo_{prefix}.txt")
    atomic_replace(txt_path, text.encode("utf-8"), fs=fs)
    return csv_path


def process_shard(prefix: str, transport, cfg: HarvestConfig) -> str | None:
    """Fetch one CDX shard, persist raw text + normalised CSV."""
    url = cdx_query_url(prefix, cfg)
    try:
        return persist_shard(prefix, transport.fetch(url), cfg)
    except Exception as e:
        print(f"Error scraping {url}: {e}")
        return None


def merge_shards(cfg: HarvestConfig, *, use_tpu: bool = True, device=None) -> int:
    """Concat shard CSVs → global keep-first exact dedup → output CSV.

    ``use_tpu`` routes the dedup through ``pipeline.dedup.ExactDedup`` on
    ``device`` (``None`` is the card, and raises without one); otherwise
    the first row of each url is kept.  The output is byte-identical
    either way."""
    files = sorted(glob.glob(os.path.join(cfg.shard_dir, "*.csv")))
    frames = []
    for f in files:
        try:
            frames.append(read_frame(f))
        except Exception as e:
            print(f"Error reading {f}: {e}")
    if not frames:
        print("No CSV files were processed.")
        return 0
    merged = concat(frames)
    urls = [str(u) for u in merged.column("url")[1]]
    if use_tpu:
        from advanced_scrapper_tpu_torch.pipeline.dedup import ExactDedup

        max_len = max((len(u.encode("utf-8", "replace")) for u in urls), default=1)
        keep = ExactDedup(max_len=max(4096, max_len), device=device).keep_indices(urls)
    else:
        first: dict[str, int] = {}
        for i, u in enumerate(urls):
            first.setdefault(u, i)
        keep = sorted(first.values())
    merged = merged.take(keep)
    # atomic commit: a crash mid-merge must leave the previous output CSV
    # (which the scrape stage may already be consuming) whole, not torn
    _atomic_write_df(cfg.output_csv, merged)
    print(f"Found {len(merged)} unique URLs → {cfg.output_csv}")
    return len(merged)


def run_harvest(
    cfg: HarvestConfig,
    *,
    transport=None,
    transport_factory: Callable[[], object] | None = None,
    use_tpu: bool = True,
    device=None,
) -> int:
    """CLI entry: full shard sweep + merge."""
    os.makedirs(cfg.shard_dir, exist_ok=True)
    prefixes = shard_prefixes(cfg.shard_dir)
    if prefixes:
        owns_transports = True  # workers close only transports they created
        if transport_factory is None:
            if transport is not None:
                shared = transport
                owns_transports = False  # caller-owned: never close it here
                transport_factory = lambda: shared  # noqa: E731
            else:
                from advanced_scrapper_tpu_torch.net.transport import make_transport

                transport_factory = lambda: make_transport(  # noqa: E731
                    cfg.transport, ready_state_timeout=cfg.ready_state_timeout
                )
        print(f"Harvesting {len(prefixes)} CDX shards with {cfg.num_workers} workers")

        def worker_batch(batch: list[str]) -> None:
            t = transport_factory()
            try:
                for p in batch:
                    process_shard(p, t, cfg)
            finally:
                if owns_transports:
                    try:
                        t.close()
                    except Exception:
                        pass

        n = max(1, cfg.num_workers)
        batches = [prefixes[i::n] for i in range(n)]
        with ThreadPoolExecutor(max_workers=n) as ex:
            list(ex.map(worker_batch, [b for b in batches if b]))
    merge_shards(cfg, use_tpu=use_tpu, device=device)
    return 0
