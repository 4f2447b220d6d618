"""Cross-source dedup (``BASELINE.json`` config 5) on the card.

Counterpart of the reference's ``pipeline/cross_source.py``: articles from
several sources, scraper success CSVs (``url``/``article`` columns) and
sqlite article stores (``storage.stores.ArticleStore``), stream into one
``extractors.tpu_batch.TpuBatchBackend``, so a syndicated copy in one
source collapses onto its first-seen original in another.  A manifest CSV
gets one row per article, ``url, source, status, dup_of`` with status
``keep``, ``exact_dup`` or ``near_dup``, written as each batch resolves;
per-source counts come back as a dict.  Host memory is one batch, not the
corpus.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import Iterator

import torch

from advanced_scrapper_tpu_torch.config import DedupConfig
from advanced_scrapper_tpu_torch.extractors.tpu_batch import TpuBatchBackend
from advanced_scrapper_tpu_torch.storage.csvio import AppendCsv
from advanced_scrapper_tpu_torch.storage.stores import ArticleStore


@dataclass
class SourceDoc:
    source: str
    url: str
    text: str


def load_source(path: str) -> Iterator[SourceDoc]:
    """A source is a success CSV (url/article columns) or a sqlite DB
    (``.db``, ``.sqlite``, ``.sqlite3``), read lazily."""
    name = os.path.basename(path)
    if path.endswith((".db", ".sqlite", ".sqlite3")):
        store = ArticleStore(path)
        for url, text in store.all_texts():
            yield SourceDoc(name, url, text)
        return
    with open(path, newline="", encoding="utf-8") as f:
        for row in csv.DictReader(f):
            text = row.get("article") or row.get("article_text") or ""
            yield SourceDoc(name, str(row.get("url", "")), text)


def _write_rec(rec: dict, stats: dict, out: AppendCsv) -> None:
    src = rec.get("_source", "")
    s = stats["by_source"].setdefault(src, {"total": 0, "kept": 0, "dups": 0})
    s["total"] += 1
    if rec.get("dup_of"):
        status, ref = "exact_dup", rec["dup_of"]
        stats["exact_dups"] += 1
        s["dups"] += 1
    elif rec.get("near_dup_of"):
        status, ref = "near_dup", rec["near_dup_of"]
        stats["near_dups"] += 1
        s["dups"] += 1
    else:
        status, ref = "keep", ""
        stats["kept"] += 1
        s["kept"] += 1
    out.write_row({"url": rec.get("url", ""), "source": src, "status": status, "dup_of": ref})


def cross_source_dedup(
    sources: list[str],
    output_csv: str,
    *,
    cfg: DedupConfig | None = None,
    device: str | torch.device | None = None,
) -> dict:
    """Dedup across ``sources`` into the manifest at ``output_csv``, and
    return the counts (``total``, ``kept``, ``exact_dups``, ``near_dups``
    and ``by_source``).  A stale manifest is removed first: the file
    describes this run only.  ``device`` goes to the backend (``None``
    means the card)."""
    cfg = cfg or DedupConfig()
    if os.path.exists(output_csv):
        os.remove(output_csv)
    backend = TpuBatchBackend(cfg, device=device)
    stats: dict = {"total": 0, "kept": 0, "exact_dups": 0, "near_dups": 0, "by_source": {}}
    try:
        with AppendCsv(output_csv, ["url", "source", "status", "dup_of"]) as out:
            for src_path in sources:
                for d in load_source(src_path):
                    stats["total"] += 1
                    for rec in backend.submit(
                        {"url": d.url, "article": d.text, "_source": d.source}
                    ):
                        _write_rec(rec, stats, out)
            for rec in backend.flush():
                _write_rec(rec, stats, out)
    finally:
        backend.close()
    return stats
