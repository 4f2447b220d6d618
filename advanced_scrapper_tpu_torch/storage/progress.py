"""Progress ledger: processed/failed sets persisted after every item.

The port's copy of the reference's ``storage/progress.py``; its ledger
file is the reference's byte for byte.

Successor of ``progress.json``
(``ticker_symbol_query_rate_limit_protected.py:340-353,410-415``) including
the "marked done but artifact missing" repair check (:381-393).
"""

from __future__ import annotations

import json
import os
from typing import Callable


class ProgressLedger:
    def __init__(self, path: str):
        self.path = path
        self.processed: set[str] = set()
        self.failed: set[str] = set()
        if os.path.exists(path):
            with open(path, "r", encoding="utf-8") as f:
                data = json.load(f)
            self.processed = set(data.get("processed", []))
            self.failed = set(data.get("failed", []))

    def save(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(
                {"processed": sorted(self.processed), "failed": sorted(self.failed)},
                f,
            )
        os.replace(tmp, self.path)

    def mark_processed(self, key: str) -> None:
        self.processed.add(key)
        self.failed.discard(key)
        self.save()

    def mark_failed(self, key: str) -> None:
        self.failed.add(key)
        self.save()

    def should_skip(self, key: str, artifact_exists: Callable[[], bool]) -> bool:
        """Skip keys already processed — unless their artifact vanished, in
        which case they are un-marked for re-processing (repair semantics,
        ref :381-393)."""
        if key not in self.processed:
            return False
        if artifact_exists():
            return True
        self.processed.discard(key)
        self.save()
        return False
