"""Subprocess worker-pool orchestrator (stdin/stdout pipes).

The port's copy of the reference's ``net/pipe_pool.py``: N
``advanced_scrapper_tpu_torch.net.pipe_worker`` subprocesses launched with
their config as a JSON argv blob; the dispatcher writes a URL line to an
idle worker's stdin, per-worker reader threads collect JSON result lines
from stdout and JSON errors from stderr, and busy-state bookkeeping frees
a worker as soon as its line arrives.
"""

from __future__ import annotations

import json
import queue
import subprocess
import sys
import threading
import time


class PipePool:
    def __init__(self, num_workers: int = 3, config: dict | None = None):
        # ref 06_worker.py:14 NUM_WORKERS=3
        self.num_workers = num_workers
        self.config = config or {}
        self._procs: list[subprocess.Popen] = []
        self._busy: list[bool] = []
        self._lock = threading.Lock()
        self._free = threading.Semaphore(0)
        self.results: "queue.Queue[dict]" = queue.Queue()
        self.errors: "queue.Queue[dict]" = queue.Queue()
        self._threads: list[threading.Thread] = []

    def start(self) -> "PipePool":
        blob = json.dumps(self.config)
        for i in range(self.num_workers):
            p = subprocess.Popen(
                [sys.executable, "-m", "advanced_scrapper_tpu_torch.net.pipe_worker", blob],
                stdin=subprocess.PIPE,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
                bufsize=1,
            )
            self._procs.append(p)
            self._busy.append(False)
            self._free.release()
            for stream, sink in ((p.stdout, self.results), (p.stderr, self.errors)):
                t = threading.Thread(
                    target=self._reader, args=(i, stream, sink), daemon=True
                )
                t.start()
                self._threads.append(t)
        return self

    def _reader(self, idx: int, stream, sink: "queue.Queue[dict]") -> None:
        for line in stream:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                continue  # stray prints from libraries
            sink.put(obj)
            with self._lock:
                if self._busy[idx]:
                    self._busy[idx] = False
                    self._free.release()
        # Stream EOF: the worker died (or stop() closed it).  Only the stdout
        # reader reclaims the slot — doing it from both readers would release
        # the semaphore twice.  A worker that crashed mid-task surfaces as an
        # error result so drain() callers are not left one item short.
        if sink is self.results:
            with self._lock:
                if self._busy[idx]:
                    self._busy[idx] = False
                    self._free.release()
                    self.errors.put(
                        {"error": "worker exited mid-task", "worker": idx}
                    )

    def dispatch(self, url: str, timeout: float = 60.0) -> bool:
        """Hand one URL to an idle worker (blocks for one to free up)."""
        if not self._free.acquire(timeout=timeout):
            return False
        with self._lock:
            for i, p in enumerate(self._procs):
                if not self._busy[i] and p.poll() is None:
                    self._busy[i] = True
                    try:
                        p.stdin.write(url + "\n")
                        p.stdin.flush()
                        return True
                    except (BrokenPipeError, OSError):
                        self._busy[i] = False
        self._free.release()
        return False

    def drain(self, n: int, timeout: float = 60.0) -> list[dict]:
        """Collect n results/errors (interleaved as they arrive).

        Both queues are emptied without blocking, and the loop sleeps only
        when both were empty: the reference's blocking ``get`` on whichever
        queue is empty cost every collected line up to 50 ms."""
        out: list[dict] = []
        deadline = time.monotonic() + timeout
        while len(out) < n and time.monotonic() < deadline:
            got = False
            for q in (self.results, self.errors):
                while len(out) < n:
                    try:
                        out.append(q.get_nowait())
                        got = True
                    except queue.Empty:
                        break
            if not got:
                time.sleep(0.002)
        return out

    def stop(self) -> None:
        for p in self._procs:
            try:
                p.stdin.close()
            except Exception:
                pass
        for p in self._procs:
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()
