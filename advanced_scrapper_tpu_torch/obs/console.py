"""Console multiplexer: scrolling event lines above a live status line.

Successor of the reference's print thread + ANSI dance
(``constant_rate_scrapper.py:26,106-112,257-287``): one consumer thread
drains a queue of ``(message, is_stats_line)`` tuples; stats lines overwrite
in place with ``\\r``/``\\033[K`` while event lines scroll above and the
stats line is repainted beneath them.  Single-writer by construction — the
reference's unlocked global ``print_queue`` is a constructor-injected queue
here (SURVEY.md §5.2).
"""

from __future__ import annotations

import queue
import sys
import threading

GREEN = "\033[92m"
RED = "\033[91m"
RESET = "\033[00m"


def green(msg: str) -> str:
    return f"{GREEN}{msg}{RESET}"


def red(msg: str) -> str:
    return f"{RED}{msg}{RESET}"


class ConsoleMux:
    def __init__(self, out=None):
        self._out = out if out is not None else sys.stdout
        self._queue: "queue.Queue[tuple[str, bool]]" = queue.Queue()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._last_stats_line = ""

    # -- producers ---------------------------------------------------------

    def event(self, message: str) -> None:
        self._queue.put((message, False))

    def success(self, message: str) -> None:
        self.event(green(message))

    def failure(self, message: str) -> None:
        self.event(red(message))

    def stats(self, line: str) -> None:
        self._queue.put((line, True))

    # -- consumer ----------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None

    def start(self) -> "ConsoleMux":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def drain(self) -> None:
        """Render everything queued so far (synchronous, for tests/shutdown).
        No-op while a consumer thread is running — it owns the queue."""
        if self.running:
            return
        while True:
            try:
                message, is_stats = self._queue.get_nowait()
            except queue.Empty:
                return
            self._render(message, is_stats)

    def _run(self) -> None:
        while not self._stop.is_set() or not self._queue.empty():
            try:
                message, is_stats = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            self._render(message, is_stats)

    def _render(self, message: str, is_stats: bool) -> None:
        w = self._out.write
        if is_stats:
            w("\r\033[K" + message)
            self._last_stats_line = message
        elif self._last_stats_line:
            w("\r\033[K" + message + "\n" + self._last_stats_line)
        else:
            w(message + "\n")
        self._out.flush()
