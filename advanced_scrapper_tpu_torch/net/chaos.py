"""Deterministic socket-plane fault injection for the lease protocol.

The port's copy of the reference's ``net/chaos.py``.  ``ChaosTransport``
(``net/transport.py``) injects faults at the *fetch* plane and
``storage.fsio.ChaosFs`` at the *storage* plane; this module covers the
third I/O plane — the TCP links of the lease protocol (``net/lease.py``)
and, through ``RpcClient(connect=...)``, the RPC plane (``net/rpc.py``).
The faults are the ones that kill real fleets:

- **mid-frame cut**: ``sendall`` delivers a strict prefix of the frame and
  the connection dies — the peer's reassembler must treat the partial
  frame as garbage and the lease server must requeue everything the dead
  client still held;
- **trickle** (slow-loris): a frame dribbles out in tiny chunks with
  delays — correctness must not depend on a frame arriving in one
  ``recv``, and one slow client must not stall the others;
- **fragmented recv**: reads return a few bytes at a time, as on a
  congested link.

Send-side faults are a pure function of ``(seed, frame digest,
per-digest occurrence)`` — not of a shared random stream — so a given
frame faults identically on every run even though the lease client sends
from several threads in nondeterministic order.  Recv-side faults key on
the per-socket call index (each socket is read by exactly one thread).
The ``ledger`` is reproducible by seed up to reordering of concurrent
entries; compare it sorted.  The same seed and frames give the
reference's ledger.
"""

from __future__ import annotations

import threading
import time

__all__ = ["ChaosSocket", "chaos_connector"]


class ChaosSocket:
    """Fault-injecting proxy around a connected stream socket."""

    KINDS = ("cut", "trickle", "fragment")

    def __init__(
        self,
        inner,
        *,
        seed: int = 0,
        cut_rate: float = 0.0,
        trickle_rate: float = 0.0,
        trickle_chunk: int = 3,
        trickle_delay: float = 0.002,
        fragment_rate: float = 0.0,
        fragment_bytes: int = 5,
    ):
        self._inner = inner
        self._seed = seed
        self._cut_rate = cut_rate
        self._trickle_rate = trickle_rate
        self._trickle_chunk = max(1, trickle_chunk)
        self._trickle_delay = trickle_delay
        self._fragment_rate = fragment_rate
        self._fragment_bytes = max(1, fragment_bytes)
        self._lock = threading.Lock()
        self._op_counts: dict[str, int] = {}
        self.injected: dict[str, int] = {k: 0 for k in self.KINDS}
        self.ledger: list[tuple[str, int, str]] = []

    # -- seeded decisions --------------------------------------------------

    def _rng(self, key: str):
        import random

        # string-seeded Random hashes its bytes (sha512): stable across
        # processes and threads, like ChaosTransport's (seed, url) scheme
        return random.Random(f"{self._seed}|{key}")

    def _next(self, op: str) -> int:
        with self._lock:
            n = self._op_counts.get(op, 0)
            self._op_counts[op] = n + 1
        return n

    def _record(self, op: str, tag, kind: str) -> None:
        with self._lock:
            self.injected[kind] += 1
            self.ledger.append((op, tag, kind))
        from advanced_scrapper_tpu_torch.obs import telemetry, trace

        telemetry.event_counter(
            "astpu_fault_injected_total",
            "chaos faults fired, by plane and kind",
            plane="socket",
            kind=kind,
        ).inc()
        trace.record("fault", f"socket.{kind}", op=op)

    # -- faulted surface ---------------------------------------------------

    def sendall(self, data: bytes) -> None:
        import hashlib

        digest = hashlib.sha1(bytes(data)).hexdigest()[:12]
        occ = self._next(f"send|{digest}")
        r = self._rng(f"send|{digest}|{occ}")
        draw = r.random
        if self._cut_rate and draw() < self._cut_rate:
            self._record("send", (digest, occ), "cut")
            prefix = r.randrange(1, len(data)) if len(data) > 1 else 0
            if prefix:
                self._inner.sendall(data[:prefix])
            import socket as _socket

            try:
                # shutdown, not just close: another thread blocked in recv
                # holds the file description open, which would delay the
                # peer's EOF by that recv's full timeout — a real crash
                # tears the connection down NOW
                self._inner.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._inner.close()
            except OSError:
                pass
            raise ConnectionResetError(
                f"injected mid-frame cut after {prefix}/{len(data)} bytes"
            )
        if self._trickle_rate and draw() < self._trickle_rate:
            self._record("send", (digest, occ), "trickle")
            for i in range(0, len(data), self._trickle_chunk):
                self._inner.sendall(data[i : i + self._trickle_chunk])
                time.sleep(self._trickle_delay)
            return
        self._inner.sendall(data)

    def recv(self, bufsize: int) -> bytes:
        n = self._next("recv")
        if (
            self._fragment_rate
            and self._rng(f"recv|{n}").random() < self._fragment_rate
        ):
            self._record("recv", n, "fragment")
            return self._inner.recv(min(bufsize, self._fragment_bytes))
        return self._inner.recv(bufsize)

    # -- passthrough -------------------------------------------------------

    def __getattr__(self, name):
        return getattr(self._inner, name)


def chaos_connector(**chaos_kw):
    """``connect`` factory for :class:`net.lease.LeaseClient`: dial the
    address, wrap the socket in a :class:`ChaosSocket`.  Returns
    ``(connect, sockets)`` — the list collects every wrapped socket so the
    caller can inspect the injection ledgers afterwards."""
    import socket as _socket

    sockets: list[ChaosSocket] = []

    def connect(address):
        s = ChaosSocket(
            _socket.create_connection(address, timeout=10), **chaos_kw
        )
        sockets.append(s)
        return s

    return connect, sockets
