"""The filesystem seam, the torn-write-safe whole-file commit, and
deterministic storage fault injection.

The port's copy of the reference's ``storage/fsio.py``:

- :class:`OsFs`, the real substrate behind every persistence site
  (``storage/csvio.py``, ``pipeline/harvest.py``, ``extractors/tpu_batch.py``,
  the index), so fault injection threads in without touching call sites;
- :class:`ChaosFs` / :class:`ChaosFile`, seeded fault injection (short
  writes, EIO on flush, fsync failure, crash after N bytes, a silent bit
  flip): each decision is a pure function of ``(seed, path, per-path op
  index)``, not a shared random stream, so the same seed and the same
  operations give the same ``ledger`` and the same bytes on disk as the
  reference's;
- :func:`atomic_write` / :func:`atomic_replace` (tmp, flush, fsync,
  ``os.replace``, fsync of the directory: a crash at any byte leaves the
  target whole or as it was, never torn);
- :func:`default_fs`, the process default, which the ``ASTPU_CHAOS_FS``
  environment spec overrides so forked children (a kill-restart harness)
  inherit injection without plumbing.
"""

from __future__ import annotations

import errno
import os
import threading

__all__ = [
    "OsFs",
    "ChaosFs",
    "ChaosFile",
    "SimulatedCrash",
    "atomic_replace",
    "atomic_write",
    "default_fs",
    "set_default_fs",
]


class SimulatedCrash(BaseException):
    """Raised by the crash-after-N-bytes fault (in-process flavour).

    A ``BaseException`` on purpose: production code catching broad
    ``Exception`` for per-item containment must NOT swallow a simulated
    process death — the whole point is that nothing downstream of the
    crash point runs, exactly like SIGKILL.  (Child processes under a
    kill-restart harness use ``exit=1`` in the env spec instead, which
    calls ``os._exit`` — a real no-cleanup death.)
    """


class OsFs:
    """The real filesystem, behind the seam every persistence site uses."""

    def open(self, path: str, mode: str = "r", **kw):
        return open(path, mode, **kw)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def size(self, path: str) -> int:
        return os.stat(path).st_size

    def replace(self, src: str, dst: str) -> None:
        os.replace(src, dst)

    def remove(self, path: str) -> None:
        os.unlink(path)

    def fsync(self, fh) -> None:
        os.fsync(fh.fileno())

    def fsync_dir(self, path: str) -> None:
        """Best-effort directory fsync after a rename — required for the
        rename itself to be durable on POSIX, silently skipped where
        directories cannot be opened (e.g. some overlay mounts)."""
        try:
            fd = os.open(os.path.dirname(os.path.abspath(path)) or ".", os.O_RDONLY)
        except OSError:
            return
        try:
            os.fsync(fd)
        except OSError:
            pass
        finally:
            os.close(fd)


class ChaosFile:
    """Fault-injecting proxy around one open file object.

    Write-side faults only — reads pass through (torn *tails* are created
    by faulted writes and crashes; the read-side contract is the torn-tail
    repair in ``storage/csvio.py``).  Fault kinds:

    - ``short_write``: persist a strict prefix of the buffer, then raise
      ``EIO`` — the torn-tail generator (a real ``write(2)`` can persist
      fewer bytes than asked before the error).
    - ``eio_flush``: ``flush()`` raises ``EIO`` without flushing.
    - ``crash``: persist a prefix, flush it, then die (``SimulatedCrash``
      in-process; ``os._exit`` under ``exit=1``) — crash-after-N-bytes.
    - ``bitflip``: SILENTLY flip one seeded bit of the buffer and persist
      the rest intact — no error, no short count: the medium lied.  The
      bit-rot generator the integrity plane (segment block CRCs, scrub,
      ``tools/fsck_index.py``) exists to catch; binary writes only (a
      text-mode write passes through unfaulted and uncounted).
    """

    def __init__(self, inner, fs: "ChaosFs", path: str):
        self._inner = inner
        self._fs = fs
        self._path = path

    # -- faulted surface ---------------------------------------------------

    def write(self, data):
        binary = isinstance(data, (bytes, bytearray, memoryview))
        kind = self._fs._decide(self._path, "write", binary=binary)
        if kind == "bitflip":
            # silent corruption: the write "succeeds" byte-for-byte except
            # one seeded flipped bit — exactly what a rotting medium does
            return self._inner.write(self._fs._flip_bit(self._path, bytes(data)))
        if kind in ("short_write", "crash"):
            # persist a deterministic strict prefix — the byte count comes
            # from the same seeded stream as the fault decision
            n = self._fs._prefix_len(self._path, len(data))
            self._inner.write(data[:n])
            self._inner.flush()
            if kind == "crash":
                self._fs._die(self._path, "write")
            raise OSError(
                errno.EIO,
                f"injected short write ({n}/{len(data)} bytes) for {self._path}",
            )
        return self._inner.write(data)

    def flush(self):
        kind = self._fs._decide(self._path, "flush")
        if kind == "eio_flush":
            raise OSError(errno.EIO, f"injected flush failure for {self._path}")
        if kind == "crash":
            self._fs._die(self._path, "flush")
        return self._inner.flush()

    # -- passthrough -------------------------------------------------------

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._inner.close()

    def __iter__(self):
        return iter(self._inner)


class ChaosFs:
    """Deterministic fault injection around any inner fs backend.

    Mirrors :class:`net.transport.ChaosTransport`: every fault decision is
    a pure function of ``(seed, path, per-path op index)`` — two runs with
    the same seed executing the same operation sequence produce an
    identical ``ledger`` (the reproducibility contract the crash sweep
    asserts).  ``injected`` counts faults by kind; ``ledger`` records
    ``(path, op, kind)`` in fire order.

    ``only`` restricts injection to paths containing the substring — e.g.
    fault only the success CSV, leaving fixture reads untouched.
    """

    #: fault kinds, in decision order (one uniform draw per kind, like
    #: ChaosTransport's rate cascade; ``bitflip`` sits LAST so enabling it
    #: never shifts the draw sequence of pre-existing seeded specs)
    KINDS = ("short_write", "eio_flush", "fsync_error", "crash", "bitflip")

    def __init__(
        self,
        inner=None,
        *,
        seed: int = 0,
        short_write_rate: float = 0.0,
        eio_flush_rate: float = 0.0,
        fsync_error_rate: float = 0.0,
        crash_rate: float = 0.0,
        bitflip_rate: float = 0.0,
        only: str | None = None,
        on_crash=None,
    ):
        self._inner = inner or OsFs()
        self._seed = seed
        self._rates = {
            "short_write": short_write_rate,
            "eio_flush": eio_flush_rate,
            "fsync_error": fsync_error_rate,
            "crash": crash_rate,
            "bitflip": bitflip_rate,
        }
        self._only = only
        self._on_crash = on_crash  # None → raise SimulatedCrash
        self._lock = threading.Lock()
        self._op_counts: dict[tuple[str, str], int] = {}
        self.injected: dict[str, int] = {k: 0 for k in self.KINDS}
        self.ledger: list[tuple[str, str, str]] = []

    # -- decision machinery ------------------------------------------------

    def _rng(self, path: str, op: str, n: int):
        import random

        # string-seeded Random hashes its bytes (sha512): stable across
        # processes and threads, like ChaosTransport's (seed, url) scheme
        return random.Random(f"{self._seed}|{os.path.basename(path)}|{op}|{n}")

    def _decide(self, path: str, op: str, *, binary: bool = True) -> str | None:
        if self._only is not None and self._only not in path:
            return None
        with self._lock:
            key = (os.path.basename(path), op)
            n = self._op_counts.get(key, 0)
            self._op_counts[key] = n + 1
        r = self._rng(path, op, n).random
        for kind in self.KINDS:
            if self._rates[kind] and r() < self._rates[kind]:
                if kind == "bitflip" and not binary:
                    return None  # flip is defined on bytes only
                if (kind, op) in _KIND_OPS:
                    with self._lock:
                        self.injected[kind] += 1
                        self.ledger.append((os.path.basename(path), op, kind))
                    # fault counts belong on /metrics, not only in the
                    # ledger object a test happens to hold (always-on:
                    # injection is rare by construction)
                    from advanced_scrapper_tpu_torch.obs import telemetry

                    telemetry.event_counter(
                        "astpu_fault_injected_total",
                        "chaos faults fired, by plane and kind",
                        plane="fs",
                        kind=kind,
                    ).inc()
                    return kind
                return None  # kind drawn but not applicable to this op
        return None

    def _flip_bit(self, path: str, data: bytes) -> bytes:
        """One seeded bit flipped in ``data`` — same determinism contract
        as every other fault: a pure function of (seed, path, per-path
        flip index)."""
        if not data:
            return data
        with self._lock:
            key = (os.path.basename(path), "bitflip")
            n = self._op_counts.get(key, 0)
            self._op_counts[key] = n + 1
        bit = self._rng(path, "bitflip", n).randrange(len(data) * 8)
        out = bytearray(data)
        out[bit // 8] ^= 1 << (bit % 8)
        return bytes(out)

    def _prefix_len(self, path: str, total: int) -> int:
        if total <= 1:
            return 0
        with self._lock:
            key = (os.path.basename(path), "prefix")
            n = self._op_counts.get(key, 0)
            self._op_counts[key] = n + 1
        return self._rng(path, "prefix", n).randrange(1, total)

    def _die(self, path: str, op: str):
        # last act before death: dump the flight recorder so the sweep
        # harness can assert on what was in flight at the kill point
        # (covers BOTH flavours — os._exit runs no cleanup handlers, and
        # SimulatedCrash is a BaseException production code must not catch)
        try:
            from advanced_scrapper_tpu_torch.obs import trace

            trace.dump_on_fault(f"chaos-fs crash during {op} of {path}")
        except Exception:
            pass
        if self._on_crash is not None:
            self._on_crash()
        raise SimulatedCrash(f"injected crash during {op} of {path}")

    # -- fs surface --------------------------------------------------------

    def open(self, path: str, mode: str = "r", **kw):
        fh = self._inner.open(path, mode, **kw)
        if any(m in mode for m in ("w", "a", "+", "x")):
            return ChaosFile(fh, self, path)
        return fh

    def exists(self, path: str) -> bool:
        return self._inner.exists(path)

    def size(self, path: str) -> int:
        return self._inner.size(path)

    def replace(self, src: str, dst: str) -> None:
        kind = self._decide(dst, "replace")
        if kind == "crash":
            self._die(dst, "replace")
        self._inner.replace(src, dst)

    def remove(self, path: str) -> None:
        self._inner.remove(path)

    def fsync(self, fh) -> None:
        target = getattr(fh, "name", "<fh>")
        kind = self._decide(str(target), "fsync")
        if kind == "fsync_error":
            raise OSError(errno.EIO, f"injected fsync failure for {target}")
        if kind == "crash":
            self._die(str(target), "fsync")
        inner = getattr(fh, "_inner", fh)
        self._inner.fsync(inner)

    def fsync_dir(self, path: str) -> None:
        self._inner.fsync_dir(path)


#: which fault kinds apply to which operation — a draw of an inapplicable
#: kind is a no-fault (keeps each op's decision a single-seeded function
#: instead of per-op rate vocabularies)
_KIND_OPS = {
    ("short_write", "write"),
    ("crash", "write"),
    ("bitflip", "write"),
    ("eio_flush", "flush"),
    ("crash", "flush"),
    ("fsync_error", "fsync"),
    ("crash", "fsync"),
    ("crash", "replace"),
}


#: dir → leftover ``*.tmp-*`` names found by the once-per-process scandir
#: (a listing per atomic_write would be O(dir) on every persist — a full
#: harvest writes thousands of files into one shard_dir)
_stale_tmps: dict[str, set[str]] = {}
_stale_lock = threading.Lock()


def _sweep_stale_tmps(path: str, own_tmp: str, fs) -> None:
    """Remove tmp orphans left by CRASHED writers of ``path``: their pids
    differ, so the writer's own cleanup never matches them, and a long
    deployment of kill-restart cycles would otherwise grow the directory
    unboundedly (the single-writer model makes any same-path tmp with a
    foreign pid stale by definition).  The directory is listed once per
    process — orphans only ever predate it."""
    dirname = os.path.dirname(os.path.abspath(path)) or "."
    with _stale_lock:
        found = _stale_tmps.get(dirname)
        if found is None:
            found = set()
            try:
                with os.scandir(dirname) as it:
                    for entry in it:
                        if ".tmp-" in entry.name:
                            found.add(entry.name)
            except OSError:
                pass
            _stale_tmps[dirname] = found
        prefix = os.path.basename(path) + ".tmp-"
        mine = [n for n in found if n.startswith(prefix)]
        found.difference_update(mine)
    for name in mine:
        stale = os.path.join(dirname, name)
        if stale != own_tmp:
            try:
                fs.remove(stale)
            except OSError:
                pass


def atomic_write(path: str, writer, fs=None) -> None:
    """Torn-write-safe whole-file persistence: tmp + flush + fsync + rename.

    ``writer(fh)`` streams the payload into the tmp handle (so large
    artifacts — e.g. a compressed npz of all kept signatures — never need
    a second in-memory copy).  The rename is the commit point — a crash
    at any earlier byte leaves ``path`` untouched (tmp garbage is
    re-created/cleaned on retry, and stale tmps are invisible to every
    reader).  This is the primitive behind shard files and the
    stream-index checkpoint; append-style CSVs use torn-tail repair
    instead (``storage/csvio.py``).
    """
    fs = fs or default_fs()
    tmp = f"{path}.tmp-{os.getpid()}"
    _sweep_stale_tmps(path, tmp, fs)
    try:
        with fs.open(tmp, "wb") as fh:
            writer(fh)
            fh.flush()
            fs.fsync(fh)
        fs.replace(tmp, path)
    except SimulatedCrash:
        # a simulated death leaves its torn tmp behind, exactly like a
        # real SIGKILL would — readers must prove they never look at it
        raise
    except BaseException:
        # ordinary failures (EIO, fsync error) clean their tmp so retries
        # never see garbage
        try:
            if fs.exists(tmp):
                fs.remove(tmp)
        except OSError:
            pass
        raise
    fs.fsync_dir(path)


def atomic_replace(path: str, data: bytes, fs=None) -> None:
    """:func:`atomic_write` for callers whose payload is already bytes."""
    atomic_write(path, lambda fh: fh.write(data), fs=fs)


# -- process default -------------------------------------------------------

_default_lock = threading.Lock()
_default_fs = None


def _parse_env_spec(spec: str):
    """``ASTPU_CHAOS_FS="seed=7,short_write=0.05,eio_flush=0.02,fsync=0.02,
    crash=0.01,exit=1,only=success"`` → a configured :class:`ChaosFs`.

    ``exit=1`` makes the crash fault call ``os._exit(73)`` — a real
    no-cleanup process death for forked children under the kill-restart
    harness (in-process callers get :class:`SimulatedCrash` instead).
    """
    kw: dict = {}
    on_crash = None
    only = None
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        k, _, v = part.partition("=")
        k = k.strip()
        v = v.strip()
        if k == "seed":
            kw["seed"] = int(v)
        elif k == "short_write":
            kw["short_write_rate"] = float(v)
        elif k == "eio_flush":
            kw["eio_flush_rate"] = float(v)
        elif k == "fsync":
            kw["fsync_error_rate"] = float(v)
        elif k == "crash":
            kw["crash_rate"] = float(v)
        elif k == "bitflip":
            kw["bitflip_rate"] = float(v)
        elif k == "only":
            only = v
        elif k == "exit":
            if v not in ("0", "", "false"):
                on_crash = lambda: os._exit(73)  # noqa: E731
        else:
            raise ValueError(f"unknown ASTPU_CHAOS_FS key {k!r}")
    return ChaosFs(OsFs(), only=only, on_crash=on_crash, **kw)


def default_fs():
    """The process-wide fs backend every persistence site defaults to.

    Plain :class:`OsFs` unless ``ASTPU_CHAOS_FS`` is set (evaluated once,
    at first use) or a test installed one via :func:`set_default_fs`.
    """
    global _default_fs
    with _default_lock:
        if _default_fs is None:
            spec = os.environ.get("ASTPU_CHAOS_FS", "")
            _default_fs = _parse_env_spec(spec) if spec else OsFs()
        return _default_fs


def set_default_fs(fs) -> None:
    """Install (or with ``None``, reset) the process default — the hook
    tests use to thread :class:`ChaosFs` under engines without touching
    their call signatures."""
    global _default_fs
    with _default_lock:
        _default_fs = fs
