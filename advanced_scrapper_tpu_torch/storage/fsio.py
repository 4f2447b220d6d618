"""The filesystem seam and the torn-write-safe whole-file commit.

Counterpart of the reference's ``storage/fsio.py``: :class:`OsFs` (the
real substrate behind every persistence site), :func:`atomic_write` and
:func:`atomic_replace` (tmp, flush, fsync, ``os.replace``, fsync of the
directory: a crash at any byte leaves the target whole or as it was, never
torn), and the process default :func:`default_fs` / :func:`set_default_fs`.

The reference's fault injection (``ChaosFs``, ``ChaosFile``) and its
``ASTPU_CHAOS_FS`` environment spec are not ported yet: with that variable
set, :func:`default_fs` raises ``NotImplementedError``.  A caller may pass
any object with :class:`OsFs`'s surface as ``fs``.
"""

from __future__ import annotations

import os
import threading

__all__ = ["OsFs", "atomic_replace", "atomic_write", "default_fs", "set_default_fs"]

SLICE_CHAOS = "the slice of ROADMAP item 18 (the host planes)"


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
        """Best-effort directory fsync after a rename (what makes the
        rename itself durable on POSIX); skipped where a directory cannot
        be opened."""
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


#: dir → leftover ``*.tmp-*`` names found by the once-per-process listing
_stale_tmps: dict[str, set[str]] = {}
_stale_lock = threading.Lock()


def _sweep_stale_tmps(path: str, own_tmp: str, fs) -> None:
    """Remove the tmp files that crashed writers of ``path`` left behind:
    their pids differ from this process's, so under one writer per path
    each is stale.  The directory is listed once per process; orphans only
    ever predate it."""
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

    ``writer(fh)`` streams the payload into the tmp handle, so a large
    artifact needs no second copy in memory.  The rename is the commit
    point: a failure before it removes the tmp and leaves ``path`` as it
    was."""
    fs = fs or default_fs()
    tmp = f"{path}.tmp-{os.getpid()}"
    _sweep_stale_tmps(path, tmp, fs)
    try:
        with fs.open(tmp, "wb") as fh:
            writer(fh)
            fh.flush()
            fs.fsync(fh)
        fs.replace(tmp, path)
    except BaseException:
        try:
            if fs.exists(tmp):
                fs.remove(tmp)
        except OSError:
            pass
        raise
    fs.fsync_dir(path)


def atomic_replace(path: str, data: bytes, fs=None) -> None:
    """:func:`atomic_write` for a payload that is already bytes."""
    atomic_write(path, lambda fh: fh.write(data), fs=fs)


_default_lock = threading.Lock()
_default_fs = None


def default_fs():
    """The process-wide fs every persistence site defaults to: :class:`OsFs`
    unless :func:`set_default_fs` installed another."""
    global _default_fs
    with _default_lock:
        if _default_fs is None:
            if os.environ.get("ASTPU_CHAOS_FS"):
                raise NotImplementedError(
                    "ASTPU_CHAOS_FS (storage fault injection) is not ported yet; "
                    f"it comes in {SLICE_CHAOS}"
                )
            _default_fs = OsFs()
        return _default_fs


def set_default_fs(fs) -> None:
    """Install (or with ``None``, reset) the process default."""
    global _default_fs
    with _default_lock:
        _default_fs = fs
