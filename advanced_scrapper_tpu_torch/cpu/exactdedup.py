"""ctypes loader for the zero-copy exact-dedup tier (``native/exactdedup.cpp``).

The port's counterpart of the reference's ``cpu/exactdedup.py``.  The
source includes ``Python.h`` (it reads str/bytes buffers in place, so the
host never joins the corpus), so it needs the CPython headers to build
and the GIL to run: it is loaded through :class:`ctypes.PyDLL`.  Where the
headers are missing, this tier is off (:func:`backend_reason` names them)
and ``ExactDedup`` goes on to the blob tier; a source that is present and
fails to compile or load raises (``cpu/native.py``).  An input this tier
does not serve goes on to the next tier, as in the reference: a non-list,
mixed str and bytes, or a str that UTF-8 cannot view (a lone surrogate).
"""

from __future__ import annotations

import ctypes
import os
import sysconfig
import threading

import numpy as np

from advanced_scrapper_tpu_torch.cpu import native

SOURCE = native.PACKAGE_DIR / "native" / "exactdedup.cpp"

_lock = threading.Lock()
_lib: ctypes.PyDLL | None = None
_backend = "unloaded"
_reason = ""  # why the tier is off ("" when it is live)


def _include() -> str | None:
    """The CPython include directory, when it holds ``Python.h``."""
    include = sysconfig.get_paths().get("include")
    if include and os.path.exists(os.path.join(include, "Python.h")):
        return include
    return None


def flags() -> list[str]:
    """The g++ flags of this source: the common ones and ``-I<include>``."""
    return [*native.CXX_FLAGS, f"-I{_include()}"]


def _load() -> ctypes.PyDLL | None:
    global _lib, _backend, _reason
    if _backend != "unloaded":
        return _lib
    with _lock:
        if _backend != "unloaded":
            return _lib
        if _include() is None:
            _backend = "python"
            _reason = (
                "CPython headers not found (no Python.h under "
                f"{sysconfig.get_paths().get('include')!r})"
            )
            return None
        # PyDLL: calls run with the GIL held, since the kernel walks live
        # Python objects
        lib = ctypes.PyDLL(str(native.build(SOURCE, flags())))
        lib.ed_keep_first_list.restype = ctypes.c_long
        lib.ed_keep_first_list.argtypes = [ctypes.py_object, ctypes.c_void_p]
        _lib = lib
        _backend = "native"
        return lib


def exactdedup_backend() -> str:
    """``"native"`` or ``"python"`` (after first use)."""
    _load()
    return _backend


def backend_reason() -> str:
    """Why the zero-copy tier is off; ``""`` when it is live."""
    _load()
    return _reason


def keep_first_list(items) -> np.ndarray | None:
    """``uint8[n]`` first-seen keep mask straight over a list of str or
    bytes, or ``None`` where this tier does not serve the input (headers
    missing, a non-list, mixed str/bytes, a str UTF-8 cannot view)."""
    lib = _load()
    if lib is None or not isinstance(items, list):
        return None
    keep = np.zeros((len(items),), dtype=np.uint8)
    rc = lib.ed_keep_first_list(items, keep.ctypes.data)
    if rc < 0:
        return None
    return keep
