"""Wrappers of the hand-written CUDA LSH epilogues (``csrc/lsh.cu``).

Five kernels replace the jnp device code of the reference's
``ops/lsh.py``, each bit-equal to its plain version in ``ops.lsh``:

- :func:`lsh_keys`: the band keys of every key set of a signature row in
  one launch (coarse then fine, or the two wide lanes), and, from the same
  launch, the packed per-band sort keys of :func:`lsh_sort`, a tile of
  rows through shared memory a block (:func:`keys_load` says how the tile
  is read); :func:`pack_keys` packs keys already made (counted as
  ``lsh_keys``);
- :func:`lsh_sort`: each band's packed keys, whose rows enter ascending,
  sorted by a stable LSD radix sort of their 32 key bits (a digit count,
  then a scatter a pass, all counted);
- :func:`lsh_run_heads`: run head, predecessor and predecessor² of every
  row in every band (at most :data:`MAX_HEAD_BANDS`) from the bands'
  sorted packed keys (a scan, then a transpose into the rows: 2 launches,
  both counted);
- :func:`lsh_verify`: the agreement of every (row, candidate) edge against
  a scalar, per-column, per-edge or fine-only bar, the exact-verify
  ``need`` mask, or the fine-only bars alone;
- :func:`lsh_label`: the component-minimum label rounds over each row's
  distinct ok edges, :data:`LABEL_LAUNCHES` launches whatever the rounds
  (the edge lists, then one cooperative launch of every round; both
  counted).

Each checks device, dtype, shape and contiguity before anything is built,
launches on PyTorch's current stream, raises if a launch returns a CUDA
error, and counts its launches in a plain integer attribute
(``lsh_keys.launches`` ...).  None falls back to the plain version; a CPU
tensor raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from advanced_scrapper_tpu_torch.ops import _build

_ptr = ctypes.c_void_p
_int = ctypes.c_int
_float = ctypes.c_float

#: the most key sets a row may have (``kMaxSalts`` in ``csrc/lsh.cu``: the
#: salts travel by value in the launch's parameter buffer)
MAX_SALTS = 512
#: the most bands :func:`lsh_run_heads` takes (``kMaxHeadBands``: a row's
#: ``3·nbt + 1`` int32 fit the transpose's 48 KiB tile)
MAX_HEAD_BANDS = 4095
#: kernel launches of one :func:`lsh_run_heads` call
RUN_HEADS_LAUNCHES = 2
#: kernel launches of one :func:`lsh_label` call, whatever its rounds
#: (``kLabelLaunches``: the edge lists, then every round in one launch)
LABEL_LAUNCHES = 2
#: how :func:`lsh_keys` reads a tile's signatures (``KeysLoad``): straight
#: from global memory (the tile does not fit a block), 4-byte words or
#: 16-byte words through shared memory
KEYS_LOAD_GLOBAL, KEYS_LOAD_WORDS, KEYS_LOAD_VEC = 0, 1, 2
#: ``thr_mode`` of ``astt_lsh_verify``
THR_SCALAR, THR_COLUMN, THR_EDGE, THR_FINE = 0, 1, 2, 3


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (pointers as
    ``c_void_p``, so ctypes never cuts them to 32 bits)."""
    lib = _build.load("lsh")
    lib.astt_lsh_keys.argtypes = [
        _ptr, _int, _int, _int, _int, _ptr, _int, _ptr, _ptr, _int, _ptr, _ptr,
    ]
    lib.astt_lsh_keys_load.argtypes = [_ptr, _int, _int, _int, _int]
    lib.astt_lsh_keys_load.restype = ctypes.c_int
    lib.astt_lsh_pack.argtypes = [_ptr, _int, _int, _ptr, _int, _ptr, _ptr]
    lib.astt_lsh_sort.argtypes = [_ptr, _int, _int, _int, _ptr, _ptr, _ptr, _ptr]
    lib.astt_lsh_sort_scratch.argtypes = [_int, _int]
    lib.astt_lsh_sort_scratch.restype = ctypes.c_longlong
    lib.astt_lsh_sort_launches.restype = ctypes.c_int
    lib.astt_lsh_sort_passes.restype = ctypes.c_int
    lib.astt_lsh_run_heads.argtypes = [_ptr, _ptr, _int, _int, _int, _ptr, _ptr, _ptr]
    lib.astt_lsh_max_head_bands.restype = ctypes.c_int
    lib.astt_lsh_run_heads_scratch.argtypes = [_int, _int, _int]
    lib.astt_lsh_run_heads_scratch.restype = ctypes.c_longlong
    lib.astt_lsh_verify.argtypes = [
        _ptr, _int, _ptr, _int, _int, _ptr, _ptr, _int, _int, _ptr, _int, _float, _float,
        _float, _ptr, _ptr, _ptr, _ptr,
    ]
    lib.astt_lsh_label.argtypes = [_ptr, _ptr, _ptr, _int, _int, _int, _ptr, _ptr, _ptr]
    lib.astt_lsh_label_scratch.argtypes = [_int, _int]
    lib.astt_lsh_label_scratch.restype = ctypes.c_longlong
    lib.astt_lsh_label_launches.restype = ctypes.c_int
    for fn in ("keys", "pack", "sort", "run_heads", "verify", "label"):
        getattr(lib, f"astt_lsh_{fn}").restype = ctypes.c_int
    lib.astt_lsh_max_salts.restype = ctypes.c_int
    lib.astt_lsh_error_string.argtypes = [ctypes.c_int]
    lib.astt_lsh_error_string.restype = ctypes.c_char_p
    return lib


def max_salts() -> int:
    """The kernel's ``kMaxSalts`` (builds the library if needed)."""
    return _lib().astt_lsh_max_salts()


def max_head_bands() -> int:
    """The kernel's ``kMaxHeadBands`` (builds the library if needed)."""
    return _lib().astt_lsh_max_head_bands()


def label_launches() -> int:
    """The kernel's ``kLabelLaunches`` (builds the library if needed)."""
    return _lib().astt_lsh_label_launches()


def _raise_on(err: int, name: str) -> None:
    if err:
        msg = _lib().astt_lsh_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _on_card(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(
            f"the CUDA kernel takes CUDA tensors, got {name} on {t.device}; the plain "
            "versions in ops.lsh run on the CPU"
        )


def _check(t: torch.Tensor, name: str, dtypes: tuple, ndim: int, dev: torch.device) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_valid(valid: torch.Tensor, B: int, dev: torch.device) -> None:
    _check(valid, "valid", (torch.bool,), 1, dev)
    if valid.shape[0] != B:
        raise ValueError(f"valid has {valid.shape[0]} rows, expected {B}")


def salt_array(salt) -> np.ndarray:
    """The salts as a contiguous host ``uint32`` array (a tensor's values
    are read back once)."""
    if isinstance(salt, torch.Tensor):
        salt = (salt.detach().cpu().to(torch.int64) & 0xFFFFFFFF).numpy()
    return np.ascontiguousarray(np.asarray(salt).astype(np.uint32))


def lsh_keys(
    sig: torch.Tensor,
    band_salt,
    fine_salt=(),
    *,
    wide: bool = False,
    valid: torch.Tensor | None = None,
    bits: int = 0,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """``(keys, packed)`` of ``sig uint32/int32[B, P]`` on the card in one
    launch.  ``keys`` is ``int64[B, nb + nf]`` in ``[0, 2³²)`` (coarse
    salts ``band_salt``, then fine ``fine_salt``), or with ``wide``
    ``int64[B, nb, 2]`` (lane 1 ``WIDE_OFFSET``/``WIDE_PRIME`` and the salt
    rotated left by 13; ``fine_salt`` must be empty).  With ``valid``,
    ``packed`` is the sort keys ``int64[nb + nf, B]``: ``((valid ? key :
    U32_MAX) << bits) | row``; else ``None``.  A block takes 32 rows;
    :func:`keys_load` says how it reads them."""
    _on_card(sig, "sig")
    dev = sig.device
    _check(sig, "sig", (torch.uint32, torch.int32), 2, dev)
    B, P = sig.shape
    coarse, fine = salt_array(band_salt), salt_array(fine_salt)
    nb, nf = coarse.size, fine.size
    if nb < 1 or nb + nf > MAX_SALTS:
        raise ValueError(f"{nb} + {nf} key sets; the kernel takes 1 to {MAX_SALTS}")
    for n in (nb, nf):
        if n and P % n:
            raise ValueError(f"{n} key sets must divide num_perm {P}")
    if wide and nf:
        raise ValueError("the wide keys take no fine salts")
    if valid is not None:
        if wide:
            raise ValueError("the wide keys have no packed sort keys")
        _check_valid(valid, B, dev)
        if not 0 <= bits <= 31 or (B > 1 and (B - 1) >> bits):
            raise ValueError(f"{B} rows do not fit {bits} row bits (at most 31)")
    salts = np.concatenate([coarse, fine])
    keys = torch.empty((B, nb, 2) if wide else (B, nb + nf), dtype=torch.int64, device=dev)
    packed = (torch.empty((nb + nf, B), dtype=torch.int64, device=dev)
              if valid is not None else None)
    if B:
        err = _lib().astt_lsh_keys(
            sig.data_ptr(), B, P, nb, nf, salts.ctypes.data, int(wide), keys.data_ptr(),
            None if valid is None else valid.data_ptr(), bits,
            None if packed is None else packed.data_ptr(), _stream(dev),
        )
        _raise_on(err, "lsh_keys")
        lsh_keys.launches += 1
    return keys, packed


lsh_keys.launches = 0


def keys_load(sig: torch.Tensor, nb: int, nf: int = 0, *, wide: bool = False) -> int:
    """How :func:`lsh_keys` reads ``sig``'s tiles at ``nb`` + ``nf`` key
    sets: :data:`KEYS_LOAD_VEC` (16-byte words through shared memory: the
    rows 16-byte aligned, ``P`` and each band width a multiple of 4),
    :data:`KEYS_LOAD_WORDS` (4-byte words through shared memory) or
    :data:`KEYS_LOAD_GLOBAL` (the tile does not fit a block's shared
    memory).  Builds the library if needed."""
    return _lib().astt_lsh_keys_load(sig.data_ptr(), sig.shape[1], nb, nf, int(wide))


def pack_keys(keys: torch.Tensor, valid: torch.Tensor, bits: int) -> torch.Tensor:
    """The sort keys ``int64[nk, B]`` of ``keys int64[B, nk]`` already made
    (see :func:`lsh_keys`), 32 rows' keys through shared memory a block;
    one launch, counted as ``lsh_keys``."""
    _on_card(keys, "keys")
    dev = keys.device
    _check(keys, "keys", (torch.int64,), 2, dev)
    B, nk = keys.shape
    _check_valid(valid, B, dev)
    if not 1 <= nk <= MAX_SALTS:
        raise ValueError(f"keys need 1 to {MAX_SALTS} columns, got {nk}")
    if not 0 <= bits <= 31 or (B > 1 and (B - 1) >> bits):
        raise ValueError(f"{B} rows do not fit {bits} row bits (at most 31)")
    packed = torch.empty((nk, B), dtype=torch.int64, device=dev)
    if B:
        err = _lib().astt_lsh_pack(keys.data_ptr(), B, nk, valid.data_ptr(), bits,
                                   packed.data_ptr(), _stream(dev))
        _raise_on(err, "lsh_keys (pack)")
        lsh_keys.launches += 1
    return packed


def _check_bands(packed: torch.Tensor, name: str, bits: int) -> tuple[int, int]:
    """``(nbt, B)`` of packed sort keys ``int64[nbt, B]`` on the card."""
    _on_card(packed, name)
    _check(packed, name, (torch.int64,), 2, packed.device)
    nbt, B = packed.shape
    if not 1 <= nbt <= 65535:
        raise ValueError(f"{nbt} bands; the kernel takes 1 to 65,535")
    if not 0 <= bits <= 31 or (B > 1 and (B - 1) >> bits):
        raise ValueError(f"{B} rows do not fit {bits} row bits (at most 31)")
    return nbt, B


def lsh_sort(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """Each band of the packed sort keys ``packed int64[nbt, B]``, whose
    row fields ascend along the band, sorted: ``int64[nbt, B]``.

    The kernel sorts by the 32 key bits alone, stably, so the rows must
    enter ascending: ``packed`` is ``(key << bits) | row`` with ``key <
    2³²`` and ``row`` the position in the band, as :func:`lsh_keys` and
    :func:`pack_keys` write it.  Then the result is ``torch.sort(packed,
    dim=1).values``; keys in any other row order come out ordered by key
    and, within a key, in the order they entered, which is not that.  The
    precondition is not checked (it would read every key once more).
    ``sort_launches()`` launches (a digit count, then a scatter a pass)."""
    nbt, B = _check_bands(packed, "packed", bits)
    out = torch.empty_like(packed)
    if B:
        lib = _lib()
        tmp = torch.empty_like(packed)
        scratch = torch.empty((lib.astt_lsh_sort_scratch(B, nbt),), dtype=torch.uint8,
                              device=packed.device)
        err = lib.astt_lsh_sort(packed.data_ptr(), B, nbt, bits, out.data_ptr(), tmp.data_ptr(),
                                scratch.data_ptr(), _stream(packed.device))
        _raise_on(err, "lsh_sort")
        lsh_sort.launches += sort_launches()
    return out


lsh_sort.launches = 0


def sort_launches() -> int:
    """Kernel launches of one :func:`lsh_sort` call (builds the library if
    needed)."""
    return _lib().astt_lsh_sort_launches()


def sort_passes() -> int:
    """The radix passes of one :func:`lsh_sort` call."""
    return _lib().astt_lsh_sort_passes()


def lsh_run_heads(sorted_keys: torch.Tensor, valid: torch.Tensor, bits: int) -> torch.Tensor:
    """``int32[B, 3·nbt]``: run heads of every band, then predecessors,
    then predecessors², from ``sorted_keys int64[nbt, B]`` (each band's
    packed keys ascending, :func:`lsh_sort`); self where there is none,
    self for invalid rows; ``nbt`` at most :data:`MAX_HEAD_BANDS`.
    :data:`RUN_HEADS_LAUNCHES` launches (the scan, then the transpose into
    the rows)."""
    nbt, B = _check_bands(sorted_keys, "sorted_keys", bits)
    if nbt > MAX_HEAD_BANDS:
        raise ValueError(f"{nbt} bands; the run heads take 1 to {MAX_HEAD_BANDS:,}")
    dev = sorted_keys.device
    _check_valid(valid, B, dev)
    out = torch.empty((B, 3 * nbt), dtype=torch.int32, device=dev)
    if B:
        lib = _lib()
        rec = torch.empty((lib.astt_lsh_run_heads_scratch(B, nbt, bits),), dtype=torch.uint8,
                          device=dev)
        err = lib.astt_lsh_run_heads(sorted_keys.data_ptr(), valid.data_ptr(), B, nbt, bits,
                                     out.data_ptr(), rec.data_ptr(), _stream(dev))
        _raise_on(err, "lsh_run_heads")
        lsh_run_heads.launches += RUN_HEADS_LAUNCHES
    return out


lsh_run_heads.launches = 0


def lsh_verify(
    rep_bands: torch.Tensor,
    valid: torch.Tensor | None,
    sig: torch.Tensor | None = None,
    *,
    thr: torch.Tensor | None = None,
    base: float = 0.0,
    strict: float | None = None,
    band: float | None = None,
    keys: torch.Tensor | None = None,
    num_coarse: int = 0,
) -> tuple[torch.Tensor | None, torch.Tensor | None, torch.Tensor | None]:
    """``(ok, need, bars)`` of the candidate matrix ``rep_bands int32[B,
    nc]`` in one launch; what is not asked is ``None``.

    - With ``sig uint32/int32[B, P]``: ``ok bool[B, nc]``, an edge whose
      agreement ``count/P`` (float32) clears its bar with both endpoints
      ``valid``.  The bar: ``thr`` (``float32[nc]`` a column or ``[B, nc]``
      an edge), else with ``strict`` and ``keys`` ``strict`` for fine-only
      edges and ``base`` for the rest, else ``base``.
    - With ``band`` (and ``keys``): also ``need bool[B, nc]``, the ok edges
      that are not self and are fine-only or below ``band``.
    - Without ``sig``: ``bars float32[B, nc]``, ``strict`` for fine-only
      edges and ``base`` for the rest (``keys`` and ``strict`` needed).

    Fine-only: column ``c`` is a fine column (``c % nk >= num_coarse``)
    whose candidate shares none of the row's ``num_coarse`` coarse keys of
    ``keys int64[B, nk]``."""
    _on_card(rep_bands, "rep_bands")
    dev = rep_bands.device
    _check(rep_bands, "rep_bands", (torch.int32,), 2, dev)
    B, nc = rep_bands.shape
    if nc < 1:
        raise ValueError("rep_bands needs at least one candidate column")
    P = 0
    if sig is not None:
        _check(sig, "sig", (torch.uint32, torch.int32), 2, dev)
        if sig.shape[0] != B:
            raise ValueError(f"sig has {sig.shape[0]} rows, rep_bands {B}")
        P = sig.shape[1]
        if valid is None:
            raise ValueError("the agreement pass needs valid")
        _check_valid(valid, B, dev)
    nk = 0
    if keys is not None:
        _check(keys, "keys", (torch.int64,), 2, dev)
        nk = keys.shape[1]
        if keys.shape[0] != B or nk < 1 or nc % nk or not 0 <= num_coarse <= nk:
            raise ValueError(
                f"keys {tuple(keys.shape)} must be [{B}, nk] with nk dividing {nc} and "
                f"num_coarse {num_coarse} in [0, nk]"
            )
    mode = THR_SCALAR
    if thr is not None:
        _check(thr, "thr", (torch.float32,), thr.ndim, dev)
        if thr.shape not in ((nc,), (B, nc)):
            raise ValueError(f"thr must be [{nc}] or [{B}, {nc}], got {tuple(thr.shape)}")
        mode = THR_COLUMN if thr.ndim == 1 else THR_EDGE
    elif strict is not None and sig is not None:
        mode = THR_FINE
    if (strict is not None or band is not None) and keys is None:
        raise ValueError("fine-only edges need keys")
    if sig is None and strict is None:
        raise ValueError("without sig the kernel writes the fine bars: give strict and keys")
    if band is not None and sig is None:
        raise ValueError("need takes the agreement pass: give sig")
    ok = torch.empty((B, nc), dtype=torch.bool, device=dev) if sig is not None else None
    need = torch.empty((B, nc), dtype=torch.bool, device=dev) if band is not None else None
    bars = torch.empty((B, nc), dtype=torch.float32, device=dev) if sig is None else None
    def f32(x: float) -> float:  # rounded to float32 here, passed exactly
        return float(np.float32(x))

    if B:
        err = _lib().astt_lsh_verify(
            None if sig is None else sig.data_ptr(), P, rep_bands.data_ptr(), B, nc,
            None if valid is None else valid.data_ptr(),
            None if keys is None else keys.data_ptr(), nk, num_coarse,
            None if thr is None else thr.data_ptr(), mode, f32(base),
            f32(base if strict is None else strict), f32(0.0 if band is None else band),
            None if ok is None else ok.data_ptr(), None if need is None else need.data_ptr(),
            None if bars is None else bars.data_ptr(), _stream(dev),
        )
        _raise_on(err, "lsh_verify")
        lsh_verify.launches += 1
    return ok, need, bars


lsh_verify.launches = 0


def lsh_label(
    rep_bands: torch.Tensor, ok: torch.Tensor, valid: torch.Tensor, jump_rounds: int
) -> torch.Tensor:
    """``int32[B]`` component-minimum labels over the ``ok`` edges of
    ``rep_bands int32[B, nc]`` after ``jump_rounds`` rounds (invalid rows
    self), the reference's ``_label_components``; a candidate outside
    ``[0, B)`` is no edge.  :data:`LABEL_LAUNCHES` launches whatever
    ``jump_rounds`` is: each row's distinct ok candidates compacted into
    scratch sized for every column distinct, then one cooperative launch
    that runs the rounds with a grid sync between pull and jump and stops
    after the first round that changed nothing.  A card that refuses the
    cooperative launch raises with CUDA's error."""
    _on_card(rep_bands, "rep_bands")
    dev = rep_bands.device
    _check(rep_bands, "rep_bands", (torch.int32,), 2, dev)
    B, nc = rep_bands.shape
    _check(ok, "ok", (torch.bool,), 2, dev)
    if ok.shape != rep_bands.shape:
        raise ValueError(f"ok {tuple(ok.shape)} must match rep_bands {tuple(rep_bands.shape)}")
    _check_valid(valid, B, dev)
    if isinstance(jump_rounds, bool) or not isinstance(jump_rounds, int) or jump_rounds < 0:
        raise ValueError(f"jump_rounds must be an int >= 0, got {jump_rounds!r}")
    out = torch.empty((B,), dtype=torch.int32, device=dev)
    if B:
        lib = _lib()
        work = torch.empty((lib.astt_lsh_label_scratch(B, nc),), dtype=torch.uint8, device=dev)
        err = lib.astt_lsh_label(rep_bands.data_ptr(), ok.data_ptr(), valid.data_ptr(), B, nc,
                                 jump_rounds, work.data_ptr(), out.data_ptr(), _stream(dev))
        _raise_on(err, "lsh_label")
        lsh_label.launches += LABEL_LAUNCHES
    return out


lsh_label.launches = 0
