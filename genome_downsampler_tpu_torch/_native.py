"""ctypes bindings to the shared host library ``_bamio.so``.

The C++ packers, capped-coverage histogram and bit test are shared with the
JAX package (``genome_downsampler_tpu/io/csrc/greedy.cpp``, built by
``genome_downsampler_tpu.io.build.build_bamio``); this module binds the same
symbols without importing the JAX modules that also bind them.

The pack outputs are ZERO-COPY views of process-lifetime C arenas: any
later pack call in the same process (from this package or from the JAX
package) silently reuses that memory. ``arena_generation`` lets a consumer
that holds a view across other work check that no pack call of this
package happened in between; a caller mixing both packages in one process
copies the first result before the second pack call.
"""

from __future__ import annotations

import ctypes

import numpy as np

from genome_downsampler_tpu.io.build import build_bamio

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U16P = ctypes.POINTER(ctypes.c_uint16)
_U8P = ctypes.POINTER(ctypes.c_uint8)

_lib = None
_arena_gen = 0


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_bamio()))
        pack_args = [
            _I64P, _I64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64,
        ]
        lib.gd_pack_flat_direct.restype = ctypes.c_int64
        lib.gd_pack_flat_direct.argtypes = pack_args + [
            ctypes.POINTER(_U16P), ctypes.POINTER(_I32P),
            _I64P, _I64P, ctypes.POINTER(_I64P),
        ]
        lib.gd_pack_blocked.restype = ctypes.c_int64
        lib.gd_pack_blocked.argtypes = pack_args + [
            ctypes.POINTER(_I32P), ctypes.POINTER(_I32P),
            _I64P, _I64P, ctypes.POINTER(_I64P),
        ]
        lib.gd_mask_select.restype = ctypes.c_int64
        lib.gd_mask_select.argtypes = [_U8P, _I64P, ctypes.c_int64, _U8P]
        lib.gd_capped_target.restype = ctypes.c_int64
        lib.gd_capped_target.argtypes = [
            _I64P, _I64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _I32P,
        ]
        lib.gd_reconstruct.restype = ctypes.c_int64
        lib.gd_reconstruct.argtypes = [
            _I64P, _I64P, ctypes.c_int64, _I64P, ctypes.c_int64, _U8P,
        ]
        _lib = lib
    return _lib


def arena_generation() -> int:
    """Monotone count of this package's pack calls (see module docstring)."""
    return _arena_gen


def _bump_arena_gen() -> None:
    global _arena_gen
    _arena_gen += 1


def _i64(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.int64)


def pack_flat_direct(start, end, n, n_windows, block, max_span,
                     cap_multiple=256, cap_floor=0):
    """Pack reads straight to the flat uint16 code stream.

    Returns ``(flat_u16[R], counts[nbw, W], win, n_pad, cap, slots[R])``:
    group order ``(t, w)``, codes ``start_rel * L + span - 1`` sorted within
    each group (stable by read index), and each read's index into the
    padded ``(nbw, W, cap)`` layout. Arrays are C-arena views."""
    W, B, L = n_windows, block, max_span
    if B * L > 1 << 16:
        raise ValueError("codes exceed uint16; use pack_blocked")
    lib = _load()
    s, e = _i64(start), _i64(end)
    p_flat, p_counts, p_slots = _U16P(), _I32P(), _I64P()
    win, cap = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.gd_pack_flat_direct(
        s.ctypes.data_as(_I64P), e.ctypes.data_as(_I64P),
        s.shape[0], n, W, B, L, cap_multiple, cap_floor, 8,
        ctypes.byref(p_flat), ctypes.byref(p_counts),
        ctypes.byref(win), ctypes.byref(cap), ctypes.byref(p_slots),
    )
    if rc != 0:
        raise ValueError("gd_pack_flat_direct: invalid reads (span/start bounds)")
    _bump_arena_gen()
    nbw = win.value // B
    flat = np.ctypeslib.as_array(p_flat, shape=(s.shape[0],))
    counts = np.ctypeslib.as_array(p_counts, shape=(nbw, W))
    slots = np.ctypeslib.as_array(p_slots, shape=(s.shape[0],))
    return flat, counts, win.value, W * win.value, cap.value, slots


def pack_blocked(start, end, n, n_windows, block, max_span,
                 cap_multiple=256, cap_floor=0):
    """Pack reads to the padded int32 ``(nbw, W, cap)`` layout (``-1``
    pads), for geometries whose codes do not fit uint16.

    Returns ``(packed, counts[nbw, W], win, n_pad, slots[R])``, C-arena
    views."""
    W, B, L = n_windows, block, max_span
    lib = _load()
    s, e = _i64(start), _i64(end)
    p_packed, p_counts, p_slots = _I32P(), _I32P(), _I64P()
    win, cap = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.gd_pack_blocked(
        s.ctypes.data_as(_I64P), e.ctypes.data_as(_I64P),
        s.shape[0], n, W, B, L, cap_multiple, cap_floor, 8,
        ctypes.byref(p_packed), ctypes.byref(p_counts),
        ctypes.byref(win), ctypes.byref(cap), ctypes.byref(p_slots),
    )
    if rc != 0:
        raise ValueError("gd_pack_blocked: invalid reads (span/start bounds)")
    _bump_arena_gen()
    nbw = win.value // B
    packed = np.ctypeslib.as_array(p_packed, shape=(nbw, W, cap.value))
    counts = np.ctypeslib.as_array(p_counts, shape=(nbw, W))
    slots = np.ctypeslib.as_array(p_slots, shape=(s.shape[0],))
    return packed, counts, win.value, W * win.value, slots


def mask_select(bits: np.ndarray, slots: np.ndarray) -> np.ndarray:
    """Indices of the reads whose slot bit is set in the little-endian
    ``bits`` (threaded C bit test)."""
    lib = _load()
    b = np.ascontiguousarray(bits, np.uint8)
    sl = _i64(slots)
    if sl.size and int(sl.max()) >= 8 * b.shape[0]:
        raise ValueError("slot index beyond the selection bitmask")
    out01 = np.empty(sl.shape[0], np.uint8)
    lib.gd_mask_select(
        b.ctypes.data_as(_U8P), sl.ctypes.data_as(_I64P), sl.shape[0],
        out01.ctypes.data_as(_U8P),
    )
    return np.flatnonzero(out01).astype(np.int64)


def capped_target(start, end, n_pad: int, max_coverage: int) -> np.ndarray:
    """``min(coverage, M)`` per base as int32[n_pad] (threaded C
    histogram)."""
    lib = _load()
    s, e = _i64(start), _i64(end)
    out = np.empty(n_pad, np.int32)
    rc = lib.gd_capped_target(
        s.ctypes.data_as(_I64P), e.ctypes.data_as(_I64P), s.shape[0],
        n_pad, int(max_coverage), out.ctypes.data_as(_I32P),
    )
    if rc != 0:
        raise ValueError("gd_capped_target: invalid reads (bounds)")
    return out


def reconstruct(start, end, sel_per_end) -> np.ndarray:
    """Read indices for per-end selected counts: in each end bucket the
    first ``sel_per_end[e]`` reads by (start, index) (threaded C counting
    sort, O(R + n))."""
    lib = _load()
    s, e, spe = _i64(start), _i64(end), _i64(sel_per_end)
    mask = np.empty(s.shape[0], np.uint8)
    total = lib.gd_reconstruct(
        s.ctypes.data_as(_I64P), e.ctypes.data_as(_I64P), s.shape[0],
        spe.ctypes.data_as(_I64P), spe.shape[0], mask.ctypes.data_as(_U8P),
    )
    if total < 0:
        raise ValueError(
            "gd_reconstruct: invalid reads or per-end quota exceeds bucket"
        )
    return np.flatnonzero(mask).astype(np.int64)
