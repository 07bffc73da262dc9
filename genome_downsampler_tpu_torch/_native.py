"""ctypes bindings to the port's host library (``io/csrc/*.cpp``).

The library is compiled from the port's own sources by
``io.build.build_bamio`` into ``build/gd_host/`` and bound once, by
``host_lib``, with every entry point's signature: the packers,
capped-coverage histogram, bit test and reconstruct wrapped here, the BAM
engine (``io.bam``) and the host solvers (``solvers.native_greedy``,
``solvers.native_mcmf``).

The pack outputs are ZERO-COPY views of process-lifetime C arenas: any
later pack call in the same process silently reuses that memory.
``arena_generation`` lets a consumer that holds a view across other work
check that no pack call happened in between.
"""

from __future__ import annotations

import ctypes

import numpy as np

from genome_downsampler_tpu_torch.io.build import build_bamio

_I64 = ctypes.c_int64
_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U16P = ctypes.POINTER(ctypes.c_uint16)
_U8P = ctypes.POINTER(ctypes.c_uint8)


class GdReadResult(ctypes.Structure):
    """``GdReadResult`` of ``io/csrc/bamio.cpp``: one BAM read's arrays,
    owned by the library until ``gd_free_read_result``."""

    _fields_ = [
        ("bam_id", _I64P),
        ("start", _I32P),
        ("end", _I32P),
        ("quality", _I32P),
        ("seq_length", _I32P),
        ("is_first", _U8P),
        ("in_single_amplicon", _U8P),
        ("contig", _I32P),
        ("n_reads", _I64),
        ("filtered_out", _I64P),
        ("n_filtered_out", _I64),
        ("ref_genome_length", _I64),
        ("contig_lengths", _I64P),
        ("n_contigs", _I64),
        ("total_records", _I64),
        ("min_mapq_seen", _I64),
        ("max_mapq_seen", _I64),
        ("unmatched_start", _I64P),
        ("unmatched_end", _I64P),
        ("unmatched_mate_pos", _I64P),
        ("n_unmatched", _I64),
        ("error", ctypes.c_char * 256),
    ]


_PACK = [_I64P, _I64P] + [_I64] * 8
_RESULT = ctypes.POINTER(GdReadResult)
_READ = [ctypes.c_char_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32,
         ctypes.c_int, _I64P, _I64P, _I64]
_WRITE = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, _I64P, _I64,
          ctypes.c_char_p]
_FLOWS = [_I64P] * 4 + [_I64] * 3 + [_I64P]
# name: (restype, argtypes)
_SIGNATURES = {
    "gd_pack_flat_direct": (_I64, _PACK + [
        ctypes.POINTER(_U16P), ctypes.POINTER(_I32P), _I64P, _I64P,
        ctypes.POINTER(_I64P)]),
    "gd_pack_blocked": (_I64, _PACK + [
        ctypes.POINTER(_I32P), ctypes.POINTER(_I32P), _I64P, _I64P,
        ctypes.POINTER(_I64P)]),
    "gd_mask_select": (_I64, [_U8P, _I64P, _I64, _U8P]),
    "gd_capped_target": (_I64, [_I64P, _I64P, _I64, _I64, _I64, _I32P]),
    "gd_reconstruct": (_I64, [_I64P, _I64P, _I64, _I64P, _I64, _U8P]),
    "gd_read_bam": (ctypes.c_int, _READ + [_RESULT]),
    "gd_read_bam_region": (ctypes.c_int, _READ + [_I64] * 3 + [ctypes.c_int32, _RESULT]),
    "gd_free_read_result": (None, [_RESULT]),
    "gd_write_bam": (_I64, _WRITE),
    "gd_write_bam_voffsets": (_I64, _WRITE),
    "gd_greedy_mcp": (_I64, [_I64P, _I64P, _I64, _I64, _I64, _I64P,
                             ctypes.POINTER(_I64P)]),
    "gd_qmcp_mcmf": (_I64, [_I64P] * 3 + [_I64] * 3 + [ctypes.POINTER(_I64P)]),
    "gd_qmcp_mcmf_flows": (_I64, _FLOWS),
    "gd_qmcp_mcmf_convex": (_I64, _FLOWS),
    "gd_free_i64": (None, [_I64P]),
}

_lib = None
_arena_gen = 0


def host_lib():
    """The port's host library, built at first use, loaded and bound once
    per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_bamio()))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
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
    lib = host_lib()
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
    lib = host_lib()
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
    lib = host_lib()
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
    lib = host_lib()
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
    lib = host_lib()
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
