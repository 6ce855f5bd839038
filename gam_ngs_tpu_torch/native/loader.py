"""Build + load the native gamio library; columnar BAM decode via ctypes."""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "gamio.cc")
_SO = os.path.join(_HERE, "libgamio.so")

_lock = threading.Lock()
_lib = None
_tried = False


class _GamBam(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64),
        ("ref_id", ctypes.POINTER(ctypes.c_int32)),
        ("pos", ctypes.POINTER(ctypes.c_int32)),
        ("end_pos", ctypes.POINTER(ctypes.c_int32)),
        ("flag", ctypes.POINTER(ctypes.c_uint16)),
        ("l_seq", ctypes.POINTER(ctypes.c_int32)),
        ("mate_ref_id", ctypes.POINTER(ctypes.c_int32)),
        ("mate_pos", ctypes.POINTER(ctypes.c_int32)),
        ("nh", ctypes.POINTER(ctypes.c_int32)),
        ("xt", ctypes.POINTER(ctypes.c_uint8)),
        ("name_h1", ctypes.POINTER(ctypes.c_uint64)),
        ("name_h2", ctypes.POINTER(ctypes.c_uint64)),
        ("header_text", ctypes.c_char_p),
        ("n_ref", ctypes.c_int32),
        ("ref_names", ctypes.POINTER(ctypes.c_char_p)),
        ("ref_lengths", ctypes.POINTER(ctypes.c_int32)),
        ("error", ctypes.c_char_p),
    ]


def _build() -> bool:
    # build into a temporary file beside _SO and rename it into place:
    # another process (pytest-xdist workers) may load _SO meanwhile, and
    # must never CDLL a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_HERE)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC, "-lz",
             "-pthread"],
            check=True, capture_output=True, text=True)
        os.replace(tmp, _SO)
        return True
    except Exception:
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


class _GamBlocks(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64),
        ("num_reads", ctypes.POINTER(ctypes.c_int32)),
        ("m_ctg", ctypes.POINTER(ctypes.c_int32)),
        ("m_begin", ctypes.POINTER(ctypes.c_int32)),
        ("m_end", ctypes.POINTER(ctypes.c_int32)),
        ("m_brl", ctypes.POINTER(ctypes.c_int64)),
        ("s_ctg", ctypes.POINTER(ctypes.c_int32)),
        ("s_strand", ctypes.POINTER(ctypes.c_uint8)),
        ("s_begin", ctypes.POINTER(ctypes.c_int32)),
        ("s_end", ctypes.POINTER(ctypes.c_int32)),
        ("s_brl", ctypes.POINTER(ctypes.c_int64)),
    ]


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("GAM_NO_NATIVE"):
            return None
        if (not os.path.exists(_SO)
                or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        lib.gamio_read_bam.restype = ctypes.POINTER(_GamBam)
        lib.gamio_read_bam.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.gamio_read_bam_range.restype = ctypes.POINTER(_GamBam)
        lib.gamio_read_bam_range.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_int64]
        lib.gamio_free.argtypes = [ctypes.POINTER(_GamBam)]
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.gamio_find_blocks.restype = ctypes.POINTER(_GamBlocks)
        lib.gamio_find_blocks.argtypes = [
            ctypes.c_int64, u64p, u64p, u8p, i32p, i32p, i32p, u8p,
            ctypes.c_int64, u64p, u64p, u8p, i32p, i32p, i32p, u8p,
            ctypes.c_int32,
        ]
        lib.gamio_free_blocks.argtypes = [ctypes.POINTER(_GamBlocks)]
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.gamio_welford.restype = None
        lib.gamio_welford.argtypes = [
            i64p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ]
        lib.gamio_traceback.restype = ctypes.c_int64
        lib.gamio_traceback.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            u8p, ctypes.c_int64, u8p, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS,WRITEABLE"),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def welford_native(inserts: np.ndarray):
    """Sequential Welford (mean, std) in C++; None if lib unavailable.

    Bit-identical to core/stats.py::welford_isize_stats (same float64
    operation order; MultiBamReader.cc:346 quirks preserved)."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(inserts, np.int64)
    mean = ctypes.c_double()
    std = ctypes.c_double()
    lib.gamio_welford(x, len(x), ctypes.byref(mean), ctypes.byref(std))
    return mean.value, std.value


def find_blocks_native(m_cols: tuple, s_cols: tuple, min_block_size: int):
    """Native loadReadsMap + findBlocks scan over merged stream columns.

    m_cols/s_cols: (h1 u64, h2 u64, first u8, ctg i32, pos i32, end i32,
    rev u8) arrays of the good-quality uniquely-mapped reads in merged
    coordinate order.  Returns a columns dict matching the Python
    oracle's finalize order, or None if the library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    m = [np.ascontiguousarray(c) for c in m_cols]
    s = [np.ascontiguousarray(c) for c in s_cols]
    h = lib.gamio_find_blocks(len(m[0]), m[0], m[1], m[2], m[3], m[4],
                              m[5], m[6], len(s[0]), s[0], s[1], s[2],
                              s[3], s[4], s[5], s[6],
                              int(min_block_size))
    try:
        b = h.contents
        n = b.n

        def arr(ptr, dtype):
            if n == 0:
                return np.empty(0, dtype)
            return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype,
                                                                 copy=True)

        return dict(
            num_reads=arr(b.num_reads, np.int64),
            m_ctg=arr(b.m_ctg, np.int32),
            m_begin=arr(b.m_begin, np.int32),
            m_end=arr(b.m_end, np.int32),
            m_block_reads_len=arr(b.m_brl, np.uint64),
            s_ctg=arr(b.s_ctg, np.int32),
            s_strand=arr(b.s_strand, np.uint8),
            s_begin=arr(b.s_begin, np.int32),
            s_end=arr(b.s_end, np.int32),
            s_block_reads_len=arr(b.s_brl, np.uint64),
        )
    finally:
        lib.gamio_free_blocks(h)


def traceback_native(dirs: np.ndarray, elem_offset: int, stride: int,
                     packed: bool, band: int, max_i: int, max_j: int,
                     begin_a: int, begin_b: int, a: np.ndarray,
                     b: np.ndarray):
    """Banded-SW traceback walk in C++; None if the lib is unavailable.

    Returns (edits uint8 array in forward order, matches, x, pos).
    """
    lib = _load()
    if lib is None:
        return None
    cap = max_i + 2 * band + 16
    out = np.empty(cap, np.uint8)
    matches = ctypes.c_int64()
    x = ctypes.c_int32()
    pos = ctypes.c_int32()
    ptr = dirs.ctypes.data + elem_offset * dirs.itemsize
    n = lib.gamio_traceback(
        ptr, int(packed), stride, band, max_i, max_j, begin_a, begin_b,
        a, len(a), b, len(b), out, cap, ctypes.byref(matches),
        ctypes.byref(x), ctypes.byref(pos))
    return out[:n][::-1].copy(), int(matches.value), int(x.value), \
        int(pos.value)


INT32_MIN = -(1 << 31)


def read_bam_native(path: str, n_threads: int = 8,
                    ref_lo: int = INT32_MIN, ref_hi: int = -1,
                    index_path: str | None = None,
                    window_bytes: int = 0):
    """Decode a BAM file natively (streaming, bounded memory).

    ref_lo/ref_hi restrict to records with ref_id in [ref_lo, ref_hi)
    (defaults decode everything, including the unmapped tail).
    index_path names a .gidx per-reference offset index: written after
    a full scan, used to seek on ranged decodes.  window_bytes bounds
    the inflated window (0 = 8 MiB default).

    Returns (header_text, ref_names, ref_lengths, columns-dict) or None
    if the native library is unavailable; raises on decode errors.
    """
    lib = _load()
    if lib is None:
        return None
    h = lib.gamio_read_bam_range(
        path.encode(), n_threads, ref_lo, ref_hi,
        index_path.encode() if index_path else None, window_bytes)
    try:
        b = h.contents
        if b.error:
            raise ValueError(
                f"native BAM decode failed for {path}: "
                f"{b.error.decode()}")
        n = b.n

        def arr(ptr, dtype):
            if n == 0:
                return np.empty(0, dtype)
            return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype,
                                                                 copy=True)

        cols = dict(
            ref_id=arr(b.ref_id, np.int32),
            pos=arr(b.pos, np.int32),
            end_pos=arr(b.end_pos, np.int32),
            flag=arr(b.flag, np.uint16),
            l_seq=arr(b.l_seq, np.int32),
            mate_ref_id=arr(b.mate_ref_id, np.int32),
            mate_pos=arr(b.mate_pos, np.int32),
            nh=arr(b.nh, np.int32),
            xt=arr(b.xt, np.uint8),
            name_h1=arr(b.name_h1, np.uint64),
            name_h2=arr(b.name_h2, np.uint64),
        )
        text = b.header_text.decode() if b.header_text else ""
        names = [b.ref_names[i].decode() for i in range(b.n_ref)]
        lengths = [int(b.ref_lengths[i]) for i in range(b.n_ref)]
        return text, names, lengths, cols
    finally:
        lib.gamio_free(h)
