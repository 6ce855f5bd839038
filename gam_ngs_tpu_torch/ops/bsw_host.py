"""Host-side helpers of the banded-SW engine (numpy only).

The port's copies of gam_ngs_tpu/ops/bsw_batch.py's host code: problem
clipping and windowing (_prepare), the window buckets (_pad_dim), the
4-bit packing of the uploads (_pack4), and the host traceback path's
walks over row-major packed directions (_traceback_native, the C++ walk
of native/gamio.cc, and its Python twin _traceback_from_dirs).  Its
find-max is ops.bsw_walk.find_max_torch, the device walk's plain
find-max, run on the fetched tensors.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .bsw_ref import BSW_MAX_ALIGNMENT
from .editops import GAP_A, GAP_B, MATCH, MISMATCH

_DIR_DIAG, _DIR_UP, _DIR_LEFT = 0, 1, 2


@dataclass
class _Prep:
    """Host-side preprocessed problem."""
    empty: bool
    a: np.ndarray = None
    b: np.ndarray = None
    begin_a: int = 0
    end_a: int = 0
    begin_b: int = 0
    x_size: int = 0
    a_win: np.ndarray = None
    b_win: np.ndarray = None
    force_start: bool = False
    force_end: bool = False


def _prepare(a, begin_a, end_a, b, begin_b, end_b, force_start, force_end,
             band) -> _Prep:
    if end_b < begin_b:
        return _Prep(empty=True)
    if end_b >= len(b):
        end_b = len(b) - 1
    x_size = end_b - begin_b + 1
    x_size = min(x_size, len(a) + band - begin_a)
    x_size = min(x_size, BSW_MAX_ALIGNMENT)
    if x_size <= 0:
        return _Prep(empty=True)
    # band-ALIGNED window: a_win[k] = a[begin_a - band + k], sentinel 255
    start = begin_a - band
    width = x_size + 2 * band
    a_win = np.full(width, 255, np.uint8)
    lo = max(0, start)
    hi = min(len(a), start + width)
    if hi > lo:
        a_win[lo - start:hi - start] = a[lo:hi]
    b_win = np.ascontiguousarray(b[begin_b:begin_b + x_size])
    return _Prep(False, a, b, begin_a, end_a, begin_b, x_size, a_win,
                 b_win, force_start, force_end)


def _pad_dim(n: int) -> int:
    """Window buckets {128, 256, 384, 512, 768, 1024, ...}: a 128
    floor, then 1x/1.5x per octave (the JAX engine's buckets, so both
    packages chunk alike).  The 1.5x intermediate sizes bound padding
    waste to <= 1.5x."""
    if n <= 128:
        return 128
    p = 256
    while True:
        if n <= p:
            return p
        if n <= p * 3 // 2:
            return p * 3 // 2
        p *= 2


def _pack4(win: np.ndarray) -> np.ndarray:
    """Two 4-bit base codes per byte; the 255 out-of-range
    sentinel becomes 15 (still != every real code and != 4/N)."""
    w = np.minimum(win, 15)
    return (w[:, 0::2] | (w[:, 1::2] << 4)).astype(np.uint8)


def _traceback_native(dirs: np.ndarray, t: int, p: "_Prep", band: int,
                      max_i: int, max_j: int):
    """C++ traceback walk (gamio_traceback) of problem t over the row
    forward's packed words, (B, XW/16, 2*band+1) int32; None -> Python
    fallback."""
    if os.environ.get("GAM_NO_NATIVE"):
        return None
    from ..native.loader import traceback_native

    nw, ys = dirs.shape[1], dirs.shape[2]
    a = np.ascontiguousarray(p.a, np.uint8)
    b = np.ascontiguousarray(p.b, np.uint8)
    res = traceback_native(dirs, t * nw * ys, ys, True, band, max_i, max_j,
                           p.begin_a, p.begin_b, a, b)
    if res is None:
        return None
    edits, matches, x, pos = res
    return list(edits), matches, x, pos


class _PackedDirs:
    """Accessor for one problem's row-form packed directions, (XW/16,
    2*band+1) int32: 16 rows of 2-bit codes per word (ops.bsw_row)."""

    __slots__ = ("arr",)

    def __init__(self, arr):
        self.arr = arr

    def __getitem__(self, xy):
        x, y = xy
        return (int(self.arr[x >> 4, y]) >> ((x & 15) * 2)) & 3


def _traceback_from_dirs(dirs, p: _Prep, band: int, max_i: int, max_j: int
                         ) -> tuple[list[int], int, int, int]:
    a, b = p.a, p.b
    x, y = max_i, max_j
    pos = p.begin_a + x + y - band
    edits: list[int] = []
    matches = 0
    y_size = 2 * band + 1
    while x >= 0 and y >= 0 and pos >= 0:
        d = int(dirs[x, y])
        if d == _DIR_DIAG:
            ca = int(a[pos])
            cb = int(b[p.begin_b + x])
            if ca == cb or ca == 4 or cb == 4:
                edits.append(MATCH)
                matches += 1
            else:
                edits.append(MISMATCH)
            x -= 1
        elif d == _DIR_UP:
            edits.append(GAP_A)
            x -= 1
            y += 1
        else:
            edits.append(GAP_B)
            y -= 1
        pos = p.begin_a + x + y - band
    edits.reverse()
    return edits, matches, x, pos
