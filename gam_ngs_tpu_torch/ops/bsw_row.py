"""Row-form banded-SW forward fill: CUDA kernel + plain version.

`forward_row` launches csrc/bsw_row.cu for CUDA tensors and runs
`forward_row_torch`, the same row loop in torch ops, for CPU tensors.
Both compute bsw_ref.fill_matrix cell for cell on the valid band cells
and produce the same output bit for bit on the whole output (the kernel
source note gives the per-lane cases and the layout).  The kernel runs W
warps a problem of R band lanes a thread in registers (`row_instance`):
one warp up to band 159 (WARP_WIDTHS), four, eight or sixteen in a
block up to 767 (MULTIWARP_WIDTHS), then a thread-block cluster of two
blocks of eight or sixteen warps up to 2047 and of eight blocks of eight
warps up to MAX_BAND (CLUSTER_WIDTHS).

Inputs are forward_antidiag's (B problems): a_pk (B, AW/2) and b_pk
(B, XW/2) uint8 4-bit packed windows with AW = a_width(XW, band), and
begin_a, end_a, a_len, x_size, force_start (B,) int32.
Outputs: dirs (B, XW/16, 2*band+1) int32, row i of band lane j at word
i >> 4, bits 2*(i & 15); last_row and diag (B, 2*band+1) int32 in
j-space, the layout forward_antidiag returns.  A problem's rows stop at
its x_size rounded up to 16: the words of later rows stay 0.
"""

from __future__ import annotations

import ctypes

import torch

from .bsw_antidiag import (
    DIR_DIAG,
    DIR_LEFT,
    DIR_UP,
    MATCH_S,
    MISMATCH_S,
    NEG,
    NN_S,
    NX_S,
    _check,
    a_width,
    unpack4,
)
from .bsw_ref import FORCE_MAXGAP_LEN, GAP

launches = 0  # kernel launches by forward_row (CPU runs not counted)
# 2 * band + 1 lanes: 8192 = 8 blocks (a portable cluster) x 8 warps x
# 32 threads x 4 lanes a thread
MAX_BAND = 4095
# csrc/bsw_row.cu's instances of W warps a problem, R band lanes a
# thread in registers: each takes the bands whose 2*band+1 lanes need
# more than the instance before it and at most 32*C*W*R (the launcher's
# choice).  One warp (row_warp_kernel<R>) up to band 159:
WARP_WIDTHS = (1, 2, 4, 6, 8, 10)
# then (W, R) (row_warps_kernel<R, W, 1>, one block) up to band 191, 255,
# 319, 383, 511, 639, 767: the fewer lanes a thread, the shorter a row,
# up to the SM's registers (eight warps of 5, sixteen of 3)
MULTIWARP_WIDTHS = ((4, 3), (4, 4), (4, 5), (8, 3), (8, 4), (8, 5), (16, 3))
# then (C, W, R) (row_warps_kernel<R, W, C>, a cluster of C blocks) up to
# band 1023, 1535, 2047, 3071, 4095: two blocks up to 2047, the most that
# runs a 64-problem chunk in one wave, then eight
CLUSTER_WIDTHS = ((2, 8, 4), (2, 16, 3), (2, 16, 4), (8, 8, 3), (8, 8, 4))


def row_instance(band: int) -> tuple[int, int, int]:
    """(C, W, R) of the kernel instance the launcher picks at `band`: the
    first with 32*C*W*R >= 2*band+1 lanes."""
    if not 0 <= band <= MAX_BAND:
        raise ValueError(f"band {band} outside 0..{MAX_BAND}")
    for c, w, r in ([(1, 1, r) for r in WARP_WIDTHS]
                    + [(1, w, r) for w, r in MULTIWARP_WIDTHS]
                    + list(CLUSTER_WIDTHS)):
        if 2 * band + 1 <= 32 * c * w * r:
            return c, w, r
    raise AssertionError("the widest instance covers MAX_BAND")

_fn = None


def _scan_exact(c, s):
    """Inclusive left-to-right composition of f_j(x) = max(c_j, s_j + x)
    (a Hillis-Steele doubling scan); both parts clamp at NEG, so sums of
    blocked (NEG) slopes never wrap.  Returns the c part."""
    n = c.shape[1]
    d = 1
    while d < n:
        c_sh = torch.nn.functional.pad(c[:, :-d], (d, 0), value=NEG)
        s_sh = torch.nn.functional.pad(s[:, :-d], (d, 0), value=0)
        c = torch.maximum(c, torch.clamp(s + c_sh, min=NEG))
        s = torch.clamp(s_sh + s, min=NEG)
        d *= 2
    return c


def _scan_lean(c):
    """row[j] = max over k <= j of c[k] + GAP * (j - k)."""
    n = c.shape[1]
    j = torch.arange(n, dtype=torch.int32, device=c.device)
    return torch.cummax(c - GAP * j, dim=1).values + GAP * j


def forward_row_torch(a_pk, b_pk, begin_a, end_a, a_len, x_size,
                      force_start, band: int):
    """The kernel's row loop in torch ops on (B, 2*band+1) lanes."""
    dev = a_pk.device
    B = a_pk.shape[0]
    xw = 2 * b_pk.shape[1]
    YS, ymax = 2 * band + 1, 2 * band
    i32 = dict(dtype=torch.int32, device=dev)
    a, b = unpack4(a_pk), unpack4(b_pk)

    col = lambda v: v.to(torch.int32).reshape(B, 1)
    ba, ea, al, xs = col(begin_a), col(end_a), col(a_len), col(x_size)
    fs = col(force_start) != 0
    exact_all = ba < 0
    jd_base = ea - ba + band
    # rows each problem runs: x_size rounded up to 16, at most xw (0 for
    # the engine's empty padding problems)
    stop = torch.clamp((xs.to(torch.int64) + 15) // 16 * 16, 0, xw)
    j = torch.arange(YS, **i32).reshape(1, YS)
    last, first = j == ymax, j == 0
    mid = ~first & ~last

    dirs = torch.zeros((B, xw // 16, YS), **i32)
    last_row = torch.zeros((B, YS), **i32)
    diag = torch.zeros((B, YS), **i32)
    prev = torch.zeros((B, YS), **i32)
    packed = torch.zeros((B, YS), dtype=torch.int64, device=dev)

    for i in range(int(stop.max()) if B else 0):
        ac = a[:, i:i + YS]
        bc = b[:, i:i + 1]
        an, bn = ac == 4, bc == 4
        sc = torch.where(an & bn, NN_S, torch.where(
            an | bn, NX_S, torch.where(ac == bc, MATCH_S, MISMATCH_S))
        ).to(torch.int32)
        prev_up = torch.nn.functional.pad(prev[:, 1:], (0, 1))
        up = torch.where(last, GAP, prev_up + GAP)
        diag_acc = prev + sc
        pos = ba - band + i + j

        exact_now = i <= band
        if exact_now or bool(exact_all.any()):
            valid_pos = (pos >= 0) & (pos < al)
            pos0 = pos == 0
            if i == 0:
                cond_b = fs & (pos > FORCE_MAXGAP_LEN) & (pos < al)
                valid = (valid_pos & (~fs | (pos <= FORCE_MAXGAP_LEN))) \
                    | cond_b
                base = torch.where(cond_b, sc, torch.clamp(sc, min=GAP))
                s = torch.where(valid & (pos > 0) & ~first, 0, NEG)
            else:
                fm_le = i <= FORCE_MAXGAP_LEN
                fresh = pos0 & (~fs | fm_le)
                forced = pos0 & fs & (not fm_le)
                base = torch.where(
                    fresh,
                    torch.where(last, torch.clamp(sc, min=GAP),
                                torch.clamp(torch.maximum(sc, up), min=GAP)),
                    torch.where(
                        forced, torch.where(last, sc, torch.maximum(sc, up)),
                        torch.where(last, diag_acc,
                                    torch.maximum(diag_acc, up))))
                valid = valid_pos
                s = torch.where(valid & ~fresh & ~forced & ~first, GAP, NEG)
            row_e = _scan_exact(torch.where(valid, base, 0).to(torch.int32),
                                s.to(torch.int32))
            row_e = torch.where(valid, row_e, 0)
            left_blocked = fs & (i > FORCE_MAXGAP_LEN)
            inner = last | ((row_e == GAP) & ~left_blocked)
            d_pos0 = torch.where(row_e == sc, DIR_DIAG,
                                 torch.where(inner, DIR_LEFT, DIR_UP))
            if i == 0:
                diag_t = sc
                up_t = torch.where(
                    fs, torch.where((pos >= 0) & (pos <= FORCE_MAXGAP_LEN),
                                    GAP, NEG),
                    torch.full_like(sc, GAP))
            else:
                diag_t, up_t = diag_acc, up
            d_gen = torch.where(
                row_e == diag_t, DIR_DIAG,
                torch.where(mid & (row_e == up_t), DIR_UP,
                            torch.where(mid | last, DIR_LEFT, DIR_UP)))
            d_e = torch.where(pos0, d_pos0, d_gen)
        if not exact_now:
            valid = pos < al
            base = torch.where(last, diag_acc, torch.maximum(diag_acc, up))
            row_l = torch.where(valid, _scan_lean(
                torch.where(valid, base, 0).to(torch.int32)), 0)
            d_l = torch.where(
                row_l == diag_acc, DIR_DIAG,
                torch.where(mid & (row_l == up), DIR_UP,
                            torch.where(mid | last, DIR_LEFT, DIR_UP)))
        if exact_now:
            row, d = row_e, d_e
        elif bool(exact_all.any()):
            row = torch.where(exact_all, row_e, row_l)
            d = torch.where(exact_all, d_e, d_l)
        else:
            row, d = row_l, d_l
        row = row.to(torch.int32)

        live = i < stop
        diag = torch.where(live & (j == jd_base - i), row, diag)
        last_row = torch.where(live & (xs - 1 == i), row, last_row)
        packed = packed | (d.to(torch.int64) << (2 * (i & 15)))
        if (i & 15) == 15:
            # the word's bit pattern as int32 (bit 31 is the sign)
            word = torch.where(packed >= 1 << 31, packed - (1 << 32), packed)
            dirs[:, i >> 4, :] = torch.where(live, word, 0).to(torch.int32)
            packed = torch.zeros_like(packed)
        prev = row
    return dirs, last_row, diag


def _kernel():
    global _fn
    if _fn is None:
        from .._build import library

        fn = library().bsw_row_forward
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 11
                       + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def instance_info(band: int) -> tuple[int, int, int, int]:
    """(C, W, R, max active clusters) of the CUDA instance at `band`, the
    last from cudaOccupancyMaxActiveClusters (0 for the one-warp kernel,
    which runs no cluster); builds the library."""
    from .._build import library

    fn = library().bsw_row_instance
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * 4)()
    err = fn(band, ctypes.addressof(info))
    if err:
        raise RuntimeError(f"bsw_row_instance({band}): CUDA error {err}")
    return tuple(info)


def forward_row(a_pk, b_pk, begin_a, end_a, a_len, x_size, force_start,
                band: int):
    """Forward fill of B problems -> (dirs, last_row, diag).  CUDA
    tensors launch the kernel (or raise); CPU tensors run the plain
    version."""
    if a_pk.device.type == "cpu":
        return forward_row_torch(a_pk, b_pk, begin_a, end_a, a_len, x_size,
                                 force_start, band)
    if a_pk.device.type != "cuda":
        raise ValueError(f"unsupported device {a_pk.device}")
    dev = a_pk.device
    B = a_pk.shape[0]
    xw = 2 * b_pk.shape[1]
    YS = 2 * band + 1
    if not 0 <= band <= MAX_BAND:
        raise ValueError(f"band {band}: the kernel holds the 2*band+1 lanes "
                         f"of a row in the registers of at most one cluster "
                         f"(8 blocks of 256 threads, 4 lanes a thread) and "
                         f"takes band <= {MAX_BAND}")
    if xw % 16:
        raise ValueError(f"window {xw}: a multiple of 16 rows")
    if not all(-8 <= v <= 7 for v in (MATCH_S, MISMATCH_S, NN_S, NX_S)):
        raise ValueError("the kernel keeps a cell's score in 4 bits: "
                         "scores must lie in [-8, 7]")
    aw = a_width(xw, band)
    _check("a_pk", a_pk, torch.uint8, (B, aw // 2), dev)
    _check("b_pk", b_pk, torch.uint8, (B, xw // 2), dev)
    for name, v in (("begin_a", begin_a), ("end_a", end_a),
                    ("a_len", a_len), ("x_size", x_size),
                    ("force_start", force_start)):
        _check(name, v, torch.int32, (B,), dev)
    # rows past a problem's stop row are never written: zero, as in the
    # plain version
    dirs = torch.zeros((B, xw // 16, YS), dtype=torch.int32, device=dev)
    last_row = torch.zeros((B, YS), dtype=torch.int32, device=dev)
    diag = torch.zeros_like(last_row)
    if B == 0:
        return dirs, last_row, diag
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(a_pk.data_ptr(), b_pk.data_ptr(), begin_a.data_ptr(),
                        end_a.data_ptr(), a_len.data_ptr(),
                        x_size.data_ptr(), force_start.data_ptr(), B, aw,
                        xw, band, MATCH_S, MISMATCH_S, NN_S, NX_S, GAP,
                        FORCE_MAXGAP_LEN, NEG, dirs.data_ptr(),
                        last_row.data_ptr(), diag.data_ptr(), stream)
    if err:
        raise RuntimeError(f"bsw_row_forward launch failed: CUDA error {err}")
    global launches
    launches += 1
    return dirs, last_row, diag
