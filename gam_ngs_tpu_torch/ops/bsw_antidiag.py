"""Anti-diagonal banded-SW forward fill: CUDA kernel + plain version.

`forward_antidiag` launches csrc/bsw_antidiag.cu for CUDA tensors and
runs `forward_antidiag_torch`, the same step loop in torch ops, for CPU
tensors.  Both compute bsw_ref.fill_matrix cell for cell on the valid
band cells and produce the same output bit for bit on the whole output
(both run the same exact/lean bodies over the same steps; see the
kernel's source note for the coordinate map and the layout).

Each problem runs its own steps, `problem_steps`: 2*(x_size-1) +
2*band + 1, the last step holding a cell of row x_size-1 (none for an
empty problem).  Its later direction bits and words are 0, and its
last row and diagonal hold only cells of those steps.  Steps below
`exact_steps(band)` (every step when begin_a < 0) run the exact body.

Inputs (B problems): a_pk (B, a_width/2) and b_pk (B, XW/2) uint8
4-bit packed windows (BswEngine._pack4: a band-aligned, a_win[q] =
a[begin_a - band + q], sentinel 15, rows padded to a_width(XW, band)
codes; b from begin_b, zero padded; codes 0-4), and begin_a, end_a,
a_len, x_size, force_start (B,) int32.
Outputs: dirs (B, NP, band+1) int32, last_row and diag (B, 2*band+1)
int32.
"""

from __future__ import annotations

import ctypes

import torch

from .bsw_ref import FORCE_MAXGAP_LEN, GAP, SCORING_MATRIX

NEG = -(1 << 29)  # below every reachable cell score
DIR_DIAG, DIR_UP, DIR_LEFT = 0, 1, 2
# bsw_ref.SCORING_MATRIX as the kernels use it (uniform over A, T, C, G):
# match, mismatch, N against N, N against any other code
MATCH_S, MISMATCH_S, NN_S, NX_S = (int(SCORING_MATRIX[0, 0]),
                                   int(SCORING_MATRIX[0, 1]),
                                   int(SCORING_MATRIX[4, 4]),
                                   int(SCORING_MATRIX[4, 0]))

launches = 0  # kernel launches by forward_antidiag (CPU runs not counted)

_fn = None


def antidiag_dims(xw: int, band: int) -> tuple[int, int, int, int]:
    """(K, T, NP, AW): lanes, steps, direction words per lane, a-window
    width.  T covers every cell (x < xw, y <= 2*band) at t = 2x + y;
    AW = xw + 2*band + 2 holds every in-range a character of an x_size
    <= xw problem (BswEngine pads its windows to it)."""
    K = band + 1
    T = 2 * (xw - 1) + 2 * band + 1
    return K, T, -(-T // 16), xw + 2 * band + 2


def a_width(xw: int, band: int) -> int:
    """The a window's width as uploaded: AW rounded up to 32 codes, so
    each problem's a_pk row is a whole number of 16-byte chunks (the
    kernel stages the windows with 16-byte cp.async copies)."""
    return -(-antidiag_dims(xw, band)[3] // 32) * 32


def exact_steps(band: int) -> int:
    """Steps that run the exact body in every problem: t <= 2*band+2
    holds each row-0 and pos == 0 cell of a begin_a >= 0 problem; the
    count is rounded up to a whole direction word."""
    return -(-(2 * band + 3) // 16) * 16


def problem_steps(x_size: torch.Tensor, band: int, T: int) -> torch.Tensor:
    """Steps each problem runs: its last cell (x_size-1, 2*band) is at
    t = 2*(x_size-1) + 2*band; 0 for an empty problem; at most T."""
    xs = x_size.to(torch.int64)
    return torch.where(xs > 0, torch.clamp(2 * (xs - 1) + 2 * band + 1,
                                           max=T), 0)


def unpack4(pk: torch.Tensor) -> torch.Tensor:
    """(B, W/2) uint8 -> (B, W) int32 codes (low nibble first)."""
    p = pk.to(torch.int32)
    return torch.stack([p & 15, p >> 4], dim=2).reshape(pk.shape[0], -1)


def forward_antidiag_torch(a_pk, b_pk, begin_a, end_a, a_len, x_size,
                           force_start, band: int):
    """The kernel's step loop in torch ops on (B, K) lanes."""
    dev = a_pk.device
    B = a_pk.shape[0]
    xw, aw = 2 * b_pk.shape[1], 2 * a_pk.shape[1]
    K, T, NP, _ = antidiag_dims(xw, band)
    YS, ymax = 2 * band + 1, 2 * band
    i32 = dict(dtype=torch.int32, device=dev)

    # a index q = ceil(t/2) + k reaches (T-1+1)//2 + band; 15 past AW.
    # b row i = t//2 - k spans [-band, xw+band): 0 outside [0, xw), and
    # flipped so one step's rows are one ascending slice.
    pad = max(0, T // 2 + K + 1 - aw)
    a_ext = torch.cat([unpack4(a_pk), torch.full((B, pad), 15, **i32)],
                      dim=1)
    b_rev = torch.cat([torch.zeros((B, K), **i32), unpack4(b_pk),
                       torch.zeros((B, K + 2), **i32)], dim=1).flip(1)
    L = b_rev.shape[1]

    col = lambda v: v.to(torch.int32).reshape(B, 1)
    ba, ea, al, xs = col(begin_a), col(end_a), col(a_len), col(x_size)
    fs = col(force_start) != 0
    steps = problem_steps(x_size, band, T).reshape(B, 1)
    n_exact = exact_steps(band)
    full_all = ba < 0
    jdb = ea - ba + band
    xs1 = xs - 1
    k = torch.arange(K, **i32).reshape(1, K)

    dirs = torch.zeros((B, NP, K), **i32)
    last_row = torch.zeros((B, YS), **i32)
    diag = torch.zeros((B, YS), **i32)
    prev1 = torch.zeros((B, K + 2), **i32)  # lanes -1..K of step t-1
    prev2 = torch.zeros((B, K), **i32)
    packed = torch.zeros((B, K), dtype=torch.int64, device=dev)

    t_end = int(steps.max()) if B else 0
    for t in range(t_end):
        base, par = t >> 1, t & 1
        chalf = base + par
        ac = a_ext[:, chalf:chalf + K]
        s = L - 1 - K - base
        bc = b_rev[:, s:s + K]
        an, bn = ac == 4, bc == 4
        sc = torch.where(an & bn, NN_S, torch.where(
            an | bn, NX_S, torch.where(ac == bc, MATCH_S, MISMATCH_S))
        ).to(torch.int32)
        up_raw = prev1[:, 1 + par:1 + par + K]
        left_raw = prev1[:, par:par + K]
        dv = prev2 + sc
        j = par + 2 * k
        jmax, j0 = j == ymax, j == 0
        mid = ~j0 & ~jmax

        full_now = t < n_exact
        if full_now or bool(full_all.any()):
            i = base - k
            pos = ba - band + chalf + k
            valid = (j < YS) & (i >= 0) & (i < xs) & (pos >= 0) & (pos < al)
            i0, pos0 = i == 0, pos == 0
            i0b = i0 & fs & (pos > FORCE_MAXGAP_LEN)
            forced = ~i0 & pos0 & fs & (i > FORCE_MAXGAP_LEN)
            fresh = ~i0 & pos0 & ~forced
            gen = ~i0 & ~pos0
            inc_up = (i0 & ~i0b) | (~i0 & ~jmax)
            uv = torch.where(inc_up, up_raw + GAP, NEG)
            lv = torch.where(
                i0 & (pos > 0) & ~j0, left_raw,
                torch.where(fresh, GAP,
                            torch.where(gen & ~j0, left_raw + GAP, NEG)))
            row_f = torch.where(valid, torch.maximum(
                dv, torch.maximum(uv, lv)), 0).to(torch.int32)
            left_blocked = fs & (i > FORCE_MAXGAP_LEN)
            d_pos0 = torch.where(
                row_f == sc, DIR_DIAG,
                torch.where(jmax | ((row_f == GAP) & ~left_blocked),
                            DIR_LEFT, DIR_UP))
            up_t = torch.where((i > 0) & ~jmax, up_raw + GAP, GAP)
            up_t = torch.where(
                fs & i0,
                torch.where((pos >= 0) & (pos <= FORCE_MAXGAP_LEN), GAP,
                            NEG), up_t)
            d_gen = torch.where(
                row_f == dv, DIR_DIAG,
                torch.where(mid & (row_f == up_t), DIR_UP,
                            torch.where(mid, DIR_LEFT,
                                        torch.where(~jmax, DIR_UP,
                                                    DIR_LEFT))))
            d_f = torch.where(pos0, d_pos0, d_gen)
        if not full_now:
            uv = torch.where(jmax, NEG, up_raw + GAP)
            lv = torch.where(j0, NEG, left_raw + GAP)
            row_l = torch.maximum(dv, torch.maximum(uv, lv))
            d_l = torch.where(
                row_l == dv, DIR_DIAG,
                torch.where(mid & (row_l == uv), DIR_UP,
                            torch.where(mid, DIR_LEFT,
                                        torch.where(~jmax, DIR_UP,
                                                    DIR_LEFT))))
        if full_now:
            row, d = row_f, d_f
        elif bool(full_all.any()):
            row = torch.where(full_all, row_f, row_l)
            d = torch.where(full_all, d_f, d_l)
        else:
            row, d = row_l, d_l
        row = row.to(torch.int32)

        live = t < steps  # (B, 1): the problem's own steps
        n = (YS - par + 1) // 2  # lanes whose j = par + 2k is in the band
        dg_hit = (live & (k == jdb - chalf))[:, :n]
        lr_hit = (live & (k == base - xs1))[:, :n]
        diag[:, par::2] = torch.where(dg_hit, row[:, :n], diag[:, par::2])
        last_row[:, par::2] = torch.where(lr_hit, row[:, :n],
                                          last_row[:, par::2])

        d = torch.where(live, d, 0)
        packed = packed | (d.to(torch.int64) << (2 * (t & 15)))
        if (t & 15) == 15 or t == t_end - 1:
            # the word's bit pattern as int32 (bit 31 is the sign)
            dirs[:, t >> 4, :] = torch.where(packed >= 1 << 31,
                                             packed - (1 << 32), packed)
            packed = torch.zeros_like(packed)
        prev2 = prev1[:, 1:K + 1]
        prev1 = torch.nn.functional.pad(row, (1, 1))
    return dirs, last_row, diag


def _kernel():
    global _fn
    if _fn is None:
        from .._build import library

        fn = library().bsw_antidiag_forward
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 12
                       + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def forward_antidiag(a_pk, b_pk, begin_a, end_a, a_len, x_size,
                     force_start, band: int):
    """Forward fill of B problems -> (dirs, last_row, diag).  CUDA
    tensors launch the kernel (or raise); CPU tensors run the plain
    version."""
    if a_pk.device.type == "cpu":
        return forward_antidiag_torch(a_pk, b_pk, begin_a, end_a, a_len,
                                      x_size, force_start, band)
    if a_pk.device.type != "cuda":
        raise ValueError(f"unsupported device {a_pk.device}")
    dev = a_pk.device
    B = a_pk.shape[0]
    xw, aw = 2 * b_pk.shape[1], 2 * a_pk.shape[1]
    K, T, NP, _ = antidiag_dims(xw, band)
    if not 1 <= K <= 1024:
        raise ValueError(f"band {band}: the kernel takes band + 1 <= 1024")
    _check("a_pk", a_pk, torch.uint8, (B, a_width(xw, band) // 2), dev)
    _check("b_pk", b_pk, torch.uint8, (B, xw // 2), dev)
    for name, v in (("begin_a", begin_a), ("end_a", end_a),
                    ("a_len", a_len), ("x_size", x_size),
                    ("force_start", force_start)):
        _check(name, v, torch.int32, (B,), dev)
    # the kernel copies whole 16-byte chunks of the rows
    if xw % 32 or a_pk.data_ptr() % 16 or b_pk.data_ptr() % 16:
        raise ValueError("a_pk and b_pk rows must start on 16-byte "
                         f"boundaries (window {xw})")
    scores = (MATCH_S, MISMATCH_S, NN_S, NX_S)
    if max(scores) - min(scores) > 63:
        raise ValueError(f"scores {scores}: the kernel packs each in 6 bits")
    # every word is written: a problem's own steps, then zeros
    dirs = torch.empty((B, NP, K), dtype=torch.int32, device=dev)
    last_row = torch.empty((B, 2 * band + 1), dtype=torch.int32, device=dev)
    diag = torch.empty_like(last_row)
    if B == 0:
        return dirs, last_row, diag
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(a_pk.data_ptr(), b_pk.data_ptr(), begin_a.data_ptr(),
                        end_a.data_ptr(), a_len.data_ptr(),
                        x_size.data_ptr(), force_start.data_ptr(), B, aw, xw,
                        band, T, NP, MATCH_S, MISMATCH_S, NN_S, NX_S, GAP,
                        FORCE_MAXGAP_LEN, dirs.data_ptr(),
                        last_row.data_ptr(), diag.data_ptr(), stream)
    if err:
        raise RuntimeError(f"bsw_antidiag_forward launch failed: CUDA "
                           f"error {err}")
    global launches
    launches += 1
    return dirs, last_row, diag
