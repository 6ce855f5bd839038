"""Find-max + traceback walk: CUDA kernel + plain version.

`walk` launches csrc/bsw_walk.cu for CUDA tensors and runs `walk_torch`
for CPU tensors.  Both take a forward's outputs and the same 4-bit
packed windows: with layout ANTIDIAG the step-major words of
ops.bsw_antidiag (B, NP, band+1), cell (x, y) at word (2x+y)/16, lane
y/2, bits 2*((2x+y) & 15); with layout ROW the row-major words of
ops.bsw_row (B, XW/16, 2*band+1), cell (x, y) at word x/16, lane y,
bits 2*(x & 15).  They return the (13, B) int32 summary
(rows xf, yf, cnt, matches, gapa, gapb, hasm, fmx, fmy, lmx, lmy, score,
found) plus, when asked, the (B, lmax) uint8 edit codes in walk order
(zero past each walk's end; the wrapper zero-fills them).  Both stop
where every walk has left the band or the sequences; the steps the JAX
scan runs after that change nothing.
"""

from __future__ import annotations

import ctypes

import torch

from .bsw_antidiag import DIR_DIAG, DIR_LEFT, DIR_UP, _check, unpack4
from .bsw_ref import FORCE_MAXGAP_LEN
from .editops import GAP_A, GAP_B, MATCH, MISMATCH

ANTIDIAG, ROW = 0, 1  # direction-word layouts

launches = 0  # kernel launches by walk (CPU runs not counted)

_fn = None


def find_max_torch(last_row, diag, begin_a, end_a, x_size, force_end,
                   band: int):
    """The reference's find-max, vectorised: candidates are the last row
    (j ascending; skipped under force_end) then the pos_a == end_a
    diagonal (i ascending; force_end keeps rows >= x_size-1-10 and none
    when x_size <= 10, the unsigned underflow of
    banded_smith_waterman.cc:201); the first maximum wins.  Returns
    (max_i, max_j, score, found), with zeros where nothing was found."""
    B, YS = last_row.shape
    big, negb = 1 << 30, -(1 << 30)
    col = lambda v: v.to(torch.int32).reshape(B, 1)
    ba, ea, xs = col(begin_a), col(end_a), col(x_size)
    fe = col(force_end) != 0
    j = torch.arange(YS, dtype=torch.int32, device=last_row.device)[None]
    posj = ba + (xs - 1) - band + j
    ok_lr = ~fe & (posj >= 0) & (posj <= ea)
    i0 = torch.clamp(ea - ba - band, min=0)
    i_of = (ea - ba + band) - j
    ok_dg = ((i_of >= i0) & (i_of < xs)
             & (~fe | ((i_of >= xs - 1 - FORCE_MAXGAP_LEN)
                       & (xs - 1 - FORCE_MAXGAP_LEN >= 0))))
    v = torch.cat([torch.where(ok_lr, last_row, negb),
                   torch.where(ok_dg, diag, negb)], dim=1)
    p = torch.cat([torch.where(ok_lr, j, big),
                   torch.where(ok_dg, YS + i_of - i0, big)], dim=1)
    m = v.max(dim=1).values
    found = (ok_lr.any(dim=1) | ok_dg.any(dim=1))
    pw = torch.where(v == m[:, None], p, big).min(dim=1).values
    is_lr = pw < YS
    i_dg = i0[:, 0] + (pw - YS)
    max_i = torch.where(is_lr, xs[:, 0] - 1, i_dg)
    max_j = torch.where(is_lr, pw, (ea - ba + band)[:, 0] - i_dg)
    z = torch.zeros_like(m)
    return (torch.where(found, max_i, z), torch.where(found, max_j, z),
            torch.where(found, m, z), found)


def walk_torch(dirs, a_pk, b_pk, begin_a, end_a, x_size, force_end,
               last_row, diag, band: int, lmax: int, with_edits: bool,
               layout: int = ANTIDIAG):
    """The walk in torch ops, one step of every problem per iteration."""
    dev = dirs.device
    B, NP, K = dirs.shape
    a, b = unpack4(a_pk), unpack4(b_pk)
    aw, xw = a.shape[1], b.shape[1]
    mi, mj, score, found = find_max_torch(last_row, diag, begin_a, end_a,
                                          x_size, force_end, band)
    ba = begin_a.to(torch.int32)
    x = torch.where(found, mi, -1)
    y = mj.clone()
    active = (x >= 0) & (y >= 0) & (ba + x + y - band >= 0)
    z = lambda: torch.zeros(B, dtype=torch.int32, device=dev)
    cnt, matches, gapa, gapb = z(), z(), z(), z()
    hasm = torch.zeros(B, dtype=torch.bool, device=dev)
    fmx, fmy, lmx, lmy = z(), z(), z(), z()
    edits = (torch.zeros((B, lmax), dtype=torch.uint8, device=dev)
             if with_edits else None)
    bi = torch.arange(B, device=dev)
    for s in range(lmax):
        if not bool(active.any()):
            break
        if layout == ROW:
            t = x
            word = dirs[bi, torch.clamp(x >> 4, 0, NP - 1),
                        torch.clamp(y, 0, K - 1)]
        else:
            t = 2 * x + y
            word = dirs[bi, torch.clamp(t >> 4, 0, NP - 1),
                        torch.clamp(y >> 1, 0, K - 1)]
        d = (word >> ((t & 15) * 2)) & 3
        ca = a[bi, torch.clamp(x + y, 0, aw - 1)]
        cb = b[bi, torch.clamp(x, 0, xw - 1)]
        is_match = (ca == cb) | (ca == 4) | (cb == 4)
        if with_edits:
            e = torch.where(d == DIR_DIAG,
                            torch.where(is_match, MATCH, MISMATCH),
                            torch.where(d == DIR_UP, GAP_A, GAP_B))
            edits[:, s] = torch.where(active, e, 0).to(torch.uint8)
        is_m = active & (d == DIR_DIAG) & is_match
        fmx = torch.where(is_m, x, fmx)
        fmy = torch.where(is_m, y, fmy)
        lmx = torch.where(is_m & ~hasm, x, lmx)
        lmy = torch.where(is_m & ~hasm, y, lmy)
        hasm = hasm | is_m
        matches = matches + is_m.to(torch.int32)
        gapa = gapa + (active & (d == DIR_UP)).to(torch.int32)
        gapb = gapb + (active & (d == DIR_LEFT)).to(torch.int32)
        cnt = cnt + active.to(torch.int32)
        nx = torch.where(active & (d != DIR_LEFT), x - 1, x)
        ny = torch.where(active & (d == DIR_UP), y + 1,
                         torch.where(active & (d == DIR_LEFT), y - 1, y))
        x, y = nx, ny
        active = active & (x >= 0) & (y >= 0) & (ba + x + y - band >= 0)
    summary = torch.stack([x, y, cnt, matches, gapa, gapb,
                           hasm.to(torch.int32), fmx, fmy, lmx, lmy,
                           score.to(torch.int32), found.to(torch.int32)])
    return summary.to(torch.int32), edits


def _kernel():
    global _fn
    if _fn is None:
        from .._build import library

        fn = library().bsw_walk
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def walk(dirs, a_pk, b_pk, begin_a, end_a, x_size, force_end, last_row,
         diag, band: int, lmax: int, with_edits: bool,
         layout: int = ANTIDIAG):
    """Find-max + walk of B problems -> (summary (13, B) int32, edits
    (B, lmax) uint8 or None).  CUDA tensors launch the kernel (or raise);
    CPU tensors run the plain version."""
    if layout not in (ANTIDIAG, ROW):
        raise ValueError(f"layout {layout}: ANTIDIAG (0) or ROW (1)")
    if dirs.device.type == "cpu":
        return walk_torch(dirs, a_pk, b_pk, begin_a, end_a, x_size,
                          force_end, last_row, diag, band, lmax, with_edits,
                          layout)
    if dirs.device.type != "cuda":
        raise ValueError(f"unsupported device {dirs.device}")
    dev = dirs.device
    B, NP, K = dirs.shape
    aw, xw, YS = 2 * a_pk.shape[1], 2 * b_pk.shape[1], 2 * band + 1
    lanes = 2 * band + 1 if layout == ROW else band + 1
    _check("dirs", dirs, torch.int32, (B, NP, lanes), dev)
    _check("a_pk", a_pk, torch.uint8, (B, aw // 2), dev)
    _check("b_pk", b_pk, torch.uint8, (B, xw // 2), dev)
    for name, v in (("begin_a", begin_a), ("end_a", end_a),
                    ("x_size", x_size), ("force_end", force_end)):
        _check(name, v, torch.int32, (B,), dev)
    _check("last_row", last_row, torch.int32, (B, YS), dev)
    _check("diag", diag, torch.int32, (B, YS), dev)
    if aw % 8 or xw % 8 or a_pk.data_ptr() % 4 or b_pk.data_ptr() % 4:
        raise ValueError("a_pk and b_pk rows must start on 4-byte "
                         f"boundaries (widths {aw}, {xw})")
    last_word = xw - 1 if layout == ROW else 2 * (xw - 1) + 2 * band
    if last_word >= 16 * NP:
        raise ValueError(f"dirs has {NP} words per lane, too few for "
                         f"xw={xw}, band={band}")
    summary = torch.empty((13, B), dtype=torch.int32, device=dev)
    edits = (torch.zeros((B, lmax), dtype=torch.uint8, device=dev)
             if with_edits else None)
    if B == 0:
        return summary, edits
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(dirs.data_ptr(), a_pk.data_ptr(), b_pk.data_ptr(),
                        begin_a.data_ptr(), end_a.data_ptr(),
                        x_size.data_ptr(), force_end.data_ptr(),
                        last_row.data_ptr(), diag.data_ptr(), B, aw, xw,
                        band, NP, lmax, FORCE_MAXGAP_LEN, layout,
                        summary.data_ptr(),
                        edits.data_ptr() if with_edits else None, stream)
    if err:
        raise RuntimeError(f"bsw_walk launch failed: CUDA error {err}")
    global launches
    launches += 1
    return summary, edits
