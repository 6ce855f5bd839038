"""Window gather from the resident sequence arena: CUDA kernel + plain
version.

The counterpart of the XLA `win` gather in gam_ngs_tpu/ops/bsw_batch.py's
`fused_arena` (:861-885).  `gather_windows` launches csrc/arena_gather.cu
for CUDA tensors and runs `gather_windows_torch`, the same arithmetic in
torch ops, for CPU tensors.  Both give, byte for byte, the packed windows
BswEngine._pack_chunk + _pack4 make on the host for the same problems:
the a window from begin_a - band, sentinel 15 outside the sequence and
past its x_size + 2*band codes; the b window from begin_b, 0 outside the
sequence and from x_size on.  A reverse orientation reads the arena from
the sequence's end and complements codes below 4 (XOR 1; N stays 4).

Inputs: arena_pk (n_codes/2,) uint8, two codes a byte (low nibble
first), and cols (12, B) int32 rows a_ofs, a_len, a_rev, begin_a, end_a,
b_ofs, b_len, b_rev, begin_b, x_size, force_start, force_end
(BswEngine._pack_chunk_arena).  Outputs: a_pk (B, aw/2) and b_pk
(B, xw/2) uint8, aw = bsw_antidiag.a_width(xw, band).  The kernel reads
and writes whole 16-byte chunks of 32 codes: aw and xw are multiples of
32 (checked here), and on the card the arena is whole 16-byte words at a
16-byte aligned address (BswEngine pads it to a multiple of 2^20 codes)
and B * (aw + xw) / 32 < 2^31; the entry point checks those, and
launches nothing and returns -1, which raises ValueError here.
"""

from __future__ import annotations

import ctypes

import torch

launches = 0  # kernel launches by gather_windows (CPU runs not counted)

_fn = None


def _window(arena_pk, ofs, ln, rev, start, width: int, fill: int):
    """(B, width) int64 codes of one window per problem."""
    dev = arena_pk.device
    k = torch.arange(width, dtype=torch.int64, device=dev)[None, :]
    p = start[:, None] + k
    rv = rev[:, None] == 1
    idx = torch.where(rv, ofs[:, None] + ln[:, None] - 1 - p,
                      ofs[:, None] + p)
    idx = idx.clamp(0, 2 * arena_pk.shape[0] - 1)
    c = (arena_pk[idx >> 1].long() >> ((idx & 1) * 4)) & 15
    c = torch.where(rv & (c < 4), c ^ 1, c)
    return torch.where((p >= 0) & (p < ln[:, None]), c, fill), k


def _pack(codes):
    return (codes[:, 0::2] | (codes[:, 1::2] << 4)).to(torch.uint8)


def gather_windows_torch(arena_pk, cols, band: int, aw: int, xw: int):
    """The kernel's arithmetic in torch ops -> (a_pk, b_pk)."""
    (a_ofs, a_len, a_rev, begin_a, _end_a, b_ofs, b_len, b_rev, begin_b,
     x_size) = cols.to(torch.int64)[:10]
    a, k = _window(arena_pk, a_ofs, a_len, a_rev, begin_a - band, aw, 15)
    a = torch.where(k < (x_size + 2 * band)[:, None], a, 15)
    b, k = _window(arena_pk, b_ofs, b_len, b_rev, begin_b, xw, 0)
    b = torch.where(k < x_size[:, None], b, 0)
    return _pack(a), _pack(b)


def _kernel():
    global _fn
    if _fn is None:
        from .._build import library

        fn = library().arena_gather
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def gather_windows(arena_pk, cols, band: int, aw: int, xw: int):
    """The packed a and b windows of B arena problems -> (a_pk (B, aw/2),
    b_pk (B, xw/2)) uint8.  CUDA tensors launch the kernel (or raise);
    CPU tensors run the plain version.  Rows are whole 16-byte chunks
    on every device: aw and xw are multiples of 32 codes."""
    if aw % 32 or xw % 32:
        raise ValueError(f"window widths {aw}, {xw}: want multiples of 32 "
                         f"codes")
    if arena_pk.device.type == "cpu":
        return gather_windows_torch(arena_pk, cols, band, aw, xw)
    if arena_pk.device.type != "cuda":
        raise ValueError(f"unsupported device {arena_pk.device}")
    dev = arena_pk.device
    if arena_pk.dtype != torch.uint8 or arena_pk.dim() != 1 \
            or not arena_pk.is_contiguous() or arena_pk.numel() == 0:
        raise ValueError(f"arena_pk: want a non-empty contiguous uint8 "
                         f"vector, got {arena_pk.dtype} "
                         f"{tuple(arena_pk.shape)}")
    if cols.dtype != torch.int32 or cols.dim() != 2 or cols.shape[0] != 12 \
            or cols.device != dev or not cols.is_contiguous():
        raise ValueError(f"cols: want contiguous int32 (12, B) on {dev}, "
                         f"got {cols.dtype} {tuple(cols.shape)} on "
                         f"{cols.device}")
    B = cols.shape[1]
    a_pk = torch.empty((B, aw // 2), dtype=torch.uint8, device=dev)
    b_pk = torch.empty((B, xw // 2), dtype=torch.uint8, device=dev)
    if B == 0:
        return a_pk, b_pk
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(arena_pk.data_ptr(), 2 * arena_pk.numel(),
                        cols.data_ptr(), B, band, aw // 2, xw // 2,
                        a_pk.data_ptr(), b_pk.data_ptr(), stream)
    if err == -1:  # the entry point's own checks: nothing launched
        raise ValueError(f"arena_gather: want an arena of whole 16-byte "
                         f"words at a 16-byte aligned address (got "
                         f"{arena_pk.numel()} bytes at "
                         f"{arena_pk.data_ptr():#x}) and fewer than 2^31 "
                         f"chunks of 32 codes ({B} problems of {aw} + {xw} "
                         f"codes)")
    if err:
        raise RuntimeError(f"arena_gather launch failed: CUDA error {err}")
    global launches
    launches += 1
    return a_pk, b_pk
