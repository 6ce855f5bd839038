"""The row forward's CUDA source run on the CPU.

gam_ngs_tpu_torch/csrc/bsw_row.cu is compiled by g++ against
tests/cuda_emu/cuda_runtime.h, a stand-in runtime that runs each warp as
32 host threads meeting at every shuffle, and its C entry point
bsw_row_forward is called on host arrays: every warp instance, at the
first and last band it takes, bit for bit against the plain version
forward_row_torch.  This holds the kernel's own code (lane layout, score
vectors, the exact and lean rows, the records, the launcher's choice of
instance) where there is no card; the card's tests
(tests/test_torch_cuda.py) hold the compiled kernel.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import torch_problems as tp
from gam_ngs_tpu_torch.ops.bsw_antidiag import MATCH_S, MISMATCH_S, NN_S, NX_S
from gam_ngs_tpu_torch.ops.bsw_ref import FORCE_MAXGAP_LEN, GAP
from gam_ngs_tpu_torch.ops.bsw_row import (
    NEG,
    WARP_WIDTHS,
    forward_row_torch,
)

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, os.pardir, "gam_ngs_tpu_torch", "csrc", "bsw_row.cu")


@pytest.fixture(scope="module")
def row_forward_emulated(tmp_path_factory):
    """bsw_row_forward of the source, built for the host."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the port's native code; it is needed here too"
    src = open(SRC).read()
    src = src.replace("extern __shared__ int smem[];",
                      "int* smem = emu::dyn_smem;")
    src = re.sub(r"([\w:]+(?:<[^<>]*>)?)<<<(.*?)>>>\(",
                 r"emu::launch(\1, \2, ", src)
    tmp = tmp_path_factory.mktemp("bsw_row_emu")
    cc, so = tmp / "bsw_row_host.cc", tmp / "libbsw_row_host.so"
    cc.write_text(src)
    r = subprocess.run([gxx, "-std=c++20", "-O1", "-fwrapv", "-pthread",
                        "-shared", "-fPIC", "-Wall", "-Wno-unknown-pragmas",
                        "-I", os.path.join(HERE, "cuda_emu"), str(cc), "-o",
                        str(so)], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    assert "warning" not in r.stderr, r.stderr
    fn = ctypes.CDLL(str(so)).bsw_row_forward
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 11
                   + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    return fn


def run_emulated(fn, a_pk, b_pk, scal, band, xw):
    B, YS = a_pk.shape[0], 2 * band + 1
    ins = [np.ascontiguousarray(v) for v in (a_pk, b_pk, *scal[:5])]
    outs = [np.zeros((B, xw // 16, YS), np.int32),
            np.zeros((B, YS), np.int32), np.zeros((B, YS), np.int32)]
    err = fn(*(v.ctypes.data for v in ins), B, 2 * a_pk.shape[1], xw, band,
             MATCH_S, MISMATCH_S, NN_S, NX_S, GAP, FORCE_MAXGAP_LEN, NEG,
             *(v.ctypes.data for v in outs), None)
    assert err == 0
    return outs


# each warp instance's first and last band (the block kernels above are
# held on the card)
WARP_MAX_BAND = (32 * WARP_WIDTHS[-1] - 1) // 2


@pytest.mark.parametrize("band", [b for b in tp.row_boundary_bands()
                                  if b <= WARP_MAX_BAND])
def test_row_warp_kernel_source_matches_plain(row_forward_emulated, band):
    """Ragged x_size from 1 row to the window (begin_a < 0 tails, N,
    force_start and force_end) and soak problems past the exact rows."""
    a_pk, b_pk, scal, _preps, xw = tp.pack_problems(
        tp.boundary_problems(band), band)
    got = run_emulated(row_forward_emulated, a_pk, b_pk, scal, band, xw)
    want = forward_row_torch(*(torch.from_numpy(v)
                               for v in (a_pk, b_pk, *scal[:5])), band)
    for name, g, w in zip(("dirs", "last_row", "diag"), got, want):
        assert (g == w.numpy()).all(), (band, name)


def test_row_warp_kernel_source_long_windows(row_forward_emulated):
    """Band 150 (ten lanes a thread) over windows of 800-1023 rows: the
    unrolled lean blocks with and without a record, prefetched codes,
    and a window whose a ends early (lanes at pos >= a_len)."""
    rng = np.random.default_rng(8)
    band, problems = 150, []
    for k in range(6):
        n = int(rng.integers(800, 1024))
        a = rng.integers(0, 5 if k % 3 == 0 else 4,
                         size=n + 2 * band).astype(np.uint8)
        b = tp.mutate(rng, a[band:band + n])
        b = np.concatenate([b, rng.integers(0, 4, n).astype(np.uint8)])[:n]
        if k >= 4:  # a runs out half way through b
            a = a[:n // 2 + band]
        problems.append((a, band, len(a) - 1 - 7 * k, b, 0, n - 1,
                         k % 2 == 0, k % 3 == 1))
    a_pk, b_pk, scal, _preps, xw = tp.pack_problems(problems, band)
    got = run_emulated(row_forward_emulated, a_pk, b_pk, scal, band, xw)
    want = forward_row_torch(*(torch.from_numpy(v)
                               for v in (a_pk, b_pk, *scal[:5])), band)
    for name, g, w in zip(("dirs", "last_row", "diag"), got, want):
        assert (g == w.numpy()).all(), name
