"""The row forward's CUDA source run on the CPU.

gam_ngs_tpu_torch/csrc/bsw_row.cu is compiled by g++ against
tests/cuda_emu/cuda_runtime.h, a stand-in runtime that runs each warp as
32 host threads meeting at every shuffle (and a block's warps at every
__syncthreads), and its C entry point bsw_row_forward is called on host
arrays: every instance of one warp or of up to eight warps a problem,
at the first and last band it takes, and long windows at bands 150 and
300, bit for bit against the plain version forward_row_torch; and
sources with one step of the W-warp exchange broken must fail there.
This holds the kernel's own code (lane layout, score vectors, the exact
and lean rows, the exchange between warps, the records, the launcher's
choice of instance) where there is no card; the wider instances and the
clusters of blocks run in tests/test_torch_row_cluster_emulated.py; the
card's tests (tests/test_torch_cuda.py) hold the compiled kernel.
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
from gam_ngs_tpu_torch.ops.bsw_row import NEG, forward_row_torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, os.pardir, "gam_ngs_tpu_torch", "csrc", "bsw_row.cu")


def build_emulated(src, tmp, warnings_ok=False):
    """bsw_row_forward of a kernel source, built for the host in tmp
    (a mutated source may leave a variable unused: warnings_ok)."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the port's native code; it is needed here too"
    src = src.replace("extern __shared__ int smem[];",
                      "int* smem = emu::dyn_smem;")
    src = re.sub(r"([\w:]+(?:<[^<>]*>)?)<<<(.*?)>>>\(",
                 r"emu::launch(\1, \2, ", src)
    cc, so = tmp / "bsw_row_host.cc", tmp / "libbsw_row_host.so"
    cc.write_text(src)
    r = subprocess.run([gxx, "-std=c++20", "-O1", "-fwrapv", "-pthread",
                        "-shared", "-fPIC", "-Wall", "-Wno-unknown-pragmas",
                        "-I", os.path.join(HERE, "cuda_emu"), str(cc), "-o",
                        str(so)], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    assert warnings_ok or "warning" not in r.stderr, r.stderr
    fn = ctypes.CDLL(str(so)).bsw_row_forward
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 11
                   + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    return fn


@pytest.fixture(scope="module")
def row_forward_emulated(tmp_path_factory):
    """bsw_row_forward of the source, built for the host."""
    return build_emulated(open(SRC).read(),
                          tmp_path_factory.mktemp("bsw_row_emu"))


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


# each instance's first and last band up to eight warps of four lanes
# (band 511), on the boundary set (the wider instances and the clusters:
# tests/test_torch_row_cluster_emulated.py and the card)
WARP_MAX_BAND = (32 * 8 * 4 - 1) // 2


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


def long_windows(band, seed, more=False):
    """Six problems of 800-1023 rows at `band`: N in every third, the
    last two with an a that runs out half way through b (lanes at pos >=
    a_len) and end_a before a's end, force_start and force_end mixed;
    packed.  `more` adds two: a b unrelated to an a that runs out half
    way, with end_a at a's end (the row falls below 0, so the 0 that
    lanes past a_len hold is taken as an up move), and an a longer than
    the window with end_a half way (the last row's block holds no other
    record and no lane past a_len)."""
    rng = np.random.default_rng(seed)
    problems = []
    for k in range(8 if more else 6):
        n = int(rng.integers(800, 1024))
        a = rng.integers(0, 5 if k % 3 == 0 else 4,
                         size=n + 2 * band).astype(np.uint8)
        b = tp.mutate(rng, a[band:band + n])
        b = np.concatenate([b, rng.integers(0, 4, n).astype(np.uint8)])[:n]
        if k == 6:
            b = rng.integers(0, 4, n).astype(np.uint8)
        if 4 <= k <= 6:  # a runs out half way through b
            a = a[:n // 2 + band]
        ea = len(a) - 1 - (0 if k == 6 else 7 * k)
        if k == 7:
            a = np.concatenate([a, rng.integers(0, 4, 64).astype(np.uint8)])
            ea = band + n // 2
        problems.append((a, band, ea, b, 0, n - 1, k % 2 == 0 and k < 6,
                         k % 3 == 1 and k < 6))
    return tp.pack_problems(problems, band)


def emulated_matches_plain(fn, packed, band) -> bool:
    a_pk, b_pk, scal, _preps, xw = packed
    got = run_emulated(fn, a_pk, b_pk, scal, band, xw)
    want = forward_row_torch(*(torch.from_numpy(v)
                               for v in (a_pk, b_pk, *scal[:5])), band)
    return all((g == w.numpy()).all() for g, w in zip(got, want))


def test_row_warp_kernel_source_long_windows(row_forward_emulated):
    """Band 150 (ten lanes a thread) over windows of 800-1023 rows: the
    unrolled lean blocks with and without a record, prefetched codes,
    and a window whose a ends early (lanes at pos >= a_len)."""
    band = 150
    a_pk, b_pk, scal, _preps, xw = long_windows(band, 8)
    got = run_emulated(row_forward_emulated, a_pk, b_pk, scal, band, xw)
    want = forward_row_torch(*(torch.from_numpy(v)
                               for v in (a_pk, b_pk, *scal[:5])), band)
    for name, g, w in zip(("dirs", "last_row", "diag"), got, want):
        assert (g == w.numpy()).all(), name


def test_row_warps_kernel_source_long_windows(row_forward_emulated):
    """Band 300 (four warps of five lanes a thread) over windows of
    800-1023 rows: the exchange between the warps on unrolled lean
    blocks with and without a record, and at the lanes past a_len of an
    a that ends half way."""
    band = 300
    assert emulated_matches_plain(row_forward_emulated,
                                  long_windows(band, 8, more=True), band)


# (old text, new text) in row_warps_kernel<R, W>'s source, from the
# helpers' cross-warp code on: each breaks one step of the exchange
MUTATIONS = {
    "drop_the_cross_warp_carry": (
        "if (v < L.w) y = max(y, q[v]);", "if (v < L.w) y = max(y, s.neg);"),
    "boundary_up_lane_from_the_wrong_buffer": (
        "const int* q = L.xch + ((i - 1) & 1) * 4 * G + L.w + 1;",
        "const int* q = L.xch + (i & 1) * 4 * G + L.w + 1;"),
    "last_row_checked_in_warp_0_only": (
        "(L.xs1 >= i0 && L.xs1 <= i0 + 15) ||",
        "(L.xs1 >= i0 && L.xs1 <= i0 + 15 && L.w == 0) ||"),
}


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_row_warps_kernel_source_mutation_fails(tmp_path, mutation):
    """A source with one step of the W-warp exchange broken gives other
    outputs than the plain version on the band-300 long windows, so the
    emulated tests would catch it."""
    old, new = MUTATIONS[mutation]
    src = open(SRC).read()
    # the text once in the code that W > 1 warps run: from the exchange
    # on; the last row's check once in row_warps_kernel, after
    # row_warp_kernel's copy
    cut = src.index("struct Exchange {")
    if mutation == "last_row_checked_in_warp_0_only":
        cut = src.index("row_warps_kernel(")
    assert src[cut:].count(old) == 1
    fn = build_emulated(src[:cut] + src[cut:].replace(old, new), tmp_path,
                        warnings_ok=True)
    assert not emulated_matches_plain(fn, long_windows(300, 8, more=True),
                                      300)

