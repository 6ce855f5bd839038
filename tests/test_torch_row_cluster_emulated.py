"""The row forward's wide instances and thread-block clusters, from its
CUDA source run on the CPU.

gam_ngs_tpu_torch/csrc/bsw_row.cu is compiled by g++ against
tests/cuda_emu/cuda_runtime.h (each warp 32 host threads; the blocks of
a cluster run together, each with its own dynamic shared memory, and
meet at every cluster barrier) as tests/test_torch_row_emulated.py
builds it, and bsw_row_forward is held bit for bit against the plain
version forward_row_torch: the one-block instances of eight warps of
five lanes and sixteen of three and the clusters of two blocks at the
first and last band each takes (512-2047, up to 1024 host threads); a
narrow cluster that only the tests build (four blocks of one warp of two
lanes a thread, put first in the launcher) on the boundary set and long
windows; and sources with one step of the cross-rank exchange broken
must fail there.  The clusters of eight blocks run on the card
(tests/test_torch_cuda.py, chip_smoke.py).  The cases sit in their own
file so that the test runner's per-file workers run them beside those
of tests/test_torch_row_emulated.py.
"""

import pytest

import torch_problems as tp
from gam_ngs_tpu_torch.ops.bsw_row import CLUSTER_WIDTHS
from test_torch_row_emulated import (
    SRC,
    WARP_MAX_BAND,
    build_emulated,
    emulated_matches_plain,
    long_windows,
)

# the widest band of the clusters of two blocks
CLUSTER2_MAX_BAND = (32 * max(c * w * r for c, w, r in CLUSTER_WIDTHS
                              if c == 2) - 1) // 2


@pytest.fixture(scope="module")
def row_forward_emulated(tmp_path_factory):
    """bsw_row_forward of the source, built for the host."""
    return build_emulated(open(SRC).read(),
                          tmp_path_factory.mktemp("bsw_row_emu"))


@pytest.mark.parametrize("band", [b for b in tp.row_boundary_bands()
                                  if WARP_MAX_BAND < b <= CLUSTER2_MAX_BAND])
def test_row_cluster_kernel_source_matches_plain(row_forward_emulated, band):
    """The wide instances at their first and last band: one block of
    eight warps of five lanes and of sixteen of three (bands 512-767),
    clusters of two blocks of eight or sixteen warps (768-2047, up to
    1024 host threads), on the ragged bucket up to half its window
    (x_size 1 to 193, a begin_a < 0 tail, N, force_start and force_end;
    the two window-long problems, two thirds of the rows, run in the
    narrow cluster's boundary set below and on the card): row 0's
    composition and the lean max carried across the warps and the
    ranks, the first lane pushed to the rank before, a last rank of
    padding lanes."""
    problems = [p for p in tp.ragged_problems(band) if len(p[3]) <= 193]
    assert emulated_matches_plain(
        row_forward_emulated, tp.pack_problems(problems, band), band)


# A narrow cluster instance for the tests alone: four blocks of one warp
# of two lanes a thread, put first in the launcher, so that it takes
# every band up to 127 (256 lanes) at the cost of 128 host threads: the
# cross-rank carry, the boundary lane, the records and the tails on
# every set.  At band 15 three ranks are padding, at 64 the third holds
# one lane.
NARROW_BANDS = (15, 64, 127)


def narrow_source(src: str) -> str:
    first = "  GAM_WARP(1, 1);"
    assert src.count(first) == 1
    return src.replace(first, "  GAM_CLUSTER(4, 1, 2);\n" + first)


@pytest.fixture(scope="module")
def narrow_emulated(tmp_path_factory):
    """bsw_row_forward of the source with the narrow cluster instance."""
    return build_emulated(narrow_source(open(SRC).read()),
                          tmp_path_factory.mktemp("bsw_row_narrow"))


@pytest.mark.parametrize("band", NARROW_BANDS)
def test_narrow_cluster_source_matches_plain(narrow_emulated, band):
    """The narrow cluster on the boundary set (ragged x_size, tails, N,
    force flags, soak problems past the exact rows)."""
    assert emulated_matches_plain(
        narrow_emulated, tp.pack_problems(tp.boundary_problems(band), band),
        band)


def test_narrow_cluster_source_long_windows(narrow_emulated):
    """The narrow cluster at band 100 over windows of 800-1023 rows:
    unrolled lean blocks with and without a record, lanes past a_len at
    a rank boundary, an unrelated b, end_a half way."""
    assert emulated_matches_plain(narrow_emulated,
                                  long_windows(100, 8, more=True), 100)


# (old text, new text) in the cluster code of row_warps_kernel<R, W, C>:
# each breaks one step of the exchange between the blocks of a cluster
CLUSTER_MUTATIONS = {
    "drop_the_cross_rank_carry": (
        "y = max(y, __reduce_max_sync(kFull, z));", "y = max(y, s.neg);"),
    "next_rank_first_lane_not_pushed": (
        "if (!L.t) q[2 * G] = fc, q[3 * G] = fsl;", ""),
    "pushes_to_the_wrong_parity": (
        "int* q = L.push + (i & 1) * 4 * G + L.w;",
        "int* q = L.push + ((i + 1) & 1) * 4 * G + L.w;"),
}


@pytest.mark.parametrize("mutation", sorted(CLUSTER_MUTATIONS))
def test_row_cluster_kernel_source_mutation_fails(tmp_path, mutation):
    """A source with one step of the cross-rank exchange broken gives
    other outputs than the plain version on the narrow cluster's band-64
    boundary set, so the emulated tests would catch it."""
    old, new = CLUSTER_MUTATIONS[mutation]
    src = open(SRC).read()
    assert src.count(old) == 1
    fn = build_emulated(narrow_source(src.replace(old, new)), tmp_path,
                        warnings_ok=True)
    assert not emulated_matches_plain(
        fn, tp.pack_problems(tp.boundary_problems(64), 64), 64)
