"""The find-max + walk kernel's CUDA source run on the CPU.

gam_ngs_tpu_torch/csrc/bsw_walk.cu is compiled by g++ against
tests/cuda_emu/cuda_runtime.h (each warp 32 host threads meeting at
every shuffle, vote and __syncwarp), and its C entry point bsw_walk is
called on host arrays: the anti-diagonal forward's words
(forward_antidiag_torch) at bands 30, 150 and 1023, and the row
forward's (forward_row_torch) at bands 30, 150 and 1023 on the 16-row
ring and 1024 (the first band on the 3-row ring), 2047 and 4095 on the
3-row ring, with and without edit codes, bit for bit against the plain
version walk_torch; and sources with the ring's slot, its prefetch or
the 16-byte span's phase broken must fail there.  The direction words
lie in a padded buffer, 16-byte aligned or one word past it, so the
3-row ring's 16-byte copies take every phase.

The stand-in cp.async copies at once, so the commit and the waits have
nothing to do here: a missing or too short wait cannot show on the CPU.
The card's tests (tests/test_torch_cuda.py, chip_smoke.py) hold the
compiled kernel, whose copies land late.
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
from gam_ngs_tpu_torch.ops.bsw_antidiag import (
    MAX_BAND as ANTIDIAG_MAX_BAND,
    forward_antidiag_torch,
)
from gam_ngs_tpu_torch.ops.bsw_ref import FORCE_MAXGAP_LEN
from gam_ngs_tpu_torch.ops.bsw_row import MAX_BAND, forward_row_torch
from gam_ngs_tpu_torch.ops.bsw_walk import (
    ANTIDIAG,
    ROW,
    WIDE_RING_BAND,
    walk_torch,
)

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, os.pardir, "gam_ngs_tpu_torch", "csrc",
                   "bsw_walk.cu")
SMEM = "extern __shared__ __align__(16) uint32_t smem[];"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions' tensors here pass torch's parallel grain, and a
    parallel region of many small ops waits on every intra-op thread: on
    a machine whose cores the other test processes fill, one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def build_emulated(src, tmp, warnings_ok=False):
    """The library of a kernel source (bsw_walk, bsw_walk_ring), built
    for the host in tmp (a mutated source may leave a variable unused:
    warnings_ok)."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the port's native code; it is needed here too"
    assert src.count(SMEM) == 1
    src = src.replace(SMEM, "uint32_t* smem = reinterpret_cast<uint32_t*>("
                      "emu::dyn_smem);")
    src = re.sub(r"([\w:]+(?:<[^<>]*>)?)<<<(.*?)>>>\(",
                 r"emu::launch(\1, \2, ", src)
    cc, so = tmp / "bsw_walk_host.cc", tmp / "libbsw_walk_host.so"
    cc.write_text(src)
    r = subprocess.run([gxx, "-std=c++20", "-O1", "-fwrapv", "-pthread",
                        "-shared", "-fPIC", "-Wall", "-Wno-unknown-pragmas",
                        "-I", os.path.join(HERE, "cuda_emu"), str(cc), "-o",
                        str(so)], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    assert warnings_ok or "warning" not in r.stderr, r.stderr
    lib = ctypes.CDLL(str(so))
    lib.bsw_walk.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                             + [ctypes.c_void_p] * 3)
    lib.bsw_walk_ring.argtypes = [ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p]
    lib.bsw_walk.restype = lib.bsw_walk_ring.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def walk_emulated(tmp_path_factory):
    """The source's library, built for the host."""
    return build_emulated(open(SRC).read(),
                          tmp_path_factory.mktemp("bsw_walk_emu"))


_FORWARDS = {ANTIDIAG: forward_antidiag_torch, ROW: forward_row_torch}
# problem sets: tp.ragged_problems(band) (x_size 1 to the window, begin_a
# < 0 tails, N, force_start and force_end), the band-30 edge cases and
# the find-max ties
_SETS = {"ragged": tp.ragged_problems, "edges": lambda _b: tp.edge_problems(),
         "ties": lambda _b: tp.tie_problems()}
_cases: dict = {}


def walk_case(name, band, layout):
    """(packed inputs, the plain forward's dirs, last row, diag, xw) of
    one set's bucket at `band`, as numpy arrays; cached, as the plain
    forwards at the wide bands take seconds."""
    key = (name, band, layout)
    if key not in _cases:
        a_pk, b_pk, scal, _preps, xw = tp.pack_problems(_SETS[name](band),
                                                        band)
        fwd = _FORWARDS[layout](*(torch.from_numpy(v)
                                  for v in (a_pk, b_pk, *scal[:5])), band)
        _cases[key] = (a_pk, b_pk, scal, [v.numpy() for v in fwd], xw)
    return _cases[key]


def lmax_of(xw, band):
    return -(-(2 * xw + 2 * band + 8) // 4) * 4


def run_emulated(lib, case, band, layout, with_edits, shift=0):
    """The emulated kernel's (summary, edits) over the case's words, the
    words placed `shift` int32 past a 16-byte boundary of a buffer padded
    by 4 words on each side."""
    a_pk, b_pk, scal, (dirs, last_row, diag), xw = case
    B = a_pk.shape[0]
    lmax = lmax_of(xw, band)
    buf = np.zeros(dirs.size + 8 + shift, np.int32)
    assert buf.ctypes.data % 16 == 0
    buf[4 + shift:4 + shift + dirs.size] = dirs.ravel()
    ins = [np.ascontiguousarray(v) for v in (a_pk, b_pk, scal[0], scal[1],
                                             scal[3], scal[5], last_row,
                                             diag)]
    summary = np.full((13, B), -7, np.int32)
    edits = np.zeros((B, lmax), np.uint8) if with_edits else None
    err = lib.bsw_walk(buf.ctypes.data + 4 * (4 + shift),
                       *(v.ctypes.data for v in ins), B, 2 * a_pk.shape[1],
                       xw, band, dirs.shape[1], lmax, FORCE_MAXGAP_LEN,
                       layout, summary.ctypes.data,
                       None if edits is None else edits.ctypes.data, None)
    assert err == 0
    return summary, edits


def plain_walk(case, band, layout, with_edits):
    a_pk, b_pk, scal, (dirs, last_row, diag), xw = case
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v))
    summary, edits = walk_torch(t(dirs), t(a_pk), t(b_pk), t(scal[0]),
                                t(scal[1]), t(scal[3]), t(scal[5]),
                                t(last_row), t(diag), band,
                                lmax_of(xw, band), with_edits, layout)
    return summary.numpy(), None if edits is None else edits.numpy()


def emulated_matches_plain(lib, case, band, layout, with_edits,
                           shift=0) -> bool:
    got = run_emulated(lib, case, band, layout, with_edits, shift)
    want = plain_walk(case, band, layout, with_edits)
    return (np.array_equal(got[0], want[0])
            and (got[1] is None) == (want[1] is None)
            and (got[1] is None or np.array_equal(got[1], want[1])))


# (layout, band): the 16-row ring at both layouts up to band 1023, then
# the row layout's 3-row ring from WIDE_RING_BAND to bsw_row.MAX_BAND
CASES = [(ANTIDIAG, 30), (ANTIDIAG, 150), (ANTIDIAG, 1023), (ROW, 30),
         (ROW, 150), (ROW, WIDE_RING_BAND - 1), (ROW, WIDE_RING_BAND),
         (ROW, 2047), (ROW, 4095)]


@pytest.mark.parametrize("layout,band", CASES)
def test_walk_kernel_source_matches_plain(walk_emulated, layout, band):
    """The ragged bucket (x_size 1 to its 384-row window at these bands:
    24 word rows of the row layout, up to 176 of the anti-diagonal one,
    so both rings wrap), with and without edit codes, the words aligned
    and one word past alignment (every phase of the 3-row ring's
    16-byte span, and for the row layout's odd 2*band+1 words the
    rows' phases cycle too)."""
    case = walk_case("ragged", band, layout)
    for with_edits, shift in ((False, 0), (True, 0), (True, 1)):
        assert emulated_matches_plain(walk_emulated, case, band, layout,
                                      with_edits, shift), (with_edits,
                                                           shift)


@pytest.mark.parametrize("layout,band", [(ANTIDIAG, 30), (ROW, 30),
                                         (ROW, 150)])
def test_walk_kernel_source_edges_and_ties(walk_emulated, layout, band):
    """The band-30 edge cases (empty windows, N, clipped ends, x_size <=
    FORCE_MAXGAP_LEN under force_end) and find-max ties between the last
    row and the pos == end_a diagonal."""
    for name in ("edges", "ties"):
        assert emulated_matches_plain(walk_emulated,
                                      walk_case(name, band, layout), band,
                                      layout, True), name


def test_launcher_ring_fits_every_band_the_wrapper_takes(walk_emulated):
    """The launcher's plan (bsw_walk_ring) at every band of each layout
    up to the wrapper's bound: 16 rows of the words, then from
    WIDE_RING_BAND on in the row layout 3 slots of the 16-byte chunks
    that cover a row, 16-byte aligned; at least one warp a block within
    the ring's budget (200 KB, the 3-row ring 227 KB), so the launch is
    never refused for want of shared memory."""
    info = (ctypes.c_int * 5)()
    for layout, top in ((ANTIDIAG, ANTIDIAG_MAX_BAND), (ROW, MAX_BAND)):
        for band in range(top + 1):
            assert walk_emulated.bsw_walk_ring(band, layout,
                                               ctypes.addressof(info)) == 0
            rows, slot, code, warps, shmem = info
            kl = 2 * band + 1 if layout == ROW else band + 1
            wide = layout == ROW and band >= WIDE_RING_BAND
            assert (rows, slot) == ((3, (kl + 6) // 4 * 4) if wide
                                    else (16, kl)), (layout, band)
            per_warp = rows * slot + 2 * code
            assert code & (code - 1) == 0 and not (wide and per_warp % 4)
            assert 1 <= warps <= 4 and shmem == 4 * warps * per_warp
            assert shmem <= (232448 if wide else 200 * 1024), (layout, band)
    m = re.search(r"constexpr int kWideBand = (\d+);", open(SRC).read())
    assert m and int(m.group(1)) == WIDE_RING_BAND


# (old text, new text): each breaks the staging of the word rows
MUTATIONS = {
    "ring_slot_one_row_off": (
        "const uint32_t* p = rows + (int)((unsigned)v % kRows) * SW;",
        "const uint32_t* p = rows + (int)((unsigned)(v + 1) % kRows) * SW;"),
    "prefetch_of_the_wrong_group": (
        "sg.fetch(cw / GR - NG + 2);", "sg.fetch(cw / GR - NG + 1);"),
    "span_without_its_phase": (
        "reinterpret_cast<const uint4*>(src - ph);",
        "reinterpret_cast<const uint4*>(src);"),
}


@pytest.fixture(scope="module")
def mutants(tmp_path_factory):
    """The library of each mutated source, built once."""
    src = open(SRC).read()
    out = {}
    for name, (old, new) in MUTATIONS.items():
        assert src.count(old) == 1, name
        out[name] = build_emulated(src.replace(old, new),
                                   tmp_path_factory.mktemp(name),
                                   warnings_ok=True)
    return out


@pytest.mark.parametrize("mutation,layout,band", [
    (m, ROW, b) for m in sorted(MUTATIONS)
    for b in (WIDE_RING_BAND - 1, WIDE_RING_BAND)]
    + [(m, ANTIDIAG, 150) for m in sorted(MUTATIONS)])
def test_walk_kernel_source_mutation_fails(mutants, mutation, layout, band):
    """A broken ring slot or prefetch gives other outputs than the plain
    version on either ring; a 16-byte span copied without its phase only
    on the 3-row ring, so the launcher switches rings at
    WIDE_RING_BAND and not before."""
    case = walk_case("ragged", band, layout)
    ok = emulated_matches_plain(mutants[mutation], case, band, layout, True)
    wide = layout == ROW and band >= WIDE_RING_BAND
    assert ok == (mutation == "span_without_its_phase" and not wide)
