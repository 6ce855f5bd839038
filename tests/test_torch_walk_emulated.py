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
    ANSWER_ROWS,
    ANTIDIAG,
    ITERS,
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
# the band-30 edge cases, the find-max ties, and the near-identical
# windows of tp.run_problems (4000 rows, 1500 past band 1024, where the
# plain row forward takes ~7 s a thousand rows)
_SETS = {"ragged": tp.ragged_problems, "edges": lambda _b: tp.edge_problems(),
         "ties": lambda _b: tp.tie_problems(),
         "runs": lambda b: tp.run_problems(b, run_rows(b))}
_cases: dict = {}
_plain: dict = {}


def run_rows(band):
    return 4000 if band <= WIDE_RING_BAND else 1500


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


def run_emulated(lib, case, band, layout, with_edits, shift=0, lmax=None):
    """The emulated kernel's (summary, edits) over the case's words, the
    words placed `shift` int32 past a 16-byte boundary of a buffer padded
    by 4 words on each side; `lmax` steps at most (default: the engine's
    bound, which no walk reaches)."""
    a_pk, b_pk, scal, (dirs, last_row, diag), xw = case
    B = a_pk.shape[0]
    lmax = lmax or lmax_of(xw, band)
    buf = np.zeros(dirs.size + 8 + shift, np.int32)
    assert buf.ctypes.data % 16 == 0
    buf[4 + shift:4 + shift + dirs.size] = dirs.ravel()
    ins = [np.ascontiguousarray(v) for v in (a_pk, b_pk, scal[0], scal[1],
                                             scal[3], scal[5], last_row,
                                             diag)]
    summary = np.full((ANSWER_ROWS + 1, B), -7, np.int32)
    # room past the last row for a broken source's overrun
    edits = (np.zeros(B * lmax + lmax_of(xw, band), np.uint8)[:B * lmax]
             .reshape(B, lmax) if with_edits else None)
    err = lib.bsw_walk(buf.ctypes.data + 4 * (4 + shift),
                       *(v.ctypes.data for v in ins), B, 2 * a_pk.shape[1],
                       xw, band, dirs.shape[1], lmax, FORCE_MAXGAP_LEN,
                       layout, summary.ctypes.data,
                       None if edits is None else edits.ctypes.data, None)
    assert err == 0
    return summary, edits


def plain_walk(case, band, layout, with_edits, lmax=None):
    """walk_torch's (summary, edits) over the case; cached."""
    key = (id(case), band, layout, with_edits, lmax)
    if key not in _plain:
        a_pk, b_pk, scal, (dirs, last_row, diag), xw = case
        t = lambda v: torch.from_numpy(np.ascontiguousarray(v))
        summary, edits = walk_torch(t(dirs), t(a_pk), t(b_pk), t(scal[0]),
                                    t(scal[1]), t(scal[3]), t(scal[5]),
                                    t(last_row), t(diag), band,
                                    lmax or lmax_of(xw, band), with_edits,
                                    layout)
        _plain[key] = (summary.numpy(),
                       None if edits is None else edits.numpy())
    return _plain[key]


def emulated_matches_plain(lib, case, band, layout, with_edits,
                           shift=0, lmax=None) -> bool:
    """The answer rows and edit codes equal the plain version's, and the
    kernel's iterations lie between 1 and the steps where it walked."""
    got = run_emulated(lib, case, band, layout, with_edits, shift, lmax)
    want = plain_walk(case, band, layout, with_edits, lmax)
    iters, cnt = got[0][ITERS], want[0][2]
    return (np.array_equal(got[0][:ANSWER_ROWS], want[0][:ANSWER_ROWS])
            and (iters <= cnt).all() and ((iters > 0) == (cnt > 0)).all()
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


# a cut that ends the long windows' walks inside a diagonal run
RUN_LMAX = 1001


@pytest.mark.parametrize("layout,band", CASES)
def test_walk_kernel_source_takes_runs(walk_emulated, layout, band):
    """Near-identical windows (tp.run_problems: substitutions, N on both
    sides, 1-3 bp indels at random rows, at word rows' edges and at a
    lookahead's edges; walks that end at row 0, at the band's lower edge
    and at lmax), with and without edit codes, and with lmax cut to
    RUN_LMAX: bit for bit the plain version, on both rings.  In layout 0
    the walk over the substitution-only pair of 4000 rows takes a
    lookahead of 32 word rows (256 steps) an iteration."""
    case = walk_case("runs", band, layout)
    for with_edits, lmax in ((False, None), (True, None), (True, RUN_LMAX)):
        assert emulated_matches_plain(walk_emulated, case, band, layout,
                                      with_edits, lmax=lmax), (with_edits,
                                                               lmax)
    summary = run_emulated(walk_emulated, case, band, layout, False)[0]
    assert summary[2, 0] == run_rows(band)  # from the end to row 0
    if layout == ANTIDIAG:
        assert summary[ITERS, 0] <= -(-run_rows(band) // 256) + 8
    assert summary[ITERS].sum() * 10 < summary[2].sum()


def test_walk_kernel_source_iterations_on_ragged(walk_emulated):
    """On the ragged bucket's random and mutated pairs the kernel takes at
    most one iteration a step, and at least one where the walk steps."""
    for layout in (ANTIDIAG, ROW):
        case = walk_case("ragged", 150, layout)
        summary = run_emulated(walk_emulated, case, 150, layout, False)[0]
        iters, cnt = summary[ITERS], summary[2]
        assert (iters <= cnt).all() and ((iters > 0) == (cnt > 0)).all()
        assert cnt.sum() > 0


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


# (old text, new text): the first three break the staging of the word
# rows, the last three the diagonal runs
MUTATIONS = {
    "ring_slot_one_row_off": (
        "const uint32_t* p = rows + (int)((unsigned)v % kRows) * SW;",
        "const uint32_t* p = rows + (int)((unsigned)(v + 1) % kRows) * SW;"),
    "prefetch_of_the_wrong_group": (
        "sg.fetch(cw / GR - NG + 2);", "sg.fetch(cw / GR - NG + 1);"),
    "span_without_its_phase": (
        "reinterpret_cast<const uint4*>(src - ph);",
        "reinterpret_cast<const uint4*>(src);"),
    "run_without_its_lmax_clip": (
        "min(min(lmax - s, x + 1), ba + x + y - band + 1)",
        "min(x + 1, ba + x + y - band + 1)"),
    "run_without_n_as_a_match": (
        "zero_nibbles(va ^ vb) | zero_nibbles(va ^ 0x44444444u) |\n"
        "                    zero_nibbles(vb ^ 0x44444444u)",
        "zero_nibbles(va ^ vb)"),
    "run_settled_one_step_short": (
        "settle_run(cur, y, L, tl, ed, s, tid);",
        "settle_run(cur, y, L - 1, tl, ed, s, tid);"),
}
RUN_MUTATIONS = ("run_settled_one_step_short", "run_without_its_lmax_clip",
                 "run_without_n_as_a_match")


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


STAGING_MUTATIONS = sorted(set(MUTATIONS) - set(RUN_MUTATIONS))


@pytest.mark.parametrize("mutation,layout,band", [
    (m, ROW, b) for m in STAGING_MUTATIONS
    for b in (WIDE_RING_BAND - 1, WIDE_RING_BAND)]
    + [(m, ANTIDIAG, 150) for m in STAGING_MUTATIONS])
def test_walk_kernel_source_mutation_fails(mutants, mutation, layout, band):
    """A broken ring slot or prefetch gives other outputs than the plain
    version on either ring; a 16-byte span copied without its phase only
    on the 3-row ring, so the launcher switches rings at
    WIDE_RING_BAND and not before."""
    case = walk_case("ragged", band, layout)
    ok = emulated_matches_plain(mutants[mutation], case, band, layout, True)
    wide = layout == ROW and band >= WIDE_RING_BAND
    assert ok == (mutation == "span_without_its_phase" and not wide)


@pytest.mark.parametrize("mutation,layout,band", [
    (m, layout, band) for m in RUN_MUTATIONS
    for layout, band in ((ANTIDIAG, 150), (ROW, 150), (ROW, WIDE_RING_BAND))])
def test_walk_kernel_source_run_mutation_fails(mutants, mutation, layout,
                                               band):
    """A run that overruns lmax, that counts N as a mismatch, or that
    settles one step fewer than it walks gives other outputs than the
    plain version on the near-identical windows (the clip with lmax cut
    to RUN_LMAX), in both layouts and on both rings."""
    case = walk_case("runs", band, layout)
    assert not emulated_matches_plain(mutants[mutation], case, band, layout,
                                      True, lmax=RUN_LMAX)
