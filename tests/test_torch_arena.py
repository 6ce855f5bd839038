"""The resident sequence arena of the port (GAM_ARENA=1) on the CPU: the
window gather's plain version (ops/arena_gather.py) and its CUDA source
(csrc/arena_gather.cu, compiled by g++ against tests/cuda_emu's stand-in
runtime) against the host's packed windows, on the arena soak and on
tp.arena_phase_problems (every nibble phase, both orientations, both
clips, the arena's last code); sources with one step of the kernel
broken, which must fail there; the arena engine against bsw_align and
against the JAX engine's arena (Pallas in interpret mode), its upload
count against the JAX engine's, and whole merges under GAM_ARENA=1
against the port's default merge.  Windows are bytes and alignments integers: exact
equality throughout."""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import torch_problems as tp
from gam_ngs_tpu.io import fasta as jax_fasta
from gam_ngs_tpu.ops.bsw_batch import BswEngine as JaxEngine
from gam_ngs_tpu_torch.io import fasta
from gam_ngs_tpu_torch.models.create import CreateOptions, run_create
from gam_ngs_tpu_torch.models.merge import MergeOptions, run_merge
from gam_ngs_tpu_torch.ops import arena_gather
from gam_ngs_tpu_torch.ops.arena_gather import (
    gather_windows,
    gather_windows_torch,
)
from gam_ngs_tpu_torch.ops.bsw_antidiag import a_width
from gam_ngs_tpu_torch.ops.bsw_engine import BswEngine
from gam_ngs_tpu_torch.ops.editops import first_match_pos, last_match_pos

CPU = torch.device("cpu")
OUTPUTS = (".gam.fasta", ".pctgs", ".stats", ".noblocks.BF.fasta",
           ".noblocks.AF.fasta", ".notmerged.fasta")
quiet = lambda *_: None  # noqa: E731


@pytest.mark.parametrize("band,seed", [(20, 29), (30, 31)])
def test_gather_matches_host_packing(band, seed):
    """gather_windows (the plain version, on CPU tensors) gives the host's
    _pack_chunk + _pack4 bytes on a soak registered as an arena, and the
    soak holds every case the gather distinguishes."""
    contigs, problems = tp.arena_problems(256, seed=seed)
    arena, cols, a_pk, b_pk, xw = tp.arena_chunk(contigs, problems, band)
    n0 = arena_gather.launches
    ga, gb = gather_windows(torch.from_numpy(arena), torch.from_numpy(cols),
                            band, a_width(xw, band), xw)
    assert arena_gather.launches == n0  # CPU: no launch
    assert ga.dtype == gb.dtype == torch.uint8
    assert np.array_equal(ga.numpy(), a_pk)
    assert np.array_equal(gb.numpy(), b_pk)
    (a_ofs, a_len, a_rev, begin_a, _ea, b_ofs, b_len, b_rev, begin_b,
     x_size) = cols[:10]
    live = x_size > 0
    assert live.sum() < len(problems)  # tails and empties left out
    assert (a_rev[live] == 1).any() and (a_rev[live] == 0).any()
    assert (b_rev[live] == 1).any() and (b_rev[live] == 0).any()
    assert (begin_a[live] < 0).any() and (begin_a[live] < band).any()
    assert (begin_a + band + x_size > a_len)[live].any()  # past a's end
    assert (a_ofs[live] % 2 == 1).any() and (b_ofs[live] % 2 == 1).any()
    assert (x_size < xw)[live].all() and len(cols[0]) > live.sum()
    codes = np.concatenate([arena & 15, arena >> 4])
    assert (codes == 4).sum() > 100  # N runs


HERE = os.path.dirname(os.path.abspath(__file__))


SOURCE = os.path.join(HERE, os.pardir, "gam_ngs_tpu_torch", "csrc",
                      "arena_gather.cu")


def build_emulated(src: str, tmp):
    """arena_gather of a kernel source, built for the host against
    tests/cuda_emu's stand-in runtime."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the port's native code; it is needed here too"
    src = re.sub(r"([\w:]+)<<<(.*?)>>>\(", r"emu::launch(\1, \2, ", src)
    cc, so = tmp / "arena_gather_host.cc", tmp / "libarena_gather_host.so"
    cc.write_text(src)
    r = subprocess.run([gxx, "-std=c++20", "-O1", "-fwrapv", "-pthread",
                        "-shared", "-fPIC", "-Wall", "-Wno-unknown-pragmas",
                        "-I", os.path.join(HERE, "cuda_emu"), str(cc), "-o",
                        str(so)], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    assert "warning" not in r.stderr, r.stderr
    fn = ctypes.CDLL(str(so)).arena_gather
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return fn


@pytest.fixture(scope="module")
def gather_emulated(tmp_path_factory):
    """arena_gather of csrc/arena_gather.cu, built for the host."""
    return build_emulated(open(SOURCE).read(),
                          tmp_path_factory.mktemp("arena_emu"))


def run_emulated(fn, arena, cols, band, a_pk, b_pk):
    """The emulated kernel's (a, b) windows, into buffers of the host
    windows' shapes that start as 0xAA."""
    cols = np.ascontiguousarray(cols)
    a_out = np.full_like(a_pk, 0xAA)
    b_out = np.full_like(b_pk, 0xAA)
    err = fn(arena.ctypes.data, 2 * len(arena), cols.ctypes.data,
             cols.shape[1], band, a_pk.shape[1], b_pk.shape[1],
             a_out.ctypes.data, b_out.ctypes.data, None)
    assert err == 0
    return a_out, b_out


@pytest.mark.parametrize("band", [20, 30])
def test_gather_kernel_source_matches_host_packing(gather_emulated, band):
    """The kernel's own code (grid, chunk layout, sentinels, orientation)
    run on the host: the host's packed windows on a small arena soak."""
    contigs, problems = tp.arena_problems(24, seed=band, max_len=200)
    arena, cols, a_pk, b_pk, xw = tp.arena_chunk(contigs, problems, band)
    a_out, b_out = run_emulated(gather_emulated, arena, cols, band, a_pk,
                                b_pk)
    assert np.array_equal(a_out, a_pk) and np.array_equal(b_out, b_pk)
    assert (cols[2] == 1).any() and (cols[7] == 1).any()


def test_gather_kernel_source_refuses_misaligned_arguments(
        gather_emulated):
    """The entry point launches nothing and returns -1 (the wrapper's
    ValueError) for an arena or rows that are not whole, aligned 16-byte
    chunks; no problems is a launch of nothing."""
    contigs, problems = tp.arena_problems(8, seed=3, max_len=120)
    arena, cols, a_pk, b_pk, _xw = tp.arena_chunk(contigs, problems, 20)
    a_out, b_out = np.zeros_like(a_pk), np.zeros_like(b_pk)
    B, a_bytes, b_bytes = cols.shape[1], a_pk.shape[1], b_pk.shape[1]
    good = (arena.ctypes.data, 2 * len(arena), cols.ctypes.data, B, 20,
            a_bytes, b_bytes, a_out.ctypes.data, b_out.ctypes.data, None)
    for k, bad in ((0, arena.ctypes.data + 8), (1, 2 * len(arena) - 2),
                   (5, a_bytes - 8), (6, b_bytes + 4),
                   (7, a_out.ctypes.data + 4)):
        assert gather_emulated(*good[:k], bad, *good[k + 1:]) == -1
    assert not a_out.any() and not b_out.any()
    assert gather_emulated(*good[:3], 0, *good[4:]) == 0


def phase_chunk(band):
    """tp.arena_phase_problems as one arena bucket (tp.arena_chunk)."""
    return tp.arena_chunk(*tp.arena_phase_problems(band), band)


@pytest.mark.parametrize("band", [30, 150])
def test_gather_phase_set_holds_every_case(band):
    """The phase set holds each case the kernel tells apart: all 32
    nibble phases of each window's first arena code in each orientation,
    a windows from before position 0 and past a's end, widths that end
    mid-chunk, padding rows (all fill), and windows that reach the last
    code of an arena of exactly 2^20 codes."""
    arena, cols, _a_pk, _b_pk, xw = phase_chunk(band)
    assert 2 * len(arena) == tp.ARENA_MIN
    (a_ofs, a_len, a_rev, begin_a, _ea, b_ofs, b_len, b_rev, begin_b,
     x_size) = cols[:10].astype(np.int64)
    live = x_size > 0
    assert live.sum() < len(x_size)  # padding rows
    for ofs, ln, rev, start in ((a_ofs, a_len, a_rev, begin_a - band),
                                (b_ofs, b_len, b_rev, begin_b)):
        first = np.where(rev == 1, ofs + ln - 32 - start, ofs + start) & 31
        for r in (0, 1):
            assert set(first[live & (rev == r)]) == set(range(32))
        assert (ofs + ln == tp.ARENA_MIN)[live].any()
    for r in (0, 1):
        sel = live & (a_rev == r)
        assert (begin_a < band)[sel].any() and (begin_a >= band)[sel].any()
        assert (begin_a + band + x_size > a_len)[sel].any()
    assert (x_size % 32 != 0)[live].any()
    assert ((x_size + 2 * band) % 32 != 0)[live].any()
    assert (x_size[live] < xw).all()
    codes = np.concatenate([arena & 15, arena >> 4])
    assert (codes == 4).any()  # N, which the complement keeps


@pytest.mark.parametrize("band", [30, 150])
def test_gather_plain_matches_host_packing_on_phase_set(band):
    arena, cols, a_pk, b_pk, xw = phase_chunk(band)
    ga, gb = gather_windows(torch.from_numpy(arena), torch.from_numpy(cols),
                            band, a_width(xw, band), xw)
    assert np.array_equal(ga.numpy(), a_pk)
    assert np.array_equal(gb.numpy(), b_pk)


@pytest.mark.parametrize("band", [30, 150])
def test_gather_kernel_source_matches_host_packing_on_phase_set(
        gather_emulated, band):
    arena, cols, a_pk, b_pk, _xw = phase_chunk(band)
    a_out, b_out = run_emulated(gather_emulated, arena, cols, band, a_pk,
                                b_pk)
    assert np.array_equal(a_out, a_pk) and np.array_equal(b_out, b_pk)


# (old text, new text): each breaks one step of the kernel's design
MUTATIONS = {
    "phase_off_by_one_nibble": ("(unsigned)i & 31u",
                                "((unsigned)i + 1u) & 31u"),
    "reverse_without_nibble_swap": (
        "return ((x >> 4) & 0x0F0F0F0Fu) | ((x & 0x0F0F0F0Fu) << 4);",
        "return x;"),
    "complement_every_code": ("~((x >> 2) | (x >> 3)) & 0x11111111u",
                              "0x11111111u"),
    "mask_one_nibble_long": ("low_nibbles(jh - 8 * k)",
                             "low_nibbles(jh + 1 - 8 * k)"),
}


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_gather_kernel_source_mutation_fails(tmp_path, mutation):
    """A kernel source with one step broken gives other bytes than the
    host's on the phase set, so the emulated test would catch it."""
    old, new = MUTATIONS[mutation]
    src = open(SOURCE).read()
    assert src.count(old) == 1
    fn = build_emulated(src.replace(old, new), tmp_path)
    band = 30
    arena, cols, a_pk, b_pk, _xw = phase_chunk(band)
    a_out, b_out = run_emulated(fn, arena, cols, band, a_pk, b_pk)
    assert not (np.array_equal(a_out, a_pk) and np.array_equal(b_out, b_pk))


def test_gather_rejects_widths_off_the_chunk():
    contigs, problems = tp.arena_problems(8)
    arena, cols, *_rest, xw = tp.arena_chunk(contigs, problems, 20)
    args = (torch.from_numpy(arena), torch.from_numpy(cols), 20)
    for aw, w in ((a_width(xw, 20) - 8, xw), (a_width(xw, 20), xw + 16)):
        with pytest.raises(ValueError, match="multiples of 32"):
            gather_windows(*args, aw, w)


def test_gather_shapes_and_device_check():
    contigs, problems = tp.arena_problems(8)
    arena, cols, *_rest, xw = tp.arena_chunk(contigs, problems, 20)
    got = gather_windows_torch(torch.from_numpy(arena),
                               torch.from_numpy(cols), 20, a_width(xw, 20),
                               xw)
    assert got[0].shape == (cols.shape[1], a_width(xw, 20) // 2)
    assert got[1].shape == (cols.shape[1], xw // 2)
    with pytest.raises(ValueError, match="unsupported device"):
        gather_windows(torch.from_numpy(arena).to("meta"),
                       torch.from_numpy(cols), 20, a_width(xw, 20), xw)


def test_resident_arena_matches_oracle():
    """tests/test_bsw_antidiag.py::test_resident_arena_matches_oracle on
    the port: forward and memoised reverse-complement orientations
    dispatch as arena columns and match the oracle exactly; an
    unregistered tail slice goes through the window upload in the same
    call."""
    rng = np.random.default_rng(91)
    eng = BswEngine(CPU, band=30, fetch="edits")
    c0 = rng.integers(0, 5, size=240).astype(np.uint8)
    c1 = tp.mutate(rng, c0)
    c2 = rng.integers(0, 4, size=180).astype(np.uint8)
    eng.register_contigs([c0, c1, c2])

    rc1 = fasta.reverse_complement(c1)
    assert fasta.reverse_complement(rc1) is c1  # memoized two-way
    tail = c0[60:].copy()                       # NOT registered

    problems = [
        (c0, 0, len(c0) - 1, c1, 0, len(c1) - 1, False, False),
        (c0, 0, len(c0) - 1, rc1, 0, len(rc1) - 1, False, False),
        (rc1, 0, len(rc1) - 1, c2, 0, len(c2) - 1, True, False),
        (c2, 0, len(c2) - 1, c0, 10, 200, False, True),
        (tail, 0, len(tail) - 1, c1, 0, len(c1) - 1, False, False),
    ]
    got = eng.align_many(problems)
    for k, (g, w) in enumerate(zip(got, tp.oracle(problems, 30))):
        assert tp.same_alignment(g, w), f"arena case {k}"
    assert eng._seq_lookup(rc1) is not None
    assert eng._seq_lookup(tail) is None
    assert (eng.arena_problems, eng.arena_chunks, eng.dispatches) == (4, 1, 2)


def test_resident_arena_lean_fetch():
    rng = np.random.default_rng(92)
    eng = BswEngine(CPU, band=30, fetch="lean")
    c0 = rng.integers(0, 4, size=300).astype(np.uint8)
    c1 = tp.mutate(rng, c0)
    eng.register_contigs([c0, c1])
    pr = (c0, 0, len(c0) - 1, fasta.reverse_complement(c1), 0, len(c1) - 1,
          False, False)
    want = tp.oracle([pr], 30)[0]
    g = eng.align_one(*pr)
    assert g.begin_a == want.begin_a and g.score == want.score
    assert g.length == want.length
    assert first_match_pos(g) == first_match_pos(want)
    assert last_match_pos(g) == last_match_pos(want)
    assert eng.arena_problems == 1


@pytest.mark.parametrize("kernel", ["antidiag", "row"])
def test_arena_soak_matches_oracle(kernel):
    """The arena soak through the engine on both forwards: the registered
    problems take the arena, the tails the upload, all equal to
    bsw_align; under the host traceback no problem takes the arena."""
    contigs, problems = tp.arena_problems(48, seed=5, max_len=260)
    want = tp.oracle(problems, 20)
    for fetch in ("edits", "lean"):
        eng = BswEngine(CPU, band=20, fetch=fetch, kernel=kernel)
        eng.register_contigs(contigs)
        got = eng.align_many(problems)
        for k, (g, w) in enumerate(zip(got, want)):
            assert tp.same_alignment(g, w), f"{fetch} {k}"
        assert 0 < eng.arena_problems < eng.util["live"]
    eng = BswEngine(CPU, band=20, traceback="host")
    eng.register_contigs(contigs)
    got = eng.align_many(problems)
    assert all(tp.same_alignment(g, w) for g, w in zip(got, want))
    assert eng.arena_problems == 0


def _registered_contigs():
    rng = np.random.default_rng(93)
    contigs = [rng.integers(0, 5, size=int(rng.integers(90, 230))).astype(
        np.uint8) for _ in range(4)]
    return contigs + [tp.mutate(rng, contigs[0])]


def _registered_problems(contigs, rc):
    """Problems over `contigs` only (rc: one package's reverse_complement,
    so each engine finds its own memoised arrays)."""
    problems = []
    for k in range(9):
        a = contigs[k % 5]
        b0 = contigs[(k + 2) % 5] if k % 3 else contigs[4 - k % 5]
        b = rc(b0) if k % 2 else b0
        if k == 4:
            a = rc(a)
        problems.append((a, (k * 7) % 40 - 10, len(a) - 1 - k, b, k,
                         len(b) + 5, k % 4 == 0, k % 3 == 0))
    return problems


def test_arena_engine_matches_jax_arena_engine():
    """The same registered problems through the JAX engine's arena
    (Pallas in interpret mode, device traceback) and the port's: equal
    results, every problem in the arena on both sides, and equal
    bytes_up: the packed arena once plus 12 int32 columns a problem row
    of each chunk."""
    contigs = _registered_contigs()
    problems = _registered_problems(contigs, fasta.reverse_complement)
    jax_problems = _registered_problems(contigs,
                                        jax_fasta.reverse_complement)
    jeng = JaxEngine(band=20, backend="pallas", traceback="device",
                     fetch="edits")
    jeng.register_contigs(contigs)
    want = jeng.align_many(jax_problems)
    eng = BswEngine(CPU, band=20, fetch="edits")
    eng.register_contigs(contigs)
    got = eng.align_many(problems)
    for k, (g, w) in enumerate(zip(got, want)):
        assert tp.same_alignment(g, w), f"problem {k}"
    assert all(jeng._seq_lookup(p[0]) and jeng._seq_lookup(p[3])
               for p in jax_problems)
    assert eng.arena_problems == eng.util["live"] > 0
    assert {k: eng.util[k] for k in jeng.util} == jeng.util
    assert eng.cells_aligned == jeng.cells_aligned
    assert eng.util["walk_iters"] == eng.util["walk_steps"] > 0
    arena_bytes = max(1 << 20, -(-sum(map(len, contigs)) // (1 << 20))
                      << 20) // 2
    assert eng.bytes_up == jeng.bytes_up == \
        arena_bytes + 12 * 4 * eng.util["batch"]


@pytest.mark.parametrize("corpus", ["junction", "fork_bubble"])
def test_merge_under_arena_matches_default(tmp_path, monkeypatch, corpus):
    """A whole merge under GAM_ARENA=1 writes the default merge's six
    outputs byte for byte; no problem with both sequences registered
    goes through the window upload."""
    if corpus == "junction":
        _genome, ml, sl, mfa, sfa = tp.junction_corpus(tmp_path)
    else:
        ml, sl, mfa, sfa = tp.fork_bubble_corpus(tmp_path)
    run_create(CreateOptions(master_bam_file=ml, slave_bam_file=sl,
                             min_block_size=10,
                             output_file_prefix=str(tmp_path / "out"),
                             engine="native"), log=quiet)
    common = dict(master_bam_file=ml, slave_bam_file=sl,
                  blocks_file=str(tmp_path / "out.blocks"),
                  master_fasta_file=mfa, slave_fasta_file=sfa,
                  min_block_size=10)
    run_merge(MergeOptions(output_file_prefix=str(tmp_path / "default"),
                           engine=BswEngine(CPU), **common), log=quiet)
    eng = BswEngine(CPU)
    uploaded = []
    pack = eng._pack_chunk

    def spy(chunk, preps, xw):
        uploaded.extend(preps[i] for i in chunk)
        return pack(chunk, preps, xw)

    monkeypatch.setattr(eng, "_pack_chunk", spy)
    monkeypatch.setenv("GAM_ARENA", "1")
    run_merge(MergeOptions(output_file_prefix=str(tmp_path / "arena"),
                           engine=eng, **common), log=quiet)
    for ext in OUTPUTS:
        assert (tmp_path / f"arena{ext}").read_bytes() == \
            (tmp_path / f"default{ext}").read_bytes(), ext
    assert eng.arena_problems > 0 and eng._seq_map
    assert not [p for p in uploaded
                if p.a_arena is not None and p.b_arena is not None]
