"""Smoke run of gam_ngs_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py [--phases header,build,parity,small,full,create,dist,
                                    mesh,timing]

Phases (all by default; any failure raises and exits non-zero):
  header  card name and power limit (nvidia-smi), torch / CUDA / nvcc
  build   nvcc build of gam_ngs_tpu_torch/csrc/*.cu for sm_90a (one nvcc
          per source, in parallel), with ptxas' register and spill lines
          (and one line of the row forward's W-warp and cluster
          instances), and the most clusters of each row instance the
          card runs at once (cudaOccupancyMaxActiveClusters)
  parity  each kernel against its plain PyTorch version on the card,
          bit for bit (256-problem soak at band 150, the anti-diagonal
          forward's split instance, and the soak tiled to the least batch
          at which it takes one warp a problem, band-30 edge cases,
          band 300, ragged buckets of x_size 1 to the window at bands 30
          and 300, find-max ties at bands 30 and 150, band 700 with four
          warps per problem (the row forward: sixteen warps of three
          lanes), bands 2000 and 4000 with clusters of two and eight
          blocks, row forward only): the anti-diagonal forward with the
          walk over its words, the row forward with the walk over
          row-major words (from band 1024 on its 3-row ring); the row
          forward and its walk at the first and last band of each of
          its instances, one warp
          a problem up to band 159, four, eight or sixteen warps up to
          767, clusters of two blocks of eight or sixteen warps up to
          2047 and of eight blocks of eight up to 4095 (15, 16,
          31, 32, ..., 159, 160, 191, 192, 255, 256, 319, 320, 383, 384,
          511, 512, 639, 640, 767, 768, 1023, 1024, 1535, 1536, 2047,
          2048, 3071, 3072, 4095; tests/torch_problems.py::
          boundary_problems); and
          the CUDA
          engine against the exact host
          aligner (merge --device oracle's bsw_align) on every soak
          problem: anti-diagonal in lean and edits fetch, kernel="row"
          in lean and edits fetch, and the host traceback, then
          kernel="row" at band 700 and the host traceback at band 2000;
          the arena gather (csrc/arena_gather.cu) against its plain
          version and the host's packed windows, bit for bit, on a
          256-problem soak registered as a sequence arena at bands 30
          and 150 (tests/torch_problems.py::arena_problems: forward and
          reverse-complement orientations, unregistered tail slices,
          begin_a < band, windows past a contig's end, N runs, odd
          offsets) and on tests/torch_problems.py::arena_phase_problems
          at the same bands (every nibble phase of each window's start
          in both orientations, both clips, windows that reach the last
          code of a 2^20-code arena); the arena engine against the
          oracle on the soak,
          both forwards in lean and edits fetch; the engine over
          (cuda:0, cuda:0) against the one-device engine and the oracle
          on all three paths
  small   gam create + gam merge through the port's CLI on the small
          junction corpus and a fork + bubble corpus: create --device
          cuda and --device auto (the device block join) write create
          --device native's .blocks and both .isize files byte for
          byte; the six outputs of
          merge --device cuda, of merge --device cuda under GAM_KERNEL=row
          and of run_merge with a traceback="host" engine, each
          byte-identical to merge --device oracle
  full    a 5 Mbp synthetic corpus (bench/e2e_scale.py's layout): gam
          create --device native, then --device cuda (the same .blocks
          and .isize bytes; each engine's load_reads and find_blocks
          seconds, the join and analysis launches read after setting
          them to 0 just before it), then three merges on the card, each
          with exact genome reconstruction and the launch counts of its
          path read after setting them to 0 just before it: merge
          --device cuda (anti-diagonal forward + walk, and the edge
          count), the same under GAM_KERNEL=row (row forward + walk),
          and run_merge with a traceback="host" engine (row forward,
          host walk), whose six outputs must equal the first's byte for
          byte.  Each kernel against its plain version, bit for
          bit, on the inputs the merges gave it (the anti-diagonal
          path's first chunk of every batch x window shape, the row
          path's 8-problem chunk); warm merges of the anti-diagonal path
          (one; one under GAM_RESIDENT=0, whose row-payload edge count
          must give the same six outputs, its partition seconds beside
          the resident count's and its count timed on its own inputs;
          then the engine's stream pool against one stream, in turns),
          one under torch.profiler (device time per kernel and device
          busy time) of the anti-diagonal path, and one profiled merge
          of the row path.  Before the warm merges: the merge under
          GAM_ARENA=1 (the arena path, launch counts set to 0 just
          before it: the gather, the anti-diagonal forward and the walk)
          with the default path's six outputs, the gather against its
          plain version on that merge's first arena chunk, then the
          arena and the window uploads in turns, four merges each (align
          seconds, align_bytes_wire, the arena's share of problems and
          chunks, gather launches); and the merge with the engine and
          the edge count over every GPU the process sees, or over
          (cuda:0, cuda:0) on one card (the six outputs, the shards
          each device ran, how many distinct GPUs); then the merge at
          bands 300, 511 and 1023 through BswEngine(band=b,
          kernel="row") (the row forward's four and eight warps a
          problem, and a cluster of two blocks of eight) and through the
          anti-diagonal engine at that band, launch counts set to 0 just
          before each and read just after, their six outputs
          byte-identical, and (bands 511 and 1023) the row kernel and
          its walk against their plain versions on the row merge's
          smallest chunk; last the merge at band 4095 through
          BswEngine(band=4095, kernel="row") (the row forward's clusters
          of eight blocks, the device walk on its 3-row ring) and with
          traceback="host" (the C++ walk), launch counts set to 0 just
          before each and read just after (bsw_walk launched by the
          first only), six outputs byte-identical, and the walk kernel
          against its plain version over the kernel forward's words on
          the device merge's smallest chunk
  create  the device block join at real size: the 5 Mbp layout with a
          pair every 2 bp (tests/torch_problems.py::scale_columns, ~5 M
          rows a side, 50x coverage), find_blocks_device on the card
          against the native scan column for column; the walls of both,
          and the CUDA-event medians of join_device, analyze_device and
          the insert-size moments (isize_stats_psum) beside their bounds
          (the bytes each
          reads and writes over the memory rate)
  dist    the multi-process create and merge: two ranks of `python -m
          gam_ngs_tpu_torch.cli create --coordinator 127.0.0.1:<port>
          --device cuda` on the junction corpus and on the 5 Mbp genome
          split into 25 graphs write host 0's .blocks byte for byte as the
          one-process native create and .isize values within the
          moment sums' rounding, every rank with slave rows launches the
          join (each rank's wall and peak RSS); then the junction corpus,
          the full phase's 5 Mbp corpus (one graph) and the split corpus,
          each merged by one child process and by two ranks of `python -m
          gam_ngs_tpu_torch.cli merge --coordinator 127.0.0.1:<port>
          --device cuda` sharing the card: host 0's six outputs equal the
          one process's, the ranks' aligned cells sum to its count, a
          rank that aligned launched the forward and the walk (both
          ranks on the split corpus); each rank's cells, launches, align
          seconds and peak RSS, and both walls
  mesh    the sharded pipeline step and its dry-run (parallel/mesh.py,
          parallel/step.py, entry.py): dryrun_step over every GPU and
          over four shards of cuda:0 (statistics = numpy, total_best > 0,
          the sharded engine = bsw_align), entry.dryrun_multichip over the
          four shards (the device join, the sharded edge count, and
          distributed_build_pctgs on the default engine and on the row
          forward with the host traceback, each giving back the genome),
          with the launch counts set to 0 just before and read just
          after; entry()'s forward on the card = its plain version on
          the CPU, bit for bit; then the step at full width over four
          shards of the card (B=64, XW 32768, band 150, 5,000,000 reads
          of 2 libraries): each shard's dirs, last row and diagonal = one
          unsharded forward_antidiag call, bit for bit, the statistics
          and total_best = numpy exactly; CUDA-event medians of 5 of the
          whole step and of its statistics beside their bound and one
          torch.bincount triple, and the peak memory of a shard and of
          the step
  timing  each kernel with CUDA events (median of 5 after a warm-up)
          beside one call of its plain version, outputs compared bit for
          bit, and the walks over the two forwards' words compared with
          each other: B=64, band 150, XW 1024 / 4096; ms, GCUPS, the
          bound and ns per serial step (the longest problem's steps);
          then the row forward at bands 160, 255, 300, 383, 511, 512,
          700, 1023, 2000 and 4095, XW 4096, and at band 150 on one 5 Mbp
          chunk's shape (XW 32768, x_size 25000), each with ns a row,
          bound, multiple and its instance (C, W, R); the walk over the
          row forward's words at bands 1023 (16-row ring), 1024, 2047
          and 4095 (3-row ring), XW 4096 (20 calls queued behind a
          sleep), with ns a step, bound, multiple, its find-max alone,
          its ring and the word rows the walks crossed; the arena
          gather on that chunk shape and at XW 4096 (B=64; 20 calls
          queued behind a sleep, as its launch outlasts it), its bound
          and multiple, the host microseconds of a call (median of 50),
          its plain version, the host packing + upload it replaces, and
          its ptxas registers and spills

Imports nothing of JAX and nothing of gam_ngs_tpu: the corpora come from
tests/torch_problems.py, the rest from the port.

The kernels' line is printed before the card's line and the last line,
which is {"ok": true, "device": {...}}.  Without a CUDA device the script
exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import re
import resource
import socket
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_problems as tp  # noqa: E402
from gam_ngs_tpu_torch import _build, cli, entry  # noqa: E402
from gam_ngs_tpu_torch.core.stats import isize_stats_psum  # noqa: E402
from gam_ngs_tpu_torch.io import bamlist  # noqa: E402
from gam_ngs_tpu_torch.io import isize as isize_io  # noqa: E402
from gam_ngs_tpu_torch.native.loader import find_blocks_native  # noqa: E402
from gam_ngs_tpu_torch.models.merge import (  # noqa: E402
    MergeOptions,
    run_merge,
)
from gam_ngs_tpu_torch.ops import (  # noqa: E402
    arena_gather,
    bsw_antidiag,
    bsw_engine,
    bsw_row,
    bsw_walk,
    device_join,
    region_score,
)
from gam_ngs_tpu_torch.ops.arena_gather import (  # noqa: E402
    gather_windows,
    gather_windows_torch,
)
from gam_ngs_tpu_torch.ops.bsw_antidiag import (  # noqa: E402
    MAX_BAND as ANTIDIAG_MAX_BAND,
    a_width,
    forward_antidiag,
    forward_antidiag_torch,
)
from gam_ngs_tpu_torch.ops.bsw_engine import BswEngine  # noqa: E402
from gam_ngs_tpu_torch.ops.bsw_host import _prepare  # noqa: E402
from gam_ngs_tpu_torch.ops.bsw_row import (  # noqa: E402
    MAX_BAND,
    forward_row,
    forward_row_torch,
    instance_info,
    row_instance,
)
from gam_ngs_tpu_torch.ops.bsw_walk import (  # noqa: E402
    ANSWER_ROWS,
    ANTIDIAG,
    ITERS,
    ROW,
    WIDE_RING_BAND,
    ring_info,
    walk,
    walk_torch,
)
from gam_ngs_tpu_torch.parallel.mesh import device_mesh  # noqa: E402
from gam_ngs_tpu_torch.parallel.step import (  # noqa: E402
    dryrun_step,
    library_moments,
    make_pipeline_step,
)

PHASES = ("header", "build", "parity", "small", "full", "create", "dist",
          "mesh", "timing")
OUTPUTS = (".gam.fasta", ".pctgs", ".stats", ".noblocks.BF.fasta",
           ".noblocks.AF.fasta", ".notmerged.fasta")
DEV = torch.device("cuda")
# forward kernel name -> (wrapper, plain version, layout of its words)
FORWARDS = {"bsw_antidiag": (forward_antidiag, forward_antidiag_torch,
                             ANTIDIAG),
            "bsw_row": (forward_row, forward_row_torch, ROW)}
KERNELS = ("bsw_antidiag", "bsw_walk", "bsw_walk_wide", "bsw_row",
           "bsw_row_warps", "bsw_row_cluster", "arena_gather")
# int32 operations the function needs, counted from the recurrence and
# not from either kernel's scheme, so both forwards share one figure.
# One band cell of bsw_ref.fill_matrix: its position (1), range test (2),
# a's code from its 4-bit pack (2; b's is one per row), the score (2),
# diag/up/left (3), their max (2), the direction (3) and packing it into
# its word (2).  One step of bsw_ref.traceback over the 2-bit words: the
# word's address (3) and field (4), the two codes from their packs (6),
# the match test (5), the counters (2), the move (4), the new position
# (2) and the loop test (5).  Find-max: 8 per candidate, 2*YS candidates
# per problem.
OPS_PER_CELL = 17
OPS_PER_WALK_STEP, OPS_PER_CANDIDATE = 31, 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM


def log(msg: str) -> None:
    print(msg, flush=True)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(
    ).splitlines()[0]


def int32_ops_per_s() -> float:
    """132 SMs x 64 int32 lanes x the card's maximum SM clock."""
    mhz = float(smi("clocks.max.sm").split()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count \
        * 64 * mhz * 1e6


def to_dev(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(DEV) for a in arrs]


def lmax_of(xw: int, band: int) -> int:
    return -(-(2 * xw + 2 * band + 8) // 4) * 4


def timed_once(ms: dict, name: str, fn):
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    ms[name] = e0.elapsed_time(e1)
    return out


def kernel_vs_plain(name, fargs, fe, lmax, with_edits, plain_fwd=True):
    """A forward kernel against its plain version on one chunk's inputs
    (fargs = the forward's arguments: a, b, begin_a, end_a, a_len,
    x_size, force_start, band; not plain_fwd: the kernel alone) and,
    unless fe is None, the walk over its words against the walk's plain
    version; both walks read the kernel's forward output.  Returns
    ({kernel: max|kernel - plain|}, {name: ms of the one call})."""
    kern, plain, layout = FORWARDS[name]
    a, b, ba, ea, _al, xs, _fs, band = fargs
    ms: dict = {}
    fk = timed_once(ms, name, lambda: kern(*fargs))
    errs = {}
    if plain_fwd:
        fp = timed_once(ms, name + "_plain", lambda: plain(*fargs))
        errs[name] = max_err(fk, fp)
    if fe is not None:
        wargs = (fk[0], a, b, ba, ea, xs, fe, fk[1], fk[2], band, lmax,
                 with_edits)
        wk = timed_once(ms, "bsw_walk", lambda: walk(*wargs, layout=layout))
        wp = timed_once(ms, "bsw_walk_plain",
                        lambda: walk_torch(*wargs, layout=layout))
        errs[walk_name(band, layout)] = walk_err(wk, wp)
    return errs, ms


def walk_name(band: int, layout: int) -> str:
    """The kernels line's name of the walk: bsw_walk_wide for the row
    form's words from band WIDE_RING_BAND on (the 3-row ring), else
    bsw_walk."""
    return ("bsw_walk_wide" if layout == ROW and band >= WIDE_RING_BAND
            else "bsw_walk")


def row_name(band: int) -> str:
    """The kernels line's name of the row forward at `band`, by the
    instance the launcher picks (ops/bsw_row.py::row_instance):
    bsw_row_cluster for a cluster of C > 1 blocks (bands 768-4095),
    bsw_row_warps for several warps in one block (160-767), else bsw_row
    (one warp)."""
    c, w, _r = row_instance(band)
    return ("bsw_row_cluster" if c > 1 else
            "bsw_row_warps" if w > 1 else "bsw_row")


def packed_inputs(problems, band):
    """One packed bucket on the card: (forward args, force_end, xw)."""
    a_pk, b_pk, scal, _preps, xw = tp.pack_problems(problems, band)
    a, b, s = to_dev(a_pk, b_pk, scal)
    ba, ea, al, xs, fs, fe = s.unbind(0)
    return (a, b, ba, ea, al, xs, fs, band), fe, xw


def max_err(xs, ys) -> int:
    err = 0
    for x, y in zip(xs, ys):
        if x is None and y is None:
            continue
        if x.shape != y.shape:
            raise AssertionError(f"shape {tuple(x.shape)} != {tuple(y.shape)}")
        err = max(err, int((x.long() - y.long()).abs().max().item())
                  if x.numel() else 0)
    return err


def walk_err(got, want) -> int:
    """max|kernel - plain| of two walks' answers: the summary's answer
    rows and the edit codes.  Raises where got's iterations exceed its
    steps, or are none where it stepped."""
    iters, cnt = got[0][ITERS], got[0][2]
    if bool((iters > cnt).any()) or bool(((iters > 0) != (cnt > 0)).any()):
        raise AssertionError("walk iterations outside 1 .. its steps")
    return max_err((got[0][:ANSWER_ROWS], got[1]),
                   (want[0][:ANSWER_ROWS], want[1]))


def note_err(res, label, errs: dict) -> None:
    log(f"{label}: " + ", ".join(f"{k} max|kernel-plain| {v}"
                                 for k, v in errs.items()))
    if any(errs.values()):
        raise AssertionError(f"{label}: kernel != plain version")
    err = res.setdefault("max_abs_err", dict.fromkeys(KERNELS, 0))
    for k, v in errs.items():
        err[k] = max(err[k], v)


def check_engine(problems, want, label, contigs=None, devices=DEV,
                 **kw) -> list:
    """The CUDA engine (on `devices`; with `contigs` registered as its
    sequence arena) against the oracle's results; the kernels its path
    runs, and no other, must launch.  Returns its results."""
    eng = BswEngine(devices, **kw)
    if contigs is not None:
        eng.register_contigs(contigs)
    n0 = BswEngine.kernel_launches()
    got = eng.align_many(problems)
    torch.cuda.synchronize()
    n1 = BswEngine.kernel_launches()
    bad = [i for i, (g, w) in enumerate(zip(got, want))
           if not tp.same_alignment(g, w)]
    used = {k: n1[k] - n0[k] for k in n1}
    arena = (f", {eng.arena_problems} problems in {eng.arena_chunks} "
             f"arena chunks" if contigs is not None else "")
    log(f"[parity] engine {label}: {len(problems) - len(bad)}/"
        f"{len(problems)} equal to the oracle (bsw_align) "
        f"({eng.dispatches} dispatches{arena}, shards a device "
        f"{eng.shard_runs}, launches {used})")
    if bad:
        raise AssertionError(f"engine {label} differs on {bad[:10]}")
    row = eng.kernel == "row" or eng.traceback == "host"
    want_used = {"arena_gather": contigs is not None,
                 "bsw_antidiag": not row, "bsw_row": row,
                 "bsw_walk": eng.traceback == "device"}
    if {k: v > 0 for k, v in used.items()} != want_used:
        raise AssertionError(f"engine {label}: launches {used}")
    if contigs is not None and not (
            0 < eng.arena_problems < eng.util["live"]
            and used["arena_gather"] == eng.arena_chunks):
        raise AssertionError(f"engine {label}: {eng.arena_problems} arena "
                             f"problems of {eng.util['live']}, "
                             f"{eng.arena_chunks} arena chunks, "
                             f"launches {used}")
    return got


def gather_inputs(problems, contigs, band):
    """The arena soak's registered problems as the gather's card inputs
    (arena, cols, band, aw, xw) and the host's packed windows."""
    arena, cols, a_pk, b_pk, xw = tp.arena_chunk(contigs, problems, band)
    args = (*to_dev(arena, cols), band, a_width(xw, band), xw)
    return args, (a_pk, b_pk)


def gather_vs_plain(res, args, host, label) -> None:
    """The gather kernel against its plain version on the same card
    inputs and, where given, the host's _pack_chunk + _pack4 bytes."""
    got = gather_windows(*args)
    plain = gather_windows_torch(*args)
    errs = {"arena_gather": max_err(got, plain)}
    if host is not None and not all(
            np.array_equal(g.cpu().numpy(), h) for g, h in zip(got, host)):
        raise AssertionError(f"{label}: the gather's windows differ from "
                             f"the host's packed windows")
    note_err(res, f"{label} arena_gather (B={args[1].shape[1]}, "
             f"XW={args[4]}){'' if host is None else ' = host packing'}",
             errs)


def phase_arena_parity(res):
    """The gather kernel on the arena soak at bands 30 and 150 (forward and
    reverse-complement orientations, unregistered tail slices, begin_a <
    band, windows past a contig's end, N runs, odd offsets) and on the
    phase set at the same bands (every nibble phase of each window's
    start in both orientations, both clips, windows that reach the last
    code of a 2^20-code arena), then the arena engine and the engine
    over two shards of one card."""
    for band in (30, 150):
        contigs, problems = tp.arena_problems(256)
        args, host = gather_inputs(problems, contigs, band)
        gather_vs_plain(res, args, host, f"[parity] arena soak band={band}")
        contigs, problems = tp.arena_phase_problems(band)
        args, host = gather_inputs(problems, contigs, band)
        gather_vs_plain(res, args, host,
                        f"[parity] arena phase set band={band}")
    contigs, problems = tp.arena_problems(256)
    want = tp.oracle(problems, 150)
    for kernel in ("antidiag", "row"):
        for fetch in ("lean", "edits"):
            check_engine(problems, want, f"arena {kernel} fetch={fetch}",
                         contigs=contigs, fetch=fetch, kernel=kernel)
    problems = tp.soak_problems(256)
    want = tp.oracle(problems, 150)
    two = (torch.device("cuda", 0),) * 2
    for label, kw in (("antidiag", {"kernel": "antidiag"}),
                      ("row", {"kernel": "row"}),
                      ("host traceback", {"traceback": "host"})):
        one = check_engine(problems, want, f"{label} one device",
                           fetch="edits", **kw)
        got = check_engine(problems, want, f"{label} over (cuda:0, cuda:0)",
                           devices=two, fetch="edits", **kw)
        if not all(tp.same_alignment(g, w) for g, w in zip(got, one)):
            raise AssertionError(f"{label}: two shards != one device")


def one_warp_batch(band: int) -> int:
    """The least batch at which the anti-diagonal forward's launcher takes
    one warp a problem at `band` (below 160) on this card."""
    return next(B for B in range(1, 1 << 16)
                if bsw_antidiag.instance(band, B)[0] == 1)


def phase_parity(res):
    soak = tp.soak_problems(256)
    big = one_warp_batch(150)
    sets = [("soak256_band150", soak, 150),
            (f"soak{big}_band150", (soak * -(-big // 256))[:big], 150),
            ("edges_band30", tp.edge_problems(), 30),
            ("soak32_band300", tp.soak_problems(32, seed=7, max_len=700),
             300),
            ("ragged_band30", tp.ragged_problems(30), 30),
            ("ragged_band300", tp.ragged_problems(300), 300),
            ("ties_band30", tp.tie_problems(), 30),
            ("ties_band150", tp.tie_problems(), 150),
            ("soak8_band700", tp.soak_problems(8, seed=3, max_len=600), 700),
            ("soak4_band2000", tp.soak_problems(4, seed=9, max_len=400),
             2000),
            ("soak4_band4000", tp.soak_problems(4, seed=4, max_len=300),
             4000)]
    for name, problems, band in sets:
        fargs, fe, xw = packed_inputs(problems, band)
        for fwd in FORWARDS:
            if fwd == "bsw_antidiag" and band > ANTIDIAG_MAX_BAND:
                continue
            for with_edits in (False, True):
                errs, _ms = kernel_vs_plain(fwd, fargs, fe,
                                            lmax_of(xw, band), with_edits)
                note_err(res, f"[parity] {name} {fwd} edits={with_edits}",
                         errs)
    # the row forward at the first and last band of each of its
    # instances, and the walk over its words (its 3-row ring from band
    # WIDE_RING_BAND on)
    for band in tp.row_boundary_bands():
        fargs, fe, xw = packed_inputs(tp.boundary_problems(band), band)
        errs, _ms = kernel_vs_plain("bsw_row", fargs, fe,
                                    lmax_of(xw, band), True)
        errs[row_name(band)] = errs.pop("bsw_row")
        note_err(res, f"[parity] bounds_band{band} bsw_row edits=True", errs)
    problems = sets[0][1]
    want = tp.oracle(problems, 150)
    for fetch in ("lean", "edits"):
        check_engine(problems, want, f"antidiag fetch={fetch}", fetch=fetch,
                     kernel="antidiag")
        check_engine(problems, want, f"row fetch={fetch}", fetch=fetch,
                     kernel="row")
    check_engine(problems, want, "row traceback=host", traceback="host")
    # the row forward's wide instances inside the engine
    for band, kw, seed, max_len in ((700, {"kernel": "row"}, 3, 1600),
                                    (2000, {"traceback": "host"}, 9, 400)):
        problems = tp.soak_problems(6, seed=seed, max_len=max_len)
        check_engine(problems, tp.oracle(problems, band),
                     f"band={band} {kw}", band=band, **kw)
    phase_arena_parity(res)


def run_cli(argv) -> None:
    rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"gam {' '.join(argv)} exited {rc}")


def merge_argv(ml, sl, mfa, sfa, blocks, out, device):
    return ["merge", "--master-bam", ml, "--slave-bam", sl,
            "--blocks-file", blocks, "--master-fasta", mfa,
            "--slave-fasta", sfa, "--min-block-size", "10",
            "--output", out, "--device", device]


def merge_path(path, ml, sl, mfa, sfa, blocks, out) -> None:
    """One merge on the card down one path: "antidiag" and "row" through
    the CLI (--device cuda, "row" under GAM_KERNEL=row), "host" through
    run_merge with a traceback="host" engine (no CLI flag reaches it)."""
    if path == "host":
        run_merge(MergeOptions(
            master_bam_file=ml, slave_bam_file=sl, blocks_file=blocks,
            master_fasta_file=mfa, slave_fasta_file=sfa, min_block_size=10,
            output_file_prefix=out,
            engine=BswEngine(DEV, traceback="host")))
        return
    old = os.environ.pop("GAM_KERNEL", None)
    if path == "row":
        os.environ["GAM_KERNEL"] = "row"
    try:
        run_cli(merge_argv(ml, sl, mfa, sfa, blocks, out, "cuda"))
    finally:
        os.environ.pop("GAM_KERNEL", None)
        if old is not None:
            os.environ["GAM_KERNEL"] = old


def create_argv(ml, sl, out, device):
    return ["create", "--master-bam", ml, "--slave-bam", sl,
            "--min-block-size", "10", "--output", out, "--device", device]


def create_files(ml, sl, out) -> list[bytes]:
    return [pathlib.Path(p).read_bytes()
            for p in (out + ".blocks", ml + ".isize", sl + ".isize")]


def create_matches_native(d, ml, sl, out, device, label) -> dict:
    """gam create --device native into d/<out>, then --device <device>
    (the device join) into d/<device>, through the CLI in this process;
    the .blocks and both .isize files must be byte-identical (the native
    run's are left in place).  The join and analysis launch counts are
    set to 0 just before the device create and read just after it.
    Returns {engine: (wall s, .metrics.json)} and the launches."""
    runs = {}
    for engine, prefix in (("native", out), (device, device)):
        if engine == device:
            device_join.launches.update(join=0, analyze=0)
        t0 = time.time()
        run_cli(create_argv(ml, sl, str(d / prefix), engine))
        torch.cuda.synchronize()
        runs[engine] = (time.time() - t0, json.load(
            open(d / f"{prefix}.metrics.json")),
            create_files(ml, sl, str(d / prefix)))
    launches = dict(device_join.launches)
    if runs[device][2] != runs["native"][2]:
        raise AssertionError(f"{label}: create --device {device} wrote "
                             f"other .blocks/.isize bytes than native")
    if launches != {"join": 1, "analyze": 1}:
        raise AssertionError(f"{label}: create --device {device}: join / "
                             f"analysis launches {launches}")
    return {"runs": {k: v[:2] for k, v in runs.items()},
            "launches": launches}


def phase_small(tmp):
    for name in ("junction", "fork_bubble"):
        d = pathlib.Path(tmp) / name
        d.mkdir()
        if name == "junction":
            genome, ml, sl, mfa, sfa = tp.junction_corpus(d)
        else:
            genome = None  # the fork's slave misjoin reconstructs no genome
            ml, sl, mfa, sfa = tp.fork_bubble_corpus(d)
        for device in ("cuda", "auto"):
            create_matches_native(d, ml, sl, "out", device, name)
        blocks = str(d / "out.blocks")
        run_cli(merge_argv(ml, sl, mfa, sfa, blocks, str(d / "oracle"),
                           "oracle"))
        for path in ("antidiag", "row", "host"):
            merge_path(path, ml, sl, mfa, sfa, blocks, str(d / path))
            for ext in OUTPUTS:
                a = (d / f"{path}{ext}").read_bytes()
                b = (d / f"oracle{ext}").read_bytes()
                if a != b:
                    raise AssertionError(f"{name}: {path}{ext} != "
                                         f"oracle{ext}")
        if genome is None:
            stats = (d / "row.stats").read_text()
            if "Forks = 1\nBubbles = 1\n" not in stats:
                raise AssertionError(f"{name}: not one fork and one bubble")
        elif tp.read_fasta_seqs(str(d / "row.gam.fasta")) != [genome]:
            raise AssertionError(f"{name}: genome not reconstructed")
        log(f"[small] {name}: create --device cuda and --device auto = "
            f"--device native (.blocks, both .isize), each launching the "
            f"join and the analysis; six outputs byte-identical to the "
            f"oracle's for merge --device cuda, GAM_KERNEL=row and the host "
            f"traceback" + (", genome reconstructed" if genome else
                            ", one fork and one bubble graph"))


class KeepChunkInputs:
    """Wraps the engine's kernel calls during one merge and keeps the
    inputs of the first chunk of every (forward, batch, window) shape, so
    the kernels can be held against their plain versions at the shapes
    the main path gives them.  The wrapped calls run unchanged (and
    count their launches as usual)."""

    NAMES = {"forward_antidiag": "bsw_antidiag", "forward_row": "bsw_row"}

    def __init__(self):
        self.kept: dict[tuple, dict] = {}
        self._orig = {n: getattr(bsw_engine, n)
                      for n in (*self.NAMES, "walk")}
        self._last = None

    def __enter__(self):
        def keep(attr):
            fn = self._orig[attr]

            def forward(*args):
                key = (self.NAMES[attr], tuple(args[0].shape),
                       tuple(args[1].shape))
                self._last = key
                if key not in self.kept:
                    self.kept[key] = {"fargs": tuple(
                        v.clone() if torch.is_tensor(v) else v
                        for v in args)}
                return fn(*args)
            return forward

        def wlk(*args, **kw):
            self.kept[self._last].setdefault(
                "walk", (args[6].clone(), args[10], kw["with_edits"]))
            return self._orig["walk"](*args, **kw)

        for attr in self.NAMES:
            setattr(bsw_engine, attr, keep(attr))
        bsw_engine.walk = wlk
        return self

    def __exit__(self, *exc):
        for attr, fn in self._orig.items():
            setattr(bsw_engine, attr, fn)


def device_ms_by_kernel(prof) -> dict[str, tuple[float, int]]:
    """Device time (ms) and count of every kernel and copy in a
    torch.profiler trace, by name."""
    out: dict[str, tuple[float, int]] = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms, n = out.get(e.key, (0.0, 0))
        out[e.key] = (ms + e.self_device_time_total / 1e3, n + e.count)
    return out


def device_busy_ms(prof) -> float:
    """Time (ms) in which at least one kernel or copy ran on the card:
    the union of the trace's device intervals (streams overlap)."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def reset_launches() -> None:
    bsw_antidiag.launches = bsw_row.launches = bsw_walk.launches = 0
    arena_gather.launches = 0


def phase_full(tmp, res):
    d = pathlib.Path(tmp) / "full"
    d.mkdir()
    t0 = time.time()
    c = tp.scale_corpus(5.0, d)
    log(f"[full] corpus 5.0 Mbp built in {time.time() - t0:.1f} s")
    cr = create_matches_native(d, c["ml"], c["sl"], "out", "cuda", "5 Mbp")
    for engine, (wall, m) in cr["runs"].items():
        log(f"[full] create --device {engine}: wall {wall:.4f} s, "
            f"load_reads {m['phases']['load_reads']:.4f} s, find_blocks "
            f"{m['phases']['find_blocks']:.4f} s, blocks "
            f"{m['counters']['blocks']}")
    log(f"[full] create --device cuda: .blocks and both .isize files "
        f"byte-identical to --device native's; launches {cr['launches']}")
    blocks = f"{d}/out.blocks"
    res["full_corpus"] = (d, c)

    def merge(path, prefix):
        t0 = time.time()
        merge_path(path, c["ml"], c["sl"], c["mfa"], c["sfa"], blocks,
                   f"{d}/{prefix}")
        torch.cuda.synchronize()
        wall = time.time() - t0
        return wall, json.load(open(f"{d}/{prefix}.metrics.json"))

    # each path once, its launch counts set to 0 just before and read
    # just after it
    expect = {"antidiag": {"arena_gather": False, "bsw_antidiag": True,
                           "bsw_row": False, "bsw_walk": True},
              "row": {"arena_gather": False, "bsw_antidiag": False,
                      "bsw_row": True, "bsw_walk": True},
              "host": {"arena_gather": False, "bsw_antidiag": False,
                       "bsw_row": True, "bsw_walk": False}}
    keep = KeepChunkInputs()
    res["launches"] = {}
    for path in ("antidiag", "row", "host"):
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        disp0 = region_score.WIRE["dispatches"]
        with keep:
            t_merge, m = merge(path, path)
        launches = BswEngine.kernel_launches()
        region_disp = region_score.WIRE["dispatches"] - disp0
        res["launches"][path] = launches
        merged = sorted(tp.read_fasta_seqs(f"{d}/{path}.gam.fasta"),
                        key=len, reverse=True)
        if not merged or merged[0] != c["genome"]:
            raise AssertionError(f"5 Mbp {path}: the longest merged contig "
                                 f"is not the genome")
        if {k: v > 0 for k, v in launches.items()} != expect[path] \
                or region_disp < 1:
            raise AssertionError(f"5 Mbp {path}: kernel launches "
                                 f"{launches}, edge count dispatches "
                                 f"{region_disp}")
        cells = m["counters"]["aligned_cells"]
        log(f"[full] {path}: merge {t_merge:.2f} s, {len(merged)} contigs, "
            f"genome reconstructed exactly")
        log(f"[full] {path}: merge phases (s): "
            f"{json.dumps(m['phases'], sort_keys=True)}")
        log(f"[full] {path}: aligned_cells {cells}, align "
            f"{m['phases']['align']:.4f} s -> "
            f"{cells / m['phases']['align']:.4g} cells/s, align_dispatches "
            f"{m['counters']['align_dispatches']}, row_fill_pct "
            f"{m['counters'].get('row_fill_pct')}, batch_fill_pct "
            f"{m['counters'].get('batch_fill_pct')}")
        log(f"[full] {path}: launches {launches}, edge-count dispatches "
            f"{region_disp}, max RSS "
            f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024}"
            f" MiB, max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    for ext in OUTPUTS:
        ref = (d / f"antidiag{ext}").read_bytes()
        for path in ("row", "host"):
            if (d / f"{path}{ext}").read_bytes() != ref:
                raise AssertionError(f"5 Mbp: {path} wrote another {ext}")
    log("[full] GAM_KERNEL=row and the host traceback: six outputs "
        "byte-identical to the default path's")
    want = (d / "antidiag.gam.fasta").read_bytes()
    arena_merges(d, c, blocks, res)
    sharded_merge(d, c, blocks)
    wide_band_merges(d, c, blocks, res)

    # the kernels against their plain versions on the merges' own chunks:
    # every shape of the anti-diagonal path, the row path's smallest batch
    # (its plain version costs tens of seconds at XW 32768)
    row_keys = [key for key in keep.kept if key[0] == "bsw_row"]
    if not row_keys:
        raise AssertionError("5 Mbp: the row path kept no chunk")
    row_key = min(row_keys, key=lambda key: key[1][0])
    for (name, a_shape, b_shape), k in sorted(keep.kept.items()):
        if name == "bsw_row" and (name, a_shape, b_shape) != row_key:
            continue
        fargs = k["fargs"]
        fe, lmax, edits = k.get("walk", (None, 0, False))
        xw = 2 * b_shape[1]  # two 4-bit codes a byte
        errs, ms = kernel_vs_plain(name, fargs, fe, lmax, edits)
        note_err(res, f"[full] merge chunk {name} B={a_shape[0]} XW={xw} "
                 f"band={fargs[7]} edits={edits}", errs)
        log(f"[full] merge chunk {name} B={a_shape[0]} XW={xw}: one call "
            "each, " + ", ".join(f"{n} {v:.4f} ms" for n, v in ms.items()))

    wall, mr = merge("antidiag", "warm")
    if (d / "warm.gam.fasta").read_bytes() != want:
        raise AssertionError("a warm merge wrote another .gam.fasta")
    log(f"[full] warm merge (antidiag): wall {wall:.4f} s, phases (s) "
        f"{json.dumps(mr['phases'], sort_keys=True)}")
    payload_merge(d, merge, mr)
    # the chunks of a round on the engine's stream pool against one
    # stream, in turns (pool, 1, 1, pool, three times); medians
    pool = BswEngine.STREAMS
    aligns: dict[int, list[float]] = {pool: [], 1: []}
    try:
        for n in (pool, 1, 1, pool) * 3:
            BswEngine.STREAMS = n
            wall, mr = merge("antidiag", f"streams{n}")
            if (d / f"streams{n}.gam.fasta").read_bytes() != want:
                raise AssertionError("a warm merge wrote another .gam.fasta")
            aligns[n].append(mr["phases"]["align"])
            log(f"[full] warm merge (antidiag), {n} stream(s): wall "
                f"{wall:.4f} s, align {mr['phases']['align']:.4f} s")
    finally:
        BswEngine.STREAMS = pool
    log("[full] align phase, median of 6 warm merges: " + ", ".join(
        f"{n} stream(s) {statistics.median(v):.4f} s"
        for n, v in aligns.items()))
    from torch.profiler import ProfilerActivity, profile

    for path in ("antidiag", "row"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall, mr = merge(path, f"prof_{path}")
        dev_ms = device_ms_by_kernel(prof)
        total = sum(ms for ms, _n in dev_ms.values())
        busy = device_busy_ms(prof)
        log(f"[full] profiled merge ({path}): wall {wall:.4f} s, align "
            f"{mr['phases']['align']:.4f} s, device busy {busy:.3f} ms "
            f"({100 * busy / (wall * 1e3):.2f}% of wall; kernels and "
            f"copies sum to {total:.3f} ms)")
        for name, (v, n) in sorted(dev_ms.items(),
                                   key=lambda kv: -kv[1][0])[:8]:
            log(f"[full]   {v:10.3f} ms  {n:4d} x {v / n:8.3f} ms  "
                f"{name[:80]}")


def engine_merge(c, blocks, prefix, engine, arena=False):
    """run_merge of the corpus with `engine`, under GAM_ARENA=1 when
    `arena`: (wall s, .metrics.json, the merge's log lines)."""
    lines: list[str] = []
    old = os.environ.pop("GAM_ARENA", None)
    if arena:
        os.environ["GAM_ARENA"] = "1"
    try:
        t0 = time.time()
        run_merge(MergeOptions(
            master_bam_file=c["ml"], slave_bam_file=c["sl"],
            blocks_file=blocks, master_fasta_file=c["mfa"],
            slave_fasta_file=c["sfa"], min_block_size=10,
            output_file_prefix=prefix, engine=engine), log=lines.append)
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        os.environ.pop("GAM_ARENA", None)
        if old is not None:
            os.environ["GAM_ARENA"] = old
    return wall, json.load(open(f"{prefix}.metrics.json")), lines


def same_outputs(d, prefix, ref="antidiag") -> bool:
    return all((d / f"{prefix}{ext}").read_bytes()
               == (d / f"{ref}{ext}").read_bytes() for ext in OUTPUTS)


def arena_merges(d, c, blocks, res) -> None:
    """The 5 Mbp merge under GAM_ARENA=1 (the arena path: the gather, the
    anti-diagonal forward and the walk, its counts set to 0 just before
    it and read just after): the default merge's six outputs; the gather
    against its plain version on the merge's first arena chunk; then the
    arena and the window uploads in turns, three merges each."""
    kept = {}
    orig = bsw_engine.gather_windows

    def keep(*args):
        kept.setdefault("args", tuple(
            v.clone() if torch.is_tensor(v) else v for v in args))
        return orig(*args)

    reset_launches()
    eng = BswEngine(DEV)
    bsw_engine.gather_windows = keep
    try:
        wall, m, lines = engine_merge(c, blocks, f"{d}/arena", eng, True)
    finally:
        bsw_engine.gather_windows = orig
    launches = BswEngine.kernel_launches()
    res["launches"]["arena"] = launches
    if not same_outputs(d, "arena"):
        raise AssertionError("5 Mbp under GAM_ARENA=1: another output")
    merged = tp.read_fasta_seqs(f"{d}/arena.gam.fasta")
    if c["genome"] not in merged:
        raise AssertionError("5 Mbp under GAM_ARENA=1: genome not rebuilt")
    if not (launches["arena_gather"] == eng.arena_chunks > 0
            and launches["bsw_antidiag"] > 0 and launches["bsw_walk"] > 0
            and launches["bsw_row"] == 0):
        raise AssertionError(f"5 Mbp under GAM_ARENA=1: launches "
                             f"{launches}, {eng.arena_chunks} arena chunks")
    log(f"[full] arena: merge {wall:.4f} s, six outputs byte-identical to "
        f"the default path's, genome reconstructed exactly; launches "
        f"{launches}; "
        + "; ".join(x for x in lines if "sequence arena:" in x))
    args = kept["args"]
    gather_vs_plain(res, args, None, "[full] arena merge chunk")
    # the arena against the window uploads, in turns
    runs: dict[str, list] = {"arena": [], "upload": []}
    for mode in ("arena", "upload", "upload", "arena") * 2:
        n0 = arena_gather.launches
        eng = BswEngine(DEV)
        wall, m, _lines = engine_merge(c, blocks, f"{d}/ab_{mode}", eng,
                                       mode == "arena")
        if not same_outputs(d, f"ab_{mode}"):
            raise AssertionError(f"5 Mbp A/B {mode}: another output")
        live = max(eng.util["live"], 1)
        arena_b = 0 if eng._arena_host is None else eng._arena_host.nbytes
        row = (m["phases"]["align"], m["counters"]["align_bytes_wire"],
               arena_b, eng.arena_problems / live,
               eng.arena_chunks / max(eng.dispatches, 1),
               arena_gather.launches - n0, wall)
        runs[mode].append(row)
        log(f"[full] A/B {mode}: align {row[0]:.4f} s, align_bytes_wire "
            f"{row[1]} (arena {row[2]} once + columns {row[1] - row[2]}), "
            f"arena share {eng.arena_problems}/{eng.util['live']} problems "
            f"({100 * row[3]:.1f}%), {eng.arena_chunks}/{eng.dispatches} "
            f"chunks ({100 * row[4]:.1f}%), gather launches {row[5]}, "
            f"wall {wall:.4f} s")
    log("[full] A/B align s, median of 4 warm merges each: " + ", ".join(
        f"{k} {statistics.median(r[0] for r in v):.4f}"
        for k, v in runs.items()) + "; align_bytes_wire " + ", ".join(
        f"{k} {v[0][1]}" for k, v in runs.items()))


def sharded_merge(d, c, blocks) -> None:
    """The 5 Mbp merge with the engine (and the edge count) over every GPU
    the process sees, or over (cuda:0, cuda:0) on one: the default
    merge's six outputs, and the shards each device ran."""
    n_gpu = torch.cuda.device_count()
    devices = (tuple(torch.device("cuda", i) for i in range(n_gpu))
               if n_gpu > 1 else (torch.device("cuda", 0),) * 2)
    reset_launches()
    eng = BswEngine(devices)
    wall, m, lines = engine_merge(c, blocks, f"{d}/sharded", eng)
    launches = BswEngine.kernel_launches()
    if not same_outputs(d, "sharded"):
        raise AssertionError(f"5 Mbp over {devices}: another output")
    if sum(n > 0 for n in eng.shard_runs) < 2:
        raise AssertionError(f"5 Mbp over {devices}: shards a device "
                             f"{eng.shard_runs}")
    log(f"[full] engine over {len(devices)} shards on "
        f"{len(set(devices))} distinct GPU(s) ({', '.join(map(str, devices))}"
        f"): six outputs byte-identical to the default path's; wall "
        f"{wall:.4f} s, align {m['phases']['align']:.4f} s; launches "
        f"{launches}; each device's shards (one forward and one walk "
        f"launch each): " + ", ".join(
            f"#{k} {dev}: {n}" for k, (dev, n) in enumerate(
                zip(devices, eng.shard_runs)))
        + "; " + "; ".join(x for x in lines if "engine on" in x))


def wide_band_merges(d, c, blocks, res) -> None:
    """The 5 Mbp merge at bands 300, 511 and 1023, where the row forward
    runs row_warps_kernel (four warps of five lanes a thread, eight of
    four, and a cluster of two blocks of eight warps of four), through
    two independent forwards on the merge's chunks (B=64, XW 32768):
    BswEngine(band=b, kernel="row") and BswEngine(band=b), the
    anti-diagonal forward; each merge's launch counts set to 0 just
    before it and read just after; the six outputs byte-identical; then,
    at bands 511 and 1023, the row kernel (and the walk over its words)
    against its plain version on the row merge's smallest chunk (band
    300's plain comparison, ~30 s of plain versions, is left out to keep
    the script's time; the parity phase holds that instance at its first
    and last band)."""
    res["launches"]["row_warps"] = {"bsw_row_warps": 0}
    res["launches"]["row_cluster"] = {"bsw_row_cluster": 0}
    for band, plain in ((300, False), (511, True), (1023, True)):
        kname = row_name(band)
        keep = KeepChunkInputs()
        for kernel in ("antidiag", "row"):
            reset_launches()
            eng = BswEngine(DEV, band=band, kernel=kernel)
            with keep:
                wall, m, _lines = engine_merge(
                    c, blocks, f"{d}/band{band}_{kernel}", eng)
            launches = BswEngine.kernel_launches()
            fwd, off = (("bsw_row", "bsw_antidiag") if kernel == "row"
                        else ("bsw_antidiag", "bsw_row"))
            if not launches[fwd] or launches[off] or not launches["bsw_walk"]:
                raise AssertionError(f"5 Mbp band={band} kernel={kernel}: "
                                     f"launches {launches}")
            if kernel == "row":
                path = kname.replace("bsw_", "")
                res["launches"][path][kname] += launches["bsw_row"]
            log(f"[full] band={band} kernel={kernel}: wall {wall:.4f} s, "
                f"align {m['phases']['align']:.4f} s, aligned_cells "
                f"{m['counters']['aligned_cells']}, launches {launches}")
        if not same_outputs(d, f"band{band}_row", ref=f"band{band}_antidiag"):
            raise AssertionError(f"5 Mbp band={band}: the row forward's "
                                 f"merge wrote other outputs")
        log(f"[full] band={band}: six outputs of the row forward "
            f"(row_warps_kernel, C, W, R = {row_instance(band)}) "
            f"byte-identical to the anti-diagonal's")
        if not plain:
            continue
        # the kernel against its plain version on the merge's own
        # smallest row chunk (the walk over its words beside it)
        (name, a_shape, b_shape), k = min(
            ((key, k) for key, k in keep.kept.items()
             if key[0] == "bsw_row"), key=lambda kv: kv[0][1][0])
        fe, lmax, edits = k.get("walk", (None, 0, False))
        errs, ms = kernel_vs_plain(name, k["fargs"], fe, lmax, edits)
        errs = {row_name(band) if n == "bsw_row" else n: v
                for n, v in errs.items()}
        note_err(res, f"[full] band={band} merge chunk {row_name(band)} "
                 f"B={a_shape[0]} XW={2 * b_shape[1]} edits={edits}", errs)
        log(f"[full] band={band} merge chunk B={a_shape[0]}: one call "
            "each, " + ", ".join(f"{n} {v:.4f} ms" for n, v in ms.items()))
    wide_walk_merges(d, c, blocks, res)


def wide_walk_merges(d, c, blocks, res) -> None:
    """The 5 Mbp merge at band 4095 (the row forward's clusters of eight
    blocks) through BswEngine(band=4095, kernel="row"), whose device walk
    runs on its 3-row ring, and through BswEngine(band=4095,
    traceback="host"), the C++ walk over the same forward's words; each
    merge's launch counts set to 0 just before it and read just after;
    the six outputs byte-identical; then the walk kernel against its
    plain version over the kernel forward's words on the device merge's
    smallest chunk (the plain forward is left out: the parity phase
    holds it at band 4095)."""
    band = MAX_BAND
    res["launches"]["walk_wide"] = {"bsw_walk_wide": 0}
    keep = KeepChunkInputs()
    for tb in ("device", "host"):
        reset_launches()
        eng = BswEngine(DEV, band=band, kernel="row", traceback=tb)
        with keep if tb == "device" else contextlib.nullcontext():
            wall, m, _lines = engine_merge(c, blocks, f"{d}/band{band}_{tb}",
                                           eng)
        launches = BswEngine.kernel_launches()
        if not launches["bsw_row"] or launches["bsw_antidiag"] \
                or (launches["bsw_walk"] > 0) != (tb == "device"):
            raise AssertionError(f"5 Mbp band={band} traceback={tb}: "
                                 f"launches {launches}")
        if tb == "device":
            res["launches"]["walk_wide"]["bsw_walk_wide"] += \
                launches["bsw_walk"]
            res["launches"]["row_cluster"]["bsw_row_cluster"] += \
                launches["bsw_row"]
        log(f"[full] band={band} kernel=row traceback={tb}: wall "
            f"{wall:.4f} s, align {m['phases']['align']:.4f} s, "
            f"aligned_cells {m['counters']['aligned_cells']}, "
            f"align_dispatches {m['counters']['align_dispatches']}, "
            f"launches {launches}")
    if not same_outputs(d, f"band{band}_device", ref=f"band{band}_host"):
        raise AssertionError(f"5 Mbp band={band}: the device walk's merge "
                             f"wrote other outputs than the host walk's")
    rows, slot, _code, warps, shmem = ring_info(band, ROW)
    log(f"[full] band={band}: six outputs of the device walk ({rows}-row "
        f"ring of {4 * slot} B slots, {warps} warps and {shmem} B of shared "
        f"memory a block) byte-identical to the host walk's")
    (name, a_shape, b_shape), k = min(
        ((key, k) for key, k in keep.kept.items() if key[0] == "bsw_row"),
        key=lambda kv: kv[0][1][0])
    fe, lmax, edits = k["walk"]
    errs, ms = kernel_vs_plain(name, k["fargs"], fe, lmax, edits,
                               plain_fwd=False)
    note_err(res, f"[full] band={band} merge chunk B={a_shape[0]} "
             f"XW={2 * b_shape[1]} edits={edits} (over the kernel "
             f"forward's words)", errs)
    log(f"[full] band={band} merge chunk B={a_shape[0]}: one call each, "
        + ", ".join(f"{n} {v:.4f} ms" for n, v in ms.items()))


def payload_merge(d, merge, m_res) -> None:
    """One warm merge under GAM_RESIDENT=0: the partition's edge count
    ships row copies (ops/region_score.py count_payload) and must give
    the resident merge's six outputs; its partition seconds beside the
    resident merge's, and count_payload timed on its first chunk."""
    kept = {}
    plain = region_score.count_payload

    def keep(rows, jobs_t):
        kept.setdefault("args", (rows, jobs_t))
        kept["calls"] = kept.get("calls", 0) + 1
        return plain(rows, jobs_t)

    os.environ["GAM_RESIDENT"] = "0"
    region_score.count_payload = keep
    try:
        wall, mp = merge("antidiag", "payload")
    finally:
        region_score.count_payload = plain
        del os.environ["GAM_RESIDENT"]
    for ext in OUTPUTS:
        if (d / f"payload{ext}").read_bytes() != (d / f"warm{ext}"
                                                  ).read_bytes():
            raise AssertionError(f"GAM_RESIDENT=0: payload{ext} != the "
                                 f"resident merge's")
    if not kept.get("calls"):
        raise AssertionError("GAM_RESIDENT=0 ran no payload count")
    rows, jobs_t = kept["args"]
    ms, out = cuda_ms(lambda: plain(rows, jobs_t))
    want = plain({k: v.cpu() for k, v in rows.items()}, jobs_t.cpu())
    if not torch.equal(out.cpu(), want):
        raise AssertionError("count_payload on the card != on the CPU")
    n_bytes = nbytes(*rows.values(), jobs_t, out)
    b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[full] warm merge under GAM_RESIDENT=0: six outputs "
        f"byte-identical to the resident merge's; wall {wall:.4f} s, "
        f"partition {mp['phases']['partition']:.4f} s (resident "
        f"{m_res['phases']['partition']:.4f} s), "
        f"{mp['counters']['partition_bytes_wire']} payload bytes up, "
        f"{kept['calls']} count_payload call(s)")
    log(f"[full] count_payload, first chunk ({rows['pos'].shape[0]} rows, "
        f"{jobs_t.shape[1]} jobs): {ms:.4f} ms (CUDA events, median of 5), "
        f"bound {b_ms:.6g} ms (bytes, {n_bytes} B), {ms / b_ms:.1f}x it")


def phase_create(genome_mb: float = 5.0):
    """find_blocks_device on the card at ~5 M rows a side (the 5 Mbp
    layout, a pair every 2 bp) against the native scan, column for
    column; walls of both; CUDA-event medians of join_device,
    analyze_device and the moments of 2.5 M inserts beside their
    bounds."""
    t0 = time.time()
    m_cols, s_cols = tp.scale_columns(genome_mb, 2)
    nm, ns = len(m_cols[0]), len(s_cols[0])
    log(f"[create] columns built in {time.time() - t0:.2f} s: {nm} master "
        f"rows, {ns} slave rows ({genome_mb} Mbp genome, a 50 bp read pair "
        f"every 2 bp, 50x coverage)")
    t0 = time.time()
    want = find_blocks_native(m_cols, s_cols, 10)
    t_nat = time.time() - t0
    device_join.launches.update(join=0, analyze=0)
    torch.cuda.synchronize()
    t0 = time.time()
    stats: dict = {}
    got = device_join.find_blocks_device(m_cols, s_cols, 10, stats=stats,
                                         device=DEV)
    torch.cuda.synchronize()
    t_dev = time.time() - t0
    launches = dict(device_join.launches)
    for k in want:
        if not np.array_equal(np.asarray(got[k], np.int64),
                              np.asarray(want[k], np.int64)):
            raise AssertionError(f"[create] column {k}: the device join "
                                 f"!= the native scan")
    if launches != {"join": 1, "analyze": 1}:
        raise AssertionError(f"[create] launches {launches}")
    log(f"[create] find_blocks_device on {DEV} = find_blocks_native, "
        f"column for column: {len(want['num_reads'])} blocks from "
        f"{stats['matched_reads']} matched reads ({stats['runs']} runs, "
        f"{stats['groups']} groups, {stats['simple_groups']} simple, "
        f"{stats['residual_reads']} residual reads); wall: device path "
        f"{t_dev:.4f} s, native scan {t_nat:.4f} s; launches {launches}")

    def up(a, b, dtype):
        return torch.from_numpy(np.concatenate(
            [np.asarray(a, dtype), np.asarray(b, dtype)])).to(DEV)

    first = up(m_cols[2], s_cols[2], np.uint8)
    h2 = up(m_cols[1], s_cols[1], np.uint64).view(torch.int64)
    h1 = up(m_cols[0], s_cols[0], np.uint64).view(torch.int64)
    ms_join, midx = cuda_ms(lambda: device_join.join_device(first, h2, h1,
                                                            nm))
    midx = midx.cpu().numpy()
    sel = np.nonzero(midx >= 0)[0]
    mi = midx[sel]
    cols = torch.from_numpy(np.stack([
        s_cols[3][sel], s_cols[4][sel], s_cols[5][sel] - 1, m_cols[3][mi],
        m_cols[4][mi], m_cols[5][mi] - 1]).astype(np.int32)).to(DEV)
    ms_an, an_out = cuda_ms(lambda: device_join.analyze_device(cols))
    # the insert-size moments that distributed_library_stats reduces on
    # each rank's card (core/stats.py::isize_stats_psum): one insert a
    # pair.  The sums of these integers are exact in float64, so mean
    # and std must equal the same formula on numpy's sums.
    x = (200 + (np.arange(ns // 2) % 7) - 3).astype(np.float64)
    ins = torch.from_numpy(x).to(DEV)
    ms_mom, mom = cuda_ms(lambda: isize_stats_psum(ins))
    n, s, ss = float(len(x)), float(x.sum()), float((x * x).sum())
    mean = s / n
    want_mom = [mean, float(np.sqrt(max(ss - n * mean * mean, 0.0) /
                                    (n + 1))), n]
    if [float(v) for v in mom] != want_mom:
        raise AssertionError(f"[create] isize_stats_psum on the card "
                             f"{[float(v) for v in mom]} != {want_mom}")
    # the running max both programs scan with: torch's cummax of one
    # long row against the two-level device_join.cummax, same values
    packed = torch.randint(-(2 ** 62), 2 ** 62, (nm + ns,), device=DEV)
    ms_one, one = cuda_ms(lambda: torch.cummax(packed, 0).values)
    ms_two, two = cuda_ms(lambda: device_join.cummax(packed))
    if not torch.equal(one, two):
        raise AssertionError("[create] two-level cummax != torch.cummax")
    log(f"[create] running max of {nm + ns} int64: torch.cummax "
        f"{ms_one:.4f} ms, two-level device_join.cummax {ms_two:.4f} ms "
        f"(CUDA events, median of 5)")
    for name, ms, n_bytes in (
            ("join_device", ms_join, nbytes(first, h2, h1) + ns * 8),
            ("analyze_device", ms_an, nbytes(cols, *an_out)),
            ("isize_stats_psum", ms_mom, nbytes(ins, *mom))):
        b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        log(f"[create] {name}: {ms:.4f} ms (CUDA events, median of 5), "
            f"bound {b_ms:.6g} ms (bytes: {n_bytes} B over "
            f"{HBM_BYTES_PER_S:.3g} B/s), {ms / b_ms:.1f}x it")


def resident_mib(pid: int) -> int:
    """A process's peak resident size in MiB (VmHWM of /proc/<pid>/status,
    or its current VmRSS where the kernel reports no peak); 0 once it has
    exited."""
    try:
        with open(f"/proc/{pid}/status") as fh:
            vm = dict(line.split(":", 1) for line in fh if ":" in line)
    except OSError:
        return 0
    kb = vm.get("VmHWM") or vm.get("VmRSS") or "0 kB"
    return int(kb.split()[0]) // 1024


def mib(v: int) -> str:
    return f"{v} MiB" if v else "not measured"


def merge_processes(d, c, blocks, prefix, nproc, timeout_s=300):
    """One merge through `python -m gam_ngs_tpu_torch.cli merge --device
    cuda` in nproc child processes (cli_processes)."""
    wall, logs, hwm, _walls = cli_processes(d, merge_argv(
        c["ml"], c["sl"], c["mfa"], c["sfa"], blocks, f"{d}/{prefix}",
        "cuda"), prefix, nproc, timeout_s)
    return wall, logs, hwm


def cli_processes(d, cli_argv, prefix, nproc, timeout_s=300):
    """One command of `python -m gam_ngs_tpu_torch.cli` in nproc child
    processes (nproc > 1: a gloo group on 127.0.0.1, every rank on this
    card).  Returns (wall s, each rank's log, each rank's peak RSS in
    MiB, each rank's wall s).  The peak is resident_mib's, read every
    20 ms while the child runs: the CLI's own MAX Memory line (getrusage)
    counts this process's resident size too, which a child inherits
    across fork and exec.  A rank that exits non-zero or outlives
    timeout_s fails the phase; every child is killed before this
    returns."""
    argv = [sys.executable, "-m", "gam_ngs_tpu_torch.cli", *cli_argv]
    if nproc > 1:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            coord = f"127.0.0.1:{s.getsockname()[1]}"
        argv += ["--coordinator", coord, "--num-processes", str(nproc)]
    env = dict(os.environ, PYTHONPATH=ROOT, GAM_BARRIER_TIMEOUT="240")
    procs = []
    hwm = [0] * nproc
    walls = [0.0] * nproc
    t0 = time.time()
    try:
        for k in range(nproc):
            logf = open(f"{d}/{prefix}.rank{k}.log", "w")
            procs.append((subprocess.Popen(
                argv + (["--process-id", str(k)] if nproc > 1 else []),
                stdout=logf, stderr=subprocess.STDOUT, env=env, cwd=ROOT),
                logf))
        while any(p.poll() is None for p, _f in procs):
            if time.time() - t0 > timeout_s:
                raise TimeoutError(f"{prefix}: {cli_argv[0]} outlived "
                                   f"{timeout_s} s")
            for k, (p, _f) in enumerate(procs):
                if p.poll() is None:
                    hwm[k] = max(hwm[k], resident_mib(p.pid))
                    walls[k] = time.time() - t0
            time.sleep(0.02)
        wall = time.time() - t0
    finally:
        for p, f in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            f.close()
    logs = [open(f"{d}/{prefix}.rank{k}.log").read() for k in range(nproc)]
    for k, (p, _f) in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(f"{prefix} rank {k} exited {p.returncode}:\n"
                               + logs[k][-3000:])
    return wall, logs, hwm, walls


def isize_values(lst: str) -> list[float]:
    """The mean, std and coverage numbers of <lst>.isize."""
    names = bamlist.load_bam_file_names(lst)[0]
    return [v for vals in isize_io.read_isize(lst + ".isize", names)
            for v in vals]


def dist_create(d, c, name) -> str:
    """Two ranks of `create --coordinator --device cuda` on the card:
    host 0's .blocks byte-identical to the one-process native create's
    (d/out), the .isize values within the moment sums' rounding (mean
    rtol 1e-9, std 1e-6, coverage 1e-12, tests/test_create_dist.py), and
    every rank whose shard holds slave rows launched the join and the
    analysis (on the split corpus, both ranks).  Its .isize files stay
    in place for the merges that follow.  Returns host 0's .blocks
    path."""
    lists = (c["ml"], c["sl"])
    want = {lst: isize_values(lst) for lst in lists}
    wall, logs, hwm, walls = cli_processes(
        d, create_argv(c["ml"], c["sl"], f"{d}/dist_create", "cuda"),
        "dist_create", 2)
    if (d / "dist_create.blocks").read_bytes() != \
            (d / "out.blocks").read_bytes():
        raise AssertionError(f"{name}: two-process create .blocks != the "
                             f"native create's")
    for lst in lists:
        got = isize_values(lst)
        for k, tol in enumerate((1e-9, 1e-6, 1e-12)):
            g, w = got[k::3], want[lst][k::3]
            if not np.allclose(g, w, rtol=tol, atol=0):
                raise AssertionError(f"{name}: {lst}.isize {g} vs native "
                                     f"{w} (rtol {tol})")
    for k, log_k in enumerate(logs):
        rows = re.search(rf"\[create\] host {k}: (\d+) slave rows", log_k)
        launch = re.search(rf"\[create\] host {k}: device join launches = "
                           rf"(\{{.*?\}})", log_k)
        if not rows or not launch:
            raise AssertionError(f"{name} create rank {k}:\n"
                                 + log_k[-3000:])
        n_rows = int(rows.group(1))
        launches = json.loads(launch.group(1))
        ran = launches["join"] >= 1 and launches["analyze"] >= 1
        if ran != (n_rows > 0) or (name == "scale5_split4" and not n_rows):
            raise AssertionError(f"{name} create rank {k}: {n_rows} slave "
                                 f"rows, launches {launches}")
        log(f"[dist] {name} create rank {k}: {n_rows} slave rows, "
            f"launches {launches}, wall {walls[k]:.4f} s, peak RSS "
            f"{mib(hwm[k])}")
    log(f"[dist] {name}: two-process create: host 0's .blocks = the "
        f"native create's, .isize within rounding; wall {wall:.4f} s")
    return str(d / "dist_create.blocks")


def rank_numbers(log: str, k: int) -> dict:
    """A rank's aligned cells, kernel launches, align seconds and device
    from its log (parallel/distributed.py and device.py lines)."""
    def grab(pattern):
        m = re.search(pattern, log)
        if not m:
            raise AssertionError(f"rank {k}: no line {pattern!r}:\n"
                                 + log[-3000:])
        return m.group(1)

    return {"cells": int(grab(rf"\[dist\] host {k}: aligned cells = (\d+)")),
            "launches": json.loads(grab(
                rf"\[dist\] host {k}: kernel launches = (\{{.*\}})")),
            "align_s": float(grab(
                rf"\[dist\] host {k}: align compute seconds = ([\d.]+)")),
            "device": grab(rf"process {k}/\d+: --device cuda -> (\S+)")}


def phase_dist(tmp, res):
    """The multi-process create and merge: the junction corpus (fails
    fast), the full phase's 5 Mbp corpus (one graph: rank 1 has nothing
    to align) and the same 5 Mbp genome with every 4th slave cut on a
    master cut (bench/dist_scale.py's corpus: 25 graphs).  On the junction
    and split corpora two ranks of create --coordinator run first
    (dist_create) and the merges read host 0's blocks.  Each corpus is
    merged by one child process and by two ranks of merge --coordinator
    on this card.  Host 0's six outputs must equal the one-process run's,
    on the junction and split corpora those outputs must also equal a
    one-process merge of the native create's .blocks and .isize (the
    whole one-process pipeline), the ranks' aligned cells must sum to
    the one-process run's, every
    rank that aligned must have launched the forward and the walk, and on
    the split corpus both ranks must have aligned."""
    for name in ("junction", "scale5", "scale5_split4"):
        if name == "scale5" and "full_corpus" in res:
            d, c = res["full_corpus"]
        else:
            d = pathlib.Path(tmp) / f"dist_{name}"
            d.mkdir()
            if name == "junction":
                genome, ml, sl, mfa, sfa = tp.junction_corpus(d)
                c = {"genome": genome, "ml": ml, "sl": sl, "mfa": mfa,
                     "sfa": sfa}
            else:
                c = tp.scale_corpus(5.0, d, break_every=4 * (
                    name == "scale5_split4"))
            run_cli(create_argv(c["ml"], c["sl"], f"{d}/out", "native"))
        blocks = f"{d}/out.blocks"
        if name != "scale5":
            # the one-process pipeline's merge (native create's .blocks
            # and .isize), then the merges read the two-rank create's
            merge_processes(d, c, blocks, "native1", 1)
            blocks = dist_create(d, c, name)
        wall1, _logs, hwm1 = merge_processes(d, c, blocks, "dist1", 1)
        m1 = json.load(open(f"{d}/dist1.metrics.json"))
        wall2, logs, hwm2 = merge_processes(d, c, blocks, "dist2", 2)
        for ext in OUTPUTS:
            if (d / f"dist2{ext}").read_bytes() != \
                    (d / f"dist1{ext}").read_bytes():
                raise AssertionError(f"{name}: two-process {ext} differs "
                                     f"from the one-process run's")
            if name != "scale5" and (d / f"dist1{ext}").read_bytes() != \
                    (d / f"native1{ext}").read_bytes():
                raise AssertionError(f"{name}: merge {ext} from the "
                                     f"two-rank create differs from the "
                                     f"one-process pipeline's")
        merged = "".join(tp.read_fasta_seqs(f"{d}/dist2.gam.fasta"))
        if name != "scale5_split4" and c["genome"] not in merged:
            raise AssertionError(f"{name}: genome not reconstructed")
        ranks = [dict(rank_numbers(log, k), peak_rss_mib=hwm2[k])
                 for k, log in enumerate(logs)]
        cells1 = m1["counters"]["aligned_cells"]
        for k, r in enumerate(ranks):
            log(f"[dist] {name} rank {k}: device {r['device']}, aligned "
                f"cells {r['cells']}, launches {r['launches']}, align "
                f"{r['align_s']:.4f} s, peak RSS {mib(r['peak_rss_mib'])}")
            ran = {k2: r["launches"].get(k2, 0) > 0
                   for k2 in ("bsw_antidiag", "bsw_walk")}
            if set(ran.values()) != {r["cells"] > 0} or (
                    name == "scale5_split4" and r["cells"] == 0):
                raise AssertionError(f"{name} rank {k}: {r['cells']} cells, "
                                     f"launches {r['launches']}")
        if sum(r["cells"] for r in ranks) != cells1:
            raise AssertionError(f"{name}: ranks aligned "
                                 f"{[r['cells'] for r in ranks]} cells, the "
                                 f"one-process run {cells1}")
        cells = " + ".join(str(r["cells"]) for r in ranks)
        aligns = ", ".join(f"{r['align_s']:.4f}" for r in ranks)
        same = ("" if name == "scale5" else " and to the merge of the "
                "one-process native create's .blocks and .isize")
        log(f"[dist] {name}: {m1['counters']['graphs']} graphs; six outputs "
            f"of 2 processes byte-identical to 1 process{same}; aligned cells "
            f"{cells} = {cells1}; merge wall "
            f"1 process {wall1:.4f} s (align {m1['phases']['align']:.4f} s, "
            f"peak RSS {mib(hwm1[0])}), 2 processes {wall2:.4f} s (align "
            f"{aligns} s)")
        res.setdefault("dist", {})[name] = {
            "wall1": wall1, "wall2": wall2, "ranks": ranks}


def mesh_dryruns(res) -> None:
    """The step's dry-run over every GPU and over four shards of cuda:0,
    and entry.dryrun_multichip over the four shards, with the launch
    counts set to 0 just before and read just after; then entry()'s
    forward on the card against its plain version on the CPU."""
    n_gpu = torch.cuda.device_count()
    shards = (DEV,) * 4
    reset_launches()
    t0 = time.time()
    dryrun_step(device_mesh(n_gpu, "cuda"))
    dryrun_step(shards)
    entry.dryrun_multichip(4, devices=shards)
    launches = BswEngine.kernel_launches()
    res.setdefault("launches", {})["mesh"] = launches
    if n_gpu == 1:
        log("[mesh] one GPU: the dry-run across distinct cards needs a "
            "machine with several; four shards of cuda:0 stand in")
    log(f"[mesh] dryrun_step over {n_gpu} GPU(s) and over 4 shards of "
        f"cuda:0 (statistics = numpy, total_best > 0, sharded engine = "
        f"bsw_align); dryrun_multichip over 4 shards: the genome back on "
        f"the default engine and on the row forward + host traceback; "
        f"{time.time() - t0:.2f} s; launches {launches}")
    if not all(launches[k] > 0 for k in ("bsw_antidiag", "bsw_row",
                                         "bsw_walk")):
        raise AssertionError(f"[mesh] dry-run launches {launches}")
    fn, args = entry.entry()
    got = fn(*args)
    want = forward_antidiag_torch(*(a.cpu() for a in args),
                                  fn.keywords["band"])
    note_err(res, "[mesh] entry() B=4 XW=256 band=30 on the card vs plain "
             "on the CPU", {"bsw_antidiag": max_err(
                 [g.cpu() for g in got], want)})


def phase_mesh(res, card):
    """The dry-runs (mesh_dryruns), then the sharded step at full width:
    the 5 Mbp merge's chunk shape (B=64, XW 32768, band 150,
    timing_problems) and a read table of 5,000,000 reads (~ one side of
    scale_columns(5.0, 2), the 50x create) of 2 libraries, isize uniform
    in [150, 450), 90% masked in, over four shards of the card."""
    mesh_dryruns(res)
    band, xw, B, n_reads, n_libs = 150, 32768, 64, 5_000_000, 2
    fargs, _fe, xw_b = packed_inputs(timing_problems(xw, band), band)
    if xw_b != xw:
        raise AssertionError(f"[mesh] problems fell in bucket {xw_b}")
    rng = np.random.default_rng(23)
    lib_id = rng.integers(0, n_libs, n_reads).astype(np.int32)
    isize = rng.integers(150, 450, n_reads).astype(np.int32)
    mask = rng.random(n_reads) < 0.9
    reads = to_dev(lib_id, isize, mask)
    shards = (DEV,) * 4
    step = make_pipeline_step(shards, B, xw, a_width(xw, band), band,
                              n_reads, n_libs)
    sargs = (*fargs[:7], *reads)

    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = step(*sargs)
    torch.cuda.synchronize()
    step_peak = torch.cuda.max_memory_allocated() - base
    launches = BswEngine.kernel_launches()
    if launches["bsw_antidiag"] != len(shards):
        raise AssertionError(f"[mesh] step launches {launches}")
    one = forward_antidiag(*fargs)
    for k, name in enumerate(("dirs", "last_row", "diag")):
        if not torch.equal(torch.cat(out[k]), one[k]):
            raise AssertionError(f"[mesh] the four shards' {name} differ "
                                 f"from one forward_antidiag call")
    want = np.zeros((3, n_libs))
    for lib in range(n_libs):
        sel = isize[mask & (lib_id == lib)].astype(np.int64)
        want[:, lib] = (len(sel), sel.sum(), (sel * sel).sum())
    best = int(one[1].cpu().numpy().max(1).astype(np.int64).sum())
    for d in range(len(shards)):
        got = np.stack([out[k][d].cpu().numpy() for k in (3, 4, 5)])
        if not np.array_equal(got, want) or int(out[6][d]) != best:
            raise AssertionError(f"[mesh] copy {d}: statistics "
                                 f"{got.tolist()} against {want.tolist()}, "
                                 f"total_best {int(out[6][d])} against "
                                 f"{best}")

    # one shard alone: its forward and its statistics
    per, rper = B // len(shards), n_reads // len(shards)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    forward_antidiag(*(v[:per] for v in fargs[:7]), band)
    library_moments(*(v[:rper] for v in reads), n_libs)
    torch.cuda.synchronize()
    shard_peak = torch.cuda.max_memory_allocated() - base

    step_ms, _ = cuda_ms(lambda: step(*sargs))
    fwd_ms, _ = cuda_ms(lambda: step.forward(*fargs[:7]))
    one_ms, _ = cuda_ms(lambda: forward_antidiag(*fargs))
    stats_ms, _ = cuda_ms(lambda: step.statistics(*reads))
    lib_d, isize_d, mask_d = reads
    lib64 = lib_d.long()

    def bincounts():
        w = mask_d.to(torch.float64)
        s = isize_d.to(torch.float64) * w
        return torch.stack([torch.bincount(lib64, weights=v, minlength=n_libs)
                            for v in (w, s, s * isize_d)])

    bin_ms, bins = cuda_ms(bincounts)
    if not np.array_equal(bins.cpu().numpy(), want):
        raise AssertionError("[mesh] torch.bincount's statistics differ")
    stats_bytes = 9 * n_reads  # lib_id i32, isize i32, mask bool: each once
    stats_bound = stats_bytes / HBM_BYTES_PER_S * 1e3
    cells = int(fargs[5].sum()) * (2 * band + 1)
    # the step: the forward's bytes and int32 operations (bound()) plus
    # the statistics' bytes
    step_bytes = nbytes(*fargs[:7], *one) + stats_bytes
    t_bytes = step_bytes / HBM_BYTES_PER_S
    t_ops = cells * OPS_PER_CELL / int32_ops_per_s()
    step_bound = max(t_bytes, t_ops) * 1e3
    step_by = "bytes" if t_bytes >= t_ops else "operations"
    log(f"[mesh] full-width step over 4 shards of cuda:0 (B=64, XW={xw}, "
        f"band={band}, {n_reads} reads, {n_libs} libraries): each shard's "
        f"dirs, last row and diagonal = one forward_antidiag call bit for "
        f"bit, statistics and total_best ({best}) = numpy exactly, "
        f"{launches['bsw_antidiag']} forward launches")
    log(f"[mesh] {card} | step {step_ms:.4f} ms ({cells} band cells, "
        f"{cells / (step_ms * 1e-3) / 1e9:.3f} GCUPS), bound "
        f"{step_bound:.6f} ms ({step_by}), {step_ms / step_bound:.1f}x it; "
        f"its forward over the 4 shards {fwd_ms:.4f} ms against one "
        f"unsharded forward_antidiag call {one_ms:.4f} ms; statistics "
        f"{stats_ms:.4f} ms, bound {stats_bound:.6f} ms (bytes, "
        f"{stats_bytes} B), {stats_ms / stats_bound:.1f}x it; "
        f"torch.bincount triple {bin_ms:.4f} ms (CUDA-event medians of 5)")
    log(f"[mesh] {card} | peak memory: one shard "
        f"{shard_peak / 2**20:.1f} MiB, the step over 4 shards "
        f"{step_peak / 2**20:.1f} MiB (torch.cuda.max_memory_allocated "
        f"above the inputs)")
    res["mesh"] = {"step_ms": step_ms, "step_bound_ms": step_bound,
                   "stats_ms": stats_ms, "stats_bound_ms": stats_bound,
                   "bincount_ms": bin_ms}


def timing_problems(xw, band, B=64, seed=11, fixed=0):
    """B problems of x_size in [0.8 xw, xw) (at most: b is a mutated copy
    of a), or of x_size `fixed` exactly (b topped up with random codes)."""
    rng = np.random.default_rng(seed)
    problems = []
    for _ in range(B):
        n = fixed or int(rng.integers(int(0.8 * xw), xw))
        a = rng.integers(0, 4, size=n + 2 * band).astype(np.uint8)
        b = tp.mutate(rng, a[band:band + n])[:n]
        if fixed:
            b = np.concatenate([b, rng.integers(0, 4, n).astype(np.uint8)])[:n]
        problems.append((a, band, len(a) - 1, b, 0, len(b) - 1, False,
                         False))
    return problems


def cuda_ms(fn, reps=5):
    """(median ms of reps calls after a warm-up, the warm-up's output)."""
    out = fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times), out


def queued_ms(fn, reps=20) -> float:
    """Device ms of one call of a kernel whose launch costs the host more
    than the kernel costs the card: the stream sleeps while the host
    queues two events around `reps` calls, so the card runs them back to
    back and the events see no host gap."""
    fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # ~50 ms: longer than the queueing
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(name, fargs, fe, out, ops_rate) -> tuple[float, str]:
    """The least time the card could take for one call of `name` on these
    inputs: the larger of bytes (each input read once, each output
    written once) over the memory rate and int32 operations over the
    int32 rate.  Cells are the band cells of the problems' own rows
    (x_size x (2*band+1)).  A walk reads one direction word and two
    4-bit codes a step, and writes one edit code a step when it returns
    edits; its steps are the walks' own lengths."""
    a, b, ba, ea, al, xs, fs, band = fargs
    ys = 2 * band + 1
    if name == "bsw_walk":  # out: (summary, edits, last row, diag)
        summary, edits, last_row, diag = out
        steps = int(summary[2].sum())
        n_bytes = (steps * (4 + 1 + (edits is not None))
                   + nbytes(ba, ea, xs, fe, last_row, diag, summary))
        ops = (steps * OPS_PER_WALK_STEP
               + a.shape[0] * 2 * ys * OPS_PER_CANDIDATE)
    else:
        n_bytes = nbytes(a, b, ba, ea, al, xs, fs, *out)
        ops = int(xs.sum()) * ys * OPS_PER_CELL
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / ops_rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_timing(res, card):
    band = 150
    ops_rate = int32_ops_per_s()
    log(f"[timing] int32 rate {ops_rate:.4g} op/s (SMs x 64 x max SM "
        f"clock), memory {HBM_BYTES_PER_S:.3g} B/s")
    for xw in (1024, 4096):
        fargs, fe, xw_b = packed_inputs(timing_problems(xw, band), band)
        if xw_b != xw:
            raise AssertionError(f"timing problems fell in bucket {xw_b}")
        a, b, ba, ea, _al, xs, _fs, _band = fargs
        cells = int(xs.sum()) * (2 * band + 1)  # x_size rows
        t, out, bounds = {}, {}, {}
        errs = {}
        for name, (kern, plain, layout) in FORWARDS.items():
            wname = "bsw_walk" if layout == ANTIDIAG else "bsw_walk_row"
            # the plain versions take seconds: one call each
            t[name], out[name] = cuda_ms(lambda: kern(*fargs))
            out[name + "_plain"] = timed_once(t, name + "_plain",
                                              lambda: plain(*fargs))
            dirs, lr, dg = out[name]
            wargs = (dirs, a, b, ba, ea, xs, fe, lr, dg, band,
                     lmax_of(xw, band), False)
            t[wname], out[wname] = cuda_ms(lambda: walk(*wargs,
                                                        layout=layout))
            out[wname + "_plain"] = timed_once(
                t, wname + "_plain", lambda: walk_torch(*wargs, layout=layout))
            errs[name] = max_err(out[name], out[name + "_plain"])
            errs["bsw_walk"] = max(errs.get("bsw_walk", 0), walk_err(
                out[wname], out[wname + "_plain"]))
            bounds[name] = bound(name, fargs, fe, out[name], ops_rate)
            bounds[wname] = bound("bsw_walk", fargs, fe,
                                  (*out[wname], lr, dg), ops_rate)
        note_err(res, f"[timing] B=64 band={band} XW={xw}", errs)
        # both forwards hold the same cells: their walks agree
        if walk_err(out["bsw_walk"], out["bsw_walk_row"]):
            raise AssertionError(f"[timing] XW={xw}: the walks over the two "
                                 f"forwards' words differ")
        # the serial steps a launch lasts: its longest problem's
        steps = {"bsw_antidiag": int((2 * (xs - 1) + 2 * band + 1).max()),
                 "bsw_row": int(((xs + 15) // 16 * 16).max()),
                 "bsw_walk": int(out["bsw_walk"][0][2].max()),
                 "bsw_walk_row": int(out["bsw_walk_row"][0][2].max())}
        for k, ms in t.items():
            extra = ""
            if k in bounds:
                extra = (f", bound {bounds[k][0]:.6f} ms "
                         f"({bounds[k][1]}), {ms / bounds[k][0]:.1f}x it")
            if k in steps:
                extra += (f", {ms * 1e6 / steps[k]:.1f} ns/step "
                          f"({steps[k]} steps)")
            log(f"[timing] {card} | B=64 band={band} XW={xw} {k}: "
                f"{ms:.4f} ms -> {cells / (ms * 1e-3) / 1e9:.3f} GCUPS"
                + extra)
        res[f"timing_xw{xw}"] = t
        res[f"bound_xw{xw}"] = bounds
    # the row forward at XW 4096: several warps a problem at bands 160,
    # 255, 300, 383, 511, 512 and 700 (four warps of three, four and five
    # lanes a thread, eight of three, four and five, sixteen of three),
    # clusters at 1023, 2000 and 4095 (two blocks of eight warps of four
    # lanes, two of sixteen of four, eight of eight of four); then one
    # warp of ten lanes a thread at band 150 on one 5 Mbp chunk's shape
    for band, xw, fixed in ((160, 4096, 0), (255, 4096, 0), (300, 4096, 0),
                            (383, 4096, 0), (511, 4096, 0), (512, 4096, 0),
                            (700, 4096, 0), (1023, 4096, 0), (2000, 4096, 0),
                            (4095, 4096, 0), (150, 32768, 25000)):
        fargs, _fe, xw_b = packed_inputs(
            timing_problems(xw, band, fixed=fixed), band)
        if xw_b != xw:
            raise AssertionError(f"timing problems fell in bucket {xw_b}")
        xs = fargs[5]
        t = {}
        t["bsw_row"], got = cuda_ms(lambda: forward_row(*fargs))
        want = timed_once(t, "bsw_row_plain", lambda: forward_row_torch(*fargs))
        note_err(res, f"[timing] B=64 band={band} XW={xw}",
                 {row_name(band): max_err(got, want)})
        b_ms, b_by = bound("bsw_row", fargs, None, got, ops_rate)
        steps = int(((xs + 15) // 16 * 16).max())
        cells = int(xs.sum()) * (2 * band + 1)
        ms = t["bsw_row"]
        log(f"[timing] {card} | B=64 band={band} XW={xw} bsw_row: {ms:.4f} "
            f"ms -> {cells / (ms * 1e-3) / 1e9:.3f} GCUPS, bound {b_ms:.6f} "
            f"ms ({b_by}), {ms / b_ms:.1f}x it, {ms * 1e6 / steps:.1f} "
            f"ns/row ({steps} rows); plain {t['bsw_row_plain']:.4f} ms; "
            f"C, W, R = {row_instance(band)}")
        res[f"timing_row_band{band}_xw{xw}"] = (ms, b_ms, b_by,
                                                t["bsw_row_plain"])
    time_wide_walk(res, card, ops_rate)
    time_gather(res, card)


def time_wide_walk(res, card, ops_rate) -> None:
    """The walk over the row forward's words, B=64, XW 4096, at the
    16-row ring's last band and the 3-row ring's first, 2047 and 4095:
    device ms of one call (queued_ms: 20 calls queued behind a sleep, as
    the wrapper's host work is a tenth of the kernel's time) beside one
    call of its plain version (outputs equal bit for bit), its bound and
    ns a step (the longest walk's steps), and its find-max alone (lmax
    0: the kernel stops before the first step), with the ring and the
    word rows the walks crossed."""
    xw = 4096
    for band in (WIDE_RING_BAND - 1, WIDE_RING_BAND, 2047, MAX_BAND):
        fargs, fe, xw_b = packed_inputs(timing_problems(xw, band), band)
        if xw_b != xw:
            raise AssertionError(f"timing problems fell in bucket {xw_b}")
        a, b, ba, ea, _al, xs, _fs, _band = fargs
        dirs, lr, dg = forward_row(*fargs)
        wargs = (dirs, a, b, ba, ea, xs, fe, lr, dg, band,
                 lmax_of(xw, band), False)
        fm_args = (*wargs[:10], 0, False)
        t = {"walk": queued_ms(lambda: walk(*wargs, layout=ROW)),
             "find_max": queued_ms(lambda: walk(*fm_args, layout=ROW))}
        got, fm = walk(*wargs, layout=ROW), walk(*fm_args, layout=ROW)
        want = timed_once(t, "walk_plain",
                          lambda: walk_torch(*wargs, layout=ROW))
        name = walk_name(band, ROW)
        note_err(res, f"[timing] B=64 band={band} XW={xw} walk (row words)",
                 {name: max(walk_err(got, want),
                            walk_err(fm, walk_torch(*fm_args, layout=ROW)))})
        b_ms, b_by = bound("bsw_walk", fargs, fe, (*got, lr, dg), ops_rate)
        summary = got[0]
        steps = int(summary[2].max())
        # word rows the walks crossed: from the find-max's row down to
        # the row they ended in
        live = summary[2] > 0
        crossed = int(((fm[0][0] >> 4) - (summary[0].clamp(min=0) >> 4)
                       + 1)[live].sum())
        rows, slot, _code, warps, shmem = ring_info(band, ROW)
        ms = t["walk"]
        log(f"[timing] {card} | B=64 band={band} XW={xw} {name}: {ms:.4f} "
            f"ms, {ms * 1e6 / steps:.1f} ns/step ({steps} steps), bound "
            f"{b_ms:.6f} ms ({b_by}), {ms / b_ms:.1f}x it (queued); "
            f"find-max alone {t['find_max']:.4f} ms; plain "
            f"{t['walk_plain']:.4f} ms; ring {rows} rows x {4 * slot} B = "
            f"{4 * rows * slot} B a warp, "
            f"{warps} warps and {shmem} B a block; {crossed} word rows "
            f"crossed ({4 * slot * crossed} B)")
        res[f"timing_walk_band{band}_xw{xw}"] = (ms, b_ms, b_by,
                                                 t["walk_plain"])


def ptxas_lines(build_log: str, kernel: str) -> list[str]:
    """ptxas' register and spill lines of the entry points whose mangled
    name holds `kernel`, from one build's nvcc output."""
    out, on = [], False
    for line in build_log.splitlines():
        if "Compiling entry" in line:
            on = kernel in line
        elif on and ("registers" in line or "spill" in line):
            out.append(line.strip())
    return out


def warps_ptxas(build_log: str) -> list[str]:
    """row_warps_kernel's ptxas lines, one an instance: R=.. W=.. C=..:
    registers, then the spill stores and loads."""
    out, inst = [], None
    for line in build_log.splitlines():
        if "Compiling entry" in line:
            inst = re.search(r"row_warps_kernelILi(\d+)ELi(\d+)ELi(\d+)E",
                             line)
            if inst:
                out.append(f"R={inst[1]} W={inst[2]} C={inst[3]}:")
        elif inst and ("registers" in line or "spill" in line):
            out[-1] += " " + line.split(":", 1)[-1].strip()
    return out


def host_us(fn, reps=50) -> float:
    """Median host microseconds of one call, no synchronise inside."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def gather_case(xw, fixed=0, band=150):
    """B=64 timing problems (timing_problems) registered as a sequence
    arena on the card: (the gather's arguments, the host's packed
    windows, the bytes of its bound, (engine, preps, chunk)).  The bound
    counts the windows written, the columns and the arena codes the
    windows hold (each problem's in-range a and b codes), read once."""
    problems = timing_problems(xw, band, fixed=fixed)
    eng = BswEngine(DEV, band=band)
    eng.register_contigs([p[0] for p in problems] + [p[3] for p in problems])
    preps = [_prepare(*p, band) for p in problems]
    for p in preps:
        p.a_arena, p.b_arena = eng._seq_lookup(p.a), eng._seq_lookup(p.b)
    chunk = list(range(len(preps)))
    cols = eng._pack_chunk_arena(chunk, preps, xw)
    aw = a_width(xw, band)
    args = (eng._arena_packed(DEV), *to_dev(cols), band, aw, xw)
    host = eng._pack_chunk(chunk, preps, xw)[:2]
    held = sum(min(p.a_arena[1], p.begin_a - band + p.x_size + 2 * band)
               - max(0, p.begin_a - band) + p.x_size for p in preps)
    n_bytes = cols.shape[1] * (aw + xw) // 2 + cols.nbytes + held // 2
    return args, host, n_bytes, (eng, preps, chunk)


def time_gather(res, card) -> None:
    """gather_windows at B=64, band 150, on one 5 Mbp chunk's shape (XW
    32768, x_size 25000) and at XW 4096: its device time a call
    (queued_ms; the CUDA-event median of one call, which includes the
    launch, beside it) against its bound (bytes: gather_case) and one
    call of its plain version; the host microseconds of one call (no
    synchronise, median of 50); on the chunk shape, the host packing +
    upload of the same chunk (_pack_chunk + _pack4 + three copies to the
    card), the work the arena replaces; and the kernel's ptxas lines."""
    band = 150
    for xw, fixed in ((32768, 25000), (4096, 0)):
        args, host, n_bytes, (eng, preps, chunk) = gather_case(xw, fixed)
        t = {}
        one_ms, got = cuda_ms(lambda: gather_windows(*args))
        t["arena_gather"] = queued_ms(lambda: gather_windows(*args))
        plain = timed_once(t, "arena_gather_plain",
                           lambda: gather_windows_torch(*args))
        note_err(res, f"[timing] arena_gather B=64 XW={xw}",
                 {"arena_gather": max_err(got, plain)})
        if not all(np.array_equal(g.cpu().numpy(), h)
                   for g, h in zip(got, host)):
            raise AssertionError(f"[timing] XW={xw}: the gather's windows "
                                 f"differ from the host's packed windows")
        us = host_us(lambda: gather_windows(*args))
        b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ms = t["arena_gather"]
        extra = ""
        if xw == 32768:
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                a_pk, b_pk, scal = eng._pack_chunk(chunk, preps, xw)
                to_dev(a_pk, b_pk, scal)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            extra = (f"; the host packing + upload it replaces: "
                     f"{statistics.median(times):.4f} ms (host clock, "
                     f"median of 5)")
            res["timing_gather"] = (ms, t["arena_gather_plain"], b_ms)
        log(f"[timing] {card} | B=64 band={band} XW={xw} x_size="
            f"{fixed or 'in [0.8 XW, XW)'} arena_gather: {ms:.4f} ms a call "
            f"on the card (20 calls queued behind a sleep; one call "
            f"between CUDA events, its launch included: {one_ms:.4f} ms, "
            f"median of 5), bound {b_ms:.6f} ms (bytes, {n_bytes} B), "
            f"{ms / b_ms:.1f}x it; host {us:.1f} us a call (median of "
            f"50, no synchronise); plain "
            f"{t['arena_gather_plain']:.4f} ms" + extra)
        res[f"timing_gather_xw{xw}"] = (ms, b_ms, us)
    lines = ptxas_lines(_build.build_log, "arena_gather_kernel")
    log("[timing] arena_gather ptxas: " + ("; ".join(lines) or
        "not built by this process (library found in _build/)"))


def kernels_line(res) -> dict:
    tk = res.get("timing_xw4096", {})
    bd = res.get("bound_xw4096", {})
    launches = res.get("launches", {})
    g_ms, g_plain, g_bound = res.get("timing_gather", (None, None, None))
    w_ms, w_bound, w_by, w_plain = res.get("timing_row_band300_xw4096",
                                           (None,) * 4)
    c_ms, c_bound, c_by, c_plain = res.get("timing_row_band1023_xw4096",
                                           (None,) * 4)
    v_ms, v_bound, v_by, v_plain = res.get("timing_walk_band4095_xw4096",
                                           (None,) * 4)
    tk = {**tk, "arena_gather": g_ms, "arena_gather_plain": g_plain,
          "bsw_row_warps": w_ms, "bsw_row_warps_plain": w_plain,
          "bsw_row_cluster": c_ms, "bsw_row_cluster_plain": c_plain,
          "bsw_walk_wide": v_ms, "bsw_walk_wide_plain": v_plain}
    bd = {**bd, "arena_gather": (g_bound, "bytes" if g_bound else None),
          "bsw_row_warps": (w_bound, w_by),
          "bsw_row_cluster": (c_bound, c_by),
          "bsw_walk_wide": (v_bound, v_by)}
    kern = []
    for name, src, rep, path in (
            ("bsw_antidiag", "gam_ngs_tpu_torch/csrc/bsw_antidiag.cu",
             "gam_ngs_tpu/ops/bsw_pallas.py:542", "antidiag"),
            ("bsw_walk", "gam_ngs_tpu_torch/csrc/bsw_walk.cu",
             "gam_ngs_tpu/ops/bsw_batch.py:383", "antidiag"),
            # the walk over the row form's words on its 3-row ring (bands
            # 1024-4095): its launches from the band 4095 merge, its
            # times at band 4095, XW 4096
            ("bsw_walk_wide", "gam_ngs_tpu_torch/csrc/bsw_walk.cu",
             "gam_ngs_tpu/ops/bsw_batch.py:383", "walk_wide"),
            ("bsw_row", "gam_ngs_tpu_torch/csrc/bsw_row.cu",
             "gam_ngs_tpu/ops/bsw_pallas.py:48", "row"),
            # row_warps_kernel (bands 160-511): its launches from the
            # band 300 and 511 merges, its times at band 300, XW 4096
            ("bsw_row_warps", "gam_ngs_tpu_torch/csrc/bsw_row.cu",
             "gam_ngs_tpu/ops/bsw_pallas.py:48", "row_warps"),
            # row_warps_kernel in clusters (bands 768-4095): its launches
            # from the band 1023 and 4095 merges, its times at band 1023,
            # XW 4096
            ("bsw_row_cluster", "gam_ngs_tpu_torch/csrc/bsw_row.cu",
             "gam_ngs_tpu/ops/bsw_pallas.py:48", "row_cluster"),
            ("arena_gather", "gam_ngs_tpu_torch/csrc/arena_gather.cu",
             "gam_ngs_tpu/ops/bsw_batch.py:866", "arena")):
        b_ms, b_by = bd.get(name, (None, None))
        kern.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep,
                     "launches": launches.get(path, {}).get(name),
                     "max_abs_err": res.get("max_abs_err", {}).get(name),
                     "ms": tk.get(name), "plain_ms": tk.get(name + "_plain"),
                     "bound_ms": b_ms, "bound_by": b_by,
                     # no PyTorch call computes a banded SW fill or walk,
                     # nor the gather with its orientation and sentinels
                     "library_ms": None})
    return {"kernels": kern}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    phases = ap.parse_args().phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    res: dict = {}
    t_all = time.time()
    card = smi("name,power.limit")
    if "header" in phases:
        nvcc = subprocess.run([_build._nvcc(), "--version"],
                              capture_output=True, text=True, check=True)
        log(f"[header] {card}")
        log(f"[header] torch {torch.__version__}, CUDA {torch.version.cuda}"
            f", {torch.cuda.get_device_name(0)} x "
            f"{torch.cuda.device_count()}")
        log(f"[header] nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    t0 = time.time()
    _build.library()
    log(f"[build] kernels built and loaded in {time.time() - t0:.2f} s: "
        f"{os.path.basename(_build.library_path())}")
    for line in _build.build_log.splitlines():
        if "Compiling entry" in line or "registers" in line \
                or "spill" in line:
            log(f"[build] {line.strip()}")
    log("[build] row_warps_kernel<R, W, C> ptxas: " + (
        "; ".join(warps_ptxas(_build.build_log))
        or "not built by this process (library found in _build/)"))
    firsts = [0] + [b for b in tp.row_boundary_bands()
                    if row_instance(b) != row_instance(b - 1)]
    log("[build] bsw_row instances (first band: C, W, R, the most clusters "
        "of it the card runs at once): " + "; ".join(
            f"{b}: {instance_info(b)}" for b in firsts))
    with tempfile.TemporaryDirectory() as tmp:
        if "parity" in phases:
            phase_parity(res)
        if "small" in phases:
            phase_small(tmp)
        if "full" in phases:
            phase_full(tmp, res)
        if "create" in phases:
            phase_create()
        if "dist" in phases:
            phase_dist(tmp, res)
        if "mesh" in phases:
            phase_mesh(res, card)
        if "timing" in phases:
            phase_timing(res, card)
    if "jax" in sys.modules or "gam_ngs_tpu" in sys.modules:
        raise AssertionError("jax or gam_ngs_tpu was imported")
    log(f"[done] {time.time() - t_all:.1f} s")
    print(json.dumps(kernels_line(res)))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
