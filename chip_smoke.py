"""Smoke run of gam_ngs_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py [--phases header,build,parity,small,full,create,dist,
                                    timing]

Phases (all by default; any failure raises and exits non-zero):
  header  card name and power limit (nvidia-smi), torch / CUDA / nvcc
  build   nvcc build of gam_ngs_tpu_torch/csrc/*.cu for sm_90a (one nvcc
          per source, in parallel), with ptxas' register and spill lines
  parity  each kernel against its plain PyTorch version on the card,
          bit for bit (256-problem soak at band 150, band-30 edge cases,
          band 300, ragged buckets of x_size 1 to the window at bands 30
          and 300, find-max ties at bands 30 and 150, band 700 with four
          warps per problem and two row lanes a thread, bands 2000 and
          4000 with four and eight row lanes a thread, row forward
          only): the anti-diagonal forward with the walk over its
          words, the row forward with the walk over row-major words (up
          to band 1023); the row forward and its walk at the first and
          last band of each of its warp instances and at the switches to
          its block kernels (15, 16, 31, 32, ..., 159, 160, 511, 512;
          tests/torch_problems.py::boundary_problems); and the CUDA
          engine against the exact host
          aligner (merge --device oracle's bsw_align) on every soak
          problem: anti-diagonal in lean and edits fetch, kernel="row"
          in lean and edits fetch, and the host traceback, then
          kernel="row" at band 700 and the host traceback at band 2000
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
          of the row path
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
  timing  each kernel with CUDA events (median of 5 after a warm-up)
          beside one call of its plain version, outputs compared bit for
          bit, and the walks over the two forwards' words compared with
          each other: B=64, band 150, XW 1024 / 4096; ms, GCUPS, the
          bound and ns per serial step (the longest problem's steps);
          then the row forward at bands 300, 511, 700 and 2000, XW 4096,
          and at band 150 on one 5 Mbp chunk's shape (XW 32768, x_size
          25000), each with ns a row, bound and multiple

Imports nothing of JAX and nothing of gam_ngs_tpu: the corpora come from
tests/torch_problems.py, the rest from the port.

The kernels' line is printed before the card's line and the last line,
which is {"ok": true, "device": {...}}.  Without a CUDA device the script
exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
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
from gam_ngs_tpu_torch import _build, cli  # noqa: E402
from gam_ngs_tpu_torch.core.stats import isize_stats_psum  # noqa: E402
from gam_ngs_tpu_torch.io import bamlist  # noqa: E402
from gam_ngs_tpu_torch.io import isize as isize_io  # noqa: E402
from gam_ngs_tpu_torch.native.loader import find_blocks_native  # noqa: E402
from gam_ngs_tpu_torch.models.merge import (  # noqa: E402
    MergeOptions,
    run_merge,
)
from gam_ngs_tpu_torch.ops import (  # noqa: E402
    bsw_antidiag,
    bsw_engine,
    bsw_row,
    bsw_walk,
    device_join,
    region_score,
)
from gam_ngs_tpu_torch.ops.bsw_antidiag import (  # noqa: E402
    forward_antidiag,
    forward_antidiag_torch,
)
from gam_ngs_tpu_torch.ops.bsw_engine import BswEngine  # noqa: E402
from gam_ngs_tpu_torch.ops.bsw_row import (  # noqa: E402
    forward_row,
    forward_row_torch,
)
from gam_ngs_tpu_torch.ops.bsw_walk import (  # noqa: E402
    ANTIDIAG,
    ROW,
    walk,
    walk_torch,
)

PHASES = ("header", "build", "parity", "small", "full", "create", "dist",
          "timing")
OUTPUTS = (".gam.fasta", ".pctgs", ".stats", ".noblocks.BF.fasta",
           ".noblocks.AF.fasta", ".notmerged.fasta")
DEV = torch.device("cuda")
# forward kernel name -> (wrapper, plain version, layout of its words)
FORWARDS = {"bsw_antidiag": (forward_antidiag, forward_antidiag_torch,
                             ANTIDIAG),
            "bsw_row": (forward_row, forward_row_torch, ROW)}
KERNELS = ("bsw_antidiag", "bsw_walk", "bsw_row")
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
ANTIDIAG_MAX_BAND = 1023  # ops/bsw_antidiag.py: band + 1 <= 1024 lanes


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


def kernel_vs_plain(name, fargs, fe, lmax, with_edits):
    """A forward kernel against its plain version on one chunk's inputs
    (fargs = the forward's arguments: a, b, begin_a, end_a, a_len,
    x_size, force_start, band) and, unless fe is None, the walk over its
    words against the walk's plain version; both walks read the kernel's
    forward output.  Returns ({kernel: max|kernel - plain|}, {name: ms
    of the one call})."""
    kern, plain, layout = FORWARDS[name]
    a, b, ba, ea, _al, xs, _fs, band = fargs
    ms: dict = {}
    fk = timed_once(ms, name, lambda: kern(*fargs))
    fp = timed_once(ms, name + "_plain", lambda: plain(*fargs))
    errs = {name: max_err(fk, fp)}
    if fe is not None:
        wargs = (fk[0], a, b, ba, ea, xs, fe, fk[1], fk[2], band, lmax,
                 with_edits)
        wk = timed_once(ms, "bsw_walk", lambda: walk(*wargs, layout=layout))
        wp = timed_once(ms, "bsw_walk_plain",
                        lambda: walk_torch(*wargs, layout=layout))
        errs["bsw_walk"] = max_err(wk, wp)
    return errs, ms


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


def note_err(res, label, errs: dict) -> None:
    log(f"{label}: " + ", ".join(f"{k} max|kernel-plain| {v}"
                                 for k, v in errs.items()))
    if any(errs.values()):
        raise AssertionError(f"{label}: kernel != plain version")
    err = res.setdefault("max_abs_err", dict.fromkeys(KERNELS, 0))
    for k, v in errs.items():
        err[k] = max(err[k], v)


def check_engine(problems, want, label, **kw) -> None:
    eng = BswEngine(DEV, **kw)
    n0 = BswEngine.kernel_launches()
    got = eng.align_many(problems)
    torch.cuda.synchronize()
    n1 = BswEngine.kernel_launches()
    bad = [i for i, (g, w) in enumerate(zip(got, want))
           if not tp.same_alignment(g, w)]
    used = {k: n1[k] - n0[k] for k in n1}
    log(f"[parity] engine {label}: {len(problems) - len(bad)}/"
        f"{len(problems)} equal to the oracle (bsw_align) "
        f"({eng.dispatches} dispatches, launches {used})")
    if bad:
        raise AssertionError(f"engine {label} differs on {bad[:10]}")
    row = eng.kernel == "row" or eng.traceback == "host"
    want_used = {"bsw_antidiag": not row, "bsw_row": row,
                 "bsw_walk": eng.traceback == "device"}
    if {k: v > 0 for k, v in used.items()} != want_used:
        raise AssertionError(f"engine {label}: launches {used}")


def phase_parity(res):
    sets = [("soak256_band150", tp.soak_problems(256), 150),
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
            # the walk stages 16 word rows of 2*band+1 lanes in shared
            # memory: it takes the row form's words up to band 1023
            walk_fe = fe if fwd == "bsw_antidiag" or band <= 1023 else None
            for with_edits in (False, True):
                errs, _ms = kernel_vs_plain(fwd, fargs, walk_fe,
                                            lmax_of(xw, band), with_edits)
                note_err(res, f"[parity] {name} {fwd} edits={with_edits}",
                         errs)
                if walk_fe is None:
                    break
    # the row forward at the first and last band of each of its
    # instances, and the walk over its words
    for band in tp.row_boundary_bands():
        fargs, fe, xw = packed_inputs(tp.boundary_problems(band), band)
        errs, _ms = kernel_vs_plain("bsw_row", fargs, fe, lmax_of(xw, band),
                                    True)
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
    expect = {"antidiag": {"bsw_antidiag": True, "bsw_row": False,
                           "bsw_walk": True},
              "row": {"bsw_antidiag": False, "bsw_row": True,
                      "bsw_walk": True},
              "host": {"bsw_antidiag": False, "bsw_row": True,
                       "bsw_walk": False}}
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
            errs["bsw_walk"] = max(errs.get("bsw_walk", 0), max_err(
                out[wname], out[wname + "_plain"]))
            bounds[name] = bound(name, fargs, fe, out[name], ops_rate)
            bounds[wname] = bound("bsw_walk", fargs, fe,
                                  (*out[wname], lr, dg), ops_rate)
        note_err(res, f"[timing] B=64 band={band} XW={xw}", errs)
        # both forwards hold the same cells: their walks agree
        if max_err(out["bsw_walk"], out["bsw_walk_row"]):
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
    # the row forward's block kernels at XW 4096 (one lane a thread at
    # bands 300 and 511, 2 and 4 at 700 and 2000), then its warp kernel
    # (ten lanes a thread at band 150) on one 5 Mbp chunk's shape
    for band, xw, fixed in ((300, 4096, 0), (511, 4096, 0), (700, 4096, 0),
                            (2000, 4096, 0), (150, 32768, 25000)):
        fargs, _fe, xw_b = packed_inputs(
            timing_problems(xw, band, fixed=fixed), band)
        if xw_b != xw:
            raise AssertionError(f"timing problems fell in bucket {xw_b}")
        xs = fargs[5]
        t = {}
        t["bsw_row"], got = cuda_ms(lambda: forward_row(*fargs))
        want = timed_once(t, "bsw_row_plain", lambda: forward_row_torch(*fargs))
        note_err(res, f"[timing] B=64 band={band} XW={xw}",
                 {"bsw_row": max_err(got, want)})
        b_ms, b_by = bound("bsw_row", fargs, None, got, ops_rate)
        steps = int(((xs + 15) // 16 * 16).max())
        cells = int(xs.sum()) * (2 * band + 1)
        ms = t["bsw_row"]
        log(f"[timing] {card} | B=64 band={band} XW={xw} bsw_row: {ms:.4f} "
            f"ms -> {cells / (ms * 1e-3) / 1e9:.3f} GCUPS, bound {b_ms:.6f} "
            f"ms ({b_by}), {ms / b_ms:.1f}x it, {ms * 1e6 / steps:.1f} "
            f"ns/row ({steps} rows); plain {t['bsw_row_plain']:.4f} ms")
        res[f"timing_row_band{band}_xw{xw}"] = (ms, b_ms)


def kernels_line(res) -> dict:
    tk = res.get("timing_xw4096", {})
    bd = res.get("bound_xw4096", {})
    launches = res.get("launches", {})
    kern = []
    for name, src, rep, path in (
            ("bsw_antidiag", "gam_ngs_tpu_torch/csrc/bsw_antidiag.cu",
             "gam_ngs_tpu/ops/bsw_pallas.py:542", "antidiag"),
            ("bsw_walk", "gam_ngs_tpu_torch/csrc/bsw_walk.cu",
             "gam_ngs_tpu/ops/bsw_batch.py:383", "antidiag"),
            ("bsw_row", "gam_ngs_tpu_torch/csrc/bsw_row.cu",
             "gam_ngs_tpu/ops/bsw_pallas.py:48", "row")):
        b_ms, b_by = bd.get(name, (None, None))
        kern.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep,
                     "launches": launches.get(path, {}).get(name),
                     "max_abs_err": res.get("max_abs_err", {}).get(name),
                     "ms": tk.get(name), "plain_ms": tk.get(name + "_plain"),
                     "bound_ms": b_ms, "bound_by": b_by,
                     # no PyTorch call computes a banded SW fill or walk
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
