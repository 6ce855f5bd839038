"""Time this tree's anti-diagonal forward and walk kernels (or, with
--row, its row-form forward; with --walk, its walk over both forwards'
words; with --gather, its arena window gather) against another
version's, on one CUDA GPU, in turns.

    python3 tools/kernel_ab.py --base DIR [--row] [--reps 5] [--out FILE]
    python3 tools/kernel_ab.py --base DIR --batches 1,8,16,64 [--out FILE]
    python3 tools/kernel_ab.py --walk DIR [--bands 1023] [--out FILE]
    python3 tools/kernel_ab.py --gather DIR [--out FILE]
    python3 tools/kernel_ab.py --floor [--out FILE]
    python3 tools/kernel_ab.py --sass DIR

DIR holds the other version's bsw_antidiag.cu and bsw_walk.cu (for
example `git show <commit>:gam_ngs_tpu_torch/csrc/bsw_antidiag.cu` into
`_ab_base/`, which .gitignore lists);
their C entry points must take the arguments this tree's take.  Both
are built with gam_ngs_tpu_torch._build's nvcc flags (ptxas lines
printed).  Shapes: B=64 problems at band 150 in windows XW 1024 and
4096 (x_size drawn in [0.8 XW, XW), as in chip_smoke.py's timing)
and XW 32768 with x_size 25000 (one chunk of the 5 Mbp merge).  Each
kernel is timed base, this, this, base: CUDA events around `reps`
launches after a warm-up, the median launch of each turn.  The walks'
summaries and the forwards' last rows are held equal between the two
versions (both hold the same valid cells).  Beside each time it prints
the kernel's bound on these inputs, chip_smoke.py's `bound` (int32
operations from the recurrence, or bytes), and the multiple.  Prints
one line a shape and kernel, and one JSON object last.

--batches B1,B2,...: the forward alone on the tail rounds' shapes: B
problems (each listed batch) at band 150 (or each of --bands) in
windows XW 4096 (x_size in [0.8 XW, XW)), and at band 150 in XW 98304
(x_size 90,000, the longest windows of gage-rsph.align; batches up to
--tail-max, default 64), timed DIR's forward ("base"), this tree's as
its launcher picks ("this"), and this tree's every instance that covers
the band, whatever the launcher would pick ("W1R5": one warp a problem,
five lanes a thread; "W4R2": the split instance of four warps), built
from this tree's source with an entry point added that launches a named
instance; in turns, forward then back; all outputs held equal bit for
bit; each time with ns an anti-diagonal of the longest problem, bound
and multiple, and the instance (W, R) the launcher takes.

--row: DIR holds the other version's bsw_row.cu (same C entry point);
both row forwards run B=64 problems at band 150 in windows XW 1024, 4096
and 32768 (x_size 25000), and at bands 300 and 511 (--bands) in XW
4096, timed base, this, this, base, their outputs held equal bit for
bit; each time with its ns a row (the longest problem's rows), bound
and multiple, and this tree's instance (C, W, R) at the band.

--walk DIR (instead of --base): DIR holds the other version's
bsw_walk.cu (same C entry point).  Both walks run, without edit codes,
over this tree's forward words of B=64 problems in windows XW 4096: the
anti-diagonal forward's at band 150 and the row forward's at band 150
and at each band of --bands (default 1023), each on two kinds of pairs:
"random", the mutated copies above (3% substitutions, 1.2% insertions,
1.2% deletions), and "near", near-identical copies (0.1 substitutions
and 0.02 indels a kbp, as block windows), timed base, this, this,
base, their summaries' answer rows held equal; each time with its ns a
step (the longest walk's steps), bound and multiple, this tree's
iterations over its steps (all problems), and this tree's ring (rows,
warps a block, shared memory a block).  A band the other version's
launcher refuses is timed for this tree's alone.

--sass DIR: for each CUDA source in DIR and this tree's source of the
same name, each kernel's SASS (nvcc -cubin with _build's flags, then
cuobjdump -sass): its instruction count and a hash of its instructions
without addresses and encodings, so that a kernel whose device code did
not change shows the same count and hash in both, whatever its name.

--floor: the floor of a row of the row forward's cluster instances,
tools/cluster_floor.cu: B=64 problems of 4096 rows that do only the
exchange between the warps of a problem (eight warps a block; one block
with __syncthreads, or clusters of C = 2, 4, 8 blocks: pushing their
totals into the later ranks before the cluster barrier, pulling them
from the earlier ranks after it, pushing with a relaxed arrive behind
the writers' fence, or pushing with an arrive on the receiver's
mbarrier and no cluster barrier), timed C=1, then push, pull, relaxed,
mbarrier and back at each C; ms a launch and ns a row.

--gather DIR (instead of --base): DIR holds the other version's
arena_gather.cu (same C entry point) and, optionally, its
arena_gather.py wrapper.  Both gathers run B=64 problems at band 150
registered as a sequence arena (chip_smoke.py's gather_case) on one
5 Mbp chunk's shape (XW 32768, x_size 25000), at XW 4096 and at XW 128
(a few KB: what one queued launch costs at least), their bytes
held equal to each other and to the host's packed windows, timed base,
this, this, base, each turn the median of 3 chip_smoke.queued_ms runs
(20 calls queued behind a sleep), beside the bound and each multiple;
then the host microseconds of one wrapper call (no synchronise, median
of 50; DIR's wrapper only when DIR has one), and two torch.empty against
one torch.empty cut into two views, in turns, for the outputs.

Imports nothing of JAX and nothing of gam_ngs_tpu.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
import torch_problems as tp  # noqa: E402
from gam_ngs_tpu_torch import _build  # noqa: E402
from gam_ngs_tpu_torch.ops.bsw_antidiag import (  # noqa: E402
    MATCH_S,
    MISMATCH_S,
    NN_S,
    NX_S,
    antidiag_dims,
)
from gam_ngs_tpu_torch.ops.bsw_ref import FORCE_MAXGAP_LEN, GAP  # noqa: E402
from gam_ngs_tpu_torch.ops.bsw_walk import ANSWER_ROWS, ITERS  # noqa: E402

BAND = 150
DEV = torch.device("cuda")


def build(srcs: list[str], tmp: str) -> tuple[ctypes.CDLL, str]:
    """nvcc each source with _build's flags, link, load: (lib, log)."""
    nvcc = _build._nvcc()
    objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in srcs]
    log = ""
    for src, obj in zip(srcs, objs):
        r = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-c", src, "-o", obj],
                           capture_output=True, text=True)
        log += r.stdout + r.stderr
        if r.returncode:
            raise RuntimeError(f"nvcc {src} failed:\n{log}")
    so = os.path.join(tmp, "libbase.so")
    subprocess.run([nvcc, "-shared", "-o", so, *objs], check=True)
    return ctypes.CDLL(so), log


def entry_points(lib):
    fwd, wlk = lib.bsw_antidiag_forward, lib.bsw_walk
    fwd.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 12
                    + [ctypes.c_void_p] * 4)
    wlk.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                    + [ctypes.c_void_p] * 3)
    fwd.restype = wlk.restype = ctypes.c_int
    return fwd, wlk


# tp.mutate's rates: "random" pairs; "near" ones, as block windows
PAIRS = {"random": {}, "near": {"sub": 1e-4, "ins": 1e-5, "dele": 1e-5}}


def problems(xw: int, B: int = 64, seed: int = 11, fixed: int = 0,
             band: int = BAND, pairs: str = "random"):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(B):
        n = fixed or int(rng.integers(int(0.8 * xw), xw))
        a = rng.integers(0, 4, size=n + 2 * band).astype(np.uint8)
        b = tp.mutate(rng, a[band:band + n], **PAIRS[pairs])
        b = np.concatenate([b, rng.integers(0, 4, n).astype(np.uint8)])[:n]
        out.append((a, band, len(a) - 1, b, 0, n - 1, False, False))
    return out


class Shape:
    """One packed batch on the card and the calls of both entry points."""

    def __init__(self, probs, band: int = BAND):
        a_pk, b_pk, scal, _preps, self.xw = tp.pack_problems(probs, band)
        self.a, self.b, s = (torch.from_numpy(np.ascontiguousarray(v)).to(DEV)
                             for v in (a_pk, b_pk, scal))
        self.ba, self.ea, self.al, self.xs, self.fs, self.fe = s.unbind(0)
        self.B = self.a.shape[0]
        self.band = band
        self.K, self.T, self.NP, _ = antidiag_dims(self.xw, band)
        self.lmax = -(-(2 * self.xw + 2 * band + 8) // 4) * 4
        self.stream = torch.cuda.current_stream().cuda_stream

    def forward(self, fn):
        dirs = torch.empty((self.B, self.NP, self.K), dtype=torch.int32,
                           device=DEV)
        lr = torch.empty((self.B, 2 * self.band + 1), dtype=torch.int32,
                         device=DEV)
        dg = torch.empty_like(lr)
        err = fn(*(v.data_ptr() for v in (self.a, self.b, self.ba, self.ea,
                                          self.al, self.xs, self.fs)),
                 self.B, 2 * self.a.shape[1], self.xw, self.band, self.T,
                 self.NP,
                 MATCH_S, MISMATCH_S, NN_S, NX_S, GAP, FORCE_MAXGAP_LEN,
                 dirs.data_ptr(), lr.data_ptr(), dg.data_ptr(), self.stream)
        if err:
            raise RuntimeError(f"forward launch: CUDA error {err}")
        return dirs, lr, dg

    def walk(self, fn, fwd_out):
        dirs, lr, dg = fwd_out
        summary = torch.empty((ANSWER_ROWS + 1, self.B), dtype=torch.int32,
                              device=DEV)
        err = fn(*(v.data_ptr() for v in (dirs, self.a, self.b, self.ba,
                                          self.ea, self.xs, self.fe, lr,
                                          dg)),
                 self.B, 2 * self.a.shape[1], self.xw, self.band, self.NP,
                 self.lmax, FORCE_MAXGAP_LEN, 0, summary.data_ptr(), None,
                 self.stream)
        if err:
            raise RuntimeError(f"walk launch: CUDA error {err}")
        return summary


# Added to this tree's bsw_antidiag.cu for --batches: launch a named
# instance, and the narrowest R of W warps (split or not) at a band.
FORCED_ENTRY = """
extern "C" int bsw_antidiag_forward_as(
    int R, int W, int halo, const void* a_pk, const void* b_pk,
    const void* begin_a, const void* end_a, const void* a_len,
    const void* x_size, const void* force_start, int B, int aw, int xw,
    int band, int T, int NP, int match, int mismatch, int nn, int nx,
    int gap, int force_max_gap, void* dirs, void* last_row, void* diag,
    void* stream) {
  const Scoring s{match, mismatch, nn, nx, gap, force_max_gap};
  const int lo = min(min(match, mismatch), min(nn, nx));
  return launch_instance(Instance{R, W, halo != 0}, a_pk, b_pk, begin_a,
                         end_a, a_len, x_size, force_start, B, aw, xw, band,
                         T, NP, s, lo, dirs, last_row, diag,
                         (cudaStream_t)stream);
}
extern "C" int bsw_antidiag_narrowest(int band, int W, int halo) {
  return narrowest(band + 1, W, halo != 0).R;
}
"""


def tail_ab(base_dir: str, reps: int, card: str, ops_rate: float,
            batches: list[int], tail_max: int, bands: list[int]) -> dict:
    """The forward on the tail rounds' shapes: DIR's, this tree's as its
    launcher picks, and this tree's every instance at each band."""
    from gam_ngs_tpu_torch.ops import bsw_antidiag

    this = entry_points(_build.library())[0]
    res = {"card": card, "shapes": {}}
    with tempfile.TemporaryDirectory() as tmp:
        forced_src = os.path.join(tmp, "bsw_antidiag_forced.cu")
        with open(os.path.join(_build.CSRC, "bsw_antidiag.cu")) as fh:
            text = fh.read()
        with open(forced_src, "w") as fh:
            fh.write(text + FORCED_ENTRY)
        libs = {}
        for name, src in (("base", os.path.join(base_dir, "bsw_antidiag.cu")),
                          ("forced", forced_src)):
            os.makedirs(os.path.join(tmp, name))
            libs[name], log = build([src], os.path.join(tmp, name))
            for line in chip_smoke.ptxas_lines(log,
                                               "antidiag_forward_kernel"):
                print(f"[{name}] {line}")
        base = libs["base"].bsw_antidiag_forward
        base.argtypes, base.restype = this.argtypes, this.restype
        as_fn = libs["forced"].bsw_antidiag_forward_as
        as_fn.argtypes = [ctypes.c_int] * 3 + this.argtypes
        as_fn.restype = ctypes.c_int
        narrowest = libs["forced"].bsw_antidiag_narrowest
        narrowest.argtypes = [ctypes.c_int] * 3
        narrowest.restype = ctypes.c_int
        for band in bands:
            fns = {"base": base, "this": this}
            for w in (1, 4):
                r = narrowest(band, w, int(w > 1))
                if r:
                    fns[f"W{w}R{r}"] = (lambda *a, r=r, w=w:
                                        as_fn(r, w, int(w > 1), *a))
            for xw, fixed in ((4096, 0), (98304, 90000)):
                bs = [b for b in batches
                      if xw == 4096 or (b <= tail_max and band == BAND)]
                if not bs:
                    continue
                probs = problems(xw, B=max(bs), fixed=fixed, band=band)
                for B in bs:
                    res["shapes"][f"band{band}_B{B}_xw{xw}"] = tail_shape(
                        Shape(probs[:B], band), fns, reps, card, ops_rate,
                        bsw_antidiag.instance(band, B))
    return res


def tail_shape(sh, fns, reps, card, ops_rate, inst) -> dict:
    """One shape of tail_ab: every version's outputs held equal to this
    tree's, then each timed in turns."""
    outs = {v: sh.forward(fn) for v, fn in fns.items()}
    torch.cuda.synchronize()
    for v, out in outs.items():
        if not all(torch.equal(x, y) for x, y in zip(out, outs["this"])):
            raise AssertionError(f"B={sh.B} band={sh.band} XW={sh.xw}: "
                                 f"{v}'s outputs differ from this tree's")
    fargs = (sh.a, sh.b, sh.ba, sh.ea, sh.al, sh.xs, sh.fs, sh.band)
    b_ms, b_by = chip_smoke.bound("bsw_antidiag", fargs, sh.fe,
                                  outs["this"], ops_rate)
    del outs
    n = int((2 * (sh.xs - 1) + 2 * sh.band + 1).max())
    ms: dict = {}
    order = list(fns)
    for turn in order + order[::-1]:
        ms.setdefault(turn, []).append(
            launch_ms(lambda: sh.forward(fns[turn]), reps))
    for turn, v in ms.items():
        print(f"[tail] {card} | B={sh.B} band={sh.band} XW={sh.xw} "
              f"bsw_antidiag_{turn}: ms {', '.join(f'{t:.4f}' for t in v)}; "
              f"{statistics.mean(v) * 1e6 / n:.1f} ns/step over {n} steps; "
              f"bound {b_ms:.6f} ms ({b_by}), "
              f"{statistics.mean(v) / b_ms:.1f}x it; this: W, R = {inst}",
              flush=True)
    return {"ms": ms, "steps": n, "bound_ms": b_ms, "bound_by": b_by,
            "instance": inst}


def row_ab(base_dir: str, reps: int, card: str, ops_rate: float,
           bands: list[int]) -> dict:
    """This tree's bsw_row_forward against DIR's, in turns."""
    from gam_ngs_tpu_torch.ops import bsw_row

    this = bsw_row._kernel()
    with tempfile.TemporaryDirectory() as tmp:
        lib, log = build([os.path.join(base_dir, "bsw_row.cu")], tmp)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[base] {line.strip()}")
        base = lib.bsw_row_forward
        base.argtypes, base.restype = this.argtypes, this.restype
        res = {"card": card, "shapes": {}}
        for band, xw, fixed in ((BAND, 1024, 0), (BAND, 4096, 0),
                                (BAND, 32768, 25000),
                                *((b, 4096, 0) for b in bands)):
            sh = Shape(problems(xw, fixed=fixed, band=band), band)
            ys = 2 * band + 1

            def run(fn):
                out = [torch.zeros(shape, dtype=torch.int32, device=DEV)
                       for shape in ((sh.B, sh.xw // 16, ys), (sh.B, ys),
                                     (sh.B, ys))]
                err = fn(*(v.data_ptr() for v in (
                    sh.a, sh.b, sh.ba, sh.ea, sh.al, sh.xs, sh.fs)), sh.B,
                    2 * sh.a.shape[1], sh.xw, band, MATCH_S, MISMATCH_S,
                    NN_S, NX_S, GAP, FORCE_MAXGAP_LEN, bsw_row.NEG,
                    *(v.data_ptr() for v in out), sh.stream)
                if err:
                    raise RuntimeError(f"bsw_row launch: CUDA error {err}")
                return out

            outs = {"base": run(base), "this": run(this)}
            torch.cuda.synchronize()
            if any(not torch.equal(x, y)
                   for x, y in zip(outs["base"], outs["this"])):
                raise AssertionError(f"band {band} XW {xw}: the row "
                                     f"forwards disagree")
            fargs = (sh.a, sh.b, sh.ba, sh.ea, sh.al, sh.xs, sh.fs, band)
            b_ms, b_by = chip_smoke.bound("bsw_row", fargs, None,
                                          outs["this"], ops_rate)
            inst = bsw_row.instance_info(band)
            n = int(((sh.xs + 15) // 16 * 16).max())
            ms: dict = {}
            for turn in ("base", "this", "this", "base"):
                fn = base if turn == "base" else this
                ms.setdefault(turn, []).append(
                    launch_ms(lambda: run(fn), reps))
            for turn, v in ms.items():
                print(f"[ab] {card} | B={sh.B} band={band} XW={xw} "
                      f"bsw_row_{turn}: ms {', '.join(f'{t:.4f}' for t in v)}"
                      f"; {statistics.mean(v) * 1e6 / n:.1f} ns/row over {n} "
                      f"rows; bound {b_ms:.6f} ms ({b_by}), "
                      f"{statistics.mean(v) / b_ms:.1f}x it; this: C, W, R "
                      f"= {inst[:3]}, {inst[3]} clusters at once",
                      flush=True)
            res["shapes"][f"band{band}_xw{xw}"] = {
                "ms": ms, "rows": n, "bound_ms": b_ms, "bound_by": b_by,
                "instance": inst}
    return res


def walk_ab(base_dir: str, reps: int, card: str, ops_rate: float,
            bands: list[int]) -> dict:
    """This tree's bsw_walk against DIR's, in turns, over this tree's
    forward words."""
    from gam_ngs_tpu_torch.ops import bsw_walk
    from gam_ngs_tpu_torch.ops.bsw_antidiag import forward_antidiag
    from gam_ngs_tpu_torch.ops.bsw_row import forward_row

    this = bsw_walk._kernel()
    xw = 4096
    with tempfile.TemporaryDirectory() as tmp:
        lib, log = build([os.path.join(base_dir, "bsw_walk.cu")], tmp)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[base] {line.strip()}")
        base = lib.bsw_walk
        base.argtypes, base.restype = this.argtypes, this.restype
        res = {"card": card, "shapes": {}}
        for layout, band, pairs in (
                (layout, band, pairs) for layout, band in (
                    (bsw_walk.ANTIDIAG, BAND), (bsw_walk.ROW, BAND),
                    *((bsw_walk.ROW, b) for b in bands))
                for pairs in PAIRS):
            sh = Shape(problems(xw, band=band, pairs=pairs), band)
            fargs = (sh.a, sh.b, sh.ba, sh.ea, sh.al, sh.xs, sh.fs, band)
            fwd = forward_row if layout == bsw_walk.ROW else forward_antidiag
            dirs, lr, dg = fwd(*fargs)
            lmax = -(-(2 * xw + 2 * band + 8) // 4) * 4

            def run(fn):
                summary = torch.empty((ANSWER_ROWS + 1, sh.B),
                                      dtype=torch.int32, device=DEV)
                err = fn(*(v.data_ptr() for v in (dirs, sh.a, sh.b, sh.ba,
                                                  sh.ea, sh.xs, sh.fe, lr,
                                                  dg)),
                         sh.B, 2 * sh.a.shape[1], xw, band, dirs.shape[1],
                         lmax, FORCE_MAXGAP_LEN, layout, summary.data_ptr(),
                         None, sh.stream)
                if err:
                    raise RuntimeError(f"CUDA error {err}")
                return summary

            fns = {"this": this}
            want = run(this)
            try:
                got = run(base)
                fns["base"] = base
            except RuntimeError as e:
                print(f"[ab] {card} | layout={layout} band={band}: the base "
                      f"walk's launcher refuses it ({e})", flush=True)
            torch.cuda.synchronize()
            if "base" in fns and not torch.equal(got[:ANSWER_ROWS],
                                                 want[:ANSWER_ROWS]):
                raise AssertionError(f"layout {layout} band {band}: the "
                                     f"walks disagree")
            b_ms, b_by = chip_smoke.bound("bsw_walk", fargs, sh.fe,
                                          (want, None, lr, dg), ops_rate)
            n = int(want[2].max())
            iters, steps = int(want[ITERS].sum()), int(want[2].sum())
            rows, _slot, _code, warps, shmem = bsw_walk.ring_info(band,
                                                                  layout)
            ms: dict = {}
            for turn in ("base", "this", "this", "base"):
                if turn in fns:
                    ms.setdefault(turn, []).append(
                        launch_ms(lambda: run(fns[turn]), reps))
            for turn, v in ms.items():
                print(f"[ab] {card} | B={sh.B} layout={layout} band={band} "
                      f"XW={xw} {pairs} pairs bsw_walk_{turn}: ms "
                      f"{', '.join(f'{t:.4f}' for t in v)}; "
                      f"{statistics.mean(v) * 1e6 / n:.1f} ns/step over {n} "
                      f"steps; bound {b_ms:.6f} ms ({b_by}), "
                      f"{statistics.mean(v) / b_ms:.1f}x it; this: {iters} "
                      f"iterations for {steps} steps, {rows}-row "
                      f"ring, {warps} warps and {shmem} B a block",
                      flush=True)
            res["shapes"][f"layout{layout}_band{band}_xw{xw}_{pairs}"] = {
                "ms": ms, "steps": n, "bound_ms": b_ms, "bound_by": b_by,
                "iters": iters, "all_steps": steps,
                "ring": [rows, warps, shmem]}
    return res


def gather_ab(base_dir: str, card: str) -> dict:
    """This tree's arena_gather against DIR's, in turns."""
    import importlib.util

    from gam_ngs_tpu_torch.ops import arena_gather

    this = arena_gather._kernel()
    for line in chip_smoke.ptxas_lines(_build.build_log,
                                       "arena_gather_kernel"):
        print(f"[this] {line}")
    res = {"card": card, "shapes": {}}
    with tempfile.TemporaryDirectory() as tmp:
        lib, log = build([os.path.join(base_dir, "arena_gather.cu")], tmp)
        for line in chip_smoke.ptxas_lines(log, "arena_gather_kernel"):
            print(f"[base] {line}")
        base = lib.arena_gather
        base.argtypes, base.restype = this.argtypes, this.restype
        wrappers = {"this": arena_gather.gather_windows}
        base_py = os.path.join(base_dir, "arena_gather.py")
        if os.path.exists(base_py):
            spec = importlib.util.spec_from_file_location("_ab_base_gather",
                                                          base_py)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            mod._fn = base  # its _kernel() returns this, builds nothing
            wrappers["base"] = mod.gather_windows
        for xw, fixed in ((32768, 25000), (4096, 0), (128, 0)):
            args, host, n_bytes, _ctx = chip_smoke.gather_case(xw, fixed)
            arena, cols, band, aw, _xw = args
            B = cols.shape[1]
            stream = torch.cuda.current_stream().cuda_stream

            def run(fn):
                a_pk = torch.empty((B, aw // 2), dtype=torch.uint8,
                                   device=DEV)
                b_pk = torch.empty((B, xw // 2), dtype=torch.uint8,
                                   device=DEV)
                err = fn(arena.data_ptr(), 2 * arena.numel(),
                         cols.data_ptr(), B, band, aw // 2, xw // 2,
                         a_pk.data_ptr(), b_pk.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"arena_gather: CUDA error {err}")
                return a_pk, b_pk

            for turn, fn in (("base", base), ("this", this)):
                got = run(fn)
                if not all(np.array_equal(g.cpu().numpy(), h)
                           for g, h in zip(got, host)):
                    raise AssertionError(f"XW {xw}: the {turn} gather's "
                                         f"windows differ from the host's")
            b_ms = n_bytes / chip_smoke.HBM_BYTES_PER_S * 1e3
            ms: dict = {}
            for turn in ("base", "this", "this", "base"):
                fn = base if turn == "base" else this
                ms.setdefault(turn, []).append(statistics.median(
                    chip_smoke.queued_ms(lambda: run(fn)) for _ in range(3)))
            us: dict = {}
            for turn in ("base", "this", "this", "base"):
                if turn in wrappers:
                    us.setdefault(turn, []).append(chip_smoke.host_us(
                        lambda: wrappers[turn](*args)))
            alloc: dict = {}
            n_a = B * aw // 2

            def two():
                return (torch.empty((B, aw // 2), dtype=torch.uint8,
                                    device=DEV),
                        torch.empty((B, xw // 2), dtype=torch.uint8,
                                    device=DEV))

            def one():
                buf = torch.empty(B * (aw + xw) // 2, dtype=torch.uint8,
                                  device=DEV)
                return buf[:n_a].view(B, aw // 2), buf[n_a:].view(B, xw // 2)

            for turn in ("two", "one", "one", "two"):
                alloc.setdefault(turn, []).append(chip_smoke.host_us(
                    two if turn == "two" else one))
            def fmt(v, spec):
                return ", ".join(format(t, spec) for t in v) or "not timed"

            for turn, v in ms.items():
                print(f"[ab] {card} | B={B} band={band} XW={xw} "
                      f"arena_gather_{turn}: queued ms {fmt(v, '.5f')}; "
                      f"bound {b_ms:.6f} ms (bytes, {n_bytes} B), "
                      f"{statistics.mean(v) / b_ms:.2f}x it; wrapper host "
                      f"us {fmt(us.get(turn, []), '.1f')}", flush=True)
            print(f"[ab] {card} | XW={xw} output allocation host us: two "
                  f"torch.empty {fmt(alloc['two'], '.1f')}; one "
                  f"torch.empty + two views {fmt(alloc['one'], '.1f')}",
                  flush=True)
            res["shapes"][str(xw)] = {"ms": ms, "bound_ms": b_ms,
                                      "bytes": n_bytes, "host_us": us,
                                      "alloc_us": alloc}
    return res


def floor_ab(card: str, reps: int, B: int = 64, rows: int = 4096) -> dict:
    """tools/cluster_floor.cu's exchange loop at C = 1, 2, 4, 8."""
    res = {"card": card, "B": B, "rows": rows, "ms": {}}
    with tempfile.TemporaryDirectory() as tmp:
        lib, log = build([os.path.join(ROOT, "tools", "cluster_floor.cu")],
                         tmp)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[floor] {line.strip()}")
        fn = lib.cluster_floor
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        out = torch.empty(B * 8 * 256, dtype=torch.int32, device=DEV)
        stream = torch.cuda.current_stream().cuda_stream

        modes = {"block": 1, "pull": 0, "push": 1, "relaxed": 2, "mbarrier": 3}

        def run(c, mode):
            err = fn(c, modes[mode], B, rows, out.data_ptr(), stream)
            if err:
                raise RuntimeError(f"cluster_floor C={c} {mode}: CUDA "
                                   f"error {err}")

        turns = ("push", "pull", "relaxed", "mbarrier")
        for c, mode in [(1, "block")] + [(c, m) for c in (2, 4, 8)
                                         for m in turns + turns[::-1]]:
            ms = launch_ms(lambda: run(c, mode), reps)
            res["ms"].setdefault(f"C{c}_{mode}", []).append(ms)
            print(f"[floor] {card} | B={B} rows={rows} C={c} {mode}: "
                  f"{ms:.4f} ms, {ms * 1e6 / rows:.1f} ns/row", flush=True)
    return res


def sass_ab(base_dir: str) -> dict:
    """Each kernel's SASS instruction count and hash, this tree's and
    DIR's, for every source DIR holds."""
    import glob
    import hashlib

    nvcc = _build._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for src in sorted(glob.glob(os.path.join(base_dir, "*.cu"))):
            name = os.path.basename(src)
            for tree, path in (("this", os.path.join(_build.CSRC, name)),
                               ("base", src)):
                cubin = os.path.join(tmp, f"{tree}_{name}.cubin")
                subprocess.run([nvcc, *flags, "-cubin", path, "-o", cubin],
                               check=True)
                text = subprocess.run([cuobjdump, "-sass", cubin],
                                      capture_output=True, text=True,
                                      check=True).stdout
                funcs: dict[str, list[str]] = {}
                fn = None
                for line in text.splitlines():
                    head = line.split("Function : ")
                    if len(head) == 2:
                        fn = head[1].strip()
                        funcs[fn] = []
                    elif fn is not None and "/*" in line:
                        # the instruction, without its address and its
                        # encoding comments
                        ins = line.split("/*")[1].split("*/", 1)[1]
                        ins = ins.split("/*")[0].strip()
                        if ins:
                            funcs[fn].append(ins)
                for fn, ins in funcs.items():
                    h = hashlib.sha256("\n".join(ins).encode()).hexdigest()
                    res.setdefault(name, {}).setdefault(tree, {})[fn] = (
                        len(ins), h[:16])
                    print(f"[sass] {name} {tree}: {len(ins)} instructions, "
                          f"hash {h[:16]}: {fn}", flush=True)
    return res


def launch_ms(fn, reps: int) -> float:
    fn()  # warm-up
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--base", help="DIR of bsw_antidiag.cu, bsw_walk.cu "
                      "(or bsw_row.cu with --row)")
    mode.add_argument("--walk", help="DIR of bsw_walk.cu")
    mode.add_argument("--gather", help="DIR of arena_gather.cu (and, "
                      "optionally, arena_gather.py)")
    mode.add_argument("--sass", help="DIR of CUDA sources whose kernels' "
                      "SASS is compared with this tree's")
    mode.add_argument("--floor", action="store_true",
                      help="time tools/cluster_floor.cu's exchange loop")
    ap.add_argument("--row", action="store_true",
                    help="time the row-form forward (DIR/bsw_row.cu)")
    ap.add_argument("--bands", default=None,
                    help="the bands timed at XW 4096 besides 150 (--row: "
                    "default 300,511; --walk: default 1023); with "
                    "--batches, the bands timed (default 150)")
    ap.add_argument("--batches", default=None,
                    help="with --base: the forward alone at these batch "
                    "sizes on the tail rounds' shapes")
    ap.add_argument("--tail-max", type=int, default=64,
                    help="the largest batch timed at XW 98304")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.sass:
        print(json.dumps(sass_ab(args.sass)))
        return 0
    if not torch.cuda.is_available():
        print("kernel_ab: torch sees no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    if args.floor:
        line = json.dumps(floor_ab(card, args.reps))
        if args.out:
            with open(args.out, "w") as fh:
                fh.write(line + "\n")
        print(line)
        return 0
    if args.gather:
        _build.library()
        line = json.dumps(gather_ab(args.gather, card))
        if args.out:
            with open(args.out, "w") as fh:
                fh.write(line + "\n")
        print(line)
        return 0
    ops_rate = chip_smoke.int32_ops_per_s()
    if args.walk:
        _build.library()
        line = json.dumps(walk_ab(args.walk, args.reps, card, ops_rate,
                                  [int(b) for b in (args.bands
                                                    or "1023").split(",")]))
        if args.out:
            with open(args.out, "w") as fh:
                fh.write(line + "\n")
        print(line)
        return 0
    if args.row:
        _build.library()
        for line in _build.build_log.splitlines():
            if "bsw_row_cu" in line or "registers" in line \
                    or "spill" in line:
                print(f"[this] {line.strip()}")
        line = json.dumps(row_ab(args.base, args.reps, card, ops_rate,
                                 [int(b) for b in (args.bands
                                                   or "300,511").split(",")]))
        if args.out:
            with open(args.out, "w") as fh:
                fh.write(line + "\n")
        print(line)
        return 0
    this = entry_points(_build.library())
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[this] {line.strip()}")
    if args.batches:
        line = json.dumps(tail_ab(
            args.base, args.reps, card, ops_rate,
            [int(b) for b in args.batches.split(",")], args.tail_max,
            [int(b) for b in (args.bands or str(BAND)).split(",")]))
        if args.out:
            with open(args.out, "w") as fh:
                fh.write(line + "\n")
        print(line)
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        lib, log = build([os.path.join(args.base, n)
                          for n in ("bsw_antidiag.cu", "bsw_walk.cu")], tmp)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[base] {line.strip()}")
        base = entry_points(lib)
        res = {"card": card, "shapes": {}}
        for xw, fixed in ((1024, 0), (4096, 0), (32768, 25000)):
            sh = Shape(problems(xw, fixed=fixed))
            outs = {v: sh.forward(fns[0]) for v, fns in
                    (("base", base), ("this", this))}
            sums = {v: sh.walk(fns[1], outs[v]) for v, fns in
                    (("base", base), ("this", this))}
            torch.cuda.synchronize()
            if not torch.equal(sums["base"][:ANSWER_ROWS],
                               sums["this"][:ANSWER_ROWS]) or \
                    not torch.equal(outs["base"][1], outs["this"][1]):
                raise AssertionError(f"XW {xw}: the versions disagree")
            fargs = (sh.a, sh.b, sh.ba, sh.ea, sh.al, sh.xs, sh.fs, BAND)
            _dirs, lr, dg = outs["this"]
            bounds = {
                "bsw_antidiag": chip_smoke.bound(
                    "bsw_antidiag", fargs, sh.fe, outs["this"], ops_rate),
                "bsw_walk": chip_smoke.bound(
                    "bsw_walk", fargs, sh.fe, (sums["this"], None, lr, dg),
                    ops_rate)}
            steps = {"fwd_base": sh.T,
                     "fwd_this": int((2 * (sh.xs - 1) + 2 * BAND + 1).max()),
                     "walk": int(sums["this"][2].max())}
            ms = {}
            for turn in ("base", "this", "this", "base"):
                fwd, wlk = base if turn == "base" else this
                fo = outs[turn]
                for kern, fn in (("bsw_antidiag", lambda: sh.forward(fwd)),
                                 ("bsw_walk", lambda: sh.walk(wlk, fo))):
                    ms.setdefault(f"{kern}_{turn}", []).append(
                        launch_ms(fn, args.reps))
            row = {}
            for key, v in ms.items():
                kern, turn = key.rsplit("_", 1)
                n = (steps["walk"] if kern == "bsw_walk"
                     else steps[f"fwd_{turn}"])
                b_ms, b_by = bounds[kern]
                row[key] = {"ms": v, "steps": n,
                            "ns_per_step": [t * 1e6 / n for t in v],
                            "bound_ms": b_ms, "bound_by": b_by}
                print(f"[ab] {card} | B={sh.B} band={BAND} XW={xw} {key}: "
                      f"ms {', '.join(f'{t:.4f}' for t in v)}; "
                      f"{statistics.mean(v) * 1e6 / n:.1f} ns/step over "
                      f"{n} steps; bound {b_ms:.6f} ms ({b_by}), "
                      f"{statistics.mean(v) / b_ms:.1f}x it", flush=True)
            res["shapes"][str(xw)] = row
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
