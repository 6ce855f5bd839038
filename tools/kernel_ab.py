"""Time this tree's anti-diagonal forward and walk kernels (or, with
--row, its row-form forward) against another version's, on one CUDA GPU,
in turns.

    python3 tools/kernel_ab.py --base DIR [--row] [--reps 5] [--out FILE]

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

--row: DIR holds the other version's bsw_row.cu (same C entry point);
both row forwards run B=64 problems at band 150 in windows XW 1024, 4096
and 32768 (x_size 25000), and at bands 300 and 511 (--bands) in XW
4096, timed base, this, this, base, their outputs held equal bit for
bit; each time with its ns a row (the longest problem's rows), bound
and multiple.

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


def problems(xw: int, B: int = 64, seed: int = 11, fixed: int = 0,
             band: int = BAND):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(B):
        n = fixed or int(rng.integers(int(0.8 * xw), xw))
        a = rng.integers(0, 4, size=n + 2 * band).astype(np.uint8)
        b = tp.mutate(rng, a[band:band + n])
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
        self.K, self.T, self.NP, _ = antidiag_dims(self.xw, BAND)
        self.lmax = -(-(2 * self.xw + 2 * BAND + 8) // 4) * 4
        self.stream = torch.cuda.current_stream().cuda_stream

    def forward(self, fn):
        dirs = torch.empty((self.B, self.NP, self.K), dtype=torch.int32,
                           device=DEV)
        lr = torch.empty((self.B, 2 * BAND + 1), dtype=torch.int32,
                         device=DEV)
        dg = torch.empty_like(lr)
        err = fn(*(v.data_ptr() for v in (self.a, self.b, self.ba, self.ea,
                                          self.al, self.xs, self.fs)),
                 self.B, 2 * self.a.shape[1], self.xw, BAND, self.T, self.NP,
                 MATCH_S, MISMATCH_S, NN_S, NX_S, GAP, FORCE_MAXGAP_LEN,
                 dirs.data_ptr(), lr.data_ptr(), dg.data_ptr(), self.stream)
        if err:
            raise RuntimeError(f"forward launch: CUDA error {err}")
        return dirs, lr, dg

    def walk(self, fn, fwd_out):
        dirs, lr, dg = fwd_out
        summary = torch.empty((13, self.B), dtype=torch.int32, device=DEV)
        err = fn(*(v.data_ptr() for v in (dirs, self.a, self.b, self.ba,
                                          self.ea, self.xs, self.fe, lr,
                                          dg)),
                 self.B, 2 * self.a.shape[1], self.xw, BAND, self.NP,
                 self.lmax, FORCE_MAXGAP_LEN, 0, summary.data_ptr(), None,
                 self.stream)
        if err:
            raise RuntimeError(f"walk launch: CUDA error {err}")
        return summary


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
                      f"{statistics.mean(v) / b_ms:.1f}x it", flush=True)
            res["shapes"][f"band{band}_xw{xw}"] = {
                "ms": ms, "rows": n, "bound_ms": b_ms, "bound_by": b_by}
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
    ap.add_argument("--base", required=True)
    ap.add_argument("--row", action="store_true",
                    help="time the row-form forward (DIR/bsw_row.cu)")
    ap.add_argument("--bands", default="300,511",
                    help="--row: the bands timed at XW 4096 besides 150")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: torch sees no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    ops_rate = chip_smoke.int32_ops_per_s()
    if args.row:
        _build.library()
        for line in _build.build_log.splitlines():
            if "bsw_row_cu" in line or "registers" in line \
                    or "spill" in line:
                print(f"[this] {line.strip()}")
        line = json.dumps(row_ab(args.base, args.reps, card, ops_rate,
                                 [int(b) for b in args.bands.split(",")]))
        if args.out:
            with open(args.out, "w") as fh:
                fh.write(line + "\n")
        print(line)
        return 0
    this = entry_points(_build.library())
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[this] {line.strip()}")
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
            if not torch.equal(sums["base"], sums["this"]) or \
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
