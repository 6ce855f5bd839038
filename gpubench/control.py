"""The control of the check: the plain reference in the program's place,
filling in int16, the precision below the configuration's int32.

    python3 gpubench/control.py --workload <config>.<traffic> \
        --seconds <s> --seeds <n> [<n> ...]

Each seed is one whole run of the cell (harness.run_cell: set-up, the
window at the cell's own load, the check), with the engine's answers to
the problems the check reads replaced by the int16 reference's, worked
out during set-up.  The program still answers every other problem, so
the window drives the engine as a run does.  A sound check reads
`correct` false, and `wrong_answers` above its limit, on every seed.
Prints one line a seed; exits non-zero if a seed reads correct.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def int16_in_place(workers: int, band: int):
    """An engine hook for harness.run_cell: the answers to `checked` come
    from the int16 reference."""
    import numpy as np

    from gam_ngs_tpu_torch.ops.editops import Alignment
    from gpubench import reference

    def hook(engine, checked):
        got = reference.align_parallel(checked, band, np.int16, workers)
        by_id = {}
        for p, s in zip(checked, got):
            by_id[id(p)] = Alignment() if s == reference.EMPTY else \
                Alignment(begin_a=s[0], begin_b=s[1], a_size=s[2],
                          b_size=s[3], score=s[4], homology=s[5],
                          lean=(s[6], s[7], s[8], s[9]))
        real = engine.align_many

        def align_many(problems):
            out = real(problems)
            return [by_id.get(id(p), a) for p, a in zip(problems, out)]

        engine.align_many = align_many

    return hook


def control_run(root: str, workload: str, seed: int, seconds: float,
                device=None) -> tuple[dict, dict]:
    """One run of `workload` with the control in the program's place."""
    from gpubench import harness, spec

    cell = spec.cell(spec.load_benchmark(root), workload, root)
    hook = int16_in_place(int(cell["traffic"]["check_workers"]),
                          int(cell["config"]["band"]))
    return harness.run_cell(root, workload, seed, seconds, False,
                            device=device, engine_hook=hook)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    passed = []
    for seed in args.seeds:
        t = time.perf_counter()
        result, checks = control_run(ROOT, args.workload, seed, args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": result["correct"],
                          "attempted": result["attempted"],
                          "checks": checks,
                          "seconds": round(time.perf_counter() - t, 1)}),
              flush=True)
        if result["correct"]:
            passed.append(seed)
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
