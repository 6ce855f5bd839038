"""The benchmark of gam_ngs_tpu_torch's align stage on the H100.

    python3 gpubench/run.py --workload <config>.<traffic> --seed <n> \
        --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json (at the root of the checkout) on the
CUDA devices of this machine: set-up, a window of --seconds, the check
of the window's answers against the plain reference, and one JSON line
on standard output (the end-to-end metrics, or with --trace 1 the
per-layer ones from a torch.profiler trace of the window).  The numbers
the check compared are the last lines of standard error and the last
key of the JSON line.  Exits non-zero, printing no result, without
enough CUDA devices, when the program cannot be imported, or when JAX or
the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    cache = os.path.join(ROOT, ".gpubench_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))

    from gpubench import harness, spec

    bench = spec.load_benchmark(ROOT)
    chips = spec.cell(bench, args.workload, ROOT)["workload"]["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"needs {chips} CUDA device(s); torch sees "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result, checks = harness.run_cell(ROOT, args.workload, args.seed,
                                      args.seconds, bool(args.trace),
                                      t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"loaded in this process: {', '.join(bad)} (the "
                    f"benchmark runs gam_ngs_tpu_torch without JAX)")
        return 3
    for name, c in checks.items():
        harness.log(f"check {name} {c['value']} limit {c['limit']}")
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
