"""One run of a cell: set-up, the measured window, the check, the result.

Set-up makes the genome and the pool of stages (generate.py), builds the
engine as `gam merge --device cuda` builds it (BswEngine at its
defaults: band 150, the anti-diagonal forward, the device walk, lean
answers, no sequence arena), and warms every window bucket the pool
holds with a chunk of its shortest problems, then `warm_stages` whole
stages.  The window then runs the pool's stages back to back, over and
over in the seed's order, one align_many call a round, each ended by
torch.cuda.synchronize(), until --seconds have passed; a stage that the
deadline cuts counts its finished rounds but not its time.  After the
window: the memory peak, the trace, the engine freed, then the check
(check.py) on the CPU.
"""

from __future__ import annotations

import gc
import resource
import subprocess
import sys
import time
from dataclasses import dataclass, field

import numpy as np

from . import check, generate, spec, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "gam_ngs_tpu")


@dataclass
class RunRecord:
    """What the metric readers (metrics/<name>.py) read."""
    band: int
    setup_s: float = 0.0
    window_s: float = 0.0
    cells: int = 0              # band cells of the rounds finished
    rows: int = 0               # their problems' x_size, summed
    problems: int = 0
    walk_steps: int = 0         # edits of their answers, summed
    stage_s: list = field(default_factory=list)  # whole stages' seconds
    peak_bytes: int = 0
    util: dict = field(default_factory=dict)     # BswEngine.util, window
    trace: trace.TraceSummary | None = None


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name, power limit and clocks, as nvidia-smi reads them."""
    q = "name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({exc})"
    return f"{q}: {out}"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (gam_ngs_tpu_torch is not gam_ngs_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _buckets(stages) -> dict:
    """Problems of the pool by the engine's window bucket, shortest
    first."""
    from gam_ngs_tpu_torch.ops.bsw_host import _pad_dim

    out: dict[int, list] = {}
    for st in stages:
        for rnd, rows in zip(st.rounds, st.round_rows):
            for p, x in zip(rnd, rows.tolist()):
                if x > 0:
                    out.setdefault(_pad_dim(x), []).append((x, p))
    return {b: [p for _, p in sorted(v, key=lambda t: t[0])]
            for b, v in out.items()}


def run_cell(root: str, workload: str, seed: int, seconds: float,
             traced: bool, device=None, t_start: float | None = None,
             engine_hook=None) -> tuple[dict, dict]:
    """One run of `workload`: (the result line's object, its checks).
    device: None = the cell's `chips` GPUs, cuda:0 onwards, as `gam merge
    --device cuda` takes the GPUs it sees; a torch.device runs there (the
    CPU runs the kernels' plain versions).  engine_hook(engine, checked),
    when given, may replace parts of the engine before the warm-up;
    `checked` are the problems whose answers the check reads (the
    harness's tests plant faults with it, control.py puts the control
    in the program's place)."""
    import torch

    from gam_ngs_tpu_torch.ops.bsw_engine import BswEngine

    t_start = time.perf_counter() if t_start is None else t_start
    cell = spec.cell(spec.load_benchmark(root), workload, root)
    cfg, traffic = cell["config"], cell["traffic"]
    band = int(cfg["band"])
    if device is None:
        devices = tuple(torch.device("cuda", i)
                        for i in range(int(cell["workload"]["chips"])))
    else:
        devices = (device,)
    on_cuda = devices[0].type == "cuda"
    if on_cuda:
        log(card_line())

    t = time.perf_counter()
    layout = int(traffic["layout_seed"])
    genome = generate.make_genome(cfg, seed, layout)
    n_pool = generate.pool_size(traffic, cfg)
    stages = [generate.make_stage(cfg, genome, layout, k)
              for k in generate.stage_order(seed, n_pool)]
    log(f"[setup] {workload} seed {seed}: genome {len(genome.master)} bp, "
        f"{n_pool} stages of {np.mean([sum(len(r) for r in s.rounds) for s in stages]):.1f} "
        f"problems, {np.mean([len(s.rounds) for s in stages]):.2f} rounds "
        f"in {time.perf_counter() - t:.2f} s")

    # the answers to check: pool problems drawn from the seed, and the
    # longest; only theirs are kept, each from its last round answered
    picked = check.sample(stages, seed, int(traffic["check_problems"]))
    engine = BswEngine(devices if len(devices) > 1 else devices[0],
                       band=band)
    if engine_hook is not None:
        engine_hook(engine, [stages[p].rounds[r][i]
                             for (p, r), idx in sorted(picked.items())
                             for i in idx])

    def sync():
        if on_cuda:
            for d in devices:
                torch.cuda.synchronize(d)

    t = time.perf_counter()
    for _, probs in sorted(_buckets(stages).items()):
        engine.align_many(probs[:engine.max_batch])
    for st in stages[:int(traffic["warm_stages"])]:
        for rnd in st.rounds:
            engine.align_many(rnd)
    sync()
    log(f"[setup] warm-up {time.perf_counter() - t:.2f} s")

    kept: dict = {}
    rec = RunRecord(band=band)
    util0 = dict(engine.util)
    missing = 0
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
        span = record_function
    else:
        import contextlib

        def span(_name):
            return contextlib.nullcontext()

    # the pool and the engine live through the window: keep the
    # collector's full passes off them
    gc.collect()
    gc.freeze()
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    rec.setup_s = time.perf_counter() - t_start
    with span(trace.WINDOW):
        t0 = time.perf_counter()
        deadline = t0 + seconds
        k = 0
        over = False
        while not over:
            pos = k % n_pool
            st = stages[pos]
            ts = time.perf_counter()
            for r, rnd in enumerate(st.rounds):
                with span(trace.ROUND):
                    answers = engine.align_many(rnd)
                    sync()
                n = len(rnd)
                missing += max(0, n - len(answers)) + sum(
                    a is None for a in answers[:n])
                for i in picked.get((pos, r), ()):
                    kept[(pos, r, i)] = answers[i] if i < len(answers) \
                        else None
                if traced:
                    rec.walk_steps += sum(a.length for a in answers[:n]
                                          if a is not None)
                rec.problems += n
                rec.rows += st.round_rows_sum[r]
                rec.cells += st.round_cells[r]
                if time.perf_counter() >= deadline:
                    over = True
                    if r < len(st.rounds) - 1:
                        break
            else:
                rec.stage_s.append(time.perf_counter() - ts)
            k += 1
        rec.window_s = time.perf_counter() - t0
    gc.unfreeze()
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    st_ms = np.asarray(rec.stage_s) * 1e3
    log(f"[window] {rec.window_s:.3f} s: {len(st_ms)} whole stages "
        f"(ms min {st_ms.min() if len(st_ms) else 0:.1f}, median "
        f"{np.median(st_ms) if len(st_ms) else 0:.1f}, max "
        f"{st_ms.max() if len(st_ms) else 0:.1f}), {rec.problems} problems; "
        f"host cpu {ru1.ru_utime - ru0.ru_utime:.2f} s user "
        f"{ru1.ru_stime - ru0.ru_stime:.2f} s system, "
        f"{ru1.ru_minflt - ru0.ru_minflt} minor faults, "
        f"{ru1.ru_nivcsw - ru0.ru_nivcsw} involuntary switches")
    if prof is not None:
        prof.__exit__(None, None, None)
    if on_cuda:
        rec.peak_bytes = max(torch.cuda.max_memory_allocated(d)
                             for d in devices)
    rec.util = {key: engine.util[key] - util0[key] for key in util0}
    if prof is not None:
        t = time.perf_counter()
        rec.trace = trace.summarize(prof)
        log(f"[trace] read in {time.perf_counter() - t:.2f} s: busy "
            f"{rec.trace.busy_s:.4f} s of {rec.trace.window_s:.4f} s")
        del prof
    n_devices = len(engine.devices)
    del engine
    if on_cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    keys = sorted(kept)
    differ = check.compare([stages[p].rounds[r][i] for p, r, i in keys],
                              [kept[key] for key in keys], band,
                              int(traffic["check_workers"]))
    # an answer that never came is wrong, sampled or not
    wrong = differ + missing - sum(kept[key] is None for key in keys)
    log(f"[check] {len(keys)} answers of {rec.problems} against the "
        f"reference in {time.perf_counter() - t:.2f} s (longest "
        f"{max((int(stages[p].round_rows[r][i]) for p, r, i in keys), default=0)}"
        f" rows): {differ} differ, {missing} never came")

    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in cell["metrics"]:
        if m["kind"] != kind:
            continue
        value = m["read"](rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if on_cuda:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": n_devices, "memory_peak_bytes": rec.peak_bytes}
    else:
        dev = {"platform": devices[0].type, "kind": devices[0].type,
               "count": n_devices, "memory_peak_bytes": rec.peak_bytes}
    if rec.trace is not None:
        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.window_s
    result = {"correct": wrong <= check.WRONG_LIMIT,
              "attempted": rec.problems, "failed": wrong,
              "metrics": metrics, "device": dev}
    if rec.trace is not None:
        result["breakdown"] = trace.breakdown(rec.trace)
    checks = {"wrong_answers": {"value": wrong, "limit": check.WRONG_LIMIT}}
    return result, checks
