"""Reading the program's own host spans in a traced window, against the
device's busy time.

The align engine (gam_ngs_tpu_torch/ops/bsw_engine.py) names its host
work with spans in the torch.profiler trace, on the trace's own clock:
`bsw.align_many` a call, holding `bsw.prepare` and, a chunk, `bsw.pack`,
`bsw.upload`, `bsw.launch`, `bsw.fetch` and `bsw.decode` (`bsw.host_walk`
under the host traceback).  They are host operators, not user
annotations, so the profiler does not mirror them onto the device's
timeline.  While the profiler records, the engine appends each call's
(live problems, chunks) to `engine.call_log`, in call order: the k-th
`bsw.align_many` span of the trace is the k-th entry.

The device's intervals are the ones trace.summarize unites (every
device event but the benchmark's own ranges), clipped to the window.

The harness does not hand its profile to this reader, so no metric of
BENCHMARK.json reads it yet.  Run it beside the benchmark, from the
root of a checkout, for one traced run of a cell and its readings:

    python3 -m gpubench.spans --workload <config>.<traffic> --seed <n> \
        --seconds <s>

It prints run.py's traced result line with the readings added to its
metrics: engine_idle_pct.align, engine_host_pct.align and
small_round_busy_pct.align (None without device events), and
busy_in_calls_pct.align, the device's busy time inside calls.
"""

from __future__ import annotations

import json
import os
import sys
from dataclasses import dataclass, field

from . import trace

CALL = "bsw.align_many"
# the engine's host work: every span of a call but its fetch, where the
# host waits on the device
HOST_WORK = ("bsw.prepare", "bsw.pack", "bsw.upload", "bsw.launch",
             "bsw.decode", "bsw.host_walk")
# calls of at most one chunk's max_batch live problems: at most 16 of
# the H100's 132 SMs at four problems a block
SMALL_CALL = 64


@dataclass
class SpanSummary:
    engine_host_pct: float            # HOST_WORK's union over the window
    engine_idle_pct: float | None     # ... while the device is idle
    small_round_busy_pct: float | None  # busy time in small calls
    busy_in_calls_pct: float | None   # busy time in any call
    calls: int = 0
    spans: int = 0
    mirrored: list = field(default_factory=list)  # bsw./gam. device events


def _length(spans) -> float:
    return sum(b - a for a, b in spans)


def _intersect(x, y) -> list:
    """The intersection of two merged, sorted interval lists."""
    out, i, j = [], 0, 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if a < b:
            out.append((a, b))
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


def compute(window, device, host, call_log, mirrored=()) -> SpanSummary:
    """The metrics from the window (start, end), the device's intervals
    [(start, end)], the host spans [(name, start, end)] and call_log,
    all times on one clock."""
    calls = sorted((s for s in host if s[0] == CALL), key=lambda s: s[1])
    if len(calls) != len(call_log):
        raise ValueError(f"{len(calls)} {CALL} spans in the trace but "
                         f"{len(call_log)} entries in call_log")
    w0, w1 = window

    def union(spans):
        return trace._union((max(a, w0), min(b, w1)) for a, b in spans
                            if b > w0 and a < w1)

    work = union((a, b) for n, a, b in host if n in HOST_WORK)
    span_w = w1 - w0
    out = SpanSummary(100.0 * _length(work) / span_w, None, None, None,
                      len(calls), len(host), list(mirrored))
    busy = union(device)
    if not busy:
        return out
    idle, cur = [], w0
    for a, b in busy:
        if a > cur:
            idle.append((cur, a))
        cur = b
    if cur < w1:
        idle.append((cur, w1))
    small = union((a, b) for (_, a, b), (live, _) in zip(calls, call_log)
                  if live <= SMALL_CALL)
    busy_len = _length(busy)
    out.engine_idle_pct = 100.0 * _length(_intersect(idle, work)) / span_w
    out.small_round_busy_pct = (100.0 * _length(_intersect(busy, small))
                                / busy_len)
    out.busy_in_calls_pct = 100.0 * _length(_intersect(
        busy, union((a, b) for _, a, b in calls))) / busy_len
    return out


def summarize(prof, engine) -> SpanSummary | None:
    """The trace's spans read against engine.call_log; None for a program
    whose engine keeps no call_log (it names no spans either)."""
    call_log = getattr(engine, "call_log", None)
    if call_log is None:
        return None
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host, mirrored = [], [], set()
    window = None
    for e in prof.events():
        t0, t1 = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if e.name.startswith(("bsw.", "gam.")):
                mirrored.add(e.name)
            if e.name not in (trace.WINDOW, trace.ROUND):
                device.append((t0, t1))
        elif e.name == trace.WINDOW:
            window = (t0, t1)
        elif e.name.startswith("bsw."):
            host.append((e.name, t0, t1))
    if window is None:
        raise RuntimeError(f"the trace holds no {trace.WINDOW!r} range")
    out = compute(window, device, host, call_log, sorted(mirrored))
    print(f"[spans] {out.calls} calls, {out.spans} bsw spans: engine host "
          f"{out.engine_host_pct:.4f}% of the window, engine idle "
          f"{out.engine_idle_pct}%, small-call busy "
          f"{out.small_round_busy_pct}%, busy in calls "
          f"{out.busy_in_calls_pct}%, mirrored on the device: "
          f"{out.mirrored or 'none'}", file=sys.stderr, flush=True)
    return out


def traced_run(root: str, workload: str, seed: int, seconds: float,
               device=None) -> tuple[dict, SpanSummary | None]:
    """One traced run of `workload` (harness.run_cell), with this reader
    given the run's profile and engine: (run.py's result object, the
    readings, None for a program without spans).  The harness's own
    trace.summarize is wrapped for the run, in this process alone."""
    from . import harness

    engines, out = [], []
    summarize_trace = trace.summarize

    def summarize_both(prof):
        summary = summarize_trace(prof)
        out.append(summarize(prof, engines.pop()))
        return summary

    trace.summarize = summarize_both
    try:
        result, _ = harness.run_cell(
            root, workload, seed, seconds, True, device=device,
            engine_hook=lambda engine, _checked: engines.append(engine))
    finally:
        trace.summarize = summarize_trace
    return result, (out[0] if out else None)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cache = os.path.join(root, ".gpubench_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    result, out = traced_run(root, args.workload, args.seed, args.seconds)
    if out is not None:
        for name, value in (
                ("engine_idle_pct.align", out.engine_idle_pct),
                ("engine_host_pct.align", out.engine_host_pct),
                ("small_round_busy_pct.align", out.small_round_busy_pct),
                ("busy_in_calls_pct.align", out.busy_in_calls_pct)):
            if value is not None:
                result["metrics"][name] = {"value": value, "unit": "%"}
        result["spans_mirrored"] = out.mirrored
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
