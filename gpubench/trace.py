"""Reading the traced window: device time by kernel, the device's busy
union and its idle gaps, labelled by what the host was doing.

torch.profiler (CUPTI) records every kernel and copy on the card and the
host's torch operators and CUDA runtime calls; the benchmark's own
ranges ("window", "align_many") mark its spans.  device_ms_by_kernel and
device_busy_ms follow chip_smoke.py's helpers of the same names.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

COPY_PREFIXES = ("Memcpy", "Memset")
WINDOW = "gpubench.window"
ROUND = "gpubench.align_many"


@dataclass
class TraceSummary:
    window_s: float                 # the traced window's length
    busy_s: float                   # union of device activity in it
    kernel_s: float                 # summed device time of every kernel
    by_name: dict = field(default_factory=dict)   # name -> device s
    idle_by_host: dict = field(default_factory=dict)  # label -> idle s


def _union(spans):
    """Merged, sorted intervals of (start, end) spans."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def summarize(prof) -> TraceSummary:
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    window = None
    for e in prof.events():
        t0, t1 = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            # the benchmark's own ranges are mirrored on the device's
            # timeline as annotations: they are not device work
            if e.name not in (WINDOW, ROUND):
                dev.append((e.name, t0, t1))
        elif e.name == WINDOW:
            window = (t0, t1)
        else:
            host.append((e.name, t0, t1))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    w0, w1 = window
    dev = [(n, max(a, w0), min(b, w1)) for n, a, b in dev if b > w0 and a < w1]
    by_name: dict[str, float] = {}
    kernel_us = 0.0
    for n, a, b in dev:
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e6
        if not n.startswith(COPY_PREFIXES):
            kernel_us += b - a
    busy = _union((a, b) for _, a, b in dev)
    busy_us = sum(b - a for a, b in busy)
    # idle gaps, each labelled by the innermost host span at its middle
    gaps, cur = [], w0
    for a, b in busy:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if cur < w1:
        gaps.append((cur, w1))
    idle: dict[str, float] = {}
    mids = [(a + b) / 2 for a, b in gaps]
    for (a, b), label in zip(gaps, _labels(host, mids)):
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    return TraceSummary((w1 - w0) / 1e6, busy_us / 1e6, kernel_us / 1e6,
                        by_name, idle)


def _labels(host, mids) -> list[str]:
    """For each time of `mids` (ascending): 'align_many/<op>' inside one
    of the benchmark's align_many spans, else 'harness/<op>', where <op>
    is the innermost host event then running (a torch operator or a CUDA
    runtime call), or 'python' where there is none."""
    host = sorted(host, key=lambda h: h[1])
    rounds = [(s, e) for n, s, e in host if n == ROUND]
    active: list = []  # heap of (-start, end, name): latest start on top
    out, k, r = [], 0, 0
    for mid in mids:
        while k < len(host) and host[k][1] <= mid:
            n, s, e = host[k]
            if n != ROUND:
                heapq.heappush(active, (-s, e, n))
            k += 1
        # host events nest, so the latest-started one still running is
        # the innermost
        while active and active[0][1] < mid:
            heapq.heappop(active)
        while r < len(rounds) and rounds[r][1] < mid:
            r += 1
        where = ("align_many" if r < len(rounds) and rounds[r][0] <= mid
                 else "harness")
        out.append(f"{where}/{active[0][2] if active else 'python'}")
    return out


def breakdown(summary: TraceSummary) -> dict:
    top = sorted(summary.by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(summary.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in gaps]}
