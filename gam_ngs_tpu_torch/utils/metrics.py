"""Structured metrics: phase timers + throughput counters.

The reference only prints wall-clock phase lines (formatTime,
src/CreateBlocks.cc:66/126/164) and maxRSS; this adds a structured
record (per-phase seconds, blocks/s, aligned cells/s) written as
`<prefix>.metrics.json` so performance is measurable run-over-run
(SURVEY.md §5 observability).

`span(name)` marks a stretch of the host thread in whatever
torch.profiler session is recording: the same Kineto/CUPTI trace, on the
same clock, as the device's kernels and copies.  Each phase is the span
`gam.<phase>`; the align engine's spans are `bsw.*` (ops/bsw_engine.py).
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager

from torch._C._profiler import _RecordFunctionFast


def span(name: str):
    """A context naming a host span `name` in the running torch.profiler
    session (about half a microsecond when none runs).  It is recorded
    as a host operator, not as record_function's user annotation, which
    the profiler mirrors onto the device's timeline as if it were device
    work.  Names are fixed strings, so a trace's spans aggregate by
    name."""
    return _RecordFunctionFast(name)


class Metrics:
    def __init__(self):
        self.phases: dict[str, float] = {}
        self.counters: dict[str, float] = {}
        self._t0 = time.time()

    @contextmanager
    def phase(self, name: str):
        t = time.time()
        try:
            with span("gam." + name):
                yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.time() - t

    def count(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def rates(self) -> dict[str, float]:
        out = {}
        cells = self.counters.get("aligned_cells", 0)
        tal = self.phases.get("align", 0.0)
        if cells and tal > 0:
            out["aligned_cells_per_sec"] = cells / tal
        blocks = self.counters.get("blocks", 0)
        tb = self.phases.get("find_blocks", 0.0)
        if blocks and tb > 0:
            out["blocks_per_sec"] = blocks / tb
        return out

    def write(self, path: str) -> None:
        rec = dict(total_seconds=time.time() - self._t0,
                   phases=self.phases, counters=self.counters,
                   rates=self.rates())
        with open(path, "w") as fh:
            json.dump(rec, fh, indent=1, sort_keys=True)
            fh.write("\n")
