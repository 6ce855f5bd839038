"""Structured metrics: phase timers + throughput counters.

The reference only prints wall-clock phase lines (formatTime,
src/CreateBlocks.cc:66/126/164) and maxRSS; this adds a structured
record (per-phase seconds, blocks/s, aligned cells/s) written as
`<prefix>.metrics.json` so performance is measurable run-over-run
(SURVEY.md §5 observability).
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager


class Metrics:
    def __init__(self):
        self.phases: dict[str, float] = {}
        self.counters: dict[str, float] = {}
        self._t0 = time.time()

    @contextmanager
    def phase(self, name: str):
        t = time.time()
        try:
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
