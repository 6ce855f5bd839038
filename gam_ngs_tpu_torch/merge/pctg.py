"""PairedContig — a merged (woven) contig + provenance records.

Reference: lib/src/pctg/PairedContig.cc and
CtgInPctgInfo.cc.  Names are "PairedContig_<id>"; the .pctgs descriptor
rows are `name size Master|Slave ctgName start end F|R`
(writePctgDescriptor :329).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

PCTG_PREFIX = "PairedContig_"


@dataclass
class CtgInPctg:
    ctg_id: int
    start: int
    end: int
    reversed_: bool
    is_master: bool


@dataclass
class PairedContig:
    pctg_id: int = 0
    parts: list = field(default_factory=list)        # list[np.ndarray]
    merge_list: list = field(default_factory=list)   # list[CtgInPctg]
    master_ids: set = field(default_factory=set)
    slave_ids: set = field(default_factory=set)

    @property
    def name(self) -> str:
        return f"{PCTG_PREFIX}{self.pctg_id}"

    @property
    def size(self) -> int:
        return sum(len(p) for p in self.parts)

    def sequence(self) -> np.ndarray:
        if not self.parts:
            return np.zeros(0, np.uint8)
        return np.concatenate(self.parts)


def write_pctg_descriptors(fh, pctgs: list[PairedContig], master_ref,
                           slave_ref, separator_at: int) -> None:
    """writePctgDescriptors (PairedContig.cc:305)."""
    fh.write("#Name\tSize\tAssembly\tContigID\tBegin\tEnd\tReversed\n")
    for j, p in enumerate(pctgs):
        if j == separator_at:
            fh.write("# ----------------------------------------------------\n")
        size = p.size
        for it in p.merge_list:
            ref = master_ref if it.is_master else slave_ref
            fh.write(
                f"{p.name}\t{size}\t{'Master' if it.is_master else 'Slave'}\t"
                f"{ref[it.ctg_id].name}\t{it.start}\t{it.end}\t"
                f"{'R' if it.reversed_ else 'F'}\n")
