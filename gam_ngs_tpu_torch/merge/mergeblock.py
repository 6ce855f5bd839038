"""MergeBlock — per-compact-vertex merge descriptor.

Reference: lib/include/pctg/MergeDescriptor.hpp:40-69.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass
class MergeBlock:
    vertex: int = 0
    m_id: int = 0
    m_start: int = 0
    m_end: int = 0
    s_id: int = 0
    s_start: int = 0
    s_end: int = 0
    valid: bool = False
    align_rev: bool = False
    align_ok: bool = False
    # relative to original strand of contigs
    m_ltail: bool = True
    m_rtail: bool = True
    s_ltail: bool = True
    s_rtail: bool = True
    # relative to order of merge
    ext_slave_next: bool = True
    ext_slave_prev: bool = True
    m_rev: bool = False
    s_rev: bool = False

    def copy(self) -> "MergeBlock":
        return replace(self)
