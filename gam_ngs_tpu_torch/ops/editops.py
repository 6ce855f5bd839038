"""Alignment value type + edit-string utilities.

Mirrors MyAlignment (lib/src/alignment/my_alignment.cc).
Edit codes follow the reference enum order (my_alignment.hpp:57):
GAP_A=0 (gap in A), GAP_B=1 (gap in B), MATCH=2, MISMATCH=3.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

GAP_A, GAP_B, MATCH, MISMATCH = 0, 1, 2, 3

MIN_HOMOLOGY = 95.0  # PctgBuilder.hpp


@dataclass
class Alignment:
    begin_a: int = 0
    begin_b: int = 0
    a_size: int = 0
    b_size: int = 0
    score: int = 0
    homology: float = 0.0
    edits: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))
    # lean device-walk summary (no edit string materialized):
    # (length, matches, (found, (a, b)) first match, (found, (a, b))
    # last match).  The merge consumes ONLY length/homology/first/last
    # (align.py), so the device traceback can ship these 13 ints
    # instead of a 2-bit-packed edit string — ~400x less d2h on thin
    # links.
    lean: tuple | None = None

    @property
    def length(self) -> int:
        return self.lean[0] if self.lean is not None else len(self.edits)


def _step_deltas(edits: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-op (da, db) position deltas (MATCH/MISMATCH advance both,
    GAP_A advances b only, GAP_B advances a only)."""
    da = np.array([0, 1, 1, 1], np.int64)[edits]
    db = np.array([1, 0, 1, 1], np.int64)[edits]
    return da, db


def first_match_pos(aln: Alignment) -> tuple[bool, tuple[int, int]]:
    """(found, (a_pos, b_pos)) of the first MATCH (my_alignment.cc:168)."""
    if aln.lean is not None:
        return aln.lean[2]
    a, b = aln.begin_a, aln.begin_b
    e = aln.edits
    m = np.nonzero(e == MATCH)[0]
    if len(m) == 0:
        # position after consuming all ops (reference returns the advanced pos)
        da, db = _step_deltas(e)
        return False, (a + int(da.sum()), b + int(db.sum()))
    k = int(m[0])
    da, db = _step_deltas(e[:k])
    return True, (a + int(da.sum()), b + int(db.sum()))


def last_match_pos(aln: Alignment) -> tuple[bool, tuple[int, int]]:
    """(found, (a_pos, b_pos)) of the last MATCH (my_alignment.cc:229)."""
    if aln.lean is not None:
        return aln.lean[3]
    a, b = aln.begin_a, aln.begin_b
    e = aln.edits
    m = np.nonzero(e == MATCH)[0]
    if len(m) == 0:
        return False, (a, b)
    k = int(m[-1])
    da, db = _step_deltas(e[:k])
    return True, (a + int(da.sum()), b + int(db.sum()))


def count_matches(edits: np.ndarray) -> int:
    return int((edits == MATCH).sum())
