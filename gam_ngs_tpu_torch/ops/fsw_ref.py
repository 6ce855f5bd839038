"""Full (unbanded) Smith-Waterman — reference-parity extra.

Replicates FullSmithWaterman::find_alignment
(lib/src/alignment/full_smith_waterman.cc:52-152):
compiled into the reference binaries but never called from the merge
path; provided for API completeness.  Semantics kept verbatim:

  * matrix rows follow b, columns follow a; first row/col zero;
  * plain character equality (NO N-wildcard rule, unlike the banded
    kernel) with scores match 5 / mismatch -4 / gap -8
    (my_alignment.hpp:45-48);
  * max over last row then last column with strict '>';
  * traceback prefers diag, then up (GAP_A), else left (GAP_B);
  * the returned begin_a/begin_b are the RELATIVE i/j where the walk
    stopped (the reference does not add the window offsets — quirk
    kept).
"""

from __future__ import annotations

import numpy as np

from .editops import GAP_A, GAP_B, MATCH, MISMATCH, Alignment

MATCH_SCORE, MISMATCH_SCORE, GAP_SCORE = 5, -4, -8


def full_sw_align(a: np.ndarray, begin_a: int, end_a: int, b: np.ndarray,
                  begin_b: int, end_b: int) -> Alignment:
    x_size = end_b - begin_b + 2
    y_size = end_a - begin_a + 2

    aw = a[begin_a:begin_a + y_size - 1].astype(np.int16)
    bw = b[begin_b:begin_b + x_size - 1].astype(np.int16)
    sub = np.where(aw[None, :] == bw[:, None], MATCH_SCORE, MISMATCH_SCORE)

    sw = np.zeros((x_size, y_size), np.int64)
    for i in range(1, x_size):
        prev = sw[i - 1]
        row = sw[i]
        diag = prev[:-1] + sub[i - 1]
        up = prev[1:] + GAP_SCORE
        base = np.maximum(diag, up)
        # left dependency: prefix max-plus with constant gap slope
        best = np.int64(-1 << 60)
        for j in range(1, y_size):
            best = max(base[j - 1], best + GAP_SCORE)
            row[j] = best

    max_i, max_j = x_size - 1, y_size - 1
    max_score = sw[max_i, max_j]
    for j in range(1, y_size):
        if sw[x_size - 1, j] > max_score:
            max_score, max_i, max_j = sw[x_size - 1, j], x_size - 1, j
    for i in range(1, x_size):
        if sw[i, y_size - 1] > max_score:
            max_score, max_i, max_j = sw[i, y_size - 1], i, y_size - 1

    edits: list[int] = []
    matches = 0
    i, j = max_i, max_j
    while i > 0 and j > 0:
        diag_score = sw[i - 1, j - 1] + (
            MATCH_SCORE if a[begin_a + j - 1] == b[begin_b + i - 1]
            else MISMATCH_SCORE)
        up_score = sw[i - 1, j] + GAP_SCORE
        if sw[i, j] == diag_score:
            if a[begin_a + j - 1] == b[begin_b + i - 1]:
                edits.append(MATCH)
                matches += 1
            else:
                edits.append(MISMATCH)
            i -= 1
            j -= 1
        elif sw[i, j] == up_score:
            edits.append(GAP_A)
            i -= 1
        else:
            edits.append(GAP_B)
            j -= 1
    edits.reverse()

    homology = 0.0 if not edits else matches * 100.0 / len(edits)
    return Alignment(begin_a=j, begin_b=i, a_size=len(a), b_size=len(b),
                     score=int(max_score), homology=homology,
                     edits=np.array(edits, np.uint8))
