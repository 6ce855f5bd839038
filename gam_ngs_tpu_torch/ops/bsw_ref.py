"""Banded semi-global Smith-Waterman — exact NumPy oracle.

Cell-for-cell and traceback-identical to the reference kernel
(lib/src/alignment/banded_smith_waterman.cc:70-323):

  * diagonal band storage sw[i][j], i over the B window, j over the
    2*band+1 diagonals; A position of cell (i,j) is begin_a + i + j - band;
  * scoring: match 5 / mismatch -4 / gap -8; N vs X = 0, N vs N = 5;
  * semi-global: cells with A-pos == 0 take fresh starts (no diag
    accumulation); out-of-A cells stay 0;
  * force_start confines starts to A-pos <= FORCE_MAXGAP_LEN (=10);
    force_end confines the max search to the last FORCE_MAXGAP_LEN rows
    of the final-column diagonal;
  * max over the last row (A-pos in [0, end_a], skipped under force_end)
    and over the pos_a == end_a anti-diagonal; ties keep the first hit;
  * traceback prefers diag, then up (GAP_A), then left (GAP_B), with the
    reference's exact y-boundary and pos==0 special cases.

This is the behavioral gold standard; ops/bsw_engine.py (the CUDA kernels
and their plain versions) is validated cell-exact against it.
"""

from __future__ import annotations

import numpy as np

from .editops import GAP_A, GAP_B, MATCH, MISMATCH, Alignment

FORCE_MAXGAP_LEN = 10
DEFAULT_BAND_SIZE = 150
BSW_MAX_ALIGNMENT = 500000

GAP = -8

# SCORING_MATRIX[a][b] over base codes A,T,C,G,N
SCORING_MATRIX = np.array([
    [5, -4, -4, -4, 0],
    [-4, 5, -4, -4, 0],
    [-4, -4, 5, -4, 0],
    [-4, -4, -4, 5, 0],
    [0, 0, 0, 0, 5],
], dtype=np.int64)

_N = 4
NEG_INF = np.iinfo(np.int64).min


def fill_matrix(a: np.ndarray, begin_a: int, b: np.ndarray, begin_b: int,
                x_size: int, band: int, force_start: bool) -> np.ndarray:
    """The forward DP (rows 0..x_size-1).  Returns the (x_size, 2b+1) band."""
    y_size = 2 * band + 1
    a_len = len(a)
    sw = np.zeros((x_size, y_size), np.int64)
    S = SCORING_MATRIX

    # first row (left-to-right; has an in-row `left` dependency)
    bb = int(b[begin_b])
    for j in range(y_size):
        pos = begin_a - band + j
        # the force_start arm also bounds pos < a_len: the reference
        # lacks that check and its `a.at(pos)` THROWS std::out_of_range
        # (crashing gam-merge) whenever force_start is used with a
        # sequence shorter than FORCE_MAXGAP_LEN+1 — a crash carries no
        # output to replicate, so those lanes are defined invalid here
        if (not force_start and 0 <= pos < a_len) or \
           (force_start and 0 <= pos <= FORCE_MAXGAP_LEN and pos < a_len):
            diag = S[a[pos], bb]
            up = GAP
            left = sw[0][j - 1] if (pos > 0 and j > 0) else GAP
            sw[0][j] = max(diag, up, left) if (pos > 0 and j > 0) else max(up, diag)
        if force_start and pos > FORCE_MAXGAP_LEN and pos < a_len:
            diag = S[a[pos], bb]
            left = sw[0][j - 1] if (pos > 0 and j > 0) else GAP
            sw[0][j] = max(diag, left) if (pos > 0 and j > 0) else diag

    for i in range(1, x_size):
        bi = int(b[begin_b + i])
        row = sw[i]
        prev = sw[i - 1]
        for j in range(y_size):
            pos = begin_a + i + j - band
            if not (0 <= pos < a_len):
                continue
            if (not force_start and pos == 0) or \
               (force_start and pos == 0 and i <= FORCE_MAXGAP_LEN):
                diag = S[a[0], bi]
                up = prev[j + 1] + GAP if j < y_size - 1 else GAP
                left = GAP
                row[j] = max(diag, up, left) if j < y_size - 1 else max(diag, left)
            elif force_start and pos == 0 and i > FORCE_MAXGAP_LEN:
                diag = S[a[0], bi]
                up = prev[j + 1] + GAP if j < y_size - 1 else GAP
                row[j] = max(diag, up) if j < y_size - 1 else diag
            else:
                diag = prev[j] + S[a[pos], bi]
                up = prev[j + 1] + GAP if j < y_size - 1 else GAP
                left = row[j - 1] + GAP if j > 0 else GAP
                if 0 < j < y_size - 1:
                    row[j] = max(diag, up, left)
                elif j < y_size - 1:
                    row[j] = max(diag, up)
                elif j > 0:
                    row[j] = max(diag, left)
                else:
                    row[j] = diag
    return sw


def find_max(sw: np.ndarray, begin_a: int, end_a: int, band: int,
             force_end: bool) -> tuple[bool, int, int, int]:
    """Max over last row + the pos_a==end_a diagonal (first hit wins ties)."""
    x_size, y_size = sw.shape
    found = False
    max_i = max_j = 0
    max_score = 0

    if not force_end:
        for j in range(y_size):
            pos = begin_a + (x_size - 1) + j - band
            if 0 <= pos <= end_a:
                if not found or sw[x_size - 1][j] > max_score:
                    found = True
                    max_i, max_j = x_size - 1, j
                    max_score = int(sw[x_size - 1][j])

    if end_a >= begin_a + band:
        i = end_a - (begin_a + band)
        j = 2 * band
    else:
        i = 0
        j = 2 * band - (begin_a + band - end_a)
    # Reference quirk (banded_smith_waterman.cc:201): the force_end
    # window bound `x_size-1-FORCE_MAXGAP_LEN` is computed in UNSIGNED
    # size_type — for x_size <= FORCE_MAXGAP_LEN it wraps to a huge
    # value, so NO diagonal candidate qualifies and the whole call
    # returns the null alignment (verified against the compiled
    # reference kernel, tests/test_ref_differential.py::
    # test_ref_bsw_window_differential).
    fe_low_ok = x_size - 1 - FORCE_MAXGAP_LEN >= 0
    while i < x_size and j >= 0:
        if (not force_end) or (fe_low_ok
                               and x_size - 1 - FORCE_MAXGAP_LEN <= i
                               < x_size):
            if not found or sw[i][j] > max_score:
                found = True
                max_i, max_j = i, j
                max_score = int(sw[i][j])
        i += 1
        j -= 1

    return found, max_i, max_j, max_score


def traceback(sw: np.ndarray, a: np.ndarray, begin_a: int, b: np.ndarray,
              begin_b: int, band: int, max_i: int, max_j: int,
              force_start: bool) -> tuple[list[int], int, int, int]:
    """Exact reference traceback.  Returns (edits, matches, final_x, final_pos)."""
    x_size, y_size = sw.shape
    S = SCORING_MATRIX
    x, y = max_i, max_j
    pos = begin_a + x + y - band
    edits: list[int] = []
    matches = 0

    while x >= 0 and y >= 0 and pos >= 0:
        ca = int(a[pos])
        cb = int(b[begin_b + x])
        if pos == 0:
            diag = S[ca, cb]
            left = GAP
            if force_start and x > FORCE_MAXGAP_LEN:
                left = NEG_INF
            if sw[x][y] == diag:
                if ca == cb or ca == _N or cb == _N:
                    edits.append(MATCH)
                    matches += 1
                else:
                    edits.append(MISMATCH)
                x -= 1
            elif y == y_size - 1 or sw[x][y] == left:
                edits.append(GAP_B)
                y -= 1
            else:
                edits.append(GAP_A)
                x -= 1
                y += 1
        else:
            diag = (sw[x - 1][y] if x > 0 else 0) + S[ca, cb]
            up = sw[x - 1][y + 1] + GAP if (x > 0 and y < y_size - 1) else GAP
            if force_start and x == 0 and 0 <= pos <= FORCE_MAXGAP_LEN:
                up = GAP
            elif force_start and x == 0:
                up = NEG_INF
            if sw[x][y] == diag:
                if ca == cb or ca == _N or cb == _N:
                    edits.append(MATCH)
                    matches += 1
                else:
                    edits.append(MISMATCH)
                x -= 1
            elif 0 < y < y_size - 1 and sw[x][y] == up:
                edits.append(GAP_A)
                x -= 1
                y += 1
            elif 0 < y < y_size - 1:
                edits.append(GAP_B)
                y -= 1
            elif y < y_size - 1:  # y == 0 => up
                edits.append(GAP_A)
                x -= 1
                y += 1
            else:  # y == y_size-1 => left
                edits.append(GAP_B)
                y -= 1
        pos = begin_a + x + y - band

    edits.reverse()
    return edits, matches, x, pos


def bsw_align(a: np.ndarray, begin_a: int, end_a: int,
              b: np.ndarray, begin_b: int, end_b: int,
              force_start: bool = False, force_end: bool = False,
              band: int = DEFAULT_BAND_SIZE) -> Alignment:
    """BandedSmithWaterman::find_alignment (banded_smith_waterman.cc:70)."""
    if end_b < begin_b:
        return Alignment()
    if end_b >= len(b):
        end_b = len(b) - 1

    x_size = end_b - begin_b + 1
    x_size = min(x_size, len(a) + band - begin_a)
    x_size = min(x_size, BSW_MAX_ALIGNMENT)
    if x_size <= 0:
        return Alignment()

    sw = fill_matrix(a, begin_a, b, begin_b, x_size, band, force_start)
    found, max_i, max_j, max_score = find_max(sw, begin_a, end_a, band, force_end)
    if not found:
        return Alignment()

    edits, matches, x, pos = traceback(
        sw, a, begin_a, b, begin_b, band, max_i, max_j, force_start)

    homology = 0.0 if len(edits) == 0 else matches * 100.0 / len(edits)
    return Alignment(
        begin_a=pos + 1,
        begin_b=begin_b + x + 1,
        a_size=len(a),
        b_size=len(b),
        score=max_score,
        homology=homology,
        edits=np.array(edits, np.uint8),
    )
