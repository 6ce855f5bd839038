"""ABlast seed/hit finder.

Reference: lib/src/alignment/ablast.cc and ablast.hpp.
Hashes every 20-mer of A with the reference's rolling code
(code = 4*code + base, ablast.hpp:56 — collisions and all), scans B's
20-mers, votes on diagonal offsets idx_a - idx_b (only idx_a >= idx_b),
and returns the offsets (as absolute A positions) achieving the maximum
vote count, in ascending order.
"""

from __future__ import annotations

import numpy as np

ABLAST_DEFAULT_WORD_SIZE = 20


def _codes(seq: np.ndarray, start: int, end: int, w: int) -> np.ndarray:
    """Rolling codes of all w-mers with start positions in [start, end-w+1]."""
    # code = sum over window of 4^(w-1-k) * base  (LAST_BASE-1 == 4)
    n = end - start + 1
    if n < w:
        return np.zeros(0, np.uint64)
    window = seq[start:end + 1].astype(np.uint64)
    pows = (np.uint64(4) ** np.arange(w - 1, -1, -1, dtype=np.uint64))
    m = n - w + 1
    idx = np.arange(m)[:, None] + np.arange(w)[None, :]
    return (window[idx] * pows[None, :]).sum(axis=1, dtype=np.uint64)


def find_hits(a: np.ndarray, a_start: int, a_end: int,
              b: np.ndarray, b_start: int, b_end: int,
              word_size: int = ABLAST_DEFAULT_WORD_SIZE) -> list[int]:
    """ABlast::findHits (ablast.cc:42)."""
    if len(a) == 0 or len(b) == 0:
        return []
    if a_end >= len(a):
        a_end = len(a) - 1
    if b_end >= len(b):
        b_end = len(b) - 1
    if a_start > a_end or b_start > b_end:
        return []
    if a_end + 1 < word_size + a_start or b_end + 1 < word_size + b_start:
        return []

    a_codes = _codes(a, a_start, a_end, word_size)
    b_codes = _codes(b, b_start, b_end, word_size)

    # vote: for each matching (idx_a, idx_b) pair with idx_a >= idx_b,
    # f_vector[idx_a - idx_b] += 1
    f_vector = np.zeros(a_end - a_start + 1, np.int64)
    order = np.argsort(a_codes, kind="stable")
    sorted_codes = a_codes[order]
    left = np.searchsorted(sorted_codes, b_codes, "left")
    right = np.searchsorted(sorted_codes, b_codes, "right")
    for idx_b in range(len(b_codes)):
        lo, hi = left[idx_b], right[idx_b]
        if lo == hi:
            continue
        for idx_a in order[lo:hi]:
            if idx_a >= idx_b:
                f_vector[idx_a - idx_b] += 1

    max_score = f_vector.max(initial=0)
    if max_score == 0:
        return []
    return [a_start + int(i) for i in np.nonzero(f_vector == max_score)[0]]
