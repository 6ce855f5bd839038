"""Plain NumPy banded Smith-Waterman: the yardstick the align rounds are
held to.

The semantics are those of GAM-NGS's banded semi-global aligner
(BandedSmithWaterman::find_alignment, lib/src/alignment/
banded_smith_waterman.cc in the GAM-NGS sources): cells sw[i][j] over
the B window's rows i and the 2*band+1 diagonals j, the A position of a
cell being begin_a + i + j - band; match 5, mismatch -4, gap -8, N
against a base 0 and N against N 5; fresh starts where the A position is
0; force_start and force_end as the reference has them; the maximum over
the last row and the anti-diagonal of end_a, the first hit winning ties;
a traceback that prefers the diagonal, then up (a gap in A), then left.

It is written for speed in NumPy alone and shares no code with the
program under test: each row is a few whole-array operations over a
group of problems in lockstep, the in-row gap chain is one running
maximum, and every score is stored, so the traceback walks them cell by
cell with the aligner's own rules.
`dtype` is the score type: int32 is the configuration's precision;
int16 is the control, which wraps past 32767 as a 16-bit fill would.

Imports nothing but NumPy, so worker processes stay light.
"""

from __future__ import annotations

import numpy as np

MATCH_S, MISMATCH_S, GAP, N_CODE = 5, -4, -8, 4
FORCE_MAXGAP_LEN = 10
BSW_MAX_ALIGNMENT = 500_000
SENTINEL = 255  # an A position outside the contig

# edit codes (GAM-NGS my_alignment.hpp order)
GAP_A, GAP_B, MATCH, MISMATCH = 0, 1, 2, 3
# traceback moves
DIAG, UP, LEFT = 0, 1, 2

# a group's cells held at once (bytes of stored scores per block of rows)
BLOCK_BYTES = 64 << 20
GROUP_CELLS = 150_000_000  # most band cells of one lockstep group


class Window:
    """One problem clipped as the aligner clips it: its band-aligned A
    window (SENTINEL outside the contig) and its B rows."""

    __slots__ = ("a_len", "b_len", "begin_a", "end_a", "begin_b",
                 "x_size", "a_win", "b_win", "force_start", "force_end")

    def __init__(self, a, begin_a, end_a, b, begin_b, end_b, force_start,
                 force_end, band):
        self.a_len, self.b_len = len(a), len(b)
        self.begin_a, self.end_a, self.begin_b = begin_a, end_a, begin_b
        self.force_start, self.force_end = bool(force_start), bool(force_end)
        self.x_size = x = x_size(len(a), begin_a, len(b), begin_b, end_b,
                                 band)
        if x == 0:
            return
        start, width = begin_a - band, x + 2 * band
        self.a_win = np.full(width, SENTINEL, np.uint8)
        lo, hi = max(0, start), min(len(a), start + width)
        if hi > lo:
            self.a_win[lo - start:hi - start] = a[lo:hi]
        self.b_win = np.ascontiguousarray(b[begin_b:begin_b + x], np.uint8)


def x_size(a_len, begin_a, b_len, begin_b, end_b, band) -> int:
    """The rows the aligner fills for one problem (0 for none)."""
    if end_b < begin_b:
        return 0
    end_b = min(end_b, b_len - 1)
    return max(0, min(end_b - begin_b + 1, a_len + band - begin_a,
                      BSW_MAX_ALIGNMENT))


_SC = [[MATCH_S if ca == cb else (0 if N_CODE in (ca, cb) else MISMATCH_S)
        for cb in range(5)] for ca in range(5)]
_SC[N_CODE][N_CODE] = MATCH_S
NEG_INF = -(1 << 62)


def _wrap16(v: int) -> int:
    return ((v + 32768) & 0xFFFF) - 32768


def _fill_group(ws, band, dtype):
    """Forward fill of a lockstep group: every cell's score, (G, X, Y) of
    `dtype` (row i of problem g at [g, i]), with the A windows and B rows
    the walk reads."""
    G = len(ws)
    Y = 2 * band + 1
    X = max(w.x_size for w in ws)
    A = np.full((G, X + 2 * band), SENTINEL, np.uint8)
    B = np.zeros((G, X), np.uint8)
    for g, w in enumerate(ws):
        A[g, :len(w.a_win)] = w.a_win
        B[g, :w.x_size] = w.b_win
    has_n = bool((A == N_CODE).any() or (B == N_CODE).any())
    # rows where a problem's band holds A position 0 (a fresh start)
    fresh: dict[int, list[tuple[int, int]]] = {}
    for g, w in enumerate(ws):
        for i in range(max(0, band - w.begin_a - Y + 1),
                       min(w.x_size, band - w.begin_a + 1)):
            j = band - w.begin_a - i
            if 0 <= j < Y and 0 < w.a_len:
                fresh.setdefault(i, []).append((g, j))
    V = np.empty((G, X, Y), dtype)
    ramp = (-GAP * np.arange(Y, dtype=np.int32))[None, :]
    up = np.empty((G, Y), np.int32)
    rows_per_block = max(1, BLOCK_BYTES // (G * Y * 4))
    win = np.lib.stride_tricks.sliding_window_view(A, Y, axis=1)
    prev = None
    for r0 in range(0, X, rows_per_block):
        r1 = min(X, r0 + rows_per_block)
        ac = win[:, r0:r1]                       # (G, R, Y) A codes
        bc = B[:, r0:r1, None]
        eq = ac == bc
        S = np.where(eq, np.int32(MATCH_S), np.int32(MISMATCH_S))
        if has_n:
            S[~eq & ((ac == N_CODE) | (bc == N_CODE))] = 0
        dead = ac == SENTINEL
        partial = dead.any(axis=(0, 2))
        for k in range(r1 - r0):
            i = r0 + k
            Sk = S[:, k]
            if i == 0:
                # the first row's left takes no gap (the aligner's own
                # rule): a running maximum of the scores from the first
                # cell inside the contig
                t = np.where(dead[:, 0], np.int32(-(1 << 30)), Sk)
                row = np.maximum.accumulate(t, axis=1)
                row[dead[:, 0]] = 0
                V[:, 0] = row
                prev = V[:, 0].astype(np.int32)
                continue
            t = prev + Sk
            for g, j in fresh.get(i, ()):
                t[g, j] = Sk[g, j]
            up[:, :-1] = prev[:, 1:]
            up[:, :-1] += GAP
            up[:, -1] = t[:, -1]
            np.maximum(t, up, out=t)
            if partial[k]:
                t[dead[:, k]] = 0
            t += ramp
            row = np.maximum.accumulate(t, axis=1)
            row -= ramp
            if partial[k]:
                row[dead[:, k]] = 0
            V[:, i] = row
            prev = row if dtype is np.int32 else V[:, i].astype(np.int32)
    return V, A, B


def _find_max(w, band, V):
    """(found, i, j, score) as the aligner's find-max picks it, over one
    problem's scores V (x_size, Y)."""
    Y = 2 * band + 1
    X = w.x_size
    if w.end_a >= w.begin_a + band:
        i0, j0 = w.end_a - (w.begin_a + band), 2 * band
    else:
        i0, j0 = 0, 2 * band - (w.begin_a + band - w.end_a)
    ci, cj = [], []
    if not w.force_end:
        pos = w.begin_a + (X - 1) + np.arange(Y) - band
        ok = np.nonzero((pos >= 0) & (pos <= w.end_a))[0]
        ci.append(np.full(len(ok), X - 1))
        cj.append(ok)
    n = max(0, min(X - i0, j0 + 1))
    if n:
        ii = i0 + np.arange(n)
        if w.force_end:
            ii = ii[(X - 1 - FORCE_MAXGAP_LEN >= 0)
                    & (X - 1 - FORCE_MAXGAP_LEN <= ii)]
        ci.append(ii)
        cj.append(j0 - (ii - i0))
    ci = np.concatenate(ci) if ci else np.zeros(0, np.int64)
    cj = np.concatenate(cj) if cj else np.zeros(0, np.int64)
    if len(ci) == 0:
        return False, 0, 0, 0
    v = V[ci, cj]
    k = int(np.argmax(v))  # the first of the largest
    return True, int(ci[k]), int(cj[k]), int(v[k])


def _walk(w, band, V, A_row, B_row, i, j, wrap):
    """The aligner's traceback from (i, j), cell by cell over the stored
    scores: (edits, matches, final x, final pos)."""
    Y = 2 * band + 1
    v = memoryview(np.ascontiguousarray(V).reshape(-1))
    a = A_row.tobytes()
    b = B_row.tobytes()
    fs = w.force_start
    x, y = i, j
    pos0 = w.begin_a - band
    pos = pos0 + x + y
    edits = bytearray()
    matches = 0
    while x >= 0 and y >= 0 and pos >= 0:
        ca, cb = a[x + y], b[x]
        s = _SC[ca][cb]
        cur = v[x * Y + y]
        if pos == 0:
            left = NEG_INF if fs and x > FORCE_MAXGAP_LEN else GAP
            if cur == s:
                move = DIAG
            elif y == Y - 1 or cur == left:
                move = LEFT
            else:
                move = UP
        else:
            diag = (v[(x - 1) * Y + y] if x > 0 else 0) + s
            up = v[(x - 1) * Y + y + 1] + GAP if x > 0 and y < Y - 1 else GAP
            if fs and x == 0:
                up = GAP if pos <= FORCE_MAXGAP_LEN else NEG_INF
            if wrap:
                diag = wrap(diag)
                up = wrap(up) if up != NEG_INF else up
            if cur == diag:
                move = DIAG
            elif 0 < y < Y - 1 and cur == up:
                move = UP
            elif 0 < y < Y - 1:
                move = LEFT
            elif y < Y - 1:
                move = UP
            else:
                move = LEFT
        if move == DIAG:
            if ca == cb or ca == N_CODE or cb == N_CODE:
                edits.append(MATCH)
                matches += 1
            else:
                edits.append(MISMATCH)
            x -= 1
        elif move == UP:
            edits.append(GAP_A)
            x -= 1
            y += 1
        else:
            edits.append(GAP_B)
            y -= 1
        pos = pos0 + x + y
    edits.reverse()
    return np.frombuffer(bytes(edits), np.uint8), matches, x, pos


_DA = np.array([0, 1, 1, 1], np.int64)  # A advance of each edit code
_DB = np.array([1, 0, 1, 1], np.int64)


def summary(begin_a, begin_b, a_size, b_size, score, edits, matches):
    """The fields every returned alignment is compared on: (begin_a,
    begin_b, a_size, b_size, score, homology, length, matches, first
    match, last match), the match positions with GAM-NGS's no-match
    fallbacks (my_alignment.cc)."""
    n = len(edits)
    homology = 0.0 if n == 0 else matches * 100.0 / n
    m = np.nonzero(edits == MATCH)[0]
    e = edits.astype(np.int64)

    def at(k):
        return (begin_a + int(_DA[e[:k]].sum()),
                begin_b + int(_DB[e[:k]].sum()))

    if len(m):
        first, last = (True, at(int(m[0]))), (True, at(int(m[-1])))
    else:
        first, last = (False, at(n)), (False, (begin_a, begin_b))
    return (int(begin_a), int(begin_b), int(a_size), int(b_size),
            int(score), homology, n, int(matches), first, last)


EMPTY = summary(0, 0, 0, 0, 0, np.zeros(0, np.uint8), 0)


def align_windows(ws: list[Window], band: int, dtype=np.int32) -> list:
    """summary() of each window's alignment, filled in lockstep groups of
    similar length."""
    out = [EMPTY] * len(ws)
    order = sorted((k for k, w in enumerate(ws) if w.x_size > 0),
                   key=lambda k: ws[k].x_size)
    Y = 2 * band + 1
    groups, cur = [], []
    for k in order:
        x = ws[k].x_size
        if cur and (x > 1.25 * ws[cur[0]].x_size + 64
                    or (len(cur) + 1) * x * Y > GROUP_CELLS
                    or len(cur) == 32):
            groups.append(cur)
            cur = []
        cur.append(k)
    if cur:
        groups.append(cur)
    wrap = _wrap16 if np.dtype(dtype) == np.int16 else None
    for grp in groups:
        gws = [ws[k] for k in grp]
        V, A, B = _fill_group(gws, band, dtype)
        for g, (k, w) in enumerate(zip(grp, gws)):
            Vg = V[g, :w.x_size]
            found, i, j, score = _find_max(w, band, Vg)
            if not found:
                continue
            edits, matches, x, pos = _walk(w, band, Vg, A[g], B[g], i, j,
                                           wrap)
            out[k] = summary(pos + 1, w.begin_b + x + 1, w.a_len, w.b_len,
                             score, edits, matches)
        del V
    return out


def align(problems, band: int, dtype=np.int32) -> list:
    """summary() of each (a, begin_a, end_a, b, begin_b, end_b,
    force_start, force_end) problem's alignment."""
    return align_windows([Window(*p, band) for p in problems], band, dtype)


def _align_job(job):
    ws, band, dtype_name = job
    return align_windows(ws, band, np.dtype(dtype_name).type)


def align_parallel(problems, band: int, dtype=np.int32, workers: int = 1):
    """align() over `workers` spawned processes, the problems dealt out
    by their band cells (largest first), results in problem order."""
    ws = [Window(*p, band) for p in problems]
    if workers <= 1 or len(ws) < 2:
        return align_windows(ws, band, dtype)
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    loads = [0] * workers
    parts: list[list[int]] = [[] for _ in range(workers)]
    for k in sorted(range(len(ws)), key=lambda k: -ws[k].x_size):
        d = loads.index(min(loads))
        parts[d].append(k)
        loads[d] += ws[k].x_size
    parts = [p for p in parts if p]
    jobs = [([ws[k] for k in p], band, np.dtype(dtype).name) for p in parts]
    # a worker that dies raises here (BrokenProcessPool) instead of
    # leaving the map waiting; leaving the block waits for every worker
    with ProcessPoolExecutor(len(jobs),
                             mp_context=mp.get_context("spawn")) as pool:
        res = list(pool.map(_align_job, jobs))
    out = [EMPTY] * len(ws)
    for p, r in zip(parts, res):
        for k, s in zip(p, r):
            out[k] = s
    return out
