"""The card's published peaks and the work the align problems need.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; the int32 rate is the
SMs x INT32 lanes a SM x the boost clock, at the 700 W power limit).
The work is counted from the problems and their answers, never from
which kernels ran or how many, so a fusion or a renaming of the kernels
leaves it reading the same work.  Operation counts per unit of work are
counted from the recurrence (as chip_smoke.py counts them):
- a band cell of the forward fill: its position (1), range test (2), A's
  code from its 4-bit pack (2; B's is one a row), the score (2),
  diag/up/left (3), their max (2), the direction (3) and packing it into
  its word (2): 17;
- a traceback step over the 2-bit words: the word's address (3) and field
  (4), the two codes from their packs (6), the match test (5), the
  counters (2), the move (4), the new position (2) and the loop test
  (5): 31;
- a find-max candidate: 8, with 2*(2*band+1) candidates a problem.
Bytes: each input byte read once and each output byte written once: a
problem's 4-bit A window (x_size + 2*band codes) and B rows (x_size
codes), its six int32 scalars, and its (13,) int32 summary.
"""

from __future__ import annotations

H100_SXM = {
    "sms": 132,
    "int32_lanes_per_sm": 64,
    "boost_mhz": 1980,
    "hbm_bytes_per_s": 3.35e12,
}
OPS_PER_CELL = 17
OPS_PER_WALK_STEP = 31
OPS_PER_CANDIDATE = 8


def int32_ops_per_s(peaks: dict = H100_SXM) -> float:
    return peaks["sms"] * peaks["int32_lanes_per_sm"] * peaks["boost_mhz"] * 1e6


def align_bound_s(rows: int, problems: int, walk_steps: int, band: int,
                  peaks: dict = H100_SXM) -> tuple[float, str]:
    """Least seconds the card could take for `problems` problems of
    `rows` rows in all, whose answers hold `walk_steps` edits in all:
    the larger of the operations bound and the bytes bound, and which."""
    ys = 2 * band + 1
    ops = (rows * ys * OPS_PER_CELL + walk_steps * OPS_PER_WALK_STEP
           + problems * 2 * ys * OPS_PER_CANDIDATE)
    n_bytes = ((rows * 2 + problems * 2 * band + 1) // 2
               + problems * (6 * 4 + 13 * 4))
    t_ops = ops / int32_ops_per_s(peaks)
    t_bytes = n_bytes / peaks["hbm_bytes_per_s"]
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
