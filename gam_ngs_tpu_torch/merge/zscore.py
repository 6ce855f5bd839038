"""Insert-size z-scores of a region, per library.

Reference: computeZScore (lib/src/PartitionFunctions.cc:173).
Counts proper first-mate inserts fully contained in [start, end] and
compares the local mean insert against the library's global stats.
Used by appendBlocksRegionToPctg to choose master vs slave copy of a
duplicated-length region.

The production path (`compute_zscore`) evaluates all record filters as
vectorized numpy column operations over the binary-searched region
slice — the reference's per-record BamReader loop becomes a handful of
masked reductions.  `compute_zscore_scalar` is the per-row oracle kept
for differential tests.
"""

from __future__ import annotations

import math

import numpy as np

from ..core.multibam import MultiBam
from ..io.bam import FMUNMAP, FREAD1

_SKIP_FLAGS = 0x4 | 0x100 | 0x200 | 0x400 | FMUNMAP

MIN_INSERT_NUM = 5


def compute_zscore(mb: MultiBam, ref_id: int, start: int, end: int,
                   no_mult_filter: bool = False) -> list[float]:
    z_score = [0.0] * mb.size
    for i in range(mb.size):
        mean = mb.isize_mean[i]
        std = mb.isize_std[i]
        if std == 0:
            continue
        min_insert = int(mean - 3 * std) if mean > 3 * std else 0
        max_insert = int(mean + 3 * std)

        rows = mb.region_rows(i, ref_id, start, end + 1)
        if rows.size == 0:
            continue
        t = mb.files[i].table

        flag = t.flag[rows].astype(np.int64)
        read_start = t.pos[rows].astype(np.int64)
        read_end = t.end_pos[rows].astype(np.int64) - 1
        read_len = read_end - read_start + 1
        mate_start = t.mate_pos[rows].astype(np.int64)
        mate_end = mate_start + read_len - 1

        keep = ((flag & _SKIP_FLAGS) == 0) & (read_start >= 0)
        keep &= t.ref_id[rows] == t.mate_ref_id[rows]
        keep &= (read_start >= start) & (read_end <= end)
        keep &= (mate_start >= start) & (mate_end <= end)
        if not no_mult_filter:
            keep &= (t.nh[rows] == 1) & (t.xt[rows] == ord("U"))
        keep &= (flag & FREAD1) != 0
        i_size = np.where(read_start < mate_start,
                          mate_start + read_len - read_start,
                          read_end - mate_start + 1)
        keep &= (i_size >= min_insert) & (i_size <= max_insert)

        inserts = int(np.count_nonzero(keep))
        if inserts > MIN_INSERT_NUM:
            local_mean = int(i_size[keep].sum()) / float(inserts)
            z_score[i] = (local_mean - mean) / (std / math.sqrt(inserts))

    return z_score


def compute_zscore_scalar(mb: MultiBam, ref_id: int, start: int, end: int,
                          no_mult_filter: bool = False) -> list[float]:
    """Per-row oracle mirroring PartitionFunctions.cc:173 exactly."""
    z_score = [0.0] * mb.size
    if mb.size == 0:
        return z_score

    for i in range(mb.size):
        mean = mb.isize_mean[i]
        std = mb.isize_std[i]
        if std == 0:
            continue
        min_insert = int(mean - 3 * std) if mean > 3 * std else 0
        max_insert = int(mean + 3 * std)

        rows = mb.region_rows(i, ref_id, start, end + 1)
        t = mb.files[i].table

        inserts = 0
        span_cov = 0
        for r in rows.tolist():
            flag = int(t.flag[r])
            if (flag & 0x4) or t.pos[r] < 0 or (flag & 0x400) or \
               (flag & 0x100) or (flag & 0x200) or (flag & FMUNMAP) or \
               t.ref_id[r] != t.mate_ref_id[r]:
                continue
            read_start = int(t.pos[r])
            read_end = int(t.end_pos[r]) - 1
            read_len = read_end - read_start + 1
            mate_start = int(t.mate_pos[r])
            mate_end = mate_start + read_len - 1
            if read_start < start or read_end > end:
                continue
            if mate_start < start or mate_end > end:
                continue
            if not no_mult_filter and not (
                    t.nh[r] == 1 and t.xt[r] == ord("U")):
                continue
            if not (flag & FREAD1):
                continue
            if read_start < mate_start:
                i_size = (mate_start + read_len) - read_start
            else:
                i_size = read_end - mate_start + 1
            if i_size < min_insert or i_size > max_insert:
                continue
            inserts += 1
            span_cov += i_size

        if inserts > MIN_INSERT_NUM:
            local_mean = span_cov / float(inserts)
            z_score[i] = (local_mean - mean) / (std / math.sqrt(inserts))

    return z_score
