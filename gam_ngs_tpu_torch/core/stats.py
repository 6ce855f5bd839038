"""Per-library insert-size and coverage statistics.

Replicates MultiBamReader's streaming Welford update bit-for-bit
(lib/src/bam/MultiBamReader.cc:346-429, 430-529):

  * only good-quality first-mate reads with a mapped mate on the same
    contig contribute;
  * FR-orientation gated: fwd read needs a reverse mate downstream, rev
    read needs a forward mate upstream;
  * iSize = (mate_start + l_seq) - start      for a forward first read
           = (start + aln_len) - mate_start   for a reverse first read
    where aln_len = end_pos - pos (reference-consumed length);
  * inserts outside [min_insert, max_insert] are skipped;
  * the running count starts at 1 and the final std divides by the
    FINAL count (i.e. n_samples + 1) — a reference quirk we keep;
  * coverage = sum(end_pos - pos over good-quality reads) / assembly size.

`welford_isize_stats` performs the sequential (order-dependent) update in
float64 exactly as C++ does; `isize_stats_psum` is the device version
built from moments, which the multi-process create sums over its
processes (mathematically equal, bit-different).
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.bam import (
    AlignmentTable,
    FPAIRED,
    FMUNMAP,
    FREVERSE,
    FMREVERSE,
    FREAD1,
)


def filtered_inserts(table: AlignmentTable, min_insert: int, max_insert: int,
                     require_paired_flag: bool) -> np.ndarray:
    """Insert sizes (file order) passing the reference filters.

    require_paired_flag distinguishes the GetNextAlignment path (checks
    IsPaired, MultiBamReader.cc:353) from computeStatistics (does not,
    :461).
    """
    ok = table.is_good_quality()
    if require_paired_flag:
        ok &= (table.flag & FPAIRED) != 0
    ok &= (table.flag & FREAD1) != 0
    ok &= (table.flag & FMUNMAP) == 0
    ok &= table.ref_id == table.mate_ref_id

    start = table.pos.astype(np.int64)
    mate_start = table.mate_pos.astype(np.int64)
    aln_len = (table.end_pos - table.pos).astype(np.int64)

    fwd_first = start < mate_start
    isize = np.where(
        fwd_first,
        mate_start + table.l_seq.astype(np.int64) - start,
        start + aln_len - mate_start,
    )

    orient_ok = np.where(
        fwd_first,
        ((table.flag & FREVERSE) == 0) & ((table.flag & FMREVERSE) != 0),
        ((table.flag & FREVERSE) != 0) & ((table.flag & FMREVERSE) == 0),
    )

    in_bounds = (isize >= min_insert) & (isize <= max_insert)
    return isize[ok & in_bounds & orient_ok]


def welford_isize_stats(inserts: np.ndarray) -> tuple[float, float, int]:
    """Sequential Welford identical to the reference (returns mean, std, count).

    count starts at 1; std = sqrt(M2 / final_count).
    """
    count = 1
    mean = 0.0
    m2 = 0.0
    for x in inserts.tolist():
        if count == 1:
            mean = float(x)
            m2 = 0.0
            count += 1
        else:
            old_mean = mean
            mean = old_mean + (x - old_mean) / float(count)
            m2 = m2 + (count - 1) * (x - old_mean) * (x - old_mean) / float(count)
            count += 1
    std = float(np.sqrt(m2 / float(count)))
    return mean, std, count


def library_stats(table: AlignmentTable, asm_size: int, min_insert: int,
                  max_insert: int, require_paired_flag: bool
                  ) -> tuple[float, float, float]:
    """(mean, std, coverage) for one library table."""
    ins = filtered_inserts(table, min_insert, max_insert, require_paired_flag)
    from ..native.loader import welford_native

    res = welford_native(ins)
    if res is not None:
        mean, std = res
    else:
        mean, std, _ = welford_isize_stats(ins)
    good = table.is_good_quality()
    reads_len = int((table.end_pos[good] - table.pos[good]).astype(np.int64).sum())
    coverage = reads_len / float(asm_size) if asm_size != 0 else 0.0
    return mean, std, coverage


def isize_stats_psum(inserts: torch.Tensor, allgather=None):
    """Moment-based mean/std on the insert tensor's device, summed over
    the processes when `allgather` is given.

    The count, sum and sum of squares reduce as float64 on the device;
    `allgather` (parallel/distributed.py::allgather_obj, the sharded
    create's collective) collects every process's three numbers in
    process order and they are summed on the host.  Matches the Welford
    result up to float rounding; the one-process .isize output uses the
    host path.  Returns (mean, std, n) as float64 scalar tensors.
    """
    x = inserts.to(torch.float64)
    mom = torch.stack([torch.tensor(float(x.shape[0]), dtype=torch.float64,
                                    device=x.device), x.sum(), (x * x).sum()])
    if allgather is not None:
        mom = torch.tensor([sum(v) for v in zip(*allgather(mom.tolist()))],
                           dtype=torch.float64)
    n, s, ss = mom.unbind(0)
    mean = s / torch.clamp(n, min=1)
    # reference quirk: count starts at 1, so the sequential version
    # divides M2 by (n_samples + 1)
    var = torch.clamp(ss - n * mean * mean, min=0.0) / torch.clamp(n + 1,
                                                                   min=1)
    return mean, torch.sqrt(var), n
