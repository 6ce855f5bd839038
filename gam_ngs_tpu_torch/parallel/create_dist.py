"""Multi-process gam-create: sharded block construction + summed stats.

gam_ngs_tpu/parallel/create_dist.py on torch.distributed.  Distribution
layout:

  * block construction shards the SLAVE stream at contig boundaries —
    the device join's run segmentation never crosses a contig
    (ops/device_join.py), so shards are independent up to the single
    empty-slot carry bit, resolved by a tiny allgather fixpoint; the
    emission order is finalized globally after one allgather of the
    shard-local block arrays, byte-identical to the sequential scan;
  * library insert-size statistics reduce per-host moment triples
    (count, sum, sumsq), float64 sums on the host's device, combined
    across hosts with the reference's n+1-variance quirk
    (MultiBamReader.cc:346-430);
  * per-contig coverage vectors shard by contig range and allgather.

Every collective goes through distributed.allgather_obj (deadline +
poison semantics); single-process runs short-circuit to the local path.
The device work (the join and analysis of ops/device_join.py, the
moments) runs on the torch device each call is given.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.device_join import finalize_emission, local_block_arrays
from .distributed import allgather_obj


def shard_ranges_by_weight(weights: np.ndarray, nproc: int
                           ) -> list[tuple[int, int]]:
    """Split items 0..len-1 into nproc contiguous [lo, hi) ranges with
    near-equal total weight (deterministic greedy prefix cut)."""
    n = len(weights)
    total = float(weights.sum())
    cum = np.cumsum(weights, dtype=np.float64)
    ranges = []
    lo = 0
    for h in range(nproc):
        if h == nproc - 1:
            hi = n
        else:
            target = total * (h + 1) / nproc
            hi = int(np.searchsorted(cum, target, side="left")) + 1
            hi = max(lo, min(hi, n))
        ranges.append((lo, hi))
        lo = hi
    return ranges


def _slice_cols(cols: tuple, mask_or_idx) -> tuple:
    return tuple(c[mask_or_idx] for c in cols)


def distributed_find_blocks(m_cols: tuple, s_cols: tuple,
                            min_block_size: int, pid: int, nproc: int,
                            _allgather=None,
                            ctg_ranges: list[tuple[int, int]] | None = None,
                            s_local: bool = False, *,
                            device: torch.device) -> dict:
    """Sharded loadReadsMap+findBlocks; every host returns the full,
    byte-identical block columns (host 0 writes the file).

    Shards are contiguous slave-contig ranges (balanced by slave row
    count by default; pass ctg_ranges to shard by header contig length
    so hosts can range-decode only their shard — s_local=True then
    marks s_cols as already restricted to this host's range).  The
    carry fixpoint usually converges in one round: the empty-slot bit
    only exists when matched reads shorter than min-block-size end a
    shard (Block.cc:49 quirk).
    """
    gather = _allgather or allgather_obj
    if s_local:
        my_s = s_cols
    else:
        if ctg_ranges is None:
            n_sctg = int(s_cols[3].max()) + 1 if len(s_cols[3]) else 0
            rows_per_ctg = np.bincount(s_cols[3], minlength=max(n_sctg, 1))
            ctg_ranges = shard_ranges_by_weight(rows_per_ctg, nproc)
        lo, hi = ctg_ranges[pid]
        sel = (s_cols[3] >= lo) & (s_cols[3] < hi)
        my_s = _slice_cols(s_cols, sel)

    carry_in = False
    local = local_block_arrays(m_cols, my_s, min_block_size,
                               carry_in=carry_in, device=device)
    # fixpoint on the carry bits: each round gathers (carry_in_used,
    # carry_out); hosts whose desired carry_in changed recompute.  The
    # chain is feed-forward, so round k settles boundary k; real data
    # converges in round 1 (no short matched reads -> no carry at all).
    for _round in range(max(nproc, 1)):
        bits = gather((pid, carry_in, bool(local["carry_out"])))
        used = [False] * nproc
        out = [False] * nproc
        for p, ci, co in bits:
            used[p] = ci
            out[p] = co
        desired = [False] + out[:-1]
        if desired == used:
            break
        if desired[pid] != carry_in:
            carry_in = desired[pid]
            local = local_block_arrays(m_cols, my_s, min_block_size,
                                       carry_in=carry_in, device=device)

    shards = gather((pid, local))
    by_pid = {p: loc for p, loc in shards}
    ordered = [by_pid[p] for p in range(nproc)]
    return finalize_emission(ordered, min_block_size)


def distributed_library_stats(mb, require_paired_flag: bool, pid: int,
                              nproc: int, _allgather=None,
                              rows_are_local: bool = False, *,
                              device: torch.device) -> None:
    """Sharded per-library isize/coverage stats, filled into `mb`.

    Each host reduces its row shard of every library to the insert
    sizes' (count, sum, sumsq), as a float64 reduction on `device`, and
    core/stats.py::isize_stats_psum sums them over the hosts through the
    allgather; one more allgather sums the read lengths.  var divides by
    n+1 to keep the reference's Welford quirk
    (MultiBamReader.cc:415-421).  rows_are_local=True means `mb` was
    range-decoded: every resident row belongs to this host already.
    """
    from ..core import stats as stats_mod

    gather = _allgather or allgather_obj
    mb.isize_mean, mb.isize_std, reads = [], [], []
    for i, f in enumerate(mb.files):
        t = f.table
        n = len(t)
        if rows_are_local:
            lo, hi = 0, n
        else:
            lo, hi = shard_ranges_by_weight(np.ones(n, np.int64), nproc)[pid] \
                if n else (0, 0)
        sub = _table_slice(t, slice(lo, hi))
        ins = stats_mod.filtered_inserts(
            sub, mb.min_insert[i], mb.max_insert[i], require_paired_flag)
        mean, std, _n = stats_mod.isize_stats_psum(
            torch.from_numpy(np.asarray(ins, np.float64)).to(device),
            allgather=gather)
        mb.isize_mean.append(float(mean))
        mb.isize_std.append(float(std))
        good = sub.is_good_quality()
        reads.append(int((sub.end_pos[good] - sub.pos[good])
                         .astype(np.int64).sum()))
    mb.coverage = [sum(v) / float(mb.asm_size) if mb.asm_size else 0.0
                   for v in zip(*gather(reads))]


def _table_slice(t, sl: slice):
    from ..io.bam import AlignmentTable

    return AlignmentTable(**{
        k: getattr(t, k)[sl] for k in (
            "ref_id", "pos", "end_pos", "flag", "l_seq", "mate_ref_id",
            "mate_pos", "nh", "xt", "name_h1", "name_h2")})


def distributed_coverage_vectors(mb, no_mult_filter: bool, pid: int,
                                 nproc: int, _allgather=None,
                                 ranges: list[tuple[int, int]] | None = None
                                 ) -> list[np.ndarray]:
    """Per-contig coverage, contig ranges sharded across hosts and
    allgathered (reference Read.cc:110-118 per-base increments).  Pass
    `ranges` to reuse the decode shards of a range-decoded `mb` (any
    contiguous cover works: the per-contig filter below makes ranged
    and full tables equivalent)."""
    from ..core.blocks import coverage_vectors

    if nproc == 1 and _allgather is None:
        return coverage_vectors(mb, no_mult_filter)

    gather = _allgather or allgather_obj
    lengths = mb.ref_lengths
    if ranges is None:
        ranges = shard_ranges_by_weight(
            np.asarray(lengths, np.int64) + 1, nproc)
    lo, hi = ranges[pid]

    diffs = [np.zeros(l + 1, np.int64) for l in lengths[lo:hi]]
    for f in mb.files:
        t = f.table
        keep = (t.is_good_quality() & t.is_uniq_mapped(no_mult_filter)
                & (t.ref_id >= lo) & (t.ref_id < hi))
        ref = t.ref_id[keep]
        start = t.pos[keep]
        end = t.end_pos[keep]
        for c in range(lo, hi):
            m = ref == c
            if not m.any():
                continue
            np.add.at(diffs[c - lo], start[m], 1)
            np.add.at(diffs[c - lo], np.minimum(end[m], lengths[c]), -1)
    mine = [np.cumsum(d[:-1]).astype(np.uint32) for d in diffs]

    shards = gather((pid, mine))
    by_pid = {p: v for p, v in shards}
    out: list[np.ndarray] = []
    for p in range(nproc):
        out.extend(by_pid[p])
    if len(out) != len(lengths):
        raise RuntimeError("coverage shards do not cover every contig")
    return out
