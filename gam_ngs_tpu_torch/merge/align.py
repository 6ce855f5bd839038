"""Per-vertex contig alignment: findBestAlignment / alignBlocks / alignMergeBlock.

Reference: lib/src/pctg/PctgBuilder.cc:726-845 and
:1361-1724.  Strand hypothesis from block read evidence; chained
per-block banded-SW windows, each seeded by the previous block's last
match plus the inter-frame gap; a failed pass retries with the
reverse-complemented slave; optional tail extension anchored by ABlast
seeds with end-forced alignments.

The call chain is written as generators: every banded-SW invocation is
a `yield (a, begin_a, end_a, b, begin_b, end_b, force_start,
force_end)` that receives the Alignment back.  Two drivers exist:

  * the sequential wrappers below (`align_blocks`, `find_best_alignment`,
    `align_merge_block`) feed each yielded problem straight to an
    `aligner` callable — identical behaviour to a direct implementation;
  * merge.scheduler drives MANY generators in lockstep, batching each
    round's yielded problems into one BswEngine.align_many call — the
    device replaces the reference's pthread pool
    (lib/src/pctg/ThreadedBuildPctg.cc:144) with wavefront batching,
    and the result sequence per generator is exactly the sequential one.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..io.blocks_io import BlockTable
from ..io.fasta import reverse_complement
from ..ops import ablast
from ..ops.bsw_ref import bsw_align
from ..ops.editops import Alignment, first_match_pos, last_match_pos
from .mergeblock import MergeBlock

MIN_HOMOLOGY = 95.0  # PctgBuilder.hpp:63


@dataclass
class BestCtgAlignment:
    main: list[Alignment] = field(default_factory=list)
    left: Alignment = field(default_factory=lambda: Alignment(homology=100.0))
    right: Alignment = field(default_factory=lambda: Alignment(homology=100.0))
    is_ctg_rev: bool = False
    left_rev: bool = False
    right_rev: bool = False

    def main_homology(self) -> float:
        if not self.main:
            return 0.0
        return min(a.homology for a in self.main)


def is_good_vec(aligns: list[Alignment], min_align_len: float) -> bool:
    total = 0
    for a in aligns:
        if a.homology < MIN_HOMOLOGY:
            return False
        total += a.length
    return total >= min_align_len


def is_good(align: Alignment, min_align_len: float) -> bool:
    return align.homology >= MIN_HOMOLOGY and align.length >= min_align_len


def drive(gen, aligner):
    """Run an alignment generator to completion with a direct aligner."""
    try:
        pr = next(gen)
        while True:
            pr = gen.send(aligner(*pr))
    except StopIteration as e:
        return e.value


def align_blocks_gen(master_ctg: np.ndarray, master_start: int,
                     slave_ctg: np.ndarray, slave_start: int,
                     blocks: BlockTable, rows: list[int]):
    """PctgBuilder::alignBlocks (:1617)."""
    out: list[Alignment] = []
    first_begin = int(blocks.m_begin[rows[0]])
    last_begin = int(blocks.m_begin[rows[-1]])
    ordered = rows if first_begin <= last_begin else rows[::-1]

    m_start_align = master_start
    s_start_align = slave_start
    prev_mb = prev_me = prev_sb = prev_se = 0
    last_match = (0, 0)

    for idx, r in enumerate(ordered):
        mb, me = int(blocks.m_begin[r]), int(blocks.m_end[r])
        sb, se = int(blocks.s_begin[r]), int(blocks.s_end[r])
        mlen = me - mb + 1 if me >= mb else 0
        slen = se - sb + 1 if se >= sb else 0

        if idx > 0:
            mgap = (mb - prev_me - 1) if prev_mb <= mb else (prev_mb - me - 1)
            sgap = (sb - prev_se - 1) if prev_sb <= sb else (prev_sb - se - 1)
            m_start_align = max(last_match[0] + mgap, 0)
            s_start_align = max(last_match[1] + sgap, 0)

        aln = yield (master_ctg, m_start_align, m_start_align + mlen - 1,
                     slave_ctg, s_start_align, s_start_align + slen - 1,
                     False, False)
        out.append(aln)
        _, last_match = last_match_pos(aln)

        prev_mb, prev_me, prev_sb, prev_se = mb, me, sb, se

    return out


def find_best_alignment_gen(master_ctg: np.ndarray, master_start: int,
                            master_end: int, slave_ctg: np.ndarray,
                            slave_start: int, slave_end: int,
                            blocks: BlockTable, rows: list[int]):
    """PctgBuilder::findBestAlignment (:1361).

    Returns (best, oriented_slave) where oriented_slave is the slave
    contig in the orientation of the returned alignments (the reference
    mutates the caller's contig in place).
    """
    con_evid = 0
    dis_evid = 0
    min_frame_len = 100
    blocks_num = len(rows)

    for k, r in enumerate(rows):
        ml = int(blocks.m_end[r]) - int(blocks.m_begin[r]) + 1
        sl = int(blocks.s_end[r]) - int(blocks.s_begin[r]) + 1
        ml = max(ml, 0)
        sl = max(sl, 0)
        min_len = min(ml, sl)
        if k == 0 or min_len < min_frame_len:
            min_frame_len = min_len
        if blocks.m_strand[r] != blocks.s_strand[r]:
            dis_evid += int(blocks.num_reads[r])
        else:
            con_evid += int(blocks.num_reads[r])

    con_prob = con_evid / float(con_evid + dis_evid)

    mt = int(0.3 * len(master_ctg))
    st = int(0.3 * len(slave_ctg))
    align_threshold = 0.7 * min_frame_len
    threshold = min(200, mt, st)

    good_found = False
    is_slave_rev = False
    aligns: list[Alignment] = []
    cur_slave = slave_ctg
    s_start, s_end = slave_start, slave_end

    def flip():
        nonlocal cur_slave, s_start, s_end
        cur_slave = reverse_complement(cur_slave)
        tmp = s_start
        s_start = len(cur_slave) - s_end - 1
        s_end = len(cur_slave) - tmp - 1

    if con_prob >= 0.5:
        aligns = yield from align_blocks_gen(master_ctg, master_start,
                                             cur_slave, s_start, blocks, rows)
        if is_good_vec(aligns, align_threshold):
            good_found, is_slave_rev = True, False
        else:
            flip()
            aligns = yield from align_blocks_gen(master_ctg, master_start,
                                                 cur_slave, s_start, blocks,
                                                 rows)
            if is_good_vec(aligns, align_threshold):
                good_found, is_slave_rev = True, True
    else:
        flip()
        aligns = yield from align_blocks_gen(master_ctg, master_start,
                                             cur_slave, s_start, blocks, rows)
        if is_good_vec(aligns, align_threshold):
            good_found, is_slave_rev = True, True
        else:
            flip()
            aligns = yield from align_blocks_gen(master_ctg, master_start,
                                                 cur_slave, s_start, blocks,
                                                 rows)
            if is_good_vec(aligns, align_threshold):
                good_found, is_slave_rev = True, False

    if not good_found or len(aligns) != blocks_num or blocks_num == 0:
        return (BestCtgAlignment(main=[Alignment(homology=0.0)],
                                 is_ctg_rev=is_slave_rev), cur_slave)

    _, align_start = first_match_pos(aligns[0])
    _, align_end = last_match_pos(aligns[blocks_num - 1])

    i1 = align_start[0]
    i2 = len(master_ctg) - align_end[0] - 1
    j1 = align_start[1]
    j2 = len(cur_slave) - align_end[1] - 1

    if min(i1, j1) < threshold and min(i2, j2) < threshold:
        return (BestCtgAlignment(main=aligns, is_ctg_rev=is_slave_rev),
                cur_slave)

    left = Alignment(homology=100.0)
    right = Alignment(homology=100.0)
    left_rev = right_rev = False

    if min(i1, j1) >= threshold:
        if i1 < j1:
            hits = ablast.find_hits(cur_slave, 0, align_start[1] - 1,
                                    master_ctg, 0, align_start[0] - 1)
            if hits:
                left = yield (cur_slave, hits[-1], align_start[1] - 1,
                              master_ctg, 0, align_start[0] - 1, False, True)
            else:
                left = yield (cur_slave, align_start[1] - align_start[0],
                              align_start[1] - 1, master_ctg, 0,
                              align_start[0] - 1, False, True)
            left_rev = True
        else:
            hits = ablast.find_hits(master_ctg, 0, align_start[0] - 1,
                                    cur_slave, 0, align_start[1] - 1)
            if hits:
                left = yield (master_ctg, hits[-1], align_start[0] - 1,
                              cur_slave, 0, align_start[1] - 1, False, True)
            else:
                left = yield (master_ctg, align_start[0] - align_start[1],
                              align_start[0] - 1, cur_slave, 0,
                              align_start[1] - 1, False, True)
            left_rev = False

    if min(i2, j2) >= threshold:
        if i2 < j2:
            right_tail = cur_slave[align_end[1] + 1:]
            hits = ablast.find_hits(right_tail, 0, len(right_tail) - 1,
                                    master_ctg, align_end[0] + 1,
                                    len(master_ctg) - 1)
            start_a = hits[0] if hits else 0
            right = yield (right_tail, start_a, len(right_tail) - 1,
                           master_ctg, align_end[0] + 1,
                           len(master_ctg) - 1, True, False)
            right_rev = True
        else:
            right_tail = master_ctg[align_end[0] + 1:]
            hits = ablast.find_hits(right_tail, 0, len(right_tail) - 1,
                                    cur_slave, align_end[1] + 1,
                                    len(cur_slave) - 1)
            start_a = hits[0] if hits else 0
            right = yield (right_tail, start_a, len(right_tail) - 1,
                           cur_slave, align_end[1] + 1,
                           len(cur_slave) - 1, True, False)
            right_rev = False

    return (BestCtgAlignment(main=aligns, left=left, right=right,
                             is_ctg_rev=is_slave_rev, left_rev=left_rev,
                             right_rev=right_rev), cur_slave)


def align_merge_block_gen(graph, mb: MergeBlock, master_ref, slave_ref):
    """PctgBuilder::alignMergeBlock (:726) — fills mb's aligned coords."""
    blocks = graph.blocks
    rows = graph.vertex_rows[mb.vertex]
    rf, rl = rows[0], rows[-1]

    master_start = min(int(blocks.m_begin[rf]), int(blocks.m_begin[rl]))
    master_end = max(int(blocks.m_end[rf]), int(blocks.m_end[rl]))
    slave_start = min(int(blocks.s_begin[rf]), int(blocks.s_begin[rl]))
    slave_end = max(int(blocks.s_end[rf]), int(blocks.s_end[rl]))

    master_ctg = master_ref[mb.m_id].seq
    slave_ctg = slave_ref[mb.s_id].seq

    best, _oriented = yield from find_best_alignment_gen(
        master_ctg, master_start, master_end, slave_ctg, slave_start,
        slave_end, blocks, rows)

    mb.align_ok = True

    if best.main_homology() >= MIN_HOMOLOGY:
        _, align_start = first_match_pos(best.main[0])
        _, align_end = last_match_pos(best.main[-1])

        i1 = align_start[0]
        i2 = len(master_ctg) - align_end[0] - 1
        j1 = align_start[1]
        j2 = len(slave_ctg) - align_end[1] - 1

        mt = int(0.3 * len(master_ctg))
        st = int(0.3 * len(slave_ctg))
        left_min_len = int(0.7 * min(i1, j1))
        right_min_len = int(0.7 * min(i2, j2))
        threshold = min(100, mt, st)

        s_ltail = mb.s_rtail if best.is_ctg_rev else mb.s_ltail
        s_rtail = mb.s_ltail if best.is_ctg_rev else mb.s_rtail

        if mb.m_ltail and s_ltail and min(i1, j1) >= threshold:
            if is_good(best.left, left_min_len):
                _, align_start = first_match_pos(best.left)
                if best.left_rev:
                    align_start = (align_start[1], align_start[0])
            else:
                mb.align_ok = False

        if mb.m_rtail and s_rtail and min(i2, j2) >= threshold:
            if is_good(best.right, right_min_len):
                _, tmp_end = last_match_pos(best.right)
                if best.right_rev:
                    tmp_end = (tmp_end[1], tmp_end[0])
                    align_end = (tmp_end[0], align_end[1] + tmp_end[1] + 1)
                else:
                    align_end = (align_end[0] + tmp_end[0] + 1, tmp_end[1])
            else:
                mb.align_ok = False
    else:
        mb.align_ok = False
        return None

    if best.is_ctg_rev:
        tmp = align_start[1]
        align_start = (align_start[0], len(slave_ctg) - align_end[1] - 1)
        align_end = (align_end[0], len(slave_ctg) - tmp - 1)

    mb.align_rev = best.is_ctg_rev
    mb.m_start = int(align_start[0])
    mb.m_end = int(align_end[0])
    mb.s_start = int(align_start[1])
    mb.s_end = int(align_end[1])
    return None


# --- sequential drivers (reference-order, one aligner call at a time) ---

def align_blocks(master_ctg, master_start, slave_ctg, slave_start,
                 blocks: BlockTable, rows: list[int],
                 aligner=bsw_align) -> list[Alignment]:
    return drive(align_blocks_gen(master_ctg, master_start, slave_ctg,
                                  slave_start, blocks, rows), aligner)


def find_best_alignment(master_ctg, master_start, master_end, slave_ctg,
                        slave_start, slave_end, blocks: BlockTable,
                        rows: list[int], aligner=bsw_align):
    return drive(find_best_alignment_gen(master_ctg, master_start,
                                         master_end, slave_ctg, slave_start,
                                         slave_end, blocks, rows), aligner)


def align_merge_block(graph, mb: MergeBlock, master_ref, slave_ref,
                      aligner=bsw_align) -> None:
    return drive(align_merge_block_gen(graph, mb, master_ref, slave_ref),
                 aligner)
