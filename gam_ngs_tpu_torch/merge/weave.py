"""Merge-list normalization passes + contig weaving (buildPctgs).

Reference: PctgBuilder (lib/src/pctg/PctgBuilder.cc):
  * splitMergeBlocksByAlign (:667) — drop failed vertices, split runs;
  * splitMergeBlocksByDirection (:543) — propagate m_rev/s_rev via
    align_rev XOR along the chain; a merge-direction flip drops the
    flipping vertex and splits (with the reference's 3-in-a-row
    exceptions);
  * sortMergeBlocksByDirection (:507) — canonicalize list order;
  * splitMergeBlocksByInclusions (:291) — normalize coordinates to the
    oriented contigs and drop/split on containment anomalies (including
    the reference's no-op tail-flag write in the slave branch);
  * buildPctgs (:172) — weave master/slave segments into PairedContigs,
    choosing the copy of each block region by length similarity or
    insert-size z-score (appendBlocksRegionToPctg :134).
"""

from __future__ import annotations

import numpy as np

from ..core.multibam import MultiBam
from ..core.refseq import RefSequence
from ..io.fasta import reverse_complement
from .mergeblock import MergeBlock
from .pctg import CtgInPctg, PairedContig
from .zscore import compute_zscore

MergeBlockLists = list  # list[list[MergeBlock]]


def split_merge_blocks_by_align(ml_in: MergeBlockLists) -> MergeBlockLists:
    ml_out = []
    for ml in ml_in:
        ml_new: list[MergeBlock] = []
        prev_failed = False
        n = len(ml)
        for k in range(n):
            cur = ml[k]
            nxt = ml[k + 1] if k + 1 < n else None
            if not cur.align_ok:
                prev_failed = True
                continue
            if prev_failed:
                cur.ext_slave_prev = False
            if nxt is not None and not nxt.align_ok:
                cur.ext_slave_next = False
            if ml_new:
                if not prev_failed and (ml_new[-1].m_id == cur.m_id
                                        or ml_new[-1].s_id == cur.s_id):
                    ml_new.append(cur.copy())
                elif prev_failed and ml_new[-1].m_id == cur.m_id:
                    ml_new.append(cur.copy())
                else:
                    ml_out.append(ml_new)
                    ml_new = [cur.copy()]
            else:
                ml_new.append(cur.copy())
            prev_failed = False
        if ml_new:
            ml_out.append(ml_new)
    return ml_out


def split_merge_blocks_by_direction(ml_in: MergeBlockLists) -> MergeBlockLists:
    ml_out = []
    for ml in ml_in:
        first = True
        split_prev = False
        fwd_merge = True
        fwd_merge_prev = True
        master_rev = slave_rev = False
        master_id = slave_id = 0
        ml_new: list[MergeBlock] = []

        n = len(ml)
        k = 0
        while k < n:
            cur = ml[k]
            nxt = ml[k + 1] if k + 1 < n else None
            k += 1

            if first:
                master_id = cur.m_id
                slave_id = cur.s_id
                master_rev = False
                slave_rev = cur.align_rev
                cur.m_rev = master_rev
                cur.s_rev = slave_rev
                if split_prev:
                    cur.ext_slave_prev = False
                    split_prev = False
                if nxt is not None:
                    if cur.m_id == nxt.m_id:
                        fwd_merge = cur.m_start <= nxt.m_start
                    else:
                        if not slave_rev:
                            fwd_merge = cur.s_start <= nxt.s_start
                        else:
                            fwd_merge = cur.s_start >= nxt.s_start
                first = False
                fwd_merge_prev = fwd_merge
                ml_new.append(cur.copy())
            else:
                if master_id == cur.m_id:
                    slave_rev = master_rev != cur.align_rev
                if slave_id == cur.s_id:
                    master_rev = slave_rev != cur.align_rev
                cur.m_rev = master_rev
                cur.s_rev = slave_rev

                if nxt is not None:
                    if cur.m_id == nxt.m_id:
                        fwd_merge = (cur.m_start <= nxt.m_start
                                     if not master_rev
                                     else cur.m_start >= nxt.m_start)
                    else:
                        fwd_merge = (cur.s_start <= nxt.s_start
                                     if not slave_rev
                                     else cur.s_start >= nxt.s_start)

                    if fwd_merge != fwd_merge_prev:
                        if ml_new[-1].m_id == cur.m_id and cur.m_id == nxt.m_id:
                            ml_new.append(cur.copy())
                            master_id = cur.m_id
                            slave_id = cur.s_id
                            continue
                        if ml_new[-1].s_id == cur.s_id and cur.s_id == nxt.s_id:
                            ml_new.append(cur.copy())
                            master_id = cur.m_id
                            slave_id = cur.s_id
                            continue
                        ml_new[-1].ext_slave_next = False
                        split_prev = True
                        first = True
                        if ml_new:
                            ml_out.append(ml_new)
                        ml_new = []
                        continue  # NOTE: cur is dropped

                ml_new.append(cur.copy())
                master_id = cur.m_id
                slave_id = cur.s_id

        if ml_new:
            ml_out.append(ml_new)
    return ml_out


def sort_merge_blocks_by_direction(ml_in: MergeBlockLists) -> None:
    for ml in ml_in:
        if len(ml) < 2:
            continue
        first, second = ml[0], ml[1]
        slave_rev = first.align_rev
        if first.m_id == second.m_id:
            fwd_merge = first.m_start <= second.m_start
        else:
            if not slave_rev:
                fwd_merge = first.s_start <= second.s_start
            else:
                fwd_merge = first.s_start >= second.s_start
        if not fwd_merge:
            for mb in ml:
                mb.ext_slave_next, mb.ext_slave_prev = (
                    mb.ext_slave_prev, mb.ext_slave_next)
            ml.reverse()


def _orient(mb: MergeBlock, master_ref: RefSequence,
            slave_ref: RefSequence) -> None:
    """Normalize coordinates to the oriented contigs (ByInclusions :325)."""
    if mb.m_rev:
        m_size = master_ref[mb.m_id].length
        mb.m_start, mb.m_end = m_size - mb.m_end - 1, m_size - mb.m_start - 1
        mb.m_ltail, mb.m_rtail = mb.m_rtail, mb.m_ltail
    if mb.s_rev:
        s_size = slave_ref[mb.s_id].length
        mb.s_start, mb.s_end = s_size - mb.s_end - 1, s_size - mb.s_start - 1
        mb.s_ltail, mb.s_rtail = mb.s_rtail, mb.s_ltail


def split_merge_blocks_by_inclusions(ml_in: MergeBlockLists, master_ref,
                                     slave_ref) -> MergeBlockLists:
    tmp: MergeBlockLists = []
    for ml in ml_in:
        first = True
        ml_new: list[MergeBlock] = []
        mb_prev: MergeBlock | None = None

        n = len(ml)
        k = 0
        while k < n:
            mb_cur = ml[k].copy()
            k += 1
            nxt_idx = k  # index of mb_next in ml (if any)

            _orient(mb_cur, master_ref, slave_ref)

            if first:
                first = False
                ml_new.append(mb_cur)
                mb_prev = mb_cur
                continue

            if mb_prev.m_id == mb_cur.m_id:  # jumped from master
                if mb_prev.m_start > mb_cur.m_start and mb_prev.m_end <= mb_cur.m_end:
                    while (ml_new and ml_new[-1].m_start > mb_cur.m_start
                           and ml_new[-1].m_end <= mb_cur.m_end
                           and ml_new[-1].m_id == mb_cur.m_id):
                        ml_new.pop()
                    if (ml_new and ml_new[-1].m_id != mb_cur.m_id
                            and ml_new[-1].s_id != mb_cur.s_id):
                        ml_new[-1].ext_slave_next = False
                        tmp.append(ml_new)
                        ml_new = []
                    ml_new.append(mb_cur)
                    mb_prev = mb_cur
                elif mb_prev.m_start > mb_cur.m_start:
                    ml_new[-1].ext_slave_next = False
                    break
                elif mb_prev.m_end >= mb_cur.m_end:
                    if nxt_idx < n:
                        mb_next = ml[nxt_idx]
                        if mb_cur.m_id == mb_next.m_id:
                            continue
                        ml_new[-1].ext_slave_next = False
                        tmp.append(ml_new)
                        ml_new = []
                        ml[nxt_idx].ext_slave_prev = False  # real element
                        first = True
                    continue
                else:
                    ml_new.append(mb_cur)
                    mb_prev = mb_cur
            else:  # jumped from slave
                if mb_prev.s_start > mb_cur.s_start and mb_prev.s_end <= mb_cur.s_end:
                    while (ml_new and ml_new[-1].s_start > mb_cur.s_start
                           and ml_new[-1].s_end <= mb_cur.s_end
                           and ml_new[-1].s_id == mb_cur.s_id):
                        ml_new.pop()
                    if (ml_new and ml_new[-1].m_id != mb_cur.m_id
                            and ml_new[-1].s_id != mb_cur.s_id):
                        ml_new[-1].ext_slave_next = False
                        tmp.append(ml_new)
                        ml_new = []
                    ml_new.append(mb_cur)
                    mb_prev = mb_cur
                elif mb_prev.s_start > mb_cur.s_start:
                    ml_new[-1].ext_slave_next = False
                    break
                elif mb_prev.s_end >= mb_cur.s_end:
                    if nxt_idx < n:
                        mb_next = ml[nxt_idx]
                        if mb_cur.s_id == mb_next.s_id:
                            continue
                        ml_new[-1].ext_slave_next = False
                        tmp.append(ml_new)
                        ml_new = []
                        # reference mutates a local copy here (no effect)
                        first = True
                    continue
                else:
                    ml_new.append(mb_cur)
                    mb_prev = mb_cur

        if ml_new:
            tmp.append(ml_new)
    return tmp


class PctgWeaver:
    """buildPctgs + append helpers (PctgBuilder :71-288)."""

    def __init__(self, master_ref: RefSequence, slave_ref: RefSequence,
                 master_bam: MultiBam | None = None,
                 slave_bam: MultiBam | None = None,
                 no_mult_filter: bool = False):
        self.master_ref = master_ref
        self.slave_ref = slave_ref
        self.master_bam = master_bam
        self.slave_bam = slave_bam
        self.no_mult_filter = no_mult_filter

    # ---- append helpers ----
    def _append(self, pctg: PairedContig, is_master: bool, cid: int,
                ctg: np.ndarray, start: int, end: int, rev: bool) -> None:
        if end < start or start < 0 or end >= len(ctg):
            return
        if is_master:
            pctg.master_ids.add(cid)
        else:
            pctg.slave_ids.add(cid)
        pctg.parts.append(ctg[start:end + 1])
        pctg.merge_list.append(CtgInPctg(cid, start, end, rev, is_master))

    def append_master(self, pctg, cid, ctg, start, end, rev):
        self._append(pctg, True, cid, ctg, start, end, rev)

    def append_slave(self, pctg, cid, ctg, start, end, rev):
        self._append(pctg, False, cid, ctg, start, end, rev)

    def append_blocks_region(self, pctg, m_id, m_ctg, m_start, m_end, m_rev,
                             s_id, s_ctg, s_start, s_end, s_rev):
        """appendBlocksRegionToPctg (:134)."""
        pctg.master_ids.add(m_id)
        pctg.slave_ids.add(s_id)

        master_int = m_end - m_start + 1 if m_end >= m_start else 0
        slave_int = s_end - s_start + 1 if s_end >= s_start else 0
        large = max(master_int, slave_int)
        small = min(master_int, slave_int)

        if small >= 0.97 * large:
            return self.append_master(pctg, m_id, m_ctg, m_start, m_end, m_rev)

        master_score = compute_zscore(self.master_bam, m_id, m_start, m_end,
                                      self.no_mult_filter) \
            if self.master_bam else []
        slave_score = compute_zscore(self.slave_bam, s_id, s_start, s_end,
                                     self.no_mult_filter) \
            if self.slave_bam else []

        master_evid = slave_evid = 0
        for i in range(len(master_score)):
            m = abs(master_score[i])
            s = abs(slave_score[i]) if i < len(slave_score) else 0.0
            if s < m and s != 0:
                slave_evid += 1
            elif s < m:
                master_evid += 1
            if m < s and m != 0:
                master_evid += 1
            elif m < s:
                slave_evid += 1

        if master_evid >= slave_evid:
            return self.append_master(pctg, m_id, m_ctg, m_start, m_end, m_rev)
        return self.append_slave(pctg, s_id, s_ctg, s_start, s_end, s_rev)

    # ---- weaving ----
    def build_pctgs(self, pctg_list: list[PairedContig],
                    ml: list[MergeBlock]) -> None:
        """buildPctgs for one merge list (:182)."""
        if len(ml) == 0:
            return

        pctg = PairedContig()
        m_pos = 0
        s_pos = 0
        master_ctg = slave_ctg = None
        prev_mid = prev_sid = None

        n = len(ml)
        for k in range(n):
            mb = ml[k]
            is_last = k + 1 == n

            if k == 0:
                master_ctg = self.master_ref[mb.m_id].seq
                slave_ctg = self.slave_ref[mb.s_id].seq
                if mb.m_rev:
                    master_ctg = reverse_complement(master_ctg)
                if mb.s_rev:
                    slave_ctg = reverse_complement(slave_ctg)

                m_tail = mb.m_start if mb.m_ltail else 0
                s_tail = 0  # slave first tails disabled (PctgBuilder :216)
                if m_tail >= s_tail and m_tail > 0:
                    self.append_master(pctg, mb.m_id, master_ctg, 0,
                                       mb.m_start - 1, mb.m_rev)
                if s_tail > m_tail and s_tail > 0:
                    self.append_slave(pctg, mb.s_id, slave_ctg, 0,
                                      mb.s_start - 1, mb.s_rev)
                self.append_blocks_region(
                    pctg, mb.m_id, master_ctg, mb.m_start, mb.m_end, mb.m_rev,
                    mb.s_id, slave_ctg, mb.s_start, mb.s_end, mb.s_rev)
            else:
                if mb.m_id == prev_mid:
                    slave_ctg = self.slave_ref[mb.s_id].seq
                    if mb.s_rev:
                        slave_ctg = reverse_complement(slave_ctg)
                    if m_pos <= mb.m_start:
                        self.append_master(pctg, mb.m_id, master_ctg, m_pos,
                                           mb.m_start - 1, mb.m_rev)
                        self.append_blocks_region(
                            pctg, mb.m_id, master_ctg, mb.m_start, mb.m_end,
                            mb.m_rev, mb.s_id, slave_ctg, mb.s_start,
                            mb.s_end, mb.s_rev)
                    else:
                        self.append_master(pctg, mb.m_id, master_ctg, m_pos,
                                           mb.m_end, mb.m_rev)
                else:
                    master_ctg = self.master_ref[mb.m_id].seq
                    if mb.m_rev:
                        master_ctg = reverse_complement(master_ctg)
                    if s_pos <= mb.s_start:
                        self.append_slave(pctg, mb.s_id, slave_ctg, s_pos,
                                          mb.s_start - 1, mb.s_rev)
                        self.append_blocks_region(
                            pctg, mb.m_id, master_ctg, mb.m_start, mb.m_end,
                            mb.m_rev, mb.s_id, slave_ctg, mb.s_start,
                            mb.s_end, mb.s_rev)
                    else:
                        self.append_slave(pctg, mb.s_id, slave_ctg, s_pos,
                                          mb.s_end, mb.s_rev)
                        pctg.master_ids.add(mb.m_id)

            if is_last:
                m_size = len(master_ctg)
                s_size = len(slave_ctg)
                m_tail = (m_size - mb.m_end - 1) if mb.m_rtail else 0
                s_tail = 0  # slave last tails disabled (PctgBuilder :271)
                if m_tail >= s_tail and m_tail > 0:
                    self.append_master(pctg, mb.m_id, master_ctg,
                                       mb.m_end + 1, m_size - 1, mb.m_rev)
                if s_tail > m_tail and s_tail > 0:
                    self.append_slave(pctg, mb.s_id, slave_ctg,
                                      mb.s_end + 1, s_size - 1, mb.s_rev)

            prev_mid = mb.m_id
            prev_sid = mb.s_id
            m_pos = mb.m_end + 1
            s_pos = mb.s_end + 1

        if pctg.size > 0:
            pctg_list.append(pctg)
