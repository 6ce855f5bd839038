"""Block construction — the gam-create compute core.

Replicates, over columnar alignment tables, the exact semantics of:
  * Read::loadReadsMap   (lib/src/assembly/Read.cc:83)
  * Block::findBlocks    (lib/src/assembly/Block.cc:470)
  * Block::updateCoverages (:606), Block::filterBlocksByCoverage (:265)
  * getNoBlocksContigs / getNoBlocksAfterFilterContigs (:810/:865)

The master read maps become a 128-bit-name-key hash join; the slave-side
active-block extension is an order-dependent first-fit scan over the
coordinate-merged stream (greedy, adjacency counts as overlap:
Frame::overlaps with minOverlap=0 accepts read.start == frame.end+1).
Reads shorter than min_block_size cannot seed a block (Block ctor quirk,
Block.cc:49) and instead enqueue an EMPTY active block that absorbs the
next matched read unconditionally.

The Python scan here is the behavioral oracle; the native C++ scan
(native/gamio.cc) implements the same loop for throughput, and
ops/device_join.py provides the sort/merge-join device formulation.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.bam import FPAIRED, FREAD1, FREVERSE
from ..io.blocks_io import BlockTable
from .multibam import MultiBam


def coverage_vectors(mb: MultiBam, no_mult_filter: bool) -> list[np.ndarray]:
    """Per-contig coverage from good-quality uniquely-mapped reads."""
    lengths = mb.ref_lengths
    diffs = [np.zeros(l + 1, np.int64) for l in lengths]
    for f in mb.files:
        t = f.table
        keep = t.is_good_quality() & t.is_uniq_mapped(no_mult_filter)
        ref = t.ref_id[keep]
        start = t.pos[keep]
        end = t.end_pos[keep]
        for c in range(len(lengths)):
            m = ref == c
            if not m.any():
                continue
            np.add.at(diffs[c], start[m], 1)
            np.add.at(diffs[c], np.minimum(end[m], lengths[c]), -1)
    return [np.cumsum(d[:-1]).astype(np.uint32) for d in diffs]


def stream_columns(mb: MultiBam, no_mult_filter: bool):
    """Good uniquely-mapped reads of the merged stream as flat columns
    (h1, h2, first, ctg, pos, end, rev) — the native scan's input."""
    t, _libs = mb.merged_table()
    good = t.is_good_quality() & t.is_uniq_mapped(no_mult_filter)
    idx = np.nonzero(good)[0]
    first = ((t.flag & FPAIRED) == 0) | ((t.flag & FREAD1) != 0)
    rev = (t.flag & FREVERSE) != 0
    return (t.name_h1[idx], t.name_h2[idx],
            first[idx].astype(np.uint8), t.ref_id[idx], t.pos[idx],
            t.end_pos[idx], rev[idx].astype(np.uint8))


def block_table_from_columns(cols: dict) -> BlockTable:
    """BlockTable from the raw column dict shared by the native scan,
    the device join and the distributed combiner (reads_len columns are
    filled later by update_coverages, Block.cc:606)."""
    n = len(cols["num_reads"])
    return BlockTable(
        num_reads=cols["num_reads"],
        m_ctg=cols["m_ctg"],
        m_strand=np.full(n, ord("+"), np.uint8),
        m_begin=cols["m_begin"],
        m_end=cols["m_end"],
        m_block_reads_len=cols["m_block_reads_len"],
        m_reads_len=np.zeros(n, np.uint64),
        s_ctg=cols["s_ctg"],
        s_strand=cols["s_strand"],
        s_begin=cols["s_begin"],
        s_end=cols["s_end"],
        s_block_reads_len=cols["s_block_reads_len"],
        s_reads_len=np.zeros(n, np.uint64),
    )


def find_blocks_fast(mb_master: MultiBam, mb_slave: MultiBam,
                     min_block_size: int, no_mult_filter: bool
                     ) -> BlockTable | None:
    """Native C++ loadReadsMap + findBlocks; None if lib unavailable."""
    from ..native.loader import find_blocks_native

    m_cols = stream_columns(mb_master, no_mult_filter)
    s_cols = stream_columns(mb_slave, no_mult_filter)
    cols = find_blocks_native(m_cols, s_cols, min_block_size)
    if cols is None:
        return None
    return block_table_from_columns(cols)


def find_blocks_device_path(mb_master: MultiBam, mb_slave: MultiBam,
                            min_block_size: int, no_mult_filter: bool,
                            device: torch.device) -> BlockTable:
    """Device block construction: sort / merge-join / segment scan as
    torch ops on `device` (ops/device_join.py) over the columnar
    streams."""
    from ..ops.device_join import find_blocks_device

    m_cols = stream_columns(mb_master, no_mult_filter)
    s_cols = stream_columns(mb_slave, no_mult_filter)
    cols = find_blocks_device(m_cols, s_cols, min_block_size, device=device)
    return block_table_from_columns(cols)


def find_blocks_from_columns(m_cols: tuple, s_cols: tuple,
                             min_block_size: int) -> BlockTable:
    """Column-level oracle: loadReadsMap (Read.cc:83) + findBlocks
    (Block.cc:470) over flat (h1, h2, first, ctg, pos, end, rev) streams
    — the same interface the native scan and the device join consume,
    so all three paths are differentially testable on raw columns."""
    mh1, mh2, mfirst, mctg, mpos, mend, mrev = m_cols
    map1: dict = {}
    map2: dict = {}
    for i in range(len(mh1)):
        rec = (int(mctg[i]), int(mpos[i]), int(mend[i]), bool(mrev[i]))
        if mfirst[i]:
            map1[(int(mh1[i]), int(mh2[i]))] = rec
        else:
            map2[(int(mh1[i]), int(mh2[i]))] = rec

    sh1, sh2, sfirst, sctg, spos, send, srev = s_cols
    out_rows = []
    active: list[_ActiveBlock] = []
    for i in range(len(sh1)):
        key = (int(sh1[i]), int(sh2[i]))
        mrec = map1.get(key) if sfirst[i] else map2.get(key)
        if mrec is None:
            continue
        srec = (int(sctg[i]), int(spos[i]), int(send[i]))
        concordant = mrec[3] == bool(srev[i])

        reads_added = False
        k = 0
        while k < len(active):
            blk = active[k]
            if blk.add_reads(mrec, srec):
                reads_added = True
                if concordant:
                    blk.evid_pos += 1
                else:
                    blk.evid_neg += 1
                break
            out_of_scope = (blk.s_end + 1 < srec[1]) or (blk.s_ctg < srec[0])
            if not reads_added and out_of_scope:
                if blk.num_reads >= min_block_size:
                    out_rows.append(blk.finalize_row())
                active.pop(k)
                continue
            k += 1

        if not reads_added:
            blk = _ActiveBlock()
            if (mrec[2] - mrec[1]) >= min_block_size \
                    and (srec[2] - srec[1]) >= min_block_size:
                blk.seed(mrec, srec)
            active.append(blk)

    for blk in active:
        if blk.num_reads >= min_block_size:
            out_rows.append(blk.finalize_row())
    return BlockTable.from_rows(out_rows)


def load_reads_map(mb: MultiBam, no_mult_filter: bool):
    """Build the two master read maps keyed by 128-bit name hash.

    Returns (map1, map2): dict key -> (ctg, start, end_pos, rev) with
    last-write-wins on duplicate names, processed in merged coordinate
    order like the reference (Read.cc:100-119).
    """
    t, _libs = mb.merged_table()
    good = t.is_good_quality() & t.is_uniq_mapped(no_mult_filter)

    keys = (t.name_h1.astype(object) << 64) | t.name_h2.astype(object)
    first = ((t.flag & FPAIRED) == 0) | ((t.flag & FREAD1) != 0)
    rev = (t.flag & FREVERSE) != 0

    map1: dict = {}
    map2: dict = {}
    idx = np.nonzero(good)[0]
    ref_id = t.ref_id
    pos = t.pos
    end_pos = t.end_pos
    for i in idx.tolist():
        rec = (int(ref_id[i]), int(pos[i]), int(end_pos[i]), bool(rev[i]))
        if first[i]:
            map1[keys[i]] = rec
        else:
            map2[keys[i]] = rec
    return map1, map2


class _ActiveBlock:
    __slots__ = ("num_reads", "m_ctg", "m_begin", "m_end", "m_brl",
                 "s_ctg", "s_begin", "s_end", "s_brl", "evid_pos", "evid_neg")

    def __init__(self):
        self.num_reads = 0
        self.m_ctg = 0
        self.m_begin = 0
        self.m_end = 0
        self.m_brl = 0
        self.s_ctg = 0
        self.s_begin = 0
        self.s_end = 0
        self.s_brl = 0
        self.evid_pos = 0
        self.evid_neg = 0

    def seed(self, m, s):
        """Fill like Block(mRead,sRead) with passing length check."""
        self.num_reads = 1
        self.m_ctg, self.m_begin = m[0], m[1]
        self.m_end = m[2] - 1          # Read::getEndPos() is closed
        self.m_brl = m[2] - m[1]
        self.s_ctg, self.s_begin = s[0], s[1]
        self.s_end = s[2] - 1
        self.s_brl = s[2] - s[1]

    def add_reads(self, m, s) -> bool:
        """Block::addReads with minOverlap=0 (Block.cc:136)."""
        if self.num_reads == 0:
            self.seed(m, s)
            return True
        # overlaps: same ctg and closed-interval adjacency-or-overlap
        m_end_closed = m[2] - 1
        s_end_closed = s[2] - 1
        if (self.m_ctg == m[0]
                and self.m_end - m[1] + 1 >= 0 and m_end_closed - self.m_begin + 1 >= 0
                and self.s_ctg == s[0]
                and self.s_end - s[1] + 1 >= 0 and s_end_closed - self.s_begin + 1 >= 0):
            self.num_reads += 1
            self.m_brl += m[2] - m[1]
            self.s_brl += s[2] - s[1]
            if m[1] < self.m_begin:
                self.m_begin = m[1]
            if s[1] < self.s_begin:
                self.s_begin = s[1]
            if m_end_closed > self.m_end:
                self.m_end = m_end_closed
            if s_end_closed > self.s_end:
                self.s_end = s_end_closed
            return True
        return False

    def finalize_row(self):
        """Block row with strands set from evidence (findBlocks :587-593)."""
        s_strand = ord("+") if self.evid_pos >= self.evid_neg else ord("-")
        return (self.num_reads, self.m_ctg, ord("+"), self.m_begin, self.m_end,
                self.m_brl, 0, self.s_ctg, s_strand, self.s_begin, self.s_end,
                self.s_brl, 0)


def find_blocks(mb_slave: MultiBam, min_block_size: int, map1: dict, map2: dict,
                no_mult_filter: bool) -> BlockTable:
    """Block::findBlocks (Block.cc:470) over the merged slave stream."""
    t, _libs = mb_slave.merged_table()
    good = t.is_good_quality() & t.is_uniq_mapped(no_mult_filter)

    keys = (t.name_h1.astype(object) << 64) | t.name_h2.astype(object)
    first = ((t.flag & FPAIRED) == 0) | ((t.flag & FREAD1) != 0)
    rev = (t.flag & FREVERSE) != 0

    out_rows = []
    active: list[_ActiveBlock] = []

    idx = np.nonzero(good)[0]
    ref_id, pos, end_pos = t.ref_id, t.pos, t.end_pos
    for i in idx.tolist():
        key = keys[i]
        mrec = map1.get(key) if first[i] else map2.get(key)
        if mrec is None:
            continue
        s_ctg = int(ref_id[i])
        s_start = int(pos[i])
        s_end = int(end_pos[i])
        srec = (s_ctg, s_start, s_end)
        s_rev = bool(rev[i])
        concordant = mrec[3] == s_rev

        reads_added = False
        k = 0
        while k < len(active):
            blk = active[k]
            if blk.add_reads(mrec, srec):
                reads_added = True
                if concordant:
                    blk.evid_pos += 1
                else:
                    blk.evid_neg += 1
                break
            out_of_scope = (blk.s_end + 1 < s_start) or (blk.s_ctg < s_ctg)
            if not reads_added and out_of_scope:
                if blk.num_reads >= min_block_size:
                    out_rows.append(blk.finalize_row())
                active.pop(k)
                continue
            k += 1

        if not reads_added:
            blk = _ActiveBlock()
            # Block(mRead, sRead, minOverlap=minBlockSize): seeds only if
            # both read lengths >= min_block_size (Block.cc:49)
            if (mrec[2] - mrec[1]) >= min_block_size and (s_end - s_start) >= min_block_size:
                blk.seed(mrec, srec)
            active.append(blk)

    for blk in active:
        if blk.num_reads >= min_block_size:
            out_rows.append(blk.finalize_row())

    return BlockTable.from_rows(out_rows)


def update_coverages(blocks: BlockTable, master_cov: list[np.ndarray],
                     slave_cov: list[np.ndarray]) -> None:
    """Fill readsLen fields (Block::updateCoverages :606) in place."""
    mcs = [np.concatenate(([0], np.cumsum(c, dtype=np.uint64))) for c in master_cov]
    scs = [np.concatenate(([0], np.cumsum(c, dtype=np.uint64))) for c in slave_cov]
    m_rl = np.zeros(len(blocks), np.uint64)
    s_rl = np.zeros(len(blocks), np.uint64)
    for i in range(len(blocks)):
        c = mcs[int(blocks.m_ctg[i])]
        m_rl[i] = c[int(blocks.m_end[i]) + 1] - c[int(blocks.m_begin[i])]
        c = scs[int(blocks.s_ctg[i])]
        s_rl[i] = c[int(blocks.s_end[i]) + 1] - c[int(blocks.s_begin[i])]
    blocks.m_reads_len = m_rl
    blocks.s_reads_len = s_rl


def filter_blocks_by_coverage(blocks: BlockTable, single_link: set,
                              min_cov: float, t: float) -> BlockTable:
    """Block::filterBlocksByCoverage (Block.cc:265); returns kept rows."""
    if len(blocks) == 0:
        return blocks
    with np.errstate(divide="ignore", invalid="ignore"):
        mc_ratio = blocks.m_block_reads_len.astype(np.float64) / blocks.m_reads_len
        sc_ratio = blocks.s_block_reads_len.astype(np.float64) / blocks.s_reads_len
    # std::max(a,b) returns a (=mcRatio) when either is NaN
    pair_max = np.where(mc_ratio < sc_ratio, sc_ratio, mc_ratio)
    keep = ~(pair_max < t)

    m_cov = blocks.m_block_reads_len.astype(np.float64) / blocks.m_length()
    s_cov = blocks.s_block_reads_len.astype(np.float64) / blocks.s_length()
    cov = np.where(mc_ratio >= sc_ratio, m_cov, s_cov)

    is_sl = np.array([
        (int(m), int(s)) in single_link
        for m, s in zip(blocks.m_ctg, blocks.s_ctg)
    ])
    keep &= is_sl | ~(cov < min_cov)
    return blocks.select(keep)


def no_blocks_contigs(n_master: int, n_slave: int, blocks: BlockTable
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Bitsets of contigs with NO blocks (getNoBlocksContigs :810)."""
    m = np.ones(n_master, bool)
    s = np.ones(n_slave, bool)
    if (blocks.m_ctg >= n_master).any() or (blocks.m_ctg < 0).any():
        raise ValueError(
            "[getNoBlocksContigs] block with master id out of range — "
            "master and slave probably swapped")
    if (blocks.s_ctg >= n_slave).any() or (blocks.s_ctg < 0).any():
        raise ValueError(
            "[getNoBlocksContigs] block with slave id out of range — "
            "master and slave probably swapped")
    m[blocks.m_ctg] = False
    s[blocks.s_ctg] = False
    return m, s
