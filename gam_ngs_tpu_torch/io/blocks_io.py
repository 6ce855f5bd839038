""".blocks descriptor file codec.

Reference: Block::writeBlocks / loadBlocks
(lib/src/assembly/Block.cc:669-746).  Tab-separated rows

  numReads  0 mCtg mStrand mBegin mEnd mBlockReadsLen mReadsLen
            0 sCtg sStrand sBegin sEnd sBlockReadsLen sReadsLen

(the leading 0 of each frame is the unused assembly id; Frame operator<<
at Frame.cc:197).  The header line starts with '#'.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

HEADER = (
    "# MasterAssemblyID\tMasterContigID\tMasterStrand\tMasterBegin\tMasterEnd\t"
    "MasterBlockReadsLength\tMasterReadsLength\t"
    "SlaveAssemblyID\tSlaveContigID\tSlaveStrand\tSlaveBegin\tSlaveEnd\t"
    "SlaveBlockReadsLength\tSlaveReadsLength\n"
)


@dataclass
class BlockTable:
    """Struct-of-arrays block store (one row per block, file order)."""

    num_reads: np.ndarray   # int64
    m_ctg: np.ndarray       # int32
    m_strand: np.ndarray    # uint8 ('+'/'-'/'?')
    m_begin: np.ndarray     # int32
    m_end: np.ndarray       # int32
    m_block_reads_len: np.ndarray  # uint64 (blockReadsLen)
    m_reads_len: np.ndarray        # uint64 (readsLen)
    s_ctg: np.ndarray
    s_strand: np.ndarray
    s_begin: np.ndarray
    s_end: np.ndarray
    s_block_reads_len: np.ndarray
    s_reads_len: np.ndarray

    def __len__(self):
        return len(self.num_reads)

    @staticmethod
    def from_rows(rows) -> "BlockTable":
        if len(rows) == 0:
            z32 = np.zeros(0, np.int32)
            z64 = np.zeros(0, np.int64)
            zu64 = np.zeros(0, np.uint64)
            zu8 = np.zeros(0, np.uint8)
            return BlockTable(z64, z32, zu8, z32.copy(), z32.copy(), zu64,
                              zu64.copy(), z32.copy(), zu8.copy(), z32.copy(),
                              z32.copy(), zu64.copy(), zu64.copy())
        cols = list(zip(*rows))
        return BlockTable(
            num_reads=np.array(cols[0], np.int64),
            m_ctg=np.array(cols[1], np.int32),
            m_strand=np.array(cols[2], np.uint8),
            m_begin=np.array(cols[3], np.int32),
            m_end=np.array(cols[4], np.int32),
            m_block_reads_len=np.array(cols[5], np.uint64),
            m_reads_len=np.array(cols[6], np.uint64),
            s_ctg=np.array(cols[7], np.int32),
            s_strand=np.array(cols[8], np.uint8),
            s_begin=np.array(cols[9], np.int32),
            s_end=np.array(cols[10], np.int32),
            s_block_reads_len=np.array(cols[11], np.uint64),
            s_reads_len=np.array(cols[12], np.uint64),
        )

    def row(self, i: int) -> tuple:
        return (
            int(self.num_reads[i]), int(self.m_ctg[i]), int(self.m_strand[i]),
            int(self.m_begin[i]), int(self.m_end[i]),
            int(self.m_block_reads_len[i]), int(self.m_reads_len[i]),
            int(self.s_ctg[i]), int(self.s_strand[i]), int(self.s_begin[i]),
            int(self.s_end[i]), int(self.s_block_reads_len[i]),
            int(self.s_reads_len[i]),
        )

    def select(self, mask_or_idx) -> "BlockTable":
        return BlockTable(*[getattr(self, f)[mask_or_idx] for f in (
            "num_reads", "m_ctg", "m_strand", "m_begin", "m_end",
            "m_block_reads_len", "m_reads_len", "s_ctg", "s_strand",
            "s_begin", "s_end", "s_block_reads_len", "s_reads_len")])

    # frame lengths (Frame::getLength — 0 when end < begin)
    def m_length(self):
        ln = self.m_end - self.m_begin + 1
        return np.where(self.m_end < self.m_begin, 0, ln)

    def s_length(self):
        ln = self.s_end - self.s_begin + 1
        return np.where(self.s_end < self.s_begin, 0, ln)


def write_blocks(path: str, blocks: BlockTable) -> None:
    with open(path, "w") as fh:
        fh.write(HEADER)
        for i in range(len(blocks)):
            r = blocks.row(i)
            fh.write(
                f"{r[0]}\t0\t{r[1]}\t{chr(r[2])}\t{r[3]}\t{r[4]}\t{r[5]}\t{r[6]}"
                f"\t0\t{r[7]}\t{chr(r[8])}\t{r[9]}\t{r[10]}\t{r[11]}\t{r[12]}\n"
            )


def load_blocks(path: str, min_block_size: int = 1) -> BlockTable:
    """Load blocks, keeping rows with numReads >= min_block_size
    (Block::loadBlocks :669)."""
    rows = []
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line == "" or line.startswith("#"):
                continue
            f = line.split()
            if len(f) < 15:
                continue
            num_reads = int(f[0])
            if num_reads < min_block_size:
                continue
            rows.append((
                num_reads,
                int(f[2]), ord(f[3]), int(f[4]), int(f[5]), int(f[6]), int(f[7]),
                int(f[9]), ord(f[10]), int(f[11]), int(f[12]), int(f[13]), int(f[14]),
            ))
    return BlockTable.from_rows(rows)
