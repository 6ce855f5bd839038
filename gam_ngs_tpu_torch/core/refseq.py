"""RefSequence — contig id/name table + sequence arena.

Reference: RefSequence (lib/include/assembly/RefSequence.hpp)
filled from BAM headers, sequences attached by loadSequences
(io_contig.code.hpp:569): each contig is pre-allocated at the BAM-header
length (default-base N) and overwritten from the FASTA; a longer FASTA
sequence grows the contig.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..io.fasta import read_fasta, BASE_N


@dataclass
class RefRecord:
    name: str
    length: int
    seq: np.ndarray | None = None


class RefSequence(list):
    @staticmethod
    def from_header(names: list[str], lengths: list[int]) -> "RefSequence":
        rs = RefSequence()
        for n, l in zip(names, lengths):
            rs.append(RefRecord(n, int(l)))
        return rs

    def load_sequences(self, fasta_path: str) -> int:
        """loadSequences: attach FASTA sequences by name; returns count."""
        name_to_id = {r.name: i for i, r in enumerate(self)}
        num = 0
        for name, codes in read_fasta(fasta_path):
            if name not in name_to_id:
                raise KeyError(
                    f"FASTA sequence {name!r} not present in BAM header")
            rec = self[name_to_id[name]]
            if len(codes) < rec.length:
                seq = np.full(rec.length, BASE_N, np.uint8)
                seq[:len(codes)] = codes
            else:
                seq = codes.copy()
            rec.seq = seq
            num += 1
        return num
