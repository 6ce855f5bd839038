"""FASTA codec, byte-compatible with the reference's io_contig.

Reference semantics (lib/include/assembly/io_contig.code.hpp):
  * reading skips ONLY '\\n' and ' ' characters inside sequences
    (read_sequence :91-122); every other byte is interpreted as a base.
  * bases are normalized through the Nucleotide constructor
    (nucleotide.code.hpp): ACGTN upper or lower map to A,T,C,G,N —
    anything else becomes N.  Output is always upper-case ACGTN.
  * contig names are the header line after '>' truncated at the first
    space (readNextContigID :511-538).
  * writing emits ">name" then 60-column sequence lines
    (SEQ_LINE_LENGTH=60, operator<< :246-262), each record followed by
    a newline (write_fasta :264-277).

Sequences are held as numpy uint8 arrays of base codes 0..4 in the
reference's BaseType order (A,T,C,G,N) so kernels consume them directly.
"""

from __future__ import annotations

import numpy as np

BASE_A, BASE_T, BASE_C, BASE_G, BASE_N = 0, 1, 2, 3, 4
SEQ_LINE_LENGTH = 60

# byte -> base code lookup (everything defaults to N, like Nucleotide(char))
_CODE_LUT = np.full(256, BASE_N, dtype=np.uint8)
for _c, _v in (("A", BASE_A), ("T", BASE_T), ("C", BASE_C), ("G", BASE_G), ("N", BASE_N)):
    _CODE_LUT[ord(_c)] = _v
    _CODE_LUT[ord(_c.lower())] = _v

_CHAR_LUT = np.frombuffer(b"ATCGN", dtype=np.uint8)

# complement in code space: A<->T, C<->G, N->N
COMPLEMENT_LUT = np.array([BASE_T, BASE_A, BASE_G, BASE_C, BASE_N], dtype=np.uint8)


def seq_to_codes(seq: bytes | str) -> np.ndarray:
    """Map raw sequence bytes to base codes (non-ACGTN -> N)."""
    if isinstance(seq, str):
        seq = seq.encode()
    return _CODE_LUT[np.frombuffer(seq, dtype=np.uint8)]


def codes_to_bytes(codes: np.ndarray) -> bytes:
    """Map base codes back to upper-case ACGTN bytes."""
    return _CHAR_LUT[codes].tobytes()


_RC_MEMO: dict[int, tuple] = {}  # id(arr) -> (arr, its rc)
_RC_MEMO_CAP = 4096


def reverse_complement(codes: np.ndarray) -> np.ndarray:
    """Reverse-complement of a code array (contig.code.hpp reverse_complement).

    Memoized in BOTH directions: the merge flips slave contigs per
    alignment attempt (PctgBuilder.cc:1438 retry), and a stable rc
    OBJECT per contig lets the device engine's resident sequence arena
    serve reverse orientations without materializing or uploading them
    (rc_source below).  rc(rc(x)) returns the original object.  The
    memo holds strong refs (id-keyed caches must keep their keys
    alive); it is capped — eviction only costs recomputation.
    """
    ent = _RC_MEMO.get(id(codes))
    if ent is not None and ent[0] is codes:
        return ent[1]
    rc = COMPLEMENT_LUT[codes][::-1]
    if len(_RC_MEMO) >= 2 * _RC_MEMO_CAP:
        _RC_MEMO.clear()
    _RC_MEMO[id(codes)] = (codes, rc)
    _RC_MEMO[id(rc)] = (rc, codes)
    return rc


def rc_source(codes: np.ndarray):
    """The array whose reverse_complement produced `codes` (or None).

    Lets the engine map an rc'd contig back to its arena-resident base
    sequence (orientation handled on device)."""
    ent = _RC_MEMO.get(id(codes))
    if ent is not None and ent[0] is codes:
        return ent[1]
    return None


def read_fasta(path: str) -> list[tuple[str, np.ndarray]]:
    """Read a multi-FASTA file into [(name, base-code array), ...].

    Mirrors readNextContigID/readNextSequence: names truncated at first
    space; sequence bytes other than '\\n' and ' ' all count as bases.
    """
    with open(path, "rb") as fh:
        data = fh.read()

    out: list[tuple[str, np.ndarray]] = []
    n = len(data)
    i = 0
    while i < n:
        # skip blank space between records (readNextContigID skips ' ' and '\n')
        while i < n and data[i] in (0x20, 0x0A):
            i += 1
        if i >= n:
            break
        if data[i] != ord(">"):
            raise ValueError(f"Found invalid character: {chr(data[i])}")
        eol = data.find(b"\n", i)
        if eol == -1:
            eol = n
        header = data[i + 1:eol].decode()
        sp = header.find(" ")
        name = header[:sp] if sp != -1 else header
        i = eol + 1
        # sequence runs until next '>'
        nxt = data.find(b">", i)
        if nxt == -1:
            nxt = n
        raw = np.frombuffer(data[i:nxt], dtype=np.uint8)
        keep = (raw != 0x0A) & (raw != 0x20)
        out.append((name, _CODE_LUT[raw[keep]]))
        i = nxt
    return out


def format_record(name: str, codes: np.ndarray) -> bytes:
    """One FASTA record exactly as `os << ctg << endl` emits it."""
    parts = [b">" + name.encode()]
    seq = codes_to_bytes(codes)
    for j in range(0, len(seq), SEQ_LINE_LENGTH):
        parts.append(seq[j:j + SEQ_LINE_LENGTH])
    return b"\n".join(parts) + b"\n"


def write_fasta(path: str, records, append: bool = False) -> None:
    """Write records [(name, codes), ...] in reference format."""
    mode = "ab" if append else "wb"
    with open(path, mode) as fh:
        for name, codes in records:
            fh.write(format_record(name, codes))
