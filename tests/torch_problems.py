"""Seeded numpy problem generators and corpora for the port's tests and
for chip_smoke.py.  Imports nothing of JAX and nothing of gam_ngs_tpu:
the corpora are written by the small BAM/BGZF/FASTA writer below, and the
banded-SW helpers reach the shared host code only through the port.

- soak_problems: the randomized banded-SW problems of
  bench/parity_soak.py (negative begins, force flags, N, end_b clipping,
  indels);
- edge_problems: the cases of tests/test_bsw_antidiag.py (mixed flags,
  force_end underflow windows, negative begin_a, force_start with a deep
  pos==0 cell) and force_start on an A shorter than 11;
- ragged_problems: one bucket of x_size from 1 row to the window;
- tie_problems: find-max candidates that tie (last row and diagonal);
- pack_problems: problems -> the forward kernel's numpy inputs, one
  window bucket;
- oracle / same_alignment: the exact host aligner's results and the
  equality the engine is held to;
- junction_corpus: the corpus of
  tests/test_merge_pipeline.py::_build_inputs;
- two_partition_corpus: the two-graph corpus of
  tests/test_e2e_scenarios.py::test_two_independent_partitions;
- fork_bubble_corpus: a fork graph and a bubble graph, built as
  bench/hard_corpus.py builds them;
- scale_corpus: bench/e2e_scale.py::build_corpus's corpus (same seed,
  contig cuts and read lattice) at a given genome size;
- scale_columns: that corpus's layout at any pair stride as the block
  construction's input columns (core.blocks.stream_columns), without a
  BAM;
- read_fasta_seqs: the sequences of a FASTA file.
"""

from __future__ import annotations

import bisect
import struct
import zlib

import numpy as np


def mutate(rng, seq, sub=0.03, ins=0.012, dele=0.012):
    out = []
    for c in seq:
        r = rng.random()
        if r < dele:
            continue
        if r < dele + ins:
            out.append(rng.integers(0, 4))
        if rng.random() < sub:
            out.append((c + 1 + rng.integers(0, 3)) % 4)
        else:
            out.append(c)
    return np.array(out, np.uint8)


def soak_problems(n: int, seed: int = 2026, max_len: int = 500):
    """bench/parity_soak.py's generator, n draws."""
    rng = np.random.default_rng(seed)
    problems = []
    for _ in range(n):
        m = int(rng.integers(30, max_len))
        hi = 5 if rng.random() < 0.3 else 4
        a = rng.integers(0, hi, size=m).astype(np.uint8)
        b = a.copy()
        noise = rng.random(m) < rng.uniform(0.02, 0.15)
        b[noise] = (b[noise] + 1 + rng.integers(0, 3, noise.sum())) % 4
        if rng.random() < 0.4:
            cut = int(rng.integers(1, m))
            dl = int(rng.integers(1, 30))
            b = np.concatenate([b[:cut], b[cut + dl:]]).astype(np.uint8)
        if len(b) < 2:
            continue
        ba = 0
        if rng.random() < 0.2:
            ba = -int(rng.integers(1, 120))
        elif rng.random() < 0.3:
            ba = int(rng.integers(0, m // 2))
        ea = int(rng.integers(max(ba, 0), m))
        bb = int(rng.integers(0, max(1, len(b) // 3)))
        eb = int(rng.integers(bb, len(b) + 40))  # may pass len(b): clipped
        fs, fe = bool(rng.random() < 0.25), bool(rng.random() < 0.25)
        problems.append((a, ba, ea, b, bb, eb, fs, fe))
    return problems


def edge_problems(seed: int = 71):
    """Edge cases at band 30 (also valid at any band)."""
    rng = np.random.default_rng(seed)
    problems = []
    for k in range(6):  # mixed flags, N in every third
        m = int(rng.integers(40, 240))
        a = rng.integers(0, 5 if k % 3 == 0 else 4, size=m).astype(np.uint8)
        b = mutate(rng, a)
        problems.append((a, 0, m - 1, b, 0, len(b) - 1, k % 2 == 0,
                         k % 3 == 1))
    a = rng.integers(0, 4, size=120).astype(np.uint8)
    for xs in (2, 5, 10, 11, 12):  # force_end underflow windows
        problems.append((a, 0, len(a) - 1, a[:60].copy(), 0, xs - 1,
                         False, True))
    g = rng.integers(0, 4, size=500).astype(np.uint8)
    a = g[:280].copy()
    b = np.concatenate([rng.integers(0, 4, size=50).astype(np.uint8),
                        g[:240]])
    problems += [(a, -35, 200, b, 0, len(b) - 1, False, True),
                 (a, -100, 170, b, 0, len(b) - 1, False, False)]
    a = rng.integers(0, 4, size=80).astype(np.uint8)
    b = np.concatenate([a[:40], rng.integers(0, 4, 25).astype(np.uint8)])
    problems.append((a, 0, 79, b, 0, len(b) - 1, True, False))
    # force_start on an A shorter than FORCE_MAXGAP_LEN + 1: its lanes
    # with pos >= a_len are invalid (the reference throws there)
    a = rng.integers(0, 4, size=8).astype(np.uint8)
    b = np.concatenate([a, rng.integers(0, 4, 30).astype(np.uint8)])
    problems.append((a, 0, 7, b, 0, len(b) - 1, True, False))
    return problems


def ragged_problems(band: int, seed: int = 13):
    """One window bucket of ragged x_size, from 1 row up to the bucket's
    width, at any band: the window 128 at band < 64, else 384.  Mixed
    flags, N in every fourth, a begin_a < 0 tail window in every fifth."""
    rng = np.random.default_rng(seed)
    xw = 128 if band < 64 else 384
    sizes = sorted({1, 2, 3, 5, 16, 17, xw // 4, xw // 2 + 1, xw - 1, xw})
    problems = []
    for k, n in enumerate(sizes):
        a = rng.integers(0, 5 if k % 4 == 0 else 4,
                         size=n + 2 * band).astype(np.uint8)
        b = mutate(rng, a[band:band + n])
        b = np.concatenate([b, rng.integers(0, 4, n).astype(np.uint8)])[:n]
        ba = -int(rng.integers(1, band + 1)) if k % 5 == 4 else band
        problems.append((a, ba, len(a) - 1 - 3 * k, b, 0, n - 1,
                         k % 3 == 0, k % 3 == 1))
    return problems


def row_boundary_bands() -> list[int]:
    """The first and last band of each warp instance of the row forward
    (bsw_row.WARP_WIDTHS: 2*band+1 <= 32*R), then of its block kernels
    of one and two lanes a thread: 15, 16, 31, 32, ..., 159, 160, 511,
    512."""
    from gam_ngs_tpu_torch.ops.bsw_row import WARP_WIDTHS

    last = [(32 * r - 1) // 2 for r in WARP_WIDTHS] + [511]
    return sorted({b for hi in last for b in (hi, hi + 1)})


def boundary_problems(band: int):
    """A parity set at one band: ragged x_size from 1 row to the window
    (begin_a < 0 tails, N, force_start, force_end) and six soak problems
    of up to 3*band+200 rows, so that rows past the exact ones (i >
    band) run too."""
    return (ragged_problems(band, seed=band)
            + soak_problems(6, seed=band, max_len=3 * band + 200))


def tie_problems(seed: int = 17):
    """Problems whose find-max candidates tie: homopolymer (all A, all
    N) and period-4 sequences aligned to themselves, where every band
    lane of a row scores the same and the pos == end_a diagonal's best
    equals the last row's; with and without force_end, begin_a 0 / band
    / < 0, end_a at and before the window's end."""
    rng = np.random.default_rng(seed)
    problems = []
    for k, (code, n) in enumerate([(0, 40), (4, 33), (None, 64), (0, 9),
                                   (None, 120), (4, 70), (0, 200)]):
        m = n + 60
        a = (np.full(m, code, np.uint8) if code is not None
             else np.tile(np.arange(4, dtype=np.uint8), m // 4 + 1)[:m])
        b = a[:n].copy()
        ba = (0, 30, -12)[k % 3]
        ea = (n - 1 + max(ba, 0), m - 1, n // 2 + 5)[k % 3]
        problems.append((a, ba, ea, b, 0, n - 1, k == 4, k % 2 == 1))
    # a random b against a homopolymer: ties among negative scores
    b = rng.integers(1, 4, size=50).astype(np.uint8)
    problems.append((np.zeros(80, np.uint8), 5, 60, b, 0, 49, False, False))
    return problems


def pack_problems(problems, band: int):
    """One bucket of the port's engine layout: (a_pk, b_pk, scal, preps,
    xw), scal = (6, B) int32 rows begin_a, end_a, a_len, x_size,
    force_start, force_end.  Empty problems are dropped."""
    import torch

    from gam_ngs_tpu_torch.ops.bsw_engine import BswEngine
    from gam_ngs_tpu_torch.ops.bsw_host import _pad_dim, _prepare

    preps = [_prepare(*pr, band) for pr in problems]
    preps = [p for p in preps if not p.empty]
    xw = max(_pad_dim(p.x_size) for p in preps)
    eng = BswEngine(torch.device("cpu"), band=band)
    a_pk, b_pk, scal = eng._pack_chunk(list(range(len(preps))), preps, xw)
    return a_pk, b_pk, scal, preps, xw


READ_LEN, INSERT = 50, 200
BASES = np.frombuffer(b"ATCG", np.uint8)

# ---- a minimal BAM / BGZF / FASTA writer (SAM spec 4.1, 4.2) ----------

_NIBBLE = bytes.maketrans(b"=ACMGRSVTWYHKDBN", bytes(range(16)))
_TAGS = b"NHi" + struct.pack("<i", 1) + b"XTAU"  # NH:i:1, XT:A:U
_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def random_genome(rng, length: int) -> str:
    """tests/testutil.py::random_genome (same draws)."""
    return BASES[rng.integers(0, 4, size=length)].tobytes().decode()


def _record(name: str, flag: int, ref: int, pos: int, seq: str,
            mref: int, mpos: int) -> bytes:
    """One BAM record: MAPQ 60, CIGAR <len>M, no qualities, NH/XT tags."""
    rn = name.encode() + b"\0"
    nib = np.frombuffer(seq.encode().translate(_NIBBLE) + b"\0", np.uint8)
    n = len(seq)
    sq = ((nib[0:n:2] << 4) | nib[1:n + 1:2]).tobytes()
    body = (struct.pack("<iiIIiiii", ref, pos, (60 << 8) | len(rn),
                        (flag << 16) | 1, n, mref, mpos, 0)
            + rn + struct.pack("<I", n << 4) + sq + b"\xff" * n + _TAGS)
    return struct.pack("<i", len(body)) + body


def pe_records(name, seq1, ref1, pos1, seq2, ref2, pos2) -> list:
    """A proper FR pair (mate 1 forward, mate 2 reverse), both mapped:
    [(ref, pos, record bytes)] x 2."""
    return [(ref1, pos1, _record(name, 0x61, ref1, pos1, seq1, ref2, pos2)),
            (ref2, pos2, _record(name, 0x91, ref2, pos2, seq2, ref1, pos1))]


def _bgzf(data: bytes) -> bytes:
    out = []
    for i in range(0, len(data), 65280):
        payload = data[i:i + 65280]
        comp = zlib.compressobj(6, zlib.DEFLATED, -15)
        cdata = comp.compress(payload) + comp.flush()
        out.append(struct.pack("<BBBBIBBHBBHH", 0x1F, 0x8B, 8, 4, 0, 0,
                               0xFF, 6, 0x42, 0x43, 2, len(cdata) + 25))
        out.append(cdata)
        out.append(struct.pack("<II", zlib.crc32(payload), len(payload)))
    out.append(_BGZF_EOF)
    return b"".join(out)


def write_sorted_bam(path: str, names, lengths, records) -> None:
    """A coordinate-sorted BAM of pe_records' records."""
    text = ("@HD\tVN:1.4\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{ln}\n" for n, ln in zip(names, lengths))
    ).encode() + b"\0"
    out = [b"BAM\x01", struct.pack("<i", len(text)), text,
           struct.pack("<i", len(names))]
    for n, ln in zip(names, lengths):
        nb = n.encode() + b"\0"
        out += [struct.pack("<i", len(nb)), nb, struct.pack("<i", ln)]
    out += [r for _ref, _pos, r in
            sorted(records, key=lambda r: (r[0], r[1]))]
    with open(path, "wb") as fh:
        fh.write(_bgzf(b"".join(out)))


def write_bam_list(path: str, bam_path: str) -> None:
    """A one-library BAM list, insert bounds 100..1000."""
    with open(path, "w") as fh:
        fh.write(f"{bam_path}\n100 1000\n")


def write_fasta(path: str, records) -> None:
    """[(name, sequence)] in 60-column lines."""
    with open(path, "w") as fh:
        for name, seq in records:
            fh.write(f">{name}\n" + "".join(
                seq[j:j + 60] + "\n" for j in range(0, len(seq), 60)))


def read_fasta_seqs(path: str) -> list[str]:
    seqs: list[list[str]] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line.startswith(">"):
                seqs.append([])
            elif line:
                seqs[-1].append(line.upper())
    return ["".join(s) for s in seqs]


def _write_inputs(tmp_path, m_ctgs, s_ctgs, m_recs, s_recs, tag):
    """BAMs, BAM lists and FASTAs of a (master, slave) assembly pair;
    returns (master list, slave list, master fasta, slave fasta)."""
    out = []
    for side, ctgs, recs in (("m", m_ctgs, m_recs), ("s", s_ctgs, s_recs)):
        bam = str(tmp_path / f"{tag[side]}.bam")
        write_sorted_bam(bam, [n for n, _ in ctgs], [len(q) for _, q in ctgs],
                         recs)
        lst = str(tmp_path / f"{tag[side]}.list")
        write_bam_list(lst, bam)
        fa = str(tmp_path / f"{tag[side]}.fasta")
        write_fasta(fa, ctgs)
        out.append((lst, fa))
    (ml, mfa), (sl, sfa) = out
    return ml, sl, mfa, sfa


def junction_corpus(tmp_path):
    """The corpus of tests/test_merge_pipeline.py::_build_inputs (same
    seed and layout): a 6 kbp genome, master split at 3000, one slave
    contig over [2000, 4500).  Returns (genome, master list, slave list,
    master fasta, slave fasta)."""
    rng = np.random.default_rng(12345)
    genome = random_genome(rng, 6000)
    m_recs, s_recs = [], []
    for i, p in enumerate(range(0, 6000 - INSERT + 1, 8)):
        q = p + INSERT - READ_LEN
        name = f"pair{i}"
        seq1, seq2 = genome[p:p + READ_LEN], genome[q:q + READ_LEN]
        if q + READ_LEN <= 3000:
            m_recs += pe_records(name, seq1, 0, p, seq2, 0, q)
        elif p >= 3000:
            m_recs += pe_records(name, seq1, 1, p - 3000, seq2, 1, q - 3000)
        if p >= 2000 and q + READ_LEN <= 4500:
            s_recs += pe_records(name, seq1, 0, p - 2000, seq2, 0, q - 2000)
    return (genome, *_write_inputs(
        tmp_path, [("M0", genome[:3000]), ("M1", genome[3000:])],
        [("S0", genome[2000:4500])], m_recs, s_recs,
        {"m": "master", "s": "slave"}))


def two_partition_corpus(tmp_path):
    """Two disjoint (master pair, slave) junctions -> two graphs.
    Returns (genomes, master list, slave list, master fasta, slave
    fasta)."""
    rng = np.random.default_rng(555)
    g1 = random_genome(rng, 5000)
    g2 = random_genome(rng, 5000)
    pairs = [(p, p + INSERT - READ_LEN)
             for p in range(0, 5000 - INSERT + 1, 8)]
    m_recs, s_recs = [], []
    for gi, (g, (c1, c2), s_ctg) in enumerate([(g1, (0, 1), 0),
                                               (g2, (2, 3), 1)]):
        for i, (p, m) in enumerate(pairs):
            name = f"g{gi}_{i}"
            seq1, seq2 = g[p:p + READ_LEN], g[m:m + READ_LEN]
            if m + READ_LEN <= 2500:
                m_recs += pe_records(name, seq1, c1, p, seq2, c1, m)
            elif p >= 2500:
                m_recs += pe_records(name, seq1, c2, p - 2500, seq2, c2,
                                     m - 2500)
            if p >= 1500 and m + READ_LEN <= 4000:
                s_recs += pe_records(name, seq1, s_ctg, p - 1500, seq2,
                                     s_ctg, m - 1500)
    return ([g1, g2], *_write_inputs(
        tmp_path, [("A0", g1[:2500]), ("A1", g1[2500:]), ("B0", g2[:2500]),
                   ("B1", g2[2500:])],
        [("SA", g1[1500:4000]), ("SB", g2[1500:4000])], m_recs, s_recs,
        {"m": "m", "s": "s"}))


def fork_bubble_corpus(tmp_path, unit: int = 6000):
    """One FORK and one BUBBLE unit, laid out as bench/hard_corpus.py lays
    them out (a slave misjoin [A C] + [B] against master [A B] + [C]; two
    redundant slave contigs over one master, their reads interleaved in
    the shared middle).  Returns (master list, slave list, master fasta,
    slave fasta)."""
    rng = np.random.default_rng(77)
    third = unit // 3
    m_ctgs, s_ctgs, m_recs, s_recs = [], [], [], []

    def reads(g, lo, hi, m_map, s_map, tag):
        """Pairs starting in [lo, hi); m_map/s_map(p) -> (contig, offset)
        or None for the side a pair does not map to."""
        for p in range(lo, hi - INSERT + 1, 8):
            q = p + INSERT - READ_LEN
            seq1, seq2 = g[p:p + READ_LEN], g[q:q + READ_LEN]
            for where, recs in ((m_map(p), m_recs), (s_map(p), s_recs)):
                if where is not None:
                    c, off = where
                    recs += pe_records(f"{tag}{p}", seq1, c, p - off, seq2,
                                       c, q - off)

    # fork: master [A B], [C]; slave [A C] (misjoined), [B]
    g = random_genome(rng, unit)
    m_ctgs += [("FMab", g[:2 * third]), ("FMc", g[2 * third:])]
    s_ctgs += [("FSac", g[:third] + g[2 * third:]),
               ("FSb", g[third:2 * third])]
    reads(g, 0, third, lambda p: (0, 0), lambda p: (0, 0), "fa")
    reads(g, third, 2 * third, lambda p: (0, 0), lambda p: (1, third), "fb")
    reads(g, 2 * third, unit, lambda p: (1, 2 * third),
          lambda p: (0, third), "fc")

    # bubble: master [g]; slaves [g[:2t]] and [g[t:]], alternating runs of
    # 10 pairs between them where both cover the pair
    g = random_genome(rng, unit)
    m_ctgs.append(("BM", g))
    s_ctgs += [("BSa", g[:2 * third]), ("BSb", g[third:])]

    def bubble_slave(p):
        in_a = p + INSERT <= 2 * third
        in_b = p >= third
        if in_a and in_b:
            return (2, 0) if (p // 80) % 2 == 0 else (3, third)
        return (2, 0) if in_a else ((3, third) if in_b else None)

    reads(g, 0, unit, lambda p: (2, 0), bubble_slave, "b")
    return _write_inputs(tmp_path, m_ctgs, s_ctgs, m_recs, s_recs,
                         {"m": "m", "s": "s"})


def scale_corpus(genome_mb: float, tmp_path, break_every: int = 0) -> dict:
    """bench/e2e_scale.py::build_corpus: a random genome, master contigs
    cut every 50 kbp, slave contigs cut every 50 kbp shifted by 25 kbp,
    FR pairs (50 bp reads, insert 200) every 25 bp.  With break_every=0
    the block graph is one component and the merge of the two
    reconstructs the genome as one contig; break_every=k snaps every k-th
    slave cut onto a master cut, so the graph splits into ~#cuts/k
    components (bench/dist_scale.py's corpus has k = 4).  Returns the
    genome and the input paths (ml, sl, mfa, sfa)."""
    n = int(genome_mb * 1_000_000)
    cut, stride = 50_000, 25
    genome = random_genome(np.random.default_rng(2024), n)
    m_cuts = list(range(0, n + 1, cut))
    s_cuts = [0] + list(range(cut // 2, n, cut)) + [n]
    if break_every:
        for k in range(break_every, len(s_cuts) - 1, break_every):
            s_cuts[k] = round(s_cuts[k] / cut) * cut
        s_cuts = sorted(set(s_cuts))

    def ctg_of(cuts, p, q):
        c = bisect.bisect_right(cuts, p) - 1
        return (c, p - cuts[c]) if q <= cuts[c + 1] else (None, None)

    m_recs, s_recs = [], []
    for k, p in enumerate(range(0, n - INSERT, stride)):
        m = p + INSERT - READ_LEN
        seq1, seq2 = genome[p:p + READ_LEN], genome[m:m + READ_LEN]
        for cuts, recs in ((m_cuts, m_recs), (s_cuts, s_recs)):
            c, off = ctg_of(cuts, p, m + READ_LEN)
            if c is not None:
                recs += pe_records(f"r{k}", seq1, c, off, seq2, c,
                                   m - cuts[c])

    def ctgs(cuts, tag):
        return [(f"{tag}{i}", genome[cuts[i]:cuts[i + 1]])
                for i in range(len(cuts) - 1)]

    ml, sl, mfa, sfa = _write_inputs(
        tmp_path, ctgs(m_cuts, "M"), ctgs(s_cuts, "S"), m_recs, s_recs,
        {"m": "m", "s": "s"})
    return dict(genome=genome, ml=ml, sl=sl, mfa=mfa, sfa=sfa)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64's finaliser: a bijection of uint64 (wrapping)."""
    x = x.astype(np.uint64)
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


def scale_columns(genome_mb: float, stride: int, seed: int = 0):
    """scale_corpus's layout (master contigs cut every 50 kbp, slave
    contigs every 50 kbp shifted by 25 kbp, an FR pair of 50 bp reads at
    insert 200 every `stride` bp, a pair kept on a side where one contig
    holds both mates) as the (master, slave) column tuples of
    core.blocks.stream_columns: (name hash h1 u64, h2 u64, first u8,
    contig i32, pos i32, end i32, reverse u8) of each side's reads in
    coordinate order, ties in the order scale_corpus writes them.  No BAM
    is written, so the size is free: at stride 2 a 5 Mbp genome gives
    ~5 M rows a side (50x coverage).  The name hashes are a bijection of
    the pair number salted from `seed` (the BAM decoder hashes names)."""
    n = int(genome_mb * 1_000_000)
    cut = 50_000
    salt = np.random.default_rng(seed).integers(0, 2 ** 62, 2,
                                                dtype=np.uint64)
    p = np.arange(0, n - INSERT, stride, dtype=np.int64)
    k = np.arange(len(p), dtype=np.uint64)
    m = p + INSERT - READ_LEN
    m_cuts = np.arange(0, n + 1, cut, dtype=np.int64)
    s_cuts = np.array([0] + list(range(cut // 2, n, cut)) + [n], np.int64)

    def side(cuts):
        c = np.searchsorted(cuts, p, side="right") - 1
        ok = m + READ_LEN <= cuts[c + 1]
        c, off = c[ok], cuts[c[ok]]
        kk = np.repeat(k[ok], 2)
        pos = np.stack([p[ok] - off, m[ok] - off], 1).ravel()
        ctg = np.repeat(c, 2)
        # mate 1 forward, mate 2 reverse; a stable sort keeps the
        # writer's order (pair by pair, mate 1 first) among equal keys
        first = np.tile(np.array([1, 0], np.uint8), len(c))
        order = np.lexsort((pos, ctg))
        kk, pos, ctg, first = kk[order], pos[order], ctg[order], first[order]
        return (_mix64(kk + salt[0]), _mix64(kk ^ salt[1]), first,
                ctg.astype(np.int32), pos.astype(np.int32),
                (pos + READ_LEN).astype(np.int32), 1 - first)

    return side(m_cuts), side(s_cuts)


def oracle(problems, band: int):
    """The exact host aligner (bsw_ref.bsw_align, through the port's
    merge --device oracle entry) on each problem."""
    from gam_ngs_tpu_torch.ops.bsw_engine import align_oracle

    return align_oracle(problems, band)


# per-edit (da, db) steps of the edit codes GAP_A, GAP_B, MATCH, MISMATCH
_DA, _DB, _MATCH = np.array([0, 1, 1, 1]), np.array([1, 0, 1, 1]), 2


def _match_pos(aln, last: bool):
    """(found, (a, b)) of the first or last MATCH of an edit string, with
    the reference's no-match fallbacks (my_alignment.cc:168, :229)."""
    e = aln.edits.astype(np.int64)
    m = np.nonzero(e == _MATCH)[0]
    if len(m) == 0:
        k = 0 if last else len(e)
        return False, (aln.begin_a + int(_DA[e[:k]].sum()),
                       aln.begin_b + int(_DB[e[:k]].sum()))
    k = int(m[-1] if last else m[0])
    return True, (aln.begin_a + int(_DA[e[:k]].sum()),
                  aln.begin_b + int(_DB[e[:k]].sum()))


def same_alignment(got, want) -> bool:
    """Equal begin, score, length and homology (1e-12), and equal edit
    strings or, for a lean result, equal first/last match positions.
    want carries an edit string (the oracle's result)."""
    ok = (got.score == want.score and got.begin_a == want.begin_a
          and got.begin_b == want.begin_b and got.length == want.length
          and abs(got.homology - want.homology) <= 1e-12)
    if got.lean is None:
        return ok and got.edits.tolist() == want.edits.tolist()
    return ok and (got.lean[2] == _match_pos(want, last=False)
                   and got.lean[3] == _match_pos(want, last=True))
