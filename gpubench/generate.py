"""The general generator: one configuration (a genome and the two
assemblies of it that a GAM-NGS merge reconciles) and one traffic mix
(how the align rounds of a merge are driven) -> the problems of every
align stage, made from the seed before the window opens.

A stage is the align stage of one merge of two assemblies of the
configuration's genome:
- the genome is random, of the configuration's length and GC share; the
  slave assembly's sequence is the genome with the configuration's
  substitutions and indels, the master's is the genome itself;
- each stage cuts both sequences into contigs anew, their lengths drawn
  from a lognormal of the configuration's contig N50 (the length-weighted
  median) and spread;
- each stretch of the genome that lies in one master and one slave
  contig is a chain; repeats (fixed for the genome) leave no block, so
  they cut each chain into windows, each at most max_window_bp long,
  and windows shorter than min_block_bp are dropped;
- a window is one banded-SW problem, (master contig, begin_a, end_a,
  slave contig, begin_b, end_b, force_start, force_end), as the merge's
  alignBlocks yields it for a block;
- round r of a stage holds window r of every chain that has one, in
  genome order, as merge/scheduler.py::drive_batched batches them.

Every seed gets the same sizes in another order: the layout (contig
cuts, repeats, where the indels fall and how long they are) comes from
the traffic's fixed `layout_seed`; the run's seed draws the letters of
the genome, the substitutions and inserted bases, and the order in
which the window takes the pool's stages.  So runs on different seeds
do the same work, and differ as two runs of one seed do.

NumPy only: the genome, the contigs and the problems are made on the
host, and the problems hold views of the two sequences.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .reference import x_size

def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one named stream of a seed (any whole number)."""
    return np.random.default_rng([seed % (1 << 64), *stream])


@dataclass
class Genome:
    master: np.ndarray      # the genome, codes 0-3
    slave: np.ndarray       # the genome with the assemblies' differences
    s_of_g: np.ndarray      # slave index of each genome base, and len(slave)
    repeats: np.ndarray     # (n, 2) genome intervals that hold no block


def make_genome(cfg: dict, seed: int, layout_seed: int) -> Genome:
    rng = rng_for(seed, 0)       # letters
    lay = rng_for(layout_seed, 0)  # where the differences and repeats fall
    n = int(cfg["genome_bp"])
    gc = float(cfg["gc_share"])
    # bytes mapped to A, T, C, G in the GC share
    lut = np.empty(256, np.uint8)
    at = int(round(256 * (1 - gc) / 2))
    cg = (256 - 2 * at) // 2
    lut[:at], lut[at:2 * at] = 0, 1
    lut[2 * at:2 * at + cg], lut[2 * at + cg:] = 2, 3
    master = lut[rng.integers(0, 256, n, dtype=np.uint8)]

    diff = cfg["differences"]
    slave_g = master.copy()
    n_sub = lay.poisson(n * diff["substitutions_per_kbp"] / 1000)
    sub = lay.integers(0, n, n_sub)
    slave_g[sub] = (slave_g[sub] + rng.integers(1, 4, n_sub)) % 4
    counts = np.ones(n, np.uint8)
    n_indel = lay.poisson(n * diff["indels_per_kbp"] / 1000)
    pos = np.sort(lay.integers(0, n - 64, n_indel))
    size = lay.integers(1, int(diff["indel_max_bp"]) + 1, n_indel)
    is_ins = lay.random(n_indel) < 0.5
    for p, k, ins in zip(pos.tolist(), size.tolist(), is_ins.tolist()):
        if ins:
            counts[p] += k
        else:
            counts[p:p + k] = 0
    slave = np.repeat(slave_g, counts)
    # slave index of each genome base (a deleted base: the next kept one)
    s_of_g = np.empty(n + 1, np.int64)
    s_of_g[0] = 0
    np.cumsum(counts, out=s_of_g[1:])
    starts = s_of_g[:-1]
    # the inserted bases after each insertion site are new, random bases
    ins_sites = np.nonzero(counts > 1)[0]
    if len(ins_sites):
        extra = counts[ins_sites].astype(np.int64) - 1
        first = np.repeat(starts[ins_sites] + 1, extra)
        step = np.arange(extra.sum()) - np.repeat(np.cumsum(extra) - extra,
                                                  extra)
        slave[first + step] = rng.integers(0, 4, int(extra.sum()))

    blk = cfg["blocks"]
    n_rep = lay.poisson(n / blk["repeat_every_bp"])
    r0 = np.sort(lay.integers(0, n, n_rep))
    repeats = np.stack([r0, np.minimum(n, r0 + blk["repeat_bp"])], 1)
    return Genome(master, slave, s_of_g, repeats)


def contig_bounds(rng, n: int, asm: dict) -> np.ndarray:
    """Contig boundaries tiling [0, n): lengths from a lognormal whose
    length-weighted median is the assembly's contig N50."""
    sigma = float(asm["contig_length_sigma"])
    mu = np.log(asm["contig_n50_bp"]) - sigma ** 2
    mean = np.exp(mu + sigma ** 2 / 2)
    lens = []
    total = 0
    while total < n:
        draw = rng.lognormal(mu, sigma, int(2 * (n - total) / mean) + 16)
        draw = np.maximum(draw.astype(np.int64), int(asm["min_contig_bp"]))
        lens.append(draw)
        total += int(draw.sum())
    cuts = np.cumsum(np.concatenate(lens))
    cuts = cuts[cuts < n]
    return np.concatenate([[0], cuts, [n]])


def _windows(u: int, v: int, repeats: np.ndarray, blk: dict) -> list:
    """The block windows of chain [u, v): the stretches between repeats,
    at least min_block_bp, cut to at most max_window_bp."""
    lo = np.searchsorted(repeats[:, 1], u, side="right")
    hi = np.searchsorted(repeats[:, 0], v, side="left")
    out = []
    cur = u
    pieces = []
    for r_start, r_end in repeats[lo:hi].tolist():
        if r_start > cur:
            pieces.append((cur, min(r_start, v)))
        cur = max(cur, r_end)
    if cur < v:
        pieces.append((cur, v))
    cap = int(blk["max_window_bp"])
    for a, b in pieces:
        if b - a < blk["min_block_bp"]:
            continue
        k = -(-(b - a) // cap)
        step = -(-(b - a) // k)
        out.extend((s, min(b, s + step)) for s in range(a, b, step))
    return out


@dataclass
class Stage:
    rounds: list        # list of rounds, each a list of problem tuples
    round_cells: list   # band cells of each round (x_size x (2*band+1))
    round_rows: list    # each round's x_size per problem (np.int64 arrays)
    round_rows_sum: list  # and their sums


def make_stage(cfg: dict, genome: Genome, layout_seed: int, k: int
               ) -> Stage:
    rng = rng_for(layout_seed, 1, k)
    n = len(genome.master)
    band = int(cfg["band"])
    mb = contig_bounds(rng, n, cfg["master"])
    sb = contig_bounds(rng, n, cfg["slave"])
    cuts = np.union1d(mb, sb)
    m_idx = np.searchsorted(mb, cuts[:-1], side="right") - 1
    s_idx = np.searchsorted(sb, cuts[:-1], side="right") - 1
    s_of_g = genome.s_of_g
    masters, slaves = {}, {}
    chains = []
    for u, v, m, s in zip(cuts[:-1].tolist(), cuts[1:].tolist(),
                          m_idx.tolist(), s_idx.tolist()):
        wins = _windows(u, v, genome.repeats, cfg["blocks"])
        if not wins:
            continue
        ms, me = int(mb[m]), int(mb[m + 1])
        s0, s1 = int(s_of_g[sb[s]]), int(s_of_g[sb[s + 1]])
        a = masters.get(m)
        if a is None:
            a = masters[m] = genome.master[ms:me]
        b = slaves.get(s)
        if b is None:
            b = slaves[s] = genome.slave[s0:s1]
        probs = []
        for w0, w1 in wins:
            bb, eb = int(s_of_g[w0]) - s0, int(s_of_g[w1]) - 1 - s0
            probs.append((a, w0 - ms, w1 - 1 - ms, b, bb, eb, False, False))
        chains.append(probs)
    rounds, cells, rows = [], [], []
    depth = max(len(c) for c in chains)
    for r in range(depth):
        rnd = [c[r] for c in chains if len(c) > r]
        xs = np.array([x_size(len(p[0]), p[1], len(p[3]), p[4], p[5], band)
                       for p in rnd], np.int64)
        rounds.append(rnd)
        rows.append(xs)
        cells.append(int(xs.sum()) * (2 * band + 1))
    return Stage(rounds, cells, rows, [int(x.sum()) for x in rows])


def pool_size(traffic: dict, cfg: dict) -> int:
    """Stages in the pool the window cycles through: `pool_cells` band
    cells' worth at the genome's cells a stage, at least `min_stages`."""
    cells = cfg["genome_bp"] * (2 * cfg["band"] + 1)
    return max(int(traffic["min_stages"]),
               int(np.ceil(traffic["pool_cells"] / cells)))


def stage_order(seed: int, n: int) -> list[int]:
    """The order in which a run takes the pool's stages."""
    return rng_for(seed, 3).permutation(n).tolist()
