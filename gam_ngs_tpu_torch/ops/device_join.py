"""Device block construction: gam-create's compute core as torch ops.

gam_ngs_tpu/ops/device_join.py on a torch device.  Reference semantics
reproduced exactly:
  * Read::loadReadsMap  (lib/src/assembly/Read.cc:83)
  * Block::findBlocks   (lib/src/assembly/Block.cc:470)

The reference streams the slave BAM through a per-read hash-map lookup
and a sequential first-fit active-block list.  Here the whole stream is
recast as array programs over device-resident columns:

  1. JOIN (`join`) — master and slave rows sort together by their
     (first, name-hash h2, h1) key in three chained stable sorts, least
     significant key first; the concatenation order (masters, then
     slaves, each in stream order) is the tie-break, so within a key the
     masters come first, in stream order.  A cummax over the master
     rows' sorted positions gives every slave row the LAST master row of
     its key (last-write-wins, the reference's map insert order).
  2. RUN SEGMENTATION — a segmented running max of slave end
     coordinates splits the matched stream into independent *runs*
     (maximal slave-overlap chains).  No real block ever spans a run:
     extending a block needs `s_start <= block.s_end + 1`, and a run
     break means `s_start > max(previous s_end) + 1`.
  3. GROUP CHAIN ANALYSIS (`analyze`, with step 2) — within a run, reads
     group by master contig (a real block only absorbs reads of its own
     master contig).  Segmented exclusive max/min scans over the
     group-sorted stream test, per read, whether it chain-extends the
     group's single growing block.  Groups where every read chains — the
     overwhelming majority — reduce to exactly one block via segment
     reductions; the rest (master-interval gaps = repeats/misjoins, or
     runs containing reads shorter than min-block-size, whose
     empty-block quirk couples groups) fall back to an exact host scan
     over a tiny residue.
  4. ORDERING — the reference emits a block when a later read's
     first-fit walk passes it while out of scope, and flushes the
     remainder in list order.  Equivalently: block B (creation rank
     r_B, permanently out of scope from stream index t_B) is emitted at
     the first read index >= t_B whose own match position exceeds r_B
     (reads that create a new block, or seed the trailing empty slot,
     pass the whole list).  That index is found for all blocks at once
     with a vectorized segment-tree first-exceed query, and blocks sort
     by (emit index, rank) — byte-identical output order.

Segmented scans: torch has no associative_scan.  A segment id made
monotone by a cumsum of changes, packed above the value into one int64
(`seg * 2^32 + value + 2^31`), turns the segmented running max into one
running max (`cummax`, two-level); the min is the max of the negation.
Nothing is padded: the JAX package's pow2 padding and sentinel keys
exist for XLA's static shapes.

Why runs are independent: an active block's slave frame end only grows
by absorbing an in-scope read, so at a run break every existing block
is permanently out of scope (or on an earlier contig) and can never
match again; the only state crossing the break is the at-most-one
trailing *empty* active block (created by an unmatched read shorter
than min-block-size, Block.cc:49), which the very next unmatched read
seeds unconditionally — runs containing short reads are handled by the
exact host scan, threading the empty-slot carry bit between consecutive
short runs, and a consumed carry only renames the next run's first
block seed (plus counting its strand evidence, findBlocks :540).

`join` and `analyze` run on the device they are given; their results
return to the host as numpy, where steps 3's residue and 4 run.
"""

from __future__ import annotations

import numpy as np
import torch

_NEG = -(2 ** 30)
_INF = np.int64(2 ** 62)

# calls of join_device / analyze_device on a CUDA device (CPU runs not
# counted)
launches = {"join": 0, "analyze": 0}


# ---------------------------------------------------------------------------
# device programs
# ---------------------------------------------------------------------------

def _count(name: str, device: torch.device) -> None:
    if device.type == "cuda":
        launches[name] += 1


def _starts(*cols: torch.Tensor) -> torch.Tensor:
    """True where a row's key (cols) differs from the previous row's."""
    n = cols[0].shape[0]
    new = torch.ones(n, dtype=torch.bool, device=cols[0].device)
    if n > 1:
        diff = cols[0][1:] != cols[0][:-1]
        for c in cols[1:]:
            diff |= c[1:] != c[:-1]
        new[1:] = diff
    return new


_SCAN_ROW = 1024


def cummax(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running max of a 1-D int64 tensor, as a two-level scan:
    torch's cummax of one long row runs in one thread block on CUDA, so
    the rows of _SCAN_ROW values are scanned side by side, then the row
    maxima, and each row takes the maximum of the rows before it."""
    n = x.shape[0]
    if n <= _SCAN_ROW:
        return torch.cummax(x, 0).values
    rows = -(-n // _SCAN_ROW)
    low = torch.iinfo(torch.int64).min
    pad = torch.nn.functional.pad(x, (0, rows * _SCAN_ROW - n), value=low)
    part = torch.cummax(pad.view(rows, _SCAN_ROW), 1).values
    before = torch.full((rows, 1), low, dtype=x.dtype, device=x.device)
    before[1:, 0] = cummax(part[:-1, -1])
    return torch.maximum(part, before).view(-1)[:n]


def seg_scan_max(seg: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Inclusive running max of val (int64 in [-2^31, 2^31)) within each
    segment of seg (int64 >= 0, monotone non-decreasing): one running
    max over (seg, val + 2^31) packed into one int64."""
    packed = seg * (1 << 32) + (val + (1 << 31))
    return (cummax(packed) & 0xFFFFFFFF) - (1 << 31)


def exclusive(seg: torch.Tensor, incl: torch.Tensor, fill: int
              ) -> torch.Tensor:
    """The inclusive scan shifted by one row within each segment; fill at
    a segment's first row."""
    out = torch.full_like(incl, fill)
    if incl.shape[0] > 1:
        out[1:] = torch.where(seg[1:] == seg[:-1], incl[:-1], fill)
    return out


def join_device(first: torch.Tensor, h2: torch.Tensor, h1: torch.Tensor,
                nm: int) -> torch.Tensor:
    """join's device program over the concatenated master then slave
    rows: first (uint8), h2 and h1 (int64 views of the uint64 name
    hashes: the order between distinct keys is free, only equal keys
    must meet).  Returns, for each of the ns slave rows, the row of the
    last master with its key, or -1 (int64, on the rows' device)."""
    _count("join", first.device)
    n = first.shape[0]
    ns = n - nm
    # chained stable sorts, least significant key first: rows of one key
    # keep their concatenation order (masters first, stream order)
    perm = torch.sort(h1, stable=True).indices
    perm = perm[torch.sort(h2[perm], stable=True).indices]
    perm = perm[torch.sort(first[perm], stable=True).indices]

    idx = torch.arange(n, dtype=torch.int64, device=first.device)
    key_start = cummax(
        torch.where(_starts(first[perm], h2[perm], h1[perm]), idx, 0))
    is_master = perm < nm
    last = cummax(torch.where(is_master, idx, -1))
    m_row = torch.where(last >= key_start, perm[last.clamp(min=0)], -1)
    out = torch.full((ns,), -1, dtype=torch.int64, device=first.device)
    slave = ~is_master
    out[perm[slave] - nm] = m_row[slave]
    return out


def join(m_first, m_h2, m_h1, s_first, s_h2, s_h1,
         device: torch.device) -> np.ndarray:
    """For every slave row: index of the master row with the same
    (mate, name-hash) key — last occurrence in master stream order, as
    the reference's hash-map overwrite — or -1.  first: uint8 columns,
    h1/h2: uint64 columns; uploaded to `device`, joined there
    (join_device), fetched as numpy."""
    def up(a, b, dtype):
        return torch.from_numpy(np.concatenate(
            [np.asarray(a, dtype), np.asarray(b, dtype)])).to(device)

    return join_device(up(m_first, s_first, np.uint8),
                       up(m_h2, s_h2, np.uint64).view(torch.int64),
                       up(m_h1, s_h1, np.uint64).view(torch.int64),
                       len(m_first)).cpu().numpy()


def analyze_device(cols: torch.Tensor):
    """analyze's device program over the (6, n) int32 matched-stream
    columns s_ctg, s_start, s_end, m_ctg, m_begin, m_end.  Returns
    run_id (int32), perm (int64), g_first and chain_ok (bool), on the
    columns' device."""
    _count("analyze", cols.device)
    sc, ss, se, mc, mb, me = cols.long().unbind(0)
    n = sc.shape[0]
    pos = torch.arange(n, dtype=torch.int64, device=sc.device)

    # runs: segmented (by slave contig) running max of slave ends; a
    # contig change resets prev_max to _NEG, forcing a new run
    ctg_seg = torch.cumsum(_starts(sc), 0)
    prev_max = exclusive(ctg_seg, seg_scan_max(ctg_seg, se), _NEG)
    new_run = (pos == 0) | (ss > prev_max + 1)
    run_id = torch.cumsum(new_run, 0) - 1

    perm = torch.sort(run_id * (1 << 32) + (mc + (1 << 31)),
                      stable=True).indices
    run_s, mc_s = run_id[perm], mc[perm]
    mb_s, me_s, ss_s, se_s = mb[perm], me[perm], ss[perm], se[perm]

    g_first = _starts(run_s, mc_s)
    gid = torch.cumsum(g_first, 0)
    gmax_me = exclusive(gid, seg_scan_max(gid, me_s), _NEG)
    gmin_mb = -exclusive(gid, seg_scan_max(gid, -mb_s), _NEG)
    gmax_se = exclusive(gid, seg_scan_max(gid, se_s), _NEG)

    chain_ok = g_first | ((mb_s <= gmax_me + 1) & (me_s >= gmin_mb - 1)
                          & (ss_s <= gmax_se + 1))
    return run_id.int(), perm, g_first, chain_ok


def analyze(s_ctg, s_start, s_end, m_ctg, m_begin, m_end,
            device: torch.device):
    """Run segmentation + per-(run, master-contig) chain analysis.

    Coordinates are closed ([begin, end]), int32 columns of the matched
    stream, uploaded to `device` and analysed there (analyze_device).
    Returns, as numpy: run_id (int32, stream order), the
    (run, m_ctg)-sort permutation (int64), group-start marks and
    per-read chain-ok flags (both in sorted order).  chain-ok: the read
    extends its group's single growing block, given every previous
    group read did.
    """
    cols = torch.from_numpy(np.stack(
        [s_ctg, s_start, s_end, m_ctg, m_begin, m_end]).astype(np.int32))
    return tuple(t.cpu().numpy() for t in analyze_device(cols.to(device)))


# ---------------------------------------------------------------------------
# exact host scan for the residue (short-read runs / non-chaining groups)
# ---------------------------------------------------------------------------

class _Blk:
    __slots__ = ("seed", "last", "cnt", "m_ctg", "m_begin", "m_end", "m_brl",
                 "s_ctg", "s_begin", "s_end", "s_brl", "pos", "neg")

    def __init__(self, seed, m_ctg, m_begin, m_end, m_len,
                 s_ctg, s_begin, s_end, s_len):
        self.seed = seed
        self.last = seed
        self.cnt = 1
        self.m_ctg = m_ctg
        self.m_begin = m_begin
        self.m_end = m_end
        self.m_brl = m_len
        self.s_ctg = s_ctg
        self.s_begin = s_begin
        self.s_end = s_end
        self.s_brl = s_len
        self.pos = 0
        self.neg = 0


def _exact_scan(idx, m_ctg, m_begin, m_end, m_len,
                s_ctg, s_start, s_end, s_len, conc,
                mbs: int, carry_in_empty: bool):
    """First-fit active-list scan (Block::findBlocks :528-577) over one
    residual slice, tracking block assignments rather than emitting.

    Returns (blocks, mr_seed, carry_out): blocks in creation order;
    mr_seed[i] = seed index of the real block read i walk-matched, or
    -1 when the read seeded a block / created an empty slot (its walk
    passed the whole list).  carry_out: an unseeded empty slot survives
    the slice.
    """
    blocks: list[_Blk] = []
    active: list[_Blk] = []  # creation order; pruned once out of scope
    has_empty = bool(carry_in_empty)
    n = len(idx)
    mr_seed = np.full(n, -1, np.int64)
    for i in range(n):
        sc, ss, se = int(s_ctg[i]), int(s_start[i]), int(s_end[i])
        mc, mb, me = int(m_ctg[i]), int(m_begin[i]), int(m_end[i])
        matched = None
        k = 0
        while k < len(active):
            b = active[k]
            if b.s_ctg < sc or b.s_end + 1 < ss:
                active.pop(k)  # permanently out of scope: never matches
                continue
            if (b.m_ctg == mc and mb <= b.m_end + 1 and me >= b.m_begin - 1
                    and b.s_ctg == sc and se >= b.s_begin - 1):
                matched = b
                break
            k += 1
        if matched is not None:
            b = matched
            b.cnt += 1
            b.m_brl += int(m_len[i])
            b.s_brl += int(s_len[i])
            if mb < b.m_begin:
                b.m_begin = mb
            if me > b.m_end:
                b.m_end = me
            if ss < b.s_begin:
                b.s_begin = ss
            if se > b.s_end:
                b.s_end = se
            if conc[i]:
                b.pos += 1
            else:
                b.neg += 1
            b.last = int(idx[i])
            mr_seed[i] = b.seed
        elif has_empty:
            # the trailing empty slot seeds unconditionally via addReads
            # — and that read's strand evidence counts (walk path)
            b = _Blk(int(idx[i]), mc, mb, me, int(m_len[i]),
                     sc, ss, se, int(s_len[i]))
            if conc[i]:
                b.pos += 1
            else:
                b.neg += 1
            blocks.append(b)
            active.append(b)
            has_empty = False
        elif int(m_len[i]) >= mbs and int(s_len[i]) >= mbs:
            # Block(mRead, sRead, minBlockSize) seeds; the seeding
            # read's strand evidence is NOT counted (findBlocks :577)
            b = _Blk(int(idx[i]), mc, mb, me, int(m_len[i]),
                     sc, ss, se, int(s_len[i]))
            blocks.append(b)
            active.append(b)
        else:
            has_empty = True
    return blocks, mr_seed, has_empty


# ---------------------------------------------------------------------------
# vectorized segment-tree: first index >= t with value > x
# ---------------------------------------------------------------------------

def _first_exceed(vals: np.ndarray, t: np.ndarray, x: np.ndarray
                  ) -> np.ndarray:
    """For each query q: min{ i >= t[q] : vals[i] > x[q] }, or len(vals)
    if none.  Lockstep segment-tree walk over all queries at once."""
    n = len(vals)
    nq = len(t)
    if nq == 0:
        return np.zeros(0, np.int64)
    p = 1
    while p < max(n, 1):
        p *= 2
    levels = [np.full(p, -_INF, np.int64)]
    levels[0][:n] = vals
    while len(levels[-1]) > 1:
        a = levels[-1]
        levels.append(np.maximum(a[0::2], a[1::2]))
    top = len(levels) - 1
    flat = np.concatenate(levels)
    off = np.zeros(top + 1, np.int64)
    for k in range(1, top + 1):
        off[k] = off[k - 1] + len(levels[k - 1])

    i = np.minimum(t, p).astype(np.int64)
    k = np.zeros(nq, np.int64)
    state = np.where(t >= n, 2, 0)  # 0=walk up, 1=descend, 2=done
    ans = np.full(nq, n, np.int64)

    for _ in range(4 * (top + 1) + 4):
        up = state == 0
        if not up.any():
            break
        oor = up & (i >= (p >> k))
        state[oor] = 2
        up &= ~oor
        climb = up & (i % 2 == 0) & (k < top)
        k[climb] += 1
        i[climb] >>= 1
        chk = up & ~climb
        if chk.any():
            w = np.nonzero(chk)[0]
            hit = flat[off[k[w]] + i[w]] > x[w]
            state[w[hit]] = 1
            i[w[~hit]] += 1

    for _ in range(top + 1):
        d = state == 1
        if not d.any():
            break
        fin = d & (k == 0)
        ans[fin] = i[fin]
        state[fin] = 2
        d &= ~fin
        if d.any():
            k[d] -= 1
            i[d] <<= 1
            w = np.nonzero(d)[0]
            left_fail = flat[off[k[w]] + i[w]] <= x[w]
            i[w[left_fail]] += 1
    return np.minimum(ans, n)


# ---------------------------------------------------------------------------
# host orchestration
# ---------------------------------------------------------------------------

def find_blocks_device(m_cols: tuple, s_cols: tuple, min_block_size: int,
                       stats: dict | None = None, *,
                       device: torch.device) -> dict:
    """loadReadsMap + findBlocks over columnar streams, device-first.

    m_cols/s_cols: (h1 u64, h2 u64, first u8, ctg i32, pos i32, end i32,
    rev u8) of good-quality uniquely-mapped reads in merged coordinate
    order.  Returns the same columns dict as the native scan, rows in
    the reference's exact emission order.  join and analyze run on
    `device`.
    """
    local = local_block_arrays(m_cols, s_cols, min_block_size,
                               carry_in=False, stats=stats, device=device)
    return finalize_emission([local], int(min_block_size))


def local_block_arrays(m_cols: tuple, s_cols: tuple, min_block_size: int,
                       carry_in: bool = False,
                       stats: dict | None = None, *,
                       device: torch.device) -> dict:
    """Per-shard block construction: everything except emission order.

    Multi-host create shards the slave stream at contig boundaries
    (runs never span a contig — see module docstring); `carry_in` is
    the predecessor shard's trailing empty-slot bit.  Returns a dict of
    creation-order block arrays (b_*), per-matched-read walk-match
    seeds (mr_seed), per-block emission-query start (t_b, local stream
    index), the matched-stream length n, and carry_out — all with
    LOCAL (0-based) stream indices; the distributed combiner offsets
    them before finalize_emission.
    """
    mbs = int(min_block_size)
    mh1, mh2, mfirst, mctg, mpos, mend, mrev = [np.asarray(c) for c in m_cols]
    sh1, sh2, sfirst, sctg, spos, ssend, srev = [np.asarray(c) for c in s_cols]
    nm, ns = len(mh1), len(sh1)
    if nm == 0 or ns == 0:
        return _empty_local(carry_in)

    # ---- 1. device join
    midx = join(mfirst, mh2, mh1, sfirst, sh2, sh1, device)

    sel = np.nonzero(midx >= 0)[0]
    n = len(sel)
    if n == 0:
        return _empty_local(carry_in)
    mi = midx[sel]
    r_sctg = sctg[sel].astype(np.int32)
    r_sstart = spos[sel].astype(np.int32)
    r_send = (ssend[sel] - 1).astype(np.int32)       # closed end
    r_slen = (ssend[sel] - spos[sel]).astype(np.int32)
    r_mctg = mctg[mi].astype(np.int32)
    r_mbegin = mpos[mi].astype(np.int32)
    r_mend = (mend[mi] - 1).astype(np.int32)
    r_mlen = (mend[mi] - mpos[mi]).astype(np.int32)
    conc = ((mrev[mi] != 0) == (srev[sel] != 0))
    short = (r_mlen < mbs) | (r_slen < mbs)

    # ---- 2+3. device run/group analysis
    # sp: sorted order -> stream index
    run_id, sp, g_first, chain_ok = analyze(
        r_sctg, r_sstart, r_send, r_mctg, r_mbegin, r_mend, device)

    # ---- group / run reductions (int64-exact, vectorized)
    starts = np.nonzero(g_first)[0]
    ends = np.append(starts[1:], n)
    ngrp = len(starts)
    g_cnt = (ends - starts).astype(np.int64)
    g_seed = sp[starts]
    g_last = sp[ends - 1]
    g_m_begin = np.minimum.reduceat(r_mbegin[sp], starts)
    g_m_end = np.maximum.reduceat(r_mend[sp], starts)
    g_s_begin = np.minimum.reduceat(r_sstart[sp], starts)
    g_s_end = np.maximum.reduceat(r_send[sp], starts)
    g_mbrl = np.add.reduceat(r_mlen[sp].astype(np.int64), starts)
    g_sbrl = np.add.reduceat(r_slen[sp].astype(np.int64), starts)
    g_pos = np.add.reduceat(conc[sp].astype(np.int64), starts)
    g_chain = np.logical_and.reduceat(chain_ok, starts)
    g_mctg = r_mctg[g_seed]
    g_sctg = r_sctg[g_seed]

    run_first = np.nonzero(np.diff(run_id, prepend=np.int32(-1)))[0]
    nruns = len(run_first)
    run_end = np.append(run_first[1:], n)
    run_short = np.logical_or.reduceat(short, run_first)
    g_run = run_id[g_seed]
    g_simple = g_chain & ~run_short[g_run]
    residual_groups = np.nonzero(~g_simple & ~run_short[g_run])[0]

    # ---- carry chain over short runs (exact scan per short run); the
    # incoming bit of run 0 is the predecessor SHARD's trailing slot
    carry_out = np.zeros(nruns, bool)
    res_blocks: list[_Blk] = []
    mr_seed = np.full(n, -1, np.int64)

    for r in np.nonzero(run_short)[0].tolist():
        lo, hi = int(run_first[r]), int(run_end[r])
        cin = bool(carry_in if r == 0
                   else run_short[r - 1] and carry_out[r - 1])
        blks, mrs, co = _exact_scan(
            np.arange(lo, hi), r_mctg[lo:hi], r_mbegin[lo:hi],
            r_mend[lo:hi], r_mlen[lo:hi], r_sctg[lo:hi], r_sstart[lo:hi],
            r_send[lo:hi], r_slen[lo:hi], conc[lo:hi], mbs, cin)
        carry_out[r] = co
        res_blocks.extend(blks)
        mr_seed[lo:hi] = mrs

    # all-long runs immediately following a carrying short run (or the
    # shard head, when the carry bit arrives from the previous shard)
    # consume the empty slot with their first matched read
    prev_short = np.concatenate([[carry_in], run_short[:-1]])
    prev_carry = np.concatenate([[carry_in], carry_out[:-1]])
    consumed_heads = run_first[(~run_short) & prev_short & prev_carry]
    consumed_set = set(consumed_heads.tolist())

    # non-simple all-long groups: exact scan per group (no empty slots —
    # every read is long enough to seed — except a consumed carry)
    for g in residual_groups.tolist():
        lo, hi = int(starts[g]), int(ends[g])
        rows = sp[lo:hi]
        blks, mrs, _ = _exact_scan(
            rows, r_mctg[rows], r_mbegin[rows], r_mend[rows], r_mlen[rows],
            r_sctg[rows], r_sstart[rows], r_send[rows], r_slen[rows],
            conc[rows], mbs, int(g_seed[g]) in consumed_set)
        res_blocks.extend(blks)
        mr_seed[rows] = mrs

    # ---- simple groups: one block each, fully vectorized
    simple = np.nonzero(g_simple)[0]
    s_seed = g_seed[simple]
    seed_conc = conc[s_seed].astype(np.int64)
    carried = np.isin(s_seed, consumed_heads) if len(consumed_heads) \
        else np.zeros(len(simple), bool)
    # the seeding read's evidence does not count unless it seeded a
    # carried empty slot (walk path, findBlocks :540)
    sg_pos = g_pos[simple] - np.where(carried, 0, seed_conc)
    sg_neg = (g_cnt - g_pos)[simple] - np.where(carried, 0, 1 - seed_conc)

    gid_sorted = np.repeat(np.arange(ngrp), g_cnt)
    in_simple = g_simple[gid_sorted]
    mr_seed[sp[in_simple]] = np.repeat(g_seed, g_cnt)[in_simple]
    mr_seed[s_seed] = -1

    if stats is not None:
        stats["matched_reads"] = int(n)
        stats["runs"] = int(nruns)
        stats["groups"] = int(ngrp)
        stats["simple_groups"] = int(len(simple))
        stats["residual_reads"] = int(np.sum(run_short[run_id])) + int(
            np.sum(g_cnt[residual_groups]))

    # ---- combined block arrays (creation order within the shard)
    nres = len(res_blocks)
    nsimp = len(simple)
    nb = nres + nsimp
    carry_out_global = bool(nruns > 0 and run_short[-1] and carry_out[-1])
    if nb == 0:
        out = _empty_local(carry_out_global)
        out["n"] = n
        out["mr_seed"] = mr_seed
        return out

    def col(attr, dtype, simple_arr):
        a = np.empty(nb, dtype)
        a[:nres] = [getattr(b, attr) for b in res_blocks]
        a[nres:] = simple_arr
        return a

    b_sctg = col("s_ctg", np.int32, g_sctg[simple])
    b_send = col("s_end", np.int32, g_s_end[simple])
    b_last = col("last", np.int64, g_last[simple])

    # the emission-query start is local-computable even under sharding:
    # shards split at slave-contig boundaries, so the first stream index
    # past a block's scope either lies inside this shard or is exactly
    # the shard end (the next shard starts a strictly greater contig)
    key = r_sctg.astype(np.int64) * (2 ** 33) + r_sstart.astype(np.int64)
    t_b = np.maximum(
        np.searchsorted(key, b_sctg.astype(np.int64) * (2 ** 33)
                        + b_send.astype(np.int64) + 2, side="left"),
        b_last + 1)

    return dict(
        n=n,
        carry_out=carry_out_global,
        mr_seed=mr_seed,
        t_b=t_b,
        b_seed=col("seed", np.int64, s_seed),
        b_last=b_last,
        b_cnt=col("cnt", np.int64, g_cnt[simple]),
        b_mctg=col("m_ctg", np.int32, g_mctg[simple]),
        b_mbegin=col("m_begin", np.int32, g_m_begin[simple]),
        b_mend=col("m_end", np.int32, g_m_end[simple]),
        b_mbrl=col("m_brl", np.int64, g_mbrl[simple]),
        b_sctg=b_sctg,
        b_sbegin=col("s_begin", np.int32, g_s_begin[simple]),
        b_send=b_send,
        b_sbrl=col("s_brl", np.int64, g_sbrl[simple]),
        b_pos=col("pos", np.int64, sg_pos),
        b_neg=col("neg", np.int64, sg_neg),
    )


def finalize_emission(locals_list: list[dict], min_block_size: int) -> dict:
    """Exact emission order over one or more shard-local results.

    Shards must be passed in slave-stream order; per-shard stream
    indices (b_seed, b_last, t_b, mr_seed) are offset by the matched
    counts of the preceding shards, then the global first-exceed query
    reproduces the reference's block emission order across shard
    boundaries (a block retired near a shard's end is emitted by a
    read of a LATER shard — findBlocks :528-577 walk semantics).
    """
    mbs = int(min_block_size)
    offs = np.cumsum([0] + [p["n"] for p in locals_list])

    def cat(keyname, off_by=None):
        arrs = []
        for k, p in enumerate(locals_list):
            a = p[keyname]
            if off_by is not None and len(a):
                if keyname == "mr_seed":
                    a = np.where(a >= 0, a + offs[k], a)
                else:
                    a = a + offs[k]
            arrs.append(a)
        return np.concatenate(arrs) if arrs else np.zeros(0, np.int64)

    b_cnt = cat("b_cnt")
    nb = len(b_cnt)
    if nb == 0:
        return _empty_cols()
    b_seed = cat("b_seed", off_by=True)
    b_last = cat("b_last", off_by=True)
    t_b = cat("t_b", off_by=True)
    mr_seed = cat("mr_seed", off_by=True)
    n = int(offs[-1])

    # ---- 4. exact emission order
    order_by_seed = np.argsort(b_seed, kind="stable")
    rank_of = np.empty(nb, np.int64)
    rank_of[order_by_seed] = np.arange(nb)
    seed_sorted = b_seed[order_by_seed]

    # per-read match rank: rank of the walk-matched block, else +inf
    mr_rank = np.full(n, _INF, np.int64)
    has_m = mr_seed >= 0
    mr_rank[has_m] = np.searchsorted(seed_sorted, mr_seed[has_m])

    emit = _first_exceed(mr_rank, t_b, rank_of)
    order = np.lexsort((rank_of, emit))
    order = order[b_cnt[order] >= mbs]

    b_pos = cat("b_pos")
    b_neg = cat("b_neg")
    return dict(
        num_reads=b_cnt[order],
        m_ctg=cat("b_mctg")[order],
        m_begin=cat("b_mbegin")[order],
        m_end=cat("b_mend")[order],
        m_block_reads_len=cat("b_mbrl")[order].astype(np.uint64),
        s_ctg=cat("b_sctg")[order],
        s_strand=np.where(b_pos[order] >= b_neg[order],
                          ord("+"), ord("-")).astype(np.uint8),
        s_begin=cat("b_sbegin")[order],
        s_end=cat("b_send")[order],
        s_block_reads_len=cat("b_sbrl")[order].astype(np.uint64),
    )


def _empty_local(carry_out: bool) -> dict:
    return dict(
        n=0, carry_out=bool(carry_out),
        mr_seed=np.zeros(0, np.int64), t_b=np.zeros(0, np.int64),
        b_seed=np.zeros(0, np.int64), b_last=np.zeros(0, np.int64),
        b_cnt=np.zeros(0, np.int64),
        b_mctg=np.zeros(0, np.int32), b_mbegin=np.zeros(0, np.int32),
        b_mend=np.zeros(0, np.int32), b_mbrl=np.zeros(0, np.int64),
        b_sctg=np.zeros(0, np.int32), b_sbegin=np.zeros(0, np.int32),
        b_send=np.zeros(0, np.int32), b_sbrl=np.zeros(0, np.int64),
        b_pos=np.zeros(0, np.int64), b_neg=np.zeros(0, np.int64),
    )


def _empty_cols() -> dict:
    return dict(
        num_reads=np.zeros(0, np.int64),
        m_ctg=np.zeros(0, np.int32), m_begin=np.zeros(0, np.int32),
        m_end=np.zeros(0, np.int32),
        m_block_reads_len=np.zeros(0, np.uint64),
        s_ctg=np.zeros(0, np.int32), s_strand=np.zeros(0, np.uint8),
        s_begin=np.zeros(0, np.int32), s_end=np.zeros(0, np.int32),
        s_block_reads_len=np.zeros(0, np.uint64),
    )

