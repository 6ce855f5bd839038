"""Partition edge count (junction evidence) on a torch device.

The counterpart of gam_ngs_tpu/ops/region_score.py's two paths.  Both
apply the c1..c4 read classes of getLibRegionScore
(CompactAssemblyGraph.cc:361-530) to every row of every (edge, library)
job and sum them per job with one cumsum, as plain torch ops on the
device the columns were uploaded to:

  * resident range jobs (the default; _count_jobs_resident with
    _resident_kernel_raw): every job is a row range of a library's
    coordinate-sorted alignment columns; the union of the touched rows
    is uploaded once per call, each chunk ships only its jobs' ranges
    and scalars, and the device finds each row's job (searchsorted) and
    gathers its columns;
  * row-payload jobs (GAM_RESIDENT=0; _count_kernel): every job carries
    copies of its rows, each chunk uploads them at their wire widths
    (flag and NH uint16, XT and good-quality uint8) with the jobs'
    scalars, and the device widens them.

Chunks keep the reference's ROW_CAP / OV_CAP bounds; a job whose summed
read lengths exceed OV_CAP is counted exactly on the host
(_count_job_host).  The sums run in int64 (torch.cumsum's type for
integer input); under the caps int32 would be exact as well.  The
mesh-sharded count is not ported (one GPU a process).
"""

from __future__ import annotations

import bisect
import os

import numpy as np
import torch

from ..io.bam import FMREVERSE, FMUNMAP, FPAIRED, FREVERSE

XT_U = ord("U")

# Per-process wire counters (run_merge records deltas): job-range payload
# bytes, dispatches and the once-per-call column uploads.  The JAX
# module's per-shape compile log has no counterpart: nothing compiles
# per shape here.
WIRE = {"bytes_up": 0, "dispatches": 0, "arena_bytes_up": 0}

_SCA_FIELDS = ("s1", "s2", "t", "max_insert", "seq_len", "no_mult")
# the row-payload jobs' row columns and their wire widths (int32 else)
_ROW_FIELDS = ("pos", "end_pos", "flag", "nh", "xt", "ref_id",
               "mate_ref", "mate_pos", "goodq")
_ROW_DTYPES = {"flag": np.uint16, "nh": np.uint16, "xt": np.uint8,
               "goodq": np.uint8}

# Row cap per dispatch: bounds the int32 cumsum (cap * max-overlap
# 2^21 * ~2^9 < 2^31) and keeps every compiled shape small.
ROW_CAP = 1 << 21

# Hard bound on the int32 overlap cumsum within one dispatch: the
# summed overlap `ov` equals the FULL read length when a read ends
# inside the region, so long-read BAMs (10kb+ records) could overflow
# the row cap's short-read assumption.  Chunks are split when the
# host-side worst-case sum of read lengths exceeds this; a single job
# beyond it is counted exactly on the host instead.
OV_CAP = 1 << 30


def use_resident() -> bool:
    """Device-resident region tables (SURVEY.md §2.7 "HBM region
    tables"): the coord-sorted alignment columns upload ONCE per table
    (cached on the table object), and every edge-weighting dispatch
    ships only per-job row RANGES + scalars (~32 B/job) instead of a
    row-copy payload (~26 B/row, tens of MB per run).  GAM_RESIDENT=0
    restores the payload path."""
    v = os.environ.get("GAM_RESIDENT")
    if v is not None:
        return v != "0"
    return True


# the bit plane of _host_cols: paired, reverse, mate
# unmapped, mate reverse, NH==1 & XT:U, good quality, ref != mate ref
_B_PAIRED, _B_REV, _B_MUNMAP, _B_MREV, _B_UNIQ, _B_GOODQ, _B_DIFFREF = (
    1, 2, 4, 8, 16, 32, 64)


def _host_cols(mb, lib: int):
    """Library `lib`'s coord-sorted columns on the HOST, cached on the
    table object (tables are replaced wholesale on ranged re-ingest, so
    object identity is the correct cache key).

    Narrow layout: pos/end_pos/mate_pos int32 + ONE uint8 bit-plane
    (paired, reverse, mate-unmapped, mate-reverse, nh==1&XT:U, goodq,
    ref!=mate_ref — everything getLibRegionScore reads from flags/tags,
    CompactAssemblyGraph.cc:361-530) = 13 B/row.  Also holds the int64
    prefix sum of read lengths (the OV_CAP overflow guard needs
    per-job Σrl in O(1)).

    Only the UNION of the job row ranges is ever shipped to the device
    (_count_jobs_resident coalesces them): junction regions are sparse
    — measured <1% of rows at 10 Mbp — so uploading full tables spent
    ~40 MB of thin-link bandwidth for ~100 KB of useful rows."""
    t = mb.files[lib].table
    cols = getattr(t, "_resident_cols", None)
    if cols is not None:
        return cols
    order = mb.coord_order(lib)
    pos = np.ascontiguousarray(t.pos[order], np.int32)
    end = np.ascontiguousarray(t.end_pos[order], np.int32)
    mate = np.ascontiguousarray(t.mate_pos[order], np.int32)
    flag = t.flag[order]
    bits = (((flag & FPAIRED) != 0) * 1
            | ((flag & FREVERSE) != 0) * 2
            | ((flag & FMUNMAP) != 0) * 4
            | ((flag & FMREVERSE) != 0) * 8
            | ((t.nh[order] == 1) & (t.xt[order] == XT_U)) * 16
            | (t.is_good_quality()[order] != 0) * 32
            | (t.ref_id[order] != t.mate_ref_id[order]) * 64
            ).astype(np.uint8)
    rlp = np.zeros(len(pos) + 1, np.int64)
    np.cumsum(np.clip(end.astype(np.int64) - pos, 0, None), out=rlp[1:])
    cols = (pos, end, mate, bits, rlp)
    t._resident_cols = cols
    return cols


def _materialize_resident(job: dict) -> dict:
    """Row-copy view of a resident range job (host-exact fallback)."""
    mb, lib = job["_mb"], job["lib"]
    t = mb.files[lib].table
    rows = mb.coord_order(lib)[job["lo"]:job["hi"]]
    return dict(
        pos=t.pos[rows], end_pos=t.end_pos[rows], flag=t.flag[rows],
        nh=t.nh[rows], xt=t.xt[rows], ref_id=t.ref_id[rows],
        mate_ref=t.mate_ref_id[rows], mate_pos=t.mate_pos[rows],
        goodq=t.is_good_quality()[rows],
        **{k: job[k] for k in _SCA_FIELDS})


def _count_job_host(job: dict) -> tuple[int, int, int]:
    """Exact int64 host replica of the device kernel for one job —
    the overflow escape hatch for jobs whose Σ read lengths alone
    would exceed the int32 cumsum bound."""
    pos = np.asarray(job["pos"], np.int64)
    end_pos = np.asarray(job["end_pos"], np.int64)
    flag = np.asarray(job["flag"], np.int64)
    nh = np.asarray(job["nh"], np.int64)
    xt = np.asarray(job["xt"], np.int64)
    ref_id = np.asarray(job["ref_id"], np.int64)
    mate_ref = np.asarray(job["mate_ref"], np.int64)
    mate_pos = np.asarray(job["mate_pos"], np.int64)
    goodq = np.asarray(job["goodq"], bool)

    rl = end_pos - pos
    end_read = pos + rl - 1
    end_mate = mate_pos + rl - 1
    paired = (flag & FPAIRED) != 0
    fwd = (flag & FREVERSE) == 0
    munmap = (flag & FMUNMAP) != 0
    mrev = (flag & FMREVERSE) != 0
    uniq = bool(job["no_mult"]) | ((nh == 1) & (xt == XT_U))
    in_range = (pos >= job["s1"]) & (pos <= job["s2"])

    base = goodq & paired & uniq & in_range & fwd
    ov = np.where(end_read > job["s2"], job["s2"] - pos + 1, rl)

    diff_ref = ref_id != mate_ref
    mate_crosses = end_mate >= job["t"]
    c1 = base & munmap
    c2 = base & ~munmap & diff_ref
    c2_exp = c2 & (pos + job["max_insert"] < job["seq_len"])
    c3 = base & ~munmap & ~diff_ref & ~mrev & mate_crosses
    c4 = base & ~munmap & ~diff_ref & mrev & mate_crosses

    good = int(ov[c4].sum())
    exp = int(ov[c1 | c2_exp | c3 | c4].sum())
    num = int((c1 | c2 | c3 | c4).sum())
    return good, exp, num


def _job_sums(starts, ends, in_job, pos, end_pos, mate_pos, paired, fwd,
              munmap, mrev, uniq, goodq, diff_ref, s1j, s2j, tj, mij, slj
              ) -> torch.Tensor:
    """The c1..c4 read classes of every row (int64 columns; s1j..slj the
    scalars of each row's job), summed over each job's contiguous run of
    rows [starts, ends).  Returns (3, J) int64: good_reads, exp_reads,
    num_reads."""
    rl = end_pos - pos
    end_read = pos + rl - 1
    end_mate = mate_pos + rl - 1
    in_range = (pos >= s1j) & (pos <= s2j)

    base = in_job & goodq & paired & uniq & in_range & fwd
    ov = torch.where(end_read > s2j, s2j - pos + 1, rl)
    mate_crosses = end_mate >= tj
    c1 = base & munmap
    c2 = base & ~munmap & diff_ref
    c2_exp = c2 & (pos + mij < slj)
    c3 = base & ~munmap & ~diff_ref & ~mrev & mate_crosses
    c4 = base & ~munmap & ~diff_ref & mrev & mate_crosses
    zero = torch.zeros_like(ov)
    vals = torch.stack([torch.where(c4, ov, zero),
                        torch.where(c1 | c2_exp | c3 | c4, ov, zero),
                        (c1 | c2 | c3 | c4).long()])
    # segment sums of the contiguous job runs: exclusive prefix at the
    # run ends minus the prefix at the run starts
    csum = torch.nn.functional.pad(torch.cumsum(vals, dim=1), (1, 0))
    return csum[:, ends] - csum[:, starts]


def count_resident(cols, jobs_t, rows: int) -> torch.Tensor:
    """Count one chunk on the columns' device.

    cols: (pos, end_pos, mate_pos int32, bits uint8) (N,) resident rows;
    jobs_t: (9, J) int32 rows starts, ends, lo, s1, s2, t, max_insert,
    seq_len, no_mult — job jj covers chunk slots [starts, ends), which
    map to resident rows lo + (slot - starts); rows: slots in the chunk.
    Returns (3, J) int64: good_reads, exp_reads, num_reads."""
    pos_c, end_c, mate_c, bits_c = cols
    starts, ends, lo, s1, s2, t, max_insert, seq_len, no_mult = (
        jobs_t.long())
    J = starts.shape[0]
    slot = torch.arange(rows, dtype=torch.int64, device=jobs_t.device)
    job = torch.clamp(torch.searchsorted(ends, slot, right=True), 0, J - 1)
    st = starts[job]
    in_job = (slot >= st) & (slot < ends[job])
    row = torch.clamp(lo[job] + (slot - st), 0, pos_c.shape[0] - 1)
    bits = bits_c[row].long()
    return _job_sums(
        starts, ends, in_job, pos_c[row].long(), end_c[row].long(),
        mate_c[row].long(), (bits & _B_PAIRED) != 0, (bits & _B_REV) == 0,
        (bits & _B_MUNMAP) != 0, (bits & _B_MREV) != 0,
        (no_mult[job] != 0) | ((bits & _B_UNIQ) != 0),
        (bits & _B_GOODQ) != 0, (bits & _B_DIFFREF) != 0,
        s1[job], s2[job], t[job], max_insert[job], seq_len[job])


def count_payload(rows: dict, jobs_t: torch.Tensor) -> torch.Tensor:
    """Count one chunk of row-payload jobs on the tensors' device.

    rows: _ROW_FIELDS -> (R,) tensors of the jobs' rows back to back, at
    their wire widths (flag, nh uint16; xt, goodq uint8; the rest int32);
    jobs_t: (8, J) int32 rows starts, ends, s1, s2, t, max_insert,
    seq_len, no_mult — job jj owns rows [starts, ends).  Returns (3, J)
    int64: good_reads, exp_reads, num_reads."""
    starts, ends, s1, s2, t, max_insert, seq_len, no_mult = jobs_t.long()
    job = torch.repeat_interleave(
        torch.arange(starts.shape[0], device=jobs_t.device), ends - starts,
        output_size=rows["pos"].shape[0])
    flag = rows["flag"].long()
    # every row belongs to a job: in_job is all true
    return _job_sums(
        starts, ends, True, rows["pos"].long(),
        rows["end_pos"].long(), rows["mate_pos"].long(),
        (flag & FPAIRED) != 0, (flag & FREVERSE) == 0,
        (flag & FMUNMAP) != 0, (flag & FMREVERSE) != 0,
        (no_mult[job] != 0) | ((rows["nh"].long() == 1)
                               & (rows["xt"].long() == XT_U)),
        rows["goodq"] != 0, rows["ref_id"] != rows["mate_ref"],
        s1[job], s2[job], t[job], max_insert[job], seq_len[job])


def _chunks(lens: list[int], weights: list[int], host_count, results: list
            ) -> list[list[int]]:
    """Split the jobs at job boundaries so each chunk stays under ROW_CAP
    rows and OV_CAP summed read lengths; a job that alone exceeds OV_CAP
    is counted on the host (host_count(k)) into results instead."""
    chunks: list[list[int]] = []
    chunk: list[int] = []
    chunk_rows = chunk_w = 0
    for k, n in enumerate(lens):
        if weights[k] > OV_CAP:
            results[k] = host_count(k)
            continue
        if chunk and (chunk_rows + n > ROW_CAP
                      or chunk_w + weights[k] > OV_CAP):
            chunks.append(chunk)
            chunk, chunk_rows, chunk_w = [], 0, 0
        chunk.append(k)
        chunk_rows += n
        chunk_w += weights[k]
    if chunk:
        chunks.append(chunk)
    return chunks


def _finisher(pending: list, results: list):
    def _finish():
        for idxs, res in pending:
            r = res.cpu().numpy()
            for jj, k in enumerate(idxs):
                results[k] = (int(r[0, jj]), int(r[1, jj]), int(r[2, jj]))
        return results

    return _finish


def _count_jobs_payload(jobs: list[dict], dev: torch.device):
    """Queue every chunk of row-payload jobs on `dev`; returns the
    finisher."""
    lens = [len(j["pos"]) for j in jobs]
    # worst-case cumsum contribution per job = summed read lengths
    # (ov <= rl); used to split chunks before the sums could overflow
    weights = [
        int(np.clip(np.asarray(j["end_pos"], np.int64)
                    - np.asarray(j["pos"], np.int64), 0, None).sum())
        for j in jobs]
    results: list = [None] * len(jobs)
    chunks = _chunks(lens, weights, lambda k: _count_job_host(jobs[k]),
                     results)
    pending: list[tuple[list[int], torch.Tensor]] = []
    for idxs in chunks:
        rows = {}
        for f in _ROW_FIELDS:
            parts = [np.asarray(jobs[k][f]) for k in idxs]
            if f == "nh":
                # uint16 wire width: clip so oversized NH tags cannot
                # wrap onto the ==1 uniqueness test
                parts = [np.clip(v, 0, 65535) for v in parts]
            rows[f] = np.concatenate(parts).astype(
                _ROW_DTYPES.get(f, np.int32))
        jt = np.zeros((8, len(idxs)), np.int32)
        jt[1] = np.cumsum([lens[k] for k in idxs])
        jt[0, 1:] = jt[1, :-1]
        for f, name in enumerate(_SCA_FIELDS):
            jt[2 + f] = [jobs[k][name] for k in idxs]
        WIRE["bytes_up"] += jt.nbytes + sum(v.nbytes for v in rows.values())
        WIRE["dispatches"] += 1
        res = count_payload(
            {f: torch.from_numpy(v).to(dev) for f, v in rows.items()},
            torch.from_numpy(jt).to(dev))
        pending.append((idxs, res))
    return _finisher(pending, results)


def count_jobs(jobs: list[dict], device: torch.device, defer: bool = False):
    """Counts (good_reads, exp_reads, num_reads) of each job, in order, on
    `device`.  A job is a resident range (a dict with _mb, lib, lo, hi)
    or a row payload (a dict of _ROW_FIELDS row arrays), with the
    scalars s1, s2, t, max_insert, seq_len, no_mult; every job of one
    call has the same form.  defer=True queues every chunk on the device
    and returns a zero-argument finisher that fetches the results."""
    if not jobs:
        return (lambda: []) if defer else []
    dev = torch.device(device)
    if "_mb" not in jobs[0]:
        fin = _count_jobs_payload(jobs, dev)
        return fin if defer else fin()

    # coalesce the jobs' row ranges per table: only the union of touched
    # rows is uploaded
    ranges: dict[int, list[tuple[int, int]]] = {}
    cols_of: dict[int, tuple] = {}
    for j in jobs:
        tb = j["_mb"].files[j["lib"]].table
        if id(tb) not in cols_of:
            cols_of[id(tb)] = _host_cols(j["_mb"], j["lib"])
            ranges[id(tb)] = []
        if j["hi"] > j["lo"]:
            ranges[id(tb)].append((j["lo"], j["hi"]))

    runs: dict[int, list[tuple[int, int, int]]] = {}  # (lo, hi, base)
    total = 0
    for tid, rs_ in ranges.items():
        out = []
        for lo, hi in sorted(rs_):
            if out and lo <= out[-1][1]:
                if hi > out[-1][1]:
                    total += hi - out[-1][1]
                    out[-1] = (out[-1][0], hi, out[-1][2])
            else:
                out.append((lo, hi, total))
                total += hi - lo
        runs[tid] = out

    def arena_base(tid: int, lo: int) -> int:
        rr = runs[tid]
        k = bisect.bisect_right(rr, (lo, 1 << 62, 0)) - 1
        r_lo, _r_hi, r_base = rr[k]
        return r_base + (lo - r_lo)

    lens = [j["hi"] - j["lo"] for j in jobs]
    weights, abs_lo = [], []
    for j in jobs:
        tid = id(j["_mb"].files[j["lib"]].table)
        rlp = cols_of[tid][4]
        weights.append(int(rlp[j["hi"]] - rlp[j["lo"]]))
        abs_lo.append(arena_base(tid, j["lo"]) if j["hi"] > j["lo"] else 0)

    results: list = [None] * len(jobs)
    chunks = _chunks(
        lens, weights,
        lambda k: _count_job_host(_materialize_resident(jobs[k])), results)

    pending: list[tuple[list[int], torch.Tensor]] = []
    if chunks:
        n_rows = max(total, 1)
        cols = []
        for k in range(4):
            buf = np.zeros(n_rows, np.uint8 if k == 3 else np.int32)
            for tid, rr in runs.items():
                col = cols_of[tid][k]
                for lo, hi, bs in rr:
                    buf[bs:bs + hi - lo] = col[lo:hi]
            WIRE["arena_bytes_up"] += buf.nbytes
            cols.append(torch.from_numpy(buf).to(dev))

        for idxs in chunks:
            jt = np.zeros((9, len(idxs)), np.int32)
            off = 0
            for jj, k in enumerate(idxs):
                jt[0, jj] = off
                off += lens[k]
                jt[1, jj] = off
                jt[2, jj] = abs_lo[k]
                for f, name in enumerate(_SCA_FIELDS):
                    jt[3 + f, jj] = jobs[k][name]
            WIRE["bytes_up"] += jt.nbytes
            WIRE["dispatches"] += 1
            res = count_resident(cols, torch.from_numpy(jt).to(dev),
                                 max(off, 1))
            pending.append((idxs, res))

    fin = _finisher(pending, results)
    return fin if defer else fin()
