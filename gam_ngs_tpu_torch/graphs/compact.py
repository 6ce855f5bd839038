"""CompactAssemblyGraph — BOTH-edge chains collapsed + read-evidence weights.

Replicates lib/src/graphs/CompactAssemblyGraph.cc:
  * initGraphDFS_NR (:74): iterative stack DFS from each in-degree-0 root
    (vertex order); BOTH edges merge the target block into the source's
    compact vertex; re-encountered edges overwrite the edge property;
  * computeEdgeWeights (:284) / getRegionScore (:327) /
    getLibRegionScore (:361): per-edge windowed pair-orientation counting
    over the PE (and optional MP) libraries.  Reference quirks preserved:
      - `cov[lib]` is only ever set false (:501) → min_cov is always False;
      - the -2/-3 sentinels are overwritten to -4 by the final
        aggregation loop (:517-530); only -1 (frame containment) survives;
      - with a missing MP reader the mp_* values are uninitialized in
        C++ (REAL UB, confirmed against the compiled reference: the
        stack residue there is a tiny positive denormal + huge rnum,
        which hijacks the arbitration whenever pe_rnum < 10 or
        pe_weight < 0 and flips the safe-edge path split,
        PctgBuilder.cc:1328 — see PARITY.md).  We define the case
        deterministically as (weight=-4, rnum=0, min_cov=False); the
        ref-merge differential supplies an MP library so the
        reference's behavior is well-defined when byte-comparing.

The per-edge region counting is exposed both as the exact scalar loop and
as a batched numpy evaluation over all edges (device-friendly shape).
"""

from __future__ import annotations

import numpy as np

from ..core.multibam import MultiBam
from ..io.bam import FPAIRED, FMUNMAP, FREVERSE, FMREVERSE
from ..io.blocks_io import BlockTable
from .assembly import AssemblyGraph, DiGraph, MASTER_EDGE, SLAVE_EDGE, BOTH_EDGE


class CompactAssemblyGraph(DiGraph):
    def __init__(self, ag: AssemblyGraph):
        self.cg_id = ag.ag_id
        self.blocks = ag.blocks
        # block row lists per compact vertex
        self.vertex_rows: list[list[int]] = []
        n_ag = ag.n
        visited = [False] * n_ag
        ag2cg = [0] * n_ag
        edges: list[tuple[int, int, dict]] = []

        count = 0
        for r in range(n_ag):
            if ag.in_degree(r) == 0 and not visited[r]:
                count = self._dfs_nr(ag, r, visited, ag2cg, edges, count)

        super().__init__(count)
        for u, v, prop in edges:
            if not self.add_edge(u, v, dict(prop)):
                # re-add overwrites the property (boost put on existing edge)
                self.prop[(u, v)] = dict(prop)

    def _dfs_nr(self, ag: AssemblyGraph, root: int, visited, ag2cg, edges,
                count: int) -> int:
        new_v = count
        count += 1
        self.vertex_rows.append([ag.rows[root]])
        visited[root] = True
        ag2cg[root] = new_v

        cur_stack: list[int] = []
        pre_stack: list[int] = []
        for z in ag.out_neighbors(root):
            cur_stack.append(z)
            pre_stack.append(root)

        while cur_stack:
            curr = cur_stack.pop()
            prev = pre_stack.pop()
            prop = ag.prop[(prev, curr)]
            if visited[curr]:
                edges.append((ag2cg[prev], ag2cg[curr], prop))
                continue
            visited[curr] = True
            if prop["kind"] == BOTH_EDGE:
                self.vertex_rows[ag2cg[prev]].append(ag.rows[curr])
                ag2cg[curr] = ag2cg[prev]
            else:
                new_v = count
                count += 1
                ag2cg[curr] = new_v
                self.vertex_rows.append([ag.rows[curr]])
                edges.append((ag2cg[prev], ag2cg[curr], prop))
            for z in ag.out_neighbors(curr):
                cur_stack.append(z)
                pre_stack.append(curr)
        return count

    # ------------------------------------------------------------------
    def compute_edge_weights(self, master_pe: MultiBam, master_mp: MultiBam | None,
                             slave_pe: MultiBam, slave_mp: MultiBam | None,
                             no_mult_filter: bool = False,
                             batched: bool = True) -> None:
        """computeEdgeWeights (CompactAssemblyGraph.cc:284).

        batched=True counts every (edge, library) region in one device
        pass per shape bucket (ops.region_score); batched=False is the
        sequential per-edge oracle.  Results are identical.
        """
        if not batched:
            for (u, v) in self.edges():
                prop = self.prop[(u, v)]
                kind = prop["kind"]
                if kind == MASTER_EDGE:
                    w, r, mc = _region_score(
                        master_pe, master_mp, kind, self.blocks,
                        self.vertex_rows[u], self.vertex_rows[v],
                        no_mult_filter)
                elif kind == SLAVE_EDGE:
                    w, r, mc = _region_score(
                        slave_pe, slave_mp, kind, self.blocks,
                        self.vertex_rows[u], self.vertex_rows[v],
                        no_mult_filter)
                else:
                    w, r, mc = 0.0, 0, False
                prop["weight"], prop["rnum"], prop["min_cov"] = w, r, mc
            return

        from ..ops import region_score as region_ops

        jobs = self.prepare_edge_weights(master_pe, master_mp, slave_pe,
                                         slave_mp, no_mult_filter)
        self.apply_edge_weights(region_ops.count_jobs(jobs))

    def prepare_edge_weights(self, master_pe, master_mp, slave_pe,
                             slave_mp, no_mult_filter=False) -> list[dict]:
        """Plan every (edge, library) counting job without touching the
        device; returns the job list (indices local to this graph).
        partition_blocks concatenates the jobs of all graphs into one
        region_score.count_jobs dispatch and hands each graph its slice
        via apply_edge_weights."""
        jobs: list[dict] = []
        plans: list[tuple] = []

        def plan_for(mb, kind, rows_u, rows_v):
            if mb is None or mb.size == 0:
                return ("const", (-4.0, 0, False))
            plan = _prepare_lib_jobs(mb, kind, self.blocks, rows_u,
                                     rows_v, no_mult_filter)
            if plan[0] == "libs":
                entries = []
                for e in plan[1]:
                    if e[0] == "job":
                        jobs.append(e[1])
                        entries.append(("job", len(jobs) - 1))
                    else:
                        entries.append(e)
                plan = ("libs", entries)
            return plan

        for (u, v) in self.edges():
            prop = self.prop[(u, v)]
            kind = prop["kind"]
            if kind == MASTER_EDGE:
                pe_mb, mp_mb = master_pe, master_mp
            elif kind == SLAVE_EDGE:
                pe_mb, mp_mb = slave_pe, slave_mp
            else:
                plans.append((prop, None, None))
                continue
            ru, rv = self.vertex_rows[u], self.vertex_rows[v]
            plans.append((prop, plan_for(pe_mb, kind, ru, rv),
                          plan_for(mp_mb, kind, ru, rv)))

        self._weight_plans = plans
        return jobs

    def apply_edge_weights(self, results: list) -> None:
        """Resolve the plans from prepare_edge_weights against the
        counting results (list indexed by this graph's job ids)."""

        def resolve(plan):
            if plan[0] == "const":
                return plan[1]
            score, r_num = [], []
            for e in plan[1]:
                if e[0] == "const":
                    score.append(e[1])
                    r_num.append(0)
                else:
                    good, exp, num = results[e[1]]
                    if num < 10 or exp == 0:
                        score.append(-5.0)
                        r_num.append(0)
                    else:
                        score.append(good / float(exp))
                        r_num.append(num)
            w, r = score[0], r_num[0]
            for i in range(1, len(score)):
                if r_num[i] > r:
                    w, r = score[i], r_num[i]
            return (w, r, False)

        for prop, pe_plan, mp_plan in self._weight_plans:
            if pe_plan is None:
                prop["weight"], prop["rnum"], prop["min_cov"] = 0.0, 0, False
                continue
            w, r, mc = _combine_pe_mp(resolve(pe_plan), resolve(mp_plan))
            prop["weight"], prop["rnum"], prop["min_cov"] = w, r, mc
        del self._weight_plans

    def has_bubbles(self) -> bool:
        return DiGraph.has_bubbles(self)


def _frames(blocks: BlockTable, rows: list[int], kind: int):
    """(first, last) frame begin/end/ctg on the edge's side."""
    rf, rl = rows[0], rows[-1]
    if kind == MASTER_EDGE:
        return (int(blocks.m_ctg[rf]),
                int(blocks.m_begin[rf]), int(blocks.m_end[rf]),
                int(blocks.m_begin[rl]), int(blocks.m_end[rl]))
    return (int(blocks.s_ctg[rf]),
            int(blocks.s_begin[rf]), int(blocks.s_end[rf]),
            int(blocks.s_begin[rl]), int(blocks.s_end[rl]))


def _combine_pe_mp(pe_t: tuple, mp_t: tuple) -> tuple[float, int, bool]:
    """PE/MP arbitration (getRegionScore tail, :341-358)."""
    pe_w, pe_r, pe_c = pe_t
    mp_w, mp_r, mp_c = mp_t
    min_cov = pe_c or mp_c
    if pe_r >= 10 and mp_r < 10:
        return pe_w, pe_r, min_cov
    if mp_r >= 10 and pe_r < 10:
        return mp_w, mp_r, min_cov
    if pe_r < 10 and mp_r < 10:
        return -5.0, 0, min_cov
    if pe_w >= 0 and mp_w < 0:
        return pe_w, pe_r, min_cov
    if mp_w >= 0 and pe_w < 0:
        return mp_w, mp_r, min_cov
    if pe_w < 0 and mp_w < 0:
        return -10.0, 0, min_cov
    if pe_w > mp_w:
        return pe_w, pe_r, min_cov
    return mp_w, mp_r, min_cov


def _region_score(pe: MultiBam, mp: MultiBam | None, kind: int,
                  blocks: BlockTable, rows1: list[int], rows2: list[int],
                  no_mult_filter: bool) -> tuple[float, int, bool]:
    """getRegionScore (CompactAssemblyGraph.cc:327)."""
    pe_t = _lib_region_score(pe, kind, blocks, rows1, rows2,
                             no_mult_filter)
    if mp is not None and mp.size > 0:
        mp_t = _lib_region_score(mp, kind, blocks, rows1, rows2,
                                 no_mult_filter)
    else:
        mp_t = (-4.0, 0, False)
    return _combine_pe_mp(pe_t, mp_t)


def _prepare_lib_jobs(mb: MultiBam, kind: int, blocks: BlockTable,
                      rows1: list[int], rows2: list[int],
                      no_mult_filter: bool):
    """Plan getLibRegionScore for batched counting: returns
    ('const', (w, r, mc)) for whole-library sentinels, or
    ('libs', [('const', score) | ('job', job-dict), ...]) with one entry
    per library, mirroring the sequential loop exactly."""
    if kind not in (MASTER_EDGE, SLAVE_EDGE):
        return ("const", (-4.0, 0, False))
    if len(rows1) == 0 or len(rows2) == 0:
        return ("const", (-4.0, 0, False))

    ctg1, f1b, f1e, l1b, l1e = _frames(blocks, rows1, kind)
    _ctg2, f2b, f2e, l2b, l2e = _frames(blocks, rows2, kind)
    r1_beg, r1_end = min(f1b, l1b), max(f1e, l1e)
    r2_beg, r2_end = min(f2b, l2b), max(f2e, l2e)

    if (r1_beg <= r2_beg and r1_end >= r2_end) or \
       (r2_beg <= r1_beg and r2_end >= r1_end):
        return ("const", (-1.0, 0, False))

    gap = (r2_beg - r1_end + 1) if r1_beg <= r2_beg else (r1_beg - r2_end + 1)
    seq_len = mb.ref_lengths[ctg1]

    entries: list = []
    for lib in range(mb.size):
        isize_mean = int(mb.isize_mean[lib])
        isize_std = int(mb.isize_std[lib])
        min_insert = isize_mean - 3 * isize_std
        max_insert = isize_mean + 3 * isize_std
        if min_insert < 0:
            min_insert = 0

        if r1_beg <= r2_beg:
            t = r2_beg if gap >= 0 else r1_end
            s2 = r1_end if gap >= 0 else r2_beg
        else:
            t = r1_beg if gap >= 0 else r2_end
            s2 = r2_end if gap >= 0 else r1_beg
        s1 = max(t - max_insert, 0)

        if (seq_len - s1 < max_insert or gap >= max_insert or s2 < s1):
            entries.append(("const", -4.0))
            continue

        from ..ops import region_score as region_ops

        if region_ops.use_resident():
            # range job against the device-resident arena: rows with
            # pos < s1 (only ever reachable via the end-overlap clause
            # of region_rows) fail the kernel's s1 gate and are
            # excluded from the range outright — identical counts,
            # ~32 B/job on the wire instead of ~26 B/row
            a, b = mb.region_range(lib, ctg1, s1, s2 + 1)
            entries.append(("job", dict(
                _mb=mb, lib=lib, lo=a, hi=b,
                s1=s1, s2=s2, t=t, max_insert=max_insert,
                seq_len=seq_len, no_mult=int(no_mult_filter))))
            continue
        rows = mb.region_rows(lib, ctg1, s1, s2 + 1)
        tb = mb.files[lib].table
        entries.append(("job", dict(
            pos=tb.pos[rows].astype(np.int32),
            end_pos=tb.end_pos[rows].astype(np.int32),
            flag=tb.flag[rows].astype(np.int32),
            nh=tb.nh[rows].astype(np.int32),
            xt=tb.xt[rows].astype(np.int32),
            ref_id=tb.ref_id[rows].astype(np.int32),
            mate_ref=tb.mate_ref_id[rows].astype(np.int32),
            mate_pos=tb.mate_pos[rows].astype(np.int32),
            goodq=tb.is_good_quality()[rows].astype(np.int32),
            s1=s1, s2=s2, t=t, max_insert=max_insert,
            seq_len=seq_len, no_mult=int(no_mult_filter))))
    return ("libs", entries)


def _lib_region_score(mb: MultiBam, kind: int, blocks: BlockTable,
                      rows1: list[int], rows2: list[int],
                      no_mult_filter: bool) -> tuple[float, int, bool]:
    """getLibRegionScore (CompactAssemblyGraph.cc:361)."""
    if kind not in (MASTER_EDGE, SLAVE_EDGE):
        return -4.0, 0, False
    if len(rows1) == 0 or len(rows2) == 0:
        return -4.0, 0, False

    ctg1, f1b, f1e, l1b, l1e = _frames(blocks, rows1, kind)
    _ctg2, f2b, f2e, l2b, l2e = _frames(blocks, rows2, kind)

    r1_beg, r1_end = min(f1b, l1b), max(f1e, l1e)
    r2_beg, r2_end = min(f2b, l2b), max(f2e, l2e)

    if (r1_beg <= r2_beg and r1_end >= r2_end) or \
       (r2_beg <= r1_beg and r2_end >= r1_end):
        return -1.0, 0, False

    gap = (r2_beg - r1_end + 1) if r1_beg <= r2_beg else (r1_beg - r2_end + 1)

    n_libs = mb.size
    score = [-4.0] * n_libs
    r_num = [0] * n_libs
    # cov[lib] stays False forever (reference bug at :501 kept on purpose)

    seq_len = mb.ref_lengths[ctg1]

    for lib in range(n_libs):
        isize_mean = int(mb.isize_mean[lib])
        isize_std = int(mb.isize_std[lib])
        min_insert = isize_mean - 3 * isize_std
        max_insert = isize_mean + 3 * isize_std
        if min_insert < 0:
            min_insert = 0

        if r1_beg <= r2_beg:
            t = r2_beg if gap >= 0 else r1_end
            s2 = r1_end if gap >= 0 else r2_beg
        else:
            t = r1_beg if gap >= 0 else r2_end
            s2 = r2_end if gap >= 0 else r1_beg
        s1 = max(t - max_insert, 0)

        if seq_len - s1 < max_insert:
            continue
        if gap >= max_insert or s2 < s1:
            continue

        rows = mb.region_rows(lib, ctg1, s1, s2 + 1)
        t_tab = mb.files[lib].table
        good = t_tab.is_good_quality()

        good_reads = 0
        exp_reads = 0
        num_reads = 0
        for i in rows.tolist():
            if not good[i]:
                continue
            start_read = int(t_tab.pos[i])
            read_length = int(t_tab.end_pos[i]) - start_read
            end_read = start_read + read_length - 1
            flag = int(t_tab.flag[i])
            if not (flag & FPAIRED):
                continue
            if not no_mult_filter and not (
                    t_tab.nh[i] == 1 and t_tab.xt[i] == ord("U")):
                continue
            start_mate = int(t_tab.mate_pos[i])
            end_mate = start_mate + read_length - 1
            if start_read < s1 or start_read > s2:
                continue
            if not (flag & FREVERSE):
                max_insert_pos = start_read + max_insert
                read_overlap = s2 - start_read + 1 if end_read > s2 else read_length
                if flag & FMUNMAP:
                    exp_reads += read_overlap
                    num_reads += 1
                    continue
                if t_tab.ref_id[i] != t_tab.mate_ref_id[i]:
                    if max_insert_pos < seq_len:
                        exp_reads += read_overlap
                    num_reads += 1
                    continue
                if not (flag & FMREVERSE) and end_mate >= t:
                    exp_reads += read_overlap
                    num_reads += 1
                if (flag & FMREVERSE) and end_mate >= t:
                    good_reads += read_overlap
                    exp_reads += read_overlap
                    num_reads += 1

        if num_reads < 10 or exp_reads == 0:
            score[lib] = -5.0
            r_num[lib] = 0
        else:
            score[lib] = good_reads / float(exp_reads)
            r_num[lib] = num_reads

    weight, rnum, min_cov = score[0], r_num[0], False
    for i in range(1, n_libs):
        if r_num[i] > rnum:
            weight, rnum = score[i], r_num[i]
    return weight, rnum, min_cov
