"""Fork solving over the compact assembly graph.

Reference: PctgBuilder::solveForks
(lib/src/pctg/PctgBuilder.cc:891-1292).  Three passes:
  1. putative repeats (in>=2 and out>=2): vertex invalidated, bypassed
     with reconstructed master and slave edges carrying the min weights;
  2. bifurcations (in==2 or out==2) with both weights >= 0: a weight gap
     >= 0.8 marks the weaker side as mis-assembled — the corresponding
     edge is removed and the facing tails are forbidden;
  3. after a bubble check (bubbles abort the graph), remaining
     bifurcations are cut conservatively, preferring master continuity.

Vertex/edge iteration follows boost setS order (sorted ids).
"""

from __future__ import annotations

from ..graphs.assembly import MASTER_EDGE, SLAVE_EDGE
from ..graphs.compact import CompactAssemblyGraph
from ..io.blocks_io import BlockTable
from .mergeblock import MergeBlock


def _vertex_starts(blocks: BlockTable, rows: list[int]) -> tuple[int, int]:
    rf, rl = rows[0], rows[-1]
    m = min(int(blocks.m_begin[rf]), int(blocks.m_begin[rl]))
    s = min(int(blocks.s_begin[rf]), int(blocks.s_begin[rl]))
    return m, s


def solve_forks(graph: CompactAssemblyGraph, debug: bool = False,
                log=None) -> tuple[bool, list[MergeBlock]]:
    """Returns (ok, merge-block vector).  ok=False aborts the graph."""
    blocks = graph.blocks
    mbv = []
    for v in range(graph.n):
        rows = graph.vertex_rows[v]
        mb = MergeBlock(vertex=v, m_id=int(blocks.m_ctg[rows[0]]),
                        s_id=int(blocks.s_ctg[rows[0]]), valid=True)
        mbv.append(mb)

    # ---- pass 1: putative repeats ----
    for v in range(graph.n):
        if graph.in_degree(v) >= 2 and graph.out_degree(v) >= 2:
            mbv[v].valid = False
            mv1 = sv1 = mv2 = sv2 = None
            mw = 1.0
            sw = 1.0
            for u in graph.in_neighbors(v):
                prop = graph.prop[(u, v)]
                if prop["kind"] == MASTER_EDGE:
                    mv1 = u
                    mw = min(prop["weight"], mw)
                else:
                    sv1 = u
                    sw = min(prop["weight"], sw)
            for u in list(graph.in_neighbors(v)):
                graph.remove_edge(u, v)
            for w in graph.out_neighbors(v):
                prop = graph.prop[(v, w)]
                if prop["kind"] == MASTER_EDGE:
                    mv2 = w
                    mw = min(prop["weight"], mw)
                else:
                    sv2 = w
                    sw = min(prop["weight"], sw)
            for w in list(graph.out_neighbors(v)):
                graph.remove_edge(v, w)

            if mv1 is not None and mv2 is not None:
                graph.add_edge(mv1, mv2, dict(kind=MASTER_EDGE, weight=mw,
                                              rnum=0, min_cov=False))
                graph.prop[(mv1, mv2)] = dict(kind=MASTER_EDGE, weight=mw,
                                              rnum=0, min_cov=False)
            if sv1 is not None and sv2 is not None:
                graph.add_edge(sv1, sv2, dict(kind=SLAVE_EDGE, weight=sw,
                                              rnum=0, min_cov=False))
                graph.prop[(sv1, sv2)] = dict(kind=SLAVE_EDGE, weight=sw,
                                              rnum=0, min_cov=False)

    # ---- pass 2: bifurcations decided by weight difference ----
    for v in range(graph.n):
        rows = graph.vertex_rows[v]
        master_start, slave_start = _vertex_starts(blocks, rows)
        in_deg, out_deg = graph.in_degree(v), graph.out_degree(v)
        if in_deg < 2 and out_deg < 2:
            continue

        if in_deg == 2:
            mv = sv = None
            mw = sw = 0.0
            for u in graph.in_neighbors(v):
                prop = graph.prop[(u, v)]
                if prop["kind"] == MASTER_EDGE:
                    mv, mw = u, prop["weight"]
                else:
                    sv, sw = u, prop["weight"]
            if mv is not None and sv is not None and mw >= 0 and sw >= 0:
                w_diff = abs(mw - sw)
                fork_type = None
                if w_diff >= 0.8:
                    fork_type = "MIS_SLAVE" if mw >= sw else "MIS_MASTER"
                if fork_type is not None:
                    nm, _ = _vertex_starts(blocks, graph.vertex_rows[mv])
                    _, ns = _vertex_starts(blocks, graph.vertex_rows[sv])
                    shared_first_m = master_start <= nm
                    shared_first_s = slave_start <= ns
                    if fork_type == "MIS_MASTER":
                        if log:
                            log(f"[debug] Found MASTER mis-assembly in ctg "
                                f"{mbv[v].m_id} mw={mw} sw={sw} w_diff={w_diff}")
                        if shared_first_m:
                            mbv[v].m_rtail = False
                            mbv[mv].m_ltail = False
                        else:
                            mbv[v].m_ltail = False
                            mbv[mv].m_rtail = False
                        graph.remove_edge(mv, v)
                    else:
                        if log:
                            log(f"[debug] Found SLAVE mis-assembly in ctg "
                                f"{mbv[v].s_id} mw={mw} sw={sw} w_diff={w_diff}")
                        if shared_first_s:
                            mbv[v].s_rtail = False
                            mbv[sv].s_ltail = False
                        else:
                            mbv[v].s_ltail = False
                            mbv[sv].s_rtail = False
                        graph.remove_edge(sv, v)

        if out_deg == 2:
            mv = sv = None
            mw = sw = 0.0
            for w in graph.out_neighbors(v):
                prop = graph.prop[(v, w)]
                if prop["kind"] == MASTER_EDGE:
                    mv, mw = w, prop["weight"]
                else:
                    sv, sw = w, prop["weight"]
            if mv is not None and sv is not None and mw >= 0 and sw >= 0:
                w_diff = abs(mw - sw)
                fork_type = None
                if w_diff >= 0.8:
                    fork_type = "MIS_SLAVE" if mw >= sw else "MIS_MASTER"
                if fork_type is not None:
                    nm, _ = _vertex_starts(blocks, graph.vertex_rows[mv])
                    _, ns = _vertex_starts(blocks, graph.vertex_rows[sv])
                    shared_first_m = master_start <= nm
                    shared_first_s = slave_start <= ns
                    if fork_type == "MIS_MASTER":
                        if debug and log:
                            log(f"[debug] Found MASTER misassembly in ctg "
                                f"{mbv[v].m_id} mw={mw} sw={sw} w_diff={w_diff}")
                        if shared_first_m:
                            mbv[v].m_rtail = False
                            mbv[mv].m_ltail = False
                        else:
                            mbv[v].m_ltail = False
                            mbv[mv].m_rtail = False
                        graph.remove_edge(v, mv)
                    else:
                        if debug and log:
                            log(f"[debug] Found SLAVE misassembly in ctg "
                                f"{mbv[v].s_id} mw={mw} sw={sw} w_diff={w_diff}")
                        if shared_first_s:
                            mbv[v].s_rtail = False
                            mbv[sv].s_ltail = False
                        else:
                            mbv[v].s_ltail = False
                            mbv[sv].s_rtail = False
                        graph.remove_edge(v, sv)

    # ---- bubbles abort the merge of this graph ----
    if graph.has_bubbles():
        return False, mbv

    # ---- pass 3: unsolvable bifurcations ----
    for v in range(graph.n):
        rows = graph.vertex_rows[v]
        master_start, slave_start = _vertex_starts(blocks, rows)
        in_deg, out_deg = graph.in_degree(v), graph.out_degree(v)
        if in_deg < 2 and out_deg < 2:
            continue

        if in_deg == 2:
            outs = graph.out_neighbors(v)
            ov = outs[0] if outs else None
            mv = sv = None
            for u in graph.in_neighbors(v):
                prop = graph.prop[(u, v)]
                if prop["kind"] == MASTER_EDGE:
                    mv = u
                else:
                    sv = u
            if sv is None:  # malformed fork (UB in the reference); skip
                continue
            _, ns = _vertex_starts(blocks, graph.vertex_rows[sv])
            shared_first_s = slave_start <= ns
            if ov is not None:
                okind = graph.prop[(v, ov)]["kind"]
                if okind == MASTER_EDGE:
                    mbv[v].valid = False
                    if shared_first_s:
                        mbv[sv].s_ltail = False
                    else:
                        mbv[sv].s_rtail = False
                    graph.remove_edge(sv, v)
                else:
                    mbv[v].valid = False
                    if shared_first_s:
                        mbv[sv].s_ltail = False
                        mbv[ov].s_rtail = False
                    else:
                        mbv[sv].s_rtail = False
                        mbv[ov].s_ltail = False
                    if mv is not None:
                        graph.remove_edge(mv, v)
                    graph.remove_edge(sv, v)
            else:
                mbv[v].valid = False
                if shared_first_s:
                    mbv[sv].s_ltail = False
                else:
                    mbv[sv].s_rtail = False
                graph.remove_edge(sv, v)

        if out_deg == 2:
            ins = graph.in_neighbors(v)
            ov = ins[0] if ins else None
            mv = sv = None
            for w in graph.out_neighbors(v):
                prop = graph.prop[(v, w)]
                if prop["kind"] == MASTER_EDGE:
                    mv = w
                else:
                    sv = w
            if sv is None:  # malformed fork (UB in the reference); skip
                continue
            _, ns = _vertex_starts(blocks, graph.vertex_rows[sv])
            shared_first_s = slave_start <= ns
            if ov is not None:
                okind = graph.prop[(ov, v)]["kind"]
                if okind == MASTER_EDGE:
                    mbv[v].valid = False
                    if shared_first_s:
                        mbv[sv].s_ltail = False
                    else:
                        mbv[sv].s_rtail = False
                    graph.remove_edge(v, sv)
                else:
                    mbv[v].valid = False
                    if shared_first_s:
                        mbv[sv].s_ltail = False
                        mbv[ov].s_rtail = False
                    else:
                        mbv[sv].s_rtail = False
                        mbv[ov].s_ltail = False
                    if mv is not None:
                        graph.remove_edge(v, mv)
                    graph.remove_edge(v, sv)
            else:
                mbv[v].valid = False
                if shared_first_s:
                    mbv[sv].s_ltail = False
                else:
                    mbv[sv].s_rtail = False
                graph.remove_edge(v, sv)

    return True, mbv
