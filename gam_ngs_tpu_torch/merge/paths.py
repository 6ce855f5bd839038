"""Merge-path extraction over the fork-solved compact graph.

Reference: PctgBuilder::getMergePaths
(lib/src/pctg/PctgBuilder.cc:1294-1358).  Walks each
linear chain from a root collecting valid MergeBlocks; a low-weight
"safe" slave edge (0 <= w < 0.3, or w < 0 with min_cov — the latter never
fires since min_cov is always false) splits the path as a linear slave
mis-assembly and trims the facing slave tails.
"""

from __future__ import annotations

from ..graphs.assembly import SLAVE_EDGE
from ..graphs.compact import CompactAssemblyGraph
from .mergeblock import MergeBlock


def get_merge_paths(graph: CompactAssemblyGraph, root: int,
                    mbv: list[MergeBlock],
                    merge_paths: list[list[MergeBlock]],
                    debug: bool = False, log=None) -> bool:
    v = root
    while True:
        if graph.out_degree(v) >= 2 or graph.in_degree(v) >= 2:
            if log:
                log("[error] Found vertex with degree >= 2 in fork-solved "
                    f"graph (this should NOT happen!) ==> "
                    f"({mbv[v].m_id},{mbv[v].s_id})")
            return False

        if mbv[v].valid:
            # C++ copies the struct into the list: a later safe-edge trim of
            # THIS vertex's tails does not reach the pushed copy
            merge_paths[0].append(mbv[v].copy())

        if graph.out_degree(v) == 0:
            return True

        v_nxt = graph.out_neighbors(v)[0]
        prop = graph.prop[(v, v_nxt)]
        weight = prop["weight"]
        safe_edge = (0 <= weight < 0.3) or (weight < 0 and prop["min_cov"])

        if mbv[v_nxt].valid and prop["kind"] == SLAVE_EDGE and safe_edge:
            blocks = graph.blocks
            cur_rows = graph.vertex_rows[v]
            nxt_rows = graph.vertex_rows[v_nxt]
            cur_s = min(int(blocks.s_begin[cur_rows[0]]),
                        int(blocks.s_begin[cur_rows[-1]]))
            nxt_s = min(int(blocks.s_begin[nxt_rows[0]]),
                        int(blocks.s_begin[nxt_rows[-1]]))
            if debug and log:
                log(f"[debug] Found (linear) SLAVE mis-assembly in ctg "
                    f"{mbv[v].s_id}")
            if cur_s <= nxt_s:
                mbv[v].s_rtail = False
                mbv[v_nxt].s_ltail = False
            else:
                mbv[v].s_ltail = False
                mbv[v_nxt].s_rtail = False
            merge_paths.insert(0, [])

        v = v_nxt
