"""Relative-strand inference over the contig-pair graph.

Replicates RelativeStrandEvidencesGraph
(lib/src/strand_fixer/RelativeStrand.cc): per-pair
positive/negative read evidence, then an exhaustive acyclic-path DFS from
vertex 0 composing orientation probabilities
(p' = p*p_edge+ + (1-p)*p_edge-), capped at MAX_PTP_LIST_SIZE paths per
vertex; each vertex's probability is the evidence-weighted average over
the collected (min-evidence-along-path, prob) pairs.  Quirks preserved:
  * the running min-evidence accumulator leaks across sibling edges in
    the DFS loop (extendPathFrom :113 mutates the by-value parameter);
  * paths are push_front'ed, so the final sum runs newest-first;
  * probability 0.5 ⇒ strand '?' (StrandProbability.cc:98).
"""

from __future__ import annotations

from ..io.blocks_io import BlockTable
from .paired import PairedContigGraph

MAX_PTP_LIST_SIZE = 100


def strand_char(prob: float) -> str:
    if prob < 0.5:
        return "-"
    if prob > 0.5:
        return "+"
    return "?"


def compute_relative_strand_map(blocks: BlockTable, rows: list[int]
                                ) -> tuple[dict[int, float], dict[int, float]]:
    """(master ctg -> P(forward), slave ctg -> P(forward)) for one partition."""
    g = PairedContigGraph(blocks, rows)

    # edge evidences per (vertex u, vertex v) unordered pair
    pos: dict[tuple[int, int], int] = {}
    neg: dict[tuple[int, int], int] = {}
    for r in rows:
        u = g.master_map[int(blocks.m_ctg[r])]
        v = g.slave_map[int(blocks.s_ctg[r])]
        key = (u, v)
        pos.setdefault(key, 0)
        neg.setdefault(key, 0)
        if blocks.m_strand[r] == blocks.s_strand[r]:
            pos[key] += int(blocks.num_reads[r])
        else:
            neg[key] += int(blocks.num_reads[r])

    def edge(u: int, v: int) -> tuple[int, int]:
        return (u, v) if (u, v) in pos else (v, u)

    master_out: dict[int, float] = {}
    slave_out: dict[int, float] = {}

    if g.n == 0:
        return master_out, slave_out

    if g.n == 1:
        if 0 < g.first_slave_vertex:
            master_out[g.vertex_to_ctg[0]] = 1.0
        else:
            slave_out[g.vertex_to_ctg[0]] = 1.0
        return master_out, slave_out

    # path enumeration from vertex 0
    path_lists: dict[int, list[tuple[int, float]]] = {}
    color = [0] * g.n  # 0 white, 1 grey

    def compose(p: float, key) -> float:
        e = pos[key] + neg[key]
        p_pos = pos[key] / e
        p_neg = neg[key] / e
        return p * p_pos + (1 - p) * p_neg

    def extend_from(node: int, path_prob: float, min_evid: int):
        """Iterative DFS with an explicit frame stack — semantically the
        recursive extendPathFrom (RelativeStrand.cc:87) including the
        sibling min-evidence leak (frame[2] persists across siblings),
        but immune to C-stack exhaustion on path-shaped partitions
        (recursion-limit raises do not grow the interpreter's native
        stack; a 10k-vertex chain would otherwise crash)."""
        # frame = [node, path_prob, min_evid, neighbor-iterator]
        color[node] = 1
        stack = [[node, path_prob, min_evid, iter(g.neighbors(node))]]
        while stack:
            fr = stack[-1]
            nd, pp = fr[0], fr[1]
            descended = False
            for v in fr[3]:
                if color[v] != 0:
                    continue
                key = edge(nd, v)
                new_prob = compose(pp, key)
                fr[2] = min(fr[2], pos[key] + neg[key])  # sibling leak
                lst = path_lists.setdefault(v, [])
                if len(lst) < MAX_PTP_LIST_SIZE:
                    lst.insert(0, (fr[2], new_prob))
                    color[v] = 1
                    stack.append([v, new_prob, fr[2], iter(g.neighbors(v))])
                    descended = True
                    break
            if not descended:
                color[nd] = 0
                stack.pop()

    root = 0
    path_lists[root] = [(1, 1.0)]
    color[root] = 1
    for v in g.neighbors(root):
        if color[v] == 0:
            key = edge(root, v)
            new_prob = compose(1.0, key)
            evid = pos[key] + neg[key]
            path_lists.setdefault(v, []).insert(0, (evid, new_prob))
            extend_from(v, new_prob, evid)
    color[root] = 0

    for node, lst in path_lists.items():
        vertex_prob = 0.0
        tot_evid = 0
        for evid, prob in lst:
            vertex_prob += prob * float(evid)
            tot_evid += evid
        vertex_prob = vertex_prob / float(tot_evid)
        # StrandProbability clamps to [0,1]
        vertex_prob = min(1.0, max(0.0, vertex_prob))
        if node < g.first_slave_vertex:
            master_out[g.vertex_to_ctg[node]] = vertex_prob
        else:
            slave_out[g.vertex_to_ctg[node]] = vertex_prob

    return master_out, slave_out
