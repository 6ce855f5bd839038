"""AssemblyGraph — the directed block-order graph of one partition.

Replicates lib/src/graphs/AssemblyGraph.cc: one vertex per
block (in partition order); edges connect a block to its predecessor /
successor in the per-contig coordinate ordering, flipped when the contig's
inferred strand is '-' (a '?' strand adds no edges); a slave edge between
the endpoints of an existing master edge upgrades it to BOTH.

Edge storage mirrors boost setS/bidirectionalS: no parallel edges,
out-/in-neighbor iteration sorted by target/source vertex id.
"""

from __future__ import annotations

import numpy as np

from ..io.blocks_io import BlockTable
from .strand import compute_relative_strand_map, strand_char

MASTER_EDGE, SLAVE_EDGE, BOTH_EDGE = 0, 1, 2


class NotADag(Exception):
    pass


class DiGraph:
    """setS/bidirectional adjacency: sorted neighbor sets, edge props."""

    def __init__(self, n: int):
        self.n = n
        self.out: list[set[int]] = [set() for _ in range(n)]
        self.inn: list[set[int]] = [set() for _ in range(n)]
        self.prop: dict[tuple[int, int], dict] = {}

    def add_edge(self, u: int, v: int, prop: dict) -> bool:
        """Returns True if the edge was new; existing edges keep their
        property (callers overwrite explicitly when replicating put())."""
        if v in self.out[u]:
            return False
        self.out[u].add(v)
        self.inn[v].add(u)
        self.prop[(u, v)] = prop
        return True

    def remove_edge(self, u: int, v: int) -> None:
        if v in self.out[u]:
            self.out[u].discard(v)
            self.inn[v].discard(u)
            self.prop.pop((u, v), None)

    def out_neighbors(self, v: int) -> list[int]:
        return sorted(self.out[v])

    def in_neighbors(self, v: int) -> list[int]:
        return sorted(self.inn[v])

    def out_degree(self, v: int) -> int:
        return len(self.out[v])

    def in_degree(self, v: int) -> int:
        return len(self.inn[v])

    def edges(self) -> list[tuple[int, int]]:
        """boost edge iteration: by source vertex, then sorted targets."""
        return [(u, v) for u in range(self.n) for v in self.out_neighbors(u)]

    def roots(self) -> list[int]:
        return [v for v in range(self.n) if self.in_degree(v) == 0]

    # ---- cycle / bubble classification ----
    def topological_sort_throwing(self) -> list[int]:
        """DFS toposort over roots, raising NotADag on a back edge
        (AssemblyGraph::agTopologicalSort :396 / boost::topological_sort)."""
        colors = [0] * self.n
        order: list[int] = []

        def visit(v: int):
            colors[v] = 1
            for u in self.out_neighbors(v):
                if colors[u] == 0:
                    visit(u)
                elif colors[u] == 1:
                    raise NotADag()
            colors[v] = 2
            order.append(v)

        # boost::topological_sort runs DFS over ALL vertices
        import sys
        sys.setrecursionlimit(max(sys.getrecursionlimit(), 10000 + 10 * self.n))
        for v in range(self.n):
            if colors[v] == 0:
                visit(v)
        return order

    def has_forks(self) -> bool:
        return any(self.in_degree(v) > 1 or self.out_degree(v) > 1
                   for v in range(self.n))

    def has_bubbles(self) -> bool:
        """DFS from each root; reaching a finished vertex again = bubble
        (AssemblyGraph::hasBubbles :454).  Raises NotADag on cycles."""
        found = False

        def dfs(v: int, colors: list[int]):
            nonlocal found
            colors[v] = 1
            for u in self.out_neighbors(v):
                if colors[u] == 0:
                    dfs(u, colors)
                elif colors[u] == 2:
                    found = True
                elif colors[u] == 1:
                    raise NotADag()
            colors[v] = 2

        import sys
        sys.setrecursionlimit(max(sys.getrecursionlimit(), 10000 + 10 * self.n))
        for r in self.roots():
            colors = [0] * self.n
            dfs(r, colors)
        return found


def _ordered_indices(blocks: BlockTable, rows: list[int], side: str
                     ) -> tuple[list[int], list[int]]:
    """getOrderedIndices (OrderingFunctions.hpp:135): (index, backIndex)
    over local positions 0..len(rows)-1, ordered by (ctg, begin, -len)."""
    if side == "m":
        ctg = blocks.m_ctg
        beg = blocks.m_begin
        length = blocks.m_length()
    else:
        ctg = blocks.s_ctg
        beg = blocks.s_begin
        length = blocks.s_length()
    r = np.array(rows)
    order = np.lexsort((-length[r], beg[r], ctg[r]))
    index = [int(i) for i in order]
    back = [0] * len(rows)
    for k, i in enumerate(index):
        back[i] = k
    return index, back


class AssemblyGraph(DiGraph):
    def __init__(self, blocks: BlockTable, rows: list[int], ag_id: int = 0):
        super().__init__(len(rows))
        self.blocks = blocks
        self.rows = list(rows)
        self.ag_id = ag_id

        m_strand, s_strand = compute_relative_strand_map(blocks, rows)
        idx_m, back_m = _ordered_indices(blocks, rows, "m")
        idx_s, back_s = _ordered_indices(blocks, rows, "s")

        for i in range(len(rows)):
            self._add_side_edges(i, m_strand, idx_m, back_m, "m")
        for i in range(len(rows)):
            self._add_side_edges(i, s_strand, idx_s, back_s, "s")

    def _add_side_edges(self, vertex: int, strand_map: dict, index, back,
                        side: str):
        blocks, rows = self.blocks, self.rows
        ctg = int((blocks.m_ctg if side == "m" else blocks.s_ctg)[rows[vertex]])
        idx = back[vertex]
        nxt = index[idx + 1] if idx + 1 < len(index) else vertex
        prv = index[idx - 1] if idx > 0 else vertex
        ch = strand_char(strand_map[ctg])
        if ch == "?":
            return
        if ch == "-":
            nxt, prv = prv, nxt
        if nxt != vertex:
            self._add_single_edge(vertex, nxt, side)
        if prv != vertex:
            self._add_single_edge(prv, vertex, side)

    def _add_single_edge(self, s: int, t: int, side: str):
        blocks, rows = self.blocks, self.rows
        col = blocks.m_ctg if side == "m" else blocks.s_ctg
        if int(col[rows[s]]) != int(col[rows[t]]):
            return
        if side == "m":
            self.add_edge(s, t, dict(kind=MASTER_EDGE, weight=0.0, rnum=0,
                                     min_cov=False))
        else:
            if not self.add_edge(s, t, dict(kind=SLAVE_EDGE, weight=0.0,
                                            rnum=0, min_cov=False)):
                p = self.prop[(s, t)]
                if p["kind"] == MASTER_EDGE:
                    p["kind"] = BOTH_EDGE
