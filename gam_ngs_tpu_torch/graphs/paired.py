"""Bipartite contig-pair graphs and block partitioning.

Replicates, over BlockTable rows:
  * PairedContigGraph vertex numbering — master contig ids sorted first,
    then slave contig ids (PairedGraph.code.hpp:136-171);
  * PairingEvidencesGraph edge weights = #blocks per (master, slave)
    contig pair, and getSingleLinkBlocks
    (lib/src/graphs/PairingEvidencesGraph.cc:40/:99);
  * partitionBlocksByPairedContigs — connected components, components
    numbered in order of lowest vertex, block lists in original order
    (lib/src/PartitionFunctions.cc:262).

All boost graphs in the reference use setS out-edge storage: neighbor
iteration is sorted by target vertex id and there are no parallel edges.
"""

from __future__ import annotations

import numpy as np

from ..io.blocks_io import BlockTable


class PairedContigGraph:
    """Undirected bipartite graph over the contigs touched by `rows`."""

    def __init__(self, blocks: BlockTable, rows: list[int] | None = None):
        if rows is None:
            rows = list(range(len(blocks)))
        self.rows = rows
        m_ids = sorted({int(blocks.m_ctg[r]) for r in rows})
        s_ids = sorted({int(blocks.s_ctg[r]) for r in rows})
        self.master_map = {c: i for i, c in enumerate(m_ids)}
        self.first_slave_vertex = len(m_ids)
        self.slave_map = {c: i + len(m_ids) for i, c in enumerate(s_ids)}
        self.vertex_to_ctg = m_ids + s_ids
        self.n = len(m_ids) + len(s_ids)
        self.adj: list[set[int]] = [set() for _ in range(self.n)]
        for r in rows:
            u = self.master_map[int(blocks.m_ctg[r])]
            v = self.slave_map[int(blocks.s_ctg[r])]
            self.adj[u].add(v)
            self.adj[v].add(u)

    def neighbors(self, v: int) -> list[int]:
        return sorted(self.adj[v])

    def degree(self, v: int) -> int:
        return len(self.adj[v])

    def write_graphviz(self, fh) -> None:
        """PairedContigGraph::writeGraphviz (PairedGraph.code.hpp:176):
        vertex labels are contig ids; each undirected edge prints once
        with its master endpoint as source (edges are inserted
        (master, slave) and boost's edge iterator yields first
        encounters in vertex order, out-edges sorted by target)."""
        fh.write("graph AssemblyGraph {\n")
        for v in range(self.n):
            fh.write(f"\t{v}[label=\"{self.vertex_to_ctg[v]}\"];\n")
        for u in range(self.first_slave_vertex):
            for w in sorted(self.adj[u]):
                fh.write(f"\t{u}--{w}[color=black];\n")
        fh.write("}\n")

    def connected_components(self) -> tuple[np.ndarray, int]:
        comp = np.full(self.n, -1, np.int64)
        c = 0
        for v0 in range(self.n):
            if comp[v0] != -1:
                continue
            stack = [v0]
            comp[v0] = c
            while stack:
                u = stack.pop()
                for w in self.adj[u]:
                    if comp[w] == -1:
                        comp[w] = c
                        stack.append(w)
            c += 1
        return comp, c


def get_single_link_blocks(blocks: BlockTable) -> set[tuple[int, int]]:
    """(master, slave) pairs where either endpoint has degree 1."""
    g = PairedContigGraph(blocks)
    out = set()
    for r in range(len(blocks)):
        mv = g.master_map[int(blocks.m_ctg[r])]
        sv = g.slave_map[int(blocks.s_ctg[r])]
        if g.degree(mv) == 1 or g.degree(sv) == 1:
            out.add((int(blocks.m_ctg[r]), int(blocks.s_ctg[r])))
    return out


def pairing_edge_weights(blocks: BlockTable) -> dict[tuple[int, int], int]:
    """#blocks per contig pair (PairingEvidencesGraph::addEdgeWeights)."""
    w: dict[tuple[int, int], int] = {}
    for r in range(len(blocks)):
        key = (int(blocks.m_ctg[r]), int(blocks.s_ctg[r]))
        w[key] = w.get(key, 0) + 1
    return w


def partition_blocks_by_paired_contigs(blocks: BlockTable) -> list[list[int]]:
    """Connected-component partition; returns lists of block row indices."""
    g = PairedContigGraph(blocks)
    comp, num = g.connected_components()
    parts: list[list[int]] = [[] for _ in range(num)]
    for r in range(len(blocks)):
        v = g.master_map[int(blocks.m_ctg[r])]
        parts[comp[v]].append(r)
    return parts
