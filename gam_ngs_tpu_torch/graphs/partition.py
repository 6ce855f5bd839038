"""Block partitioning driver with the port's edge counter.

gam_ngs_tpu/graphs/partition.py::partition_blocks, single process
(PartitionFunctions.cc:65-170): partition the blocks by contig pairs,
build and classify the assembly / compact graphs (cyclic ones dropped),
then weight every compact-graph edge.  Only the edge counter differs:
with a torch device the jobs of all graphs go to ops.region_score in
one call; with device=None they are counted on the host
(CompactAssemblyGraph.compute_edge_weights(batched=False)).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from ..ops import region_score
from ..utils.cppfmt import cpp_double
from .assembly import AssemblyGraph, NotADag
from .compact import CompactAssemblyGraph
from .paired import PairedContigGraph, partition_blocks_by_paired_contigs


@dataclass
class GraphStats:
    linears: int = 0
    forks: int = 0
    bubbles: int = 0
    cyclics: int = 0

    def stats_text(self) -> str:
        """The `.stats` block ([graphs stats], PartitionFunctions.cc:162)."""
        return (f"[graphs stats]\nLinears = {self.linears}\n"
                f"Forks = {self.forks}\nBubbles = {self.bubbles}\n"
                f"Cyclics = {self.cyclics}\n\n")


def partition_blocks(blocks, master_pe, master_mp, slave_pe, slave_mp,
                     device: torch.device | None,
                     no_mult_filter: bool = False,
                     output_graphs: bool = False,
                     graphs_dir: str = "./gam_graphs",
                     defer_weights: bool = False):
    """Returns (kept compact graphs, GraphStats), plus a zero-argument
    finisher that applies the edge weights when defer_weights is set (the
    count is then only queued on the device)."""
    parts = partition_blocks_by_paired_contigs(blocks)

    # the reference writes the per-component contig graphs whenever the
    # directory exists, with or without --output-graphs
    if os.path.isdir(graphs_dir):
        for i, rows in enumerate(parts):
            try:
                with open(os.path.join(graphs_dir,
                                       f"ContigGraph_{i}.dot"), "w") as fh:
                    PairedContigGraph(blocks, rows).write_graphviz(fh)
            except OSError:
                pass

    stats = GraphStats()
    out: list[CompactAssemblyGraph] = []
    built: list[tuple] = []  # (ag, cg, suffix)
    for ag_id, rows in enumerate(parts, start=1):
        ag = AssemblyGraph(blocks, rows, ag_id)
        cg = CompactAssemblyGraph(ag)
        try:
            ag.topological_sort_throwing()
            out.append(cg)
            if ag.has_bubbles():
                stats.bubbles += 1
                suffix = "bubbles"
            elif ag.has_forks():
                stats.forks += 1
                suffix = "forks"
            else:
                stats.linears += 1
                suffix = "linear"
        except NotADag:
            stats.cyclics += 1
            suffix = "cyclic"
        built.append((ag, cg, suffix))

    fetch = None
    spans: list[tuple[int, int]] = []
    if device is None:
        for _ag, cg, _s in built:
            cg.compute_edge_weights(master_pe, master_mp, slave_pe,
                                    slave_mp, no_mult_filter, batched=False)
    else:
        all_jobs: list[dict] = []
        for _ag, cg, _s in built:
            jobs = cg.prepare_edge_weights(master_pe, master_mp, slave_pe,
                                           slave_mp, no_mult_filter)
            spans.append((len(all_jobs), len(all_jobs) + len(jobs)))
            all_jobs.extend(jobs)
        # queued now, fetched by the finisher: the caller overlaps the
        # device count with host work (run_merge loads the FASTAs)
        fetch = region_score.count_jobs(all_jobs, device, defer=True)

    def finish_weights():
        if fetch is not None:
            results = fetch()
            for (_ag, cg, _s), (lo, hi) in zip(built, spans):
                cg.apply_edge_weights(results[lo:hi])
        if output_graphs and os.path.isdir(graphs_dir):
            for gid, (ag, cg, suffix) in enumerate(built, start=1):
                _write_dot(ag, cg, graphs_dir, gid, suffix)

    if defer_weights:
        return out, stats, finish_weights
    finish_weights()
    return out, stats


def _write_dot(ag: AssemblyGraph, cg: CompactAssemblyGraph, graphs_dir: str,
               ag_id: int, suffix: str) -> None:
    kinds = {0: "black", 1: "red", 2: "green"}
    p1 = os.path.join(graphs_dir, f"AssemblyGraph_{ag_id}_{suffix}.dot")
    if not os.path.exists(p1):
        with open(p1, "w") as fh:
            fh.write("digraph AssemblyGraph {\n   rankdir=LR;\n")
            for v in range(ag.n):
                fh.write(f"   {v};\n")
            for (u, v) in ag.edges():
                prop = ag.prop[(u, v)]
                fh.write(f"   {u}->{v}[color={kinds[prop['kind']]}, "
                         f"label=\"{cpp_double(prop['weight'])}\"];\n")
            fh.write("}\n")
    p2 = os.path.join(graphs_dir, f"CompactGraph_{ag_id}_{suffix}.dot")
    if not os.path.exists(p2):
        with open(p2, "w") as fh:
            fh.write("digraph CompactAssemblyGraph {\n   rankdir=LR;\n")
            for v in range(cg.n):
                fh.write(f"   {v};\n")
            for (u, v) in cg.edges():
                prop = cg.prop[(u, v)]
                fh.write(f"   {u}->{v}[color={kinds[prop['kind']]}, "
                         f"label=\"{cpp_double(prop['weight'])}/{prop['rnum']}\"];\n")
            fh.write("}\n")
