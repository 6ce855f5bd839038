"""Block partitioning driver with the port's edge counter.

gam_ngs_tpu/graphs/partition.py::partition_blocks
(PartitionFunctions.cc:65-170): partition the blocks by contig pairs,
build and classify the assembly / compact graphs (cyclic ones dropped),
then weight every compact-graph edge, all graphs in one process or each
process its own share (shard=).  Only the edge counter differs: with
torch devices (one, or the engine's several: the JAX mesh=) the jobs of
the graphs go to ops.region_score in one call; with devices=None they
are counted on the host
(CompactAssemblyGraph.compute_edge_weights(batched=False)).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from ..ops import region_score
from ..parallel.distributed import allgather_obj, shard_partitions
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
                     devices,
                     no_mult_filter: bool = False,
                     output_graphs: bool = False,
                     graphs_dir: str = "./gam_graphs",
                     defer_weights: bool = False,
                     shard: tuple[int, int] | None = None,
                     _allgather=None):
    """Returns (kept compact graphs, GraphStats), plus a zero-argument
    finisher that applies the edge weights when defer_weights is set (the
    count is then only queued on the device).

    shard=(pid, nproc) enables the multi-process path: graph build and
    classification stay replicated (cheap, blocks-only), but each process
    decodes ONLY the BAM contig runs its owned graphs touch (deferred
    MultiBams + .gidx ranged decode), prepares and counts only its own
    edge-weight jobs, and one allgather of final edge props makes every
    process's graphs identical to the sequential run.  Ownership uses the
    same deterministic LPT assignment as distributed_build_pctgs, so the
    rows decoded here are exactly the rows the build phase needs.
    `_allgather` overrides the collective (tests)."""
    pid, nproc = shard if shard else (0, 1)
    is_writer = pid == 0
    parts = partition_blocks_by_paired_contigs(blocks)

    # the reference writes the per-component contig graphs whenever the
    # directory exists, with or without --output-graphs
    if is_writer and os.path.isdir(graphs_dir):
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
    kept_idx: list[int] = []  # indices into `built` of non-cyclic graphs
    for ag_id, rows in enumerate(parts, start=1):
        ag = AssemblyGraph(blocks, rows, ag_id)
        cg = CompactAssemblyGraph(ag)
        try:
            ag.topological_sort_throwing()
            kept_idx.append(len(built))
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

    # ---- ownership + sharded ingestion ----
    if shard and nproc > 1:
        mine_kept = shard_partitions([g.n for g in out], nproc, pid)
        owned_set = {kept_idx[k] for k in mine_kept}
        # cyclic graphs (not built later, but their weights appear in
        # host 0's dot dumps) go round-robin
        cyc = sorted(set(range(len(built))) - set(kept_idx))
        owned_set.update(i for k, i in enumerate(cyc) if k % nproc == pid)
        owned = sorted(owned_set)
        m_ctgs: set[int] = set()
        s_ctgs: set[int] = set()
        for i in owned:
            m_ctgs.update(int(blocks.m_ctg[r]) for r in parts[i])
            s_ctgs.update(int(blocks.s_ctg[r]) for r in parts[i])
        for mb, ctgs in ((master_pe, m_ctgs), (master_mp, m_ctgs),
                         (slave_pe, s_ctgs), (slave_mp, s_ctgs)):
            if mb is not None:
                mb.load_ref_runs(_ctg_runs(ctgs))
    else:
        owned = list(range(len(built)))

    fetch = None
    spans: list[tuple[int, int]] = []
    if devices is None:
        for i in owned:
            built[i][1].compute_edge_weights(master_pe, master_mp, slave_pe,
                                             slave_mp, no_mult_filter,
                                             batched=False)
    else:
        all_jobs: list[dict] = []
        for i in owned:
            jobs = built[i][1].prepare_edge_weights(
                master_pe, master_mp, slave_pe, slave_mp, no_mult_filter)
            spans.append((len(all_jobs), len(all_jobs) + len(jobs)))
            all_jobs.extend(jobs)
        # queued now, fetched by the finisher: the caller overlaps the
        # device count with host work (run_merge loads the FASTAs)
        fetch = region_score.count_jobs(all_jobs, devices, defer=True)

    def finish_weights():
        if fetch is not None:
            results = fetch()
            for i, (lo, hi) in zip(owned, spans):
                built[i][1].apply_edge_weights(results[lo:hi])
        if shard and nproc > 1:
            # one allgather of final edge props fills non-owned graphs
            ag_fn = _allgather or allgather_obj
            local_props = {
                i: [(p["weight"], p["rnum"], p["min_cov"])
                    for p in (built[i][1].prop[e]
                              for e in built[i][1].edges())]
                for i in owned}
            for part in ag_fn(local_props):
                for i, props in part.items():
                    if i in local_props:
                        continue
                    cg = built[i][1]
                    for e, (w, r, mc) in zip(cg.edges(), props):
                        cg.prop[e]["weight"] = w
                        cg.prop[e]["rnum"] = r
                        cg.prop[e]["min_cov"] = mc
        if is_writer and output_graphs and os.path.isdir(graphs_dir):
            for gid, (ag, cg, suffix) in enumerate(built, start=1):
                _write_dot(ag, cg, graphs_dir, gid, suffix)

    if defer_weights:
        return out, stats, finish_weights
    finish_weights()
    return out, stats


def _ctg_runs(ctgs: set[int]) -> list[tuple[int, int]]:
    """Ascending disjoint [lo, hi) runs of consecutive contig ids."""
    if not ctgs:
        return []
    ids = sorted(ctgs)
    runs = [[ids[0], ids[0] + 1]]
    for c in ids[1:]:
        if c == runs[-1][1]:
            runs[-1][1] = c + 1
        else:
            runs.append([c, c + 1])
    return [(lo, hi) for lo, hi in runs]


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
