"""Per-graph merge pipeline + single-contig pctg generation.

Reference: buildPctg (lib/src/pctg/BuildPctgFunctions.cc:41)
and generateSingleCtgPctgs (:111).  Processing order is the reference's
sequential (--threads 1) order, which is the canonical output order.

The pipeline is split into three phases so the batched device scheduler
can interleave graphs: prepare (fork solving + merge paths, host-only),
align (per-vertex banded-SW chains — sequential here, lockstep-batched
across all graphs in build_pctgs_batched), and finish (split/sort
passes + weaving, host-only).  build_pctg composes the three phases
sequentially and is behaviourally identical to the reference's
single-thread buildPctg.
"""

from __future__ import annotations

import os

from ..core.multibam import MultiBam
from ..core.refseq import RefSequence
from ..graphs.compact import CompactAssemblyGraph
from ..ops.bsw_ref import bsw_align
from .align import align_merge_block
from .forks import solve_forks
from .paths import get_merge_paths
from .pctg import CtgInPctg, PairedContig
from .scheduler import align_merge_blocks_batched
from .weave import (
    PctgWeaver,
    split_merge_blocks_by_align,
    split_merge_blocks_by_direction,
    split_merge_blocks_by_inclusions,
    sort_merge_blocks_by_direction,
)


def prepare_pctg(graph: CompactAssemblyGraph, debug: bool = False,
                 log=None) -> list[list] | None:
    """Fork solving + merge-path extraction; None if the graph is
    unmergeable (bubbles left after solveForks)."""
    ok, mbv = solve_forks(graph, debug, log)
    if not ok:
        return None

    roots = [v for v in range(graph.n) if graph.in_degree(v) == 0]
    merge_lists: list[list] = []
    while roots:
        rv = roots.pop()
        merge_lists.insert(0, [])
        get_merge_paths(graph, rv, mbv, merge_lists, debug, log)
    return merge_lists


def finish_pctg(graph: CompactAssemblyGraph, merge_lists: list[list],
                master_ref: RefSequence, slave_ref: RefSequence,
                master_bam: MultiBam | None, slave_bam: MultiBam | None,
                pctg_list: list[PairedContig],
                no_mult_filter: bool = False) -> None:
    merge_lists = split_merge_blocks_by_align(merge_lists)
    merge_lists = split_merge_blocks_by_direction(merge_lists)
    sort_merge_blocks_by_direction(merge_lists)
    merge_lists = split_merge_blocks_by_inclusions(merge_lists, master_ref,
                                                   slave_ref)

    weaver = PctgWeaver(master_ref, slave_ref, master_bam, slave_bam,
                        no_mult_filter)
    for ml in merge_lists:
        if len(ml) == 0:
            continue
        weaver.build_pctgs(pctg_list, ml)


def build_pctg(graph: CompactAssemblyGraph, master_ref: RefSequence,
               slave_ref: RefSequence, master_bam: MultiBam | None,
               slave_bam: MultiBam | None, pctg_list: list[PairedContig],
               aligner=bsw_align, no_mult_filter: bool = False,
               debug: bool = False, log=None) -> None:
    merge_lists = prepare_pctg(graph, debug, log)
    if merge_lists is None:
        return

    for ml in merge_lists:
        for mb in ml:
            align_merge_block(graph, mb, master_ref, slave_ref, aligner)

    finish_pctg(graph, merge_lists, master_ref, slave_ref, master_bam,
                slave_bam, pctg_list, no_mult_filter)


def build_pctgs_batched(graphs, master_ref: RefSequence,
                        slave_ref: RefSequence,
                        master_bam: MultiBam | None,
                        slave_bam: MultiBam | None,
                        pctg_list: list[PairedContig], engine,
                        no_mult_filter: bool = False, debug: bool = False,
                        log=None, progress=None,
                        ckpt_dir: str | None = None,
                        per_graph_out: dict | None = None) -> None:
    """All-graph build with the alignment phase lockstep-batched on the
    device engine.  Output order and content match the sequential loop
    exactly; a graph whose alignment raises is skipped with the
    reference's per-graph error message (ThreadedBuildPctg.cc:326).

    per_graph_out (optional dict) receives cg_id -> list of this
    graph's contributed contigs (the distribution layer uses it to
    splice shards back in canonical order).

    ckpt_dir enables partition-level resume: each finished graph's
    paired contigs are pickled to <ckpt_dir>/graph_<cgid>.pkl, and
    graphs that already have a checkpoint skip fork solving, alignment
    and weaving entirely — the checkpointed contigs are spliced back in
    canonical graph order, so resumed output is byte-identical.
    """
    import pickle

    dbg_log = log if debug else None

    def ckpt_path(g):
        return (os.path.join(ckpt_dir, f"graph_{g.cg_id}.pkl")
                if ckpt_dir else None)

    if ckpt_dir:
        os.makedirs(ckpt_dir, exist_ok=True)

    CKPT = "ckpt"
    prepared: list[tuple] = []  # (graph, merge_lists|None|CKPT, exc|None)
    for g in graphs:
        if g.n == 0:
            continue
        path = ckpt_path(g)
        if path and os.path.exists(path):
            prepared.append((g, CKPT, None))
            continue
        try:
            prepared.append((g, prepare_pctg(g, debug, dbg_log), None))
        except Exception as exc:  # noqa: BLE001 — per-graph isolation
            prepared.append((g, None, exc))

    jobs = []
    owner: list[int] = []  # job index -> prepared index
    for pi, (g, mls, exc) in enumerate(prepared):
        if mls is None or mls is CKPT:
            continue
        for ml in mls:
            for mb in ml:
                jobs.append((g, mb, master_ref, slave_ref))
                owner.append(pi)

    _rounds, errors = align_merge_blocks_batched(jobs, engine)
    failed: dict[int, Exception] = {}
    for job_idx, exc in errors.items():
        failed.setdefault(owner[job_idx], exc)

    done = 0
    tot = sum(g.n for g, _, _ in prepared)
    last_perc = 0
    for pi, (g, mls, exc) in enumerate(prepared):
        exc = exc or failed.get(pi)
        if mls is CKPT:
            with open(ckpt_path(g), "rb") as fh:
                contrib = pickle.load(fh)
            pctg_list.extend(contrib)
            if per_graph_out is not None:
                per_graph_out[g.cg_id] = list(contrib)
        elif exc is not None and log is not None:
            log(f"Something unexpected happened processing graph "
                f"{g.cg_id}: {exc!r}")
        elif mls is not None and exc is None:
            try:
                n0 = len(pctg_list)
                finish_pctg(g, mls, master_ref, slave_ref, master_bam,
                            slave_bam, pctg_list, no_mult_filter)
                if per_graph_out is not None:
                    per_graph_out[g.cg_id] = list(pctg_list[n0:])
                path = ckpt_path(g)
                if path:
                    with open(path + ".tmp", "wb") as fh:
                        pickle.dump(pctg_list[n0:], fh)
                    os.replace(path + ".tmp", path)
            except Exception as fin_exc:  # noqa: BLE001
                if log is not None:
                    log(f"Something unexpected happened processing graph "
                        f"{g.cg_id}: {fin_exc!r}")
        done += g.n
        if progress is not None and tot:
            perc = int(100 * done / tot)
            if perc > last_perc and perc % 5 == 0:
                progress(perc)
                last_perc = perc


def generate_single_ctg_pctgs(pctg_list: list[PairedContig],
                              ctg_ids: list[int], master_ref: RefSequence,
                              next_id: int) -> int:
    """Wrap unmerged master contigs as single-contig pctgs (:111)."""
    for cid in ctg_ids:
        seq = master_ref[cid].seq
        if seq is None or len(seq) == 0:
            continue
        p = PairedContig(pctg_id=next_id)
        p.master_ids.add(cid)
        p.parts.append(seq)
        p.merge_list.append(CtgInPctg(cid, 0, len(seq) - 1, False, True))
        pctg_list.append(p)
        next_id += 1
    return next_id
