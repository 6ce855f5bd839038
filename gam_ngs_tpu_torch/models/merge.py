"""gam merge — assembly reconciliation pipeline on a torch device.

gam_ngs_tpu/models/merge.py::run_merge (Merge::execute, Merge.cc:90),
in one process or, under a torch.distributed process group, sharded by
graph partition over the group (parallel.distributed; host 0 writes
every output).  With an engine (ops.bsw_engine.BswEngine) the two device
stages run on the engine's torch devices (one, or several in one
process): the partition edge count (ops.region_score) and the banded-SW
align stage (the CUDA kernels on a GPU).  Under GAM_ARENA=1 both
assemblies are registered with the engine's sequence arena once the
sequences are loaded (opt-in, as in the JAX package).  engine=None is
the oracle path: bsw_ref.bsw_align and host edge weights.  Outputs are
those of the JAX package, byte for byte:
  <prefix>.gam.fasta, .pctgs, .stats, .noblocks.BF.fasta,
  .noblocks.AF.fasta, .notmerged.fasta, .metrics.json (the same keys,
  and the count of engine devices),
  and <bam-list>.isize when missing.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core import blocks as blocks_mod
from ..core.multibam import MultiBam
from ..core.refseq import RefSequence
from ..graphs import paired
from ..graphs.partition import partition_blocks
from ..io import blocks_io
from ..io.fasta import format_record
from ..merge.builder import (
    build_pctg,
    build_pctgs_batched,
    generate_single_ctg_pctgs,
)
from ..merge.pctg import write_pctg_descriptors
from ..ops import region_score
from ..ops.bsw_ref import bsw_align
from ..parallel.distributed import (
    allgather_obj,
    distributed_build_pctgs,
    proc_info,
)
from ..utils.metrics import Metrics
from ..utils.misc import format_time, path_basename


@dataclass
class MergeOptions:
    master_bam_file: str = ""
    slave_bam_file: str = ""
    master_mp_bam_file: str = ""
    slave_mp_bam_file: str = ""
    blocks_file: str = ""
    master_fasta_file: str = ""
    slave_fasta_file: str = ""
    min_block_size: int = 5
    threads_num: int = 1
    coverage_threshold: float = 0.75
    no_multiplicity_filter: bool = False
    output_file_prefix: str = "out"
    output_graphs: bool = False
    debug: bool = False
    engine: object = None   # BswEngine; None = the host oracle path
    checkpoint: bool = False  # partition-level resume via <prefix>.ckpt/


def _open_with_stats(bam_list: str, isize_file: str, tag: str,
                     log) -> MultiBam:
    pid, nproc = proc_info()
    if nproc > 1:
        # Distributed: open DEFERRED (headers only) — the partition
        # phase later decodes just the contig runs this host's graphs
        # touch (.gidx ranged decode).  Host 0 alone computes/loads +
        # writes stats, then the file-codec round-tripped (%.6g)
        # values are allgathered so every host builds edge weights /
        # z-scores / int(mean±3std) cutoffs from IDENTICAL numbers — a
        # non-writer recomputing full-precision stats (or racing host
        # 0's write on a shared filesystem) would silently diverge the
        # sharded pctg build.
        mb = MultiBam.open_deferred(bam_list)
        stats = None
        if pid == 0:
            if not os.path.exists(isize_file):
                log(f"[bam] Computing statistics of {tag}")
                mb.load_all()  # stats need the full stream on host 0
                mb.compute_statistics(require_paired_flag=False)
                mb.write_stats_to_file(isize_file)
            mb.read_stats_from_file(isize_file)
            stats = (list(mb.isize_mean), list(mb.isize_std),
                     list(mb.coverage))
        stats = allgather_obj(stats)[0]
        mb.isize_mean, mb.isize_std, mb.coverage = (
            list(stats[0]), list(stats[1]), list(stats[2]))
        _log_opened(mb, bam_list, tag, log)
        return mb
    mb = MultiBam.open(bam_list)
    if not os.path.exists(isize_file):
        log(f"[bam] Computing statistics of {tag}")
        mb.compute_statistics(require_paired_flag=False)
        mb.write_stats_to_file(isize_file)
    mb.read_stats_from_file(isize_file)
    _log_opened(mb, bam_list, tag, log)
    return mb


def _log_opened(mb: MultiBam, bam_list: str, tag: str, log) -> None:
    log(f"[bam] {tag} file {path_basename(bam_list)} successfully opened:")
    for i in range(mb.size):
        log(f"      {mb.filenames()[i]}\n         inserts size = "
            f"{mb.isize_mean[i]} +/- {mb.isize_std[i]}\tcoverage = "
            f"{mb.coverage[i]}")


def run_merge(opts: MergeOptions, log=print):
    t_start = time.time()
    metrics = Metrics()
    engine = opts.engine
    devices = engine.devices if engine is not None else None

    if devices is not None:
        log(f"[merge] engine on {len(devices)} device(s): "
            f"{', '.join(str(d) for d in devices)}")
        metrics.count("engine_devices", len(devices))
        if devices[0].type == "cuda":
            # the process's first device round trips (context creation,
            # first copy) land here instead of in whichever phase came
            # first
            with metrics.phase("device_warmup"):
                for dev in dict.fromkeys(devices):
                    torch.zeros((), device=dev).item()
                    torch.cuda.synchronize(dev)

    pid, nproc = proc_info()
    is_writer = pid == 0
    if nproc > 1:
        log(f"[main] distributed merge: process {pid}/{nproc}")
        if engine is None:
            raise ValueError("distributed merge requires the batched "
                             "engine (--device != oracle)")

    if opts.no_multiplicity_filter:
        log("[warning] option --noMultiplicityFilter provided; reads will be "
            "processed as if they had unique mapping")

    stats_chunks: list[str] = []

    log("[main] Loading blocks")
    if nproc > 1 and not os.path.exists(opts.blocks_file):
        raise FileNotFoundError(
            f"[error] distributed merge on process {pid}/{nproc}: blocks "
            f"file {opts.blocks_file!r} does not exist on this host — "
            f"run `gam create` to completion first, before any process "
            f"of the merge starts")
    blocks = blocks_io.load_blocks(opts.blocks_file, opts.min_block_size)
    log(f"[main] Loaded blocks = {len(blocks)}")

    log("[main] Loading BAMs data")
    with metrics.phase("load_bams"):
        master_bam = _open_with_stats(
            opts.master_bam_file, opts.master_bam_file + ".isize",
            "Master PE-alignments", log)
        master_mp = None
        if opts.master_mp_bam_file:
            master_mp = _open_with_stats(
                opts.master_mp_bam_file, opts.master_mp_bam_file + ".isize",
                "Master MP-alignments", log)
        slave_bam = _open_with_stats(
            opts.slave_bam_file, opts.slave_bam_file + ".isize",
            "Slave PE-alignments", log)
        slave_mp = None
        if opts.slave_mp_bam_file:
            slave_mp = _open_with_stats(
                opts.slave_mp_bam_file, opts.slave_mp_bam_file + ".isize",
                "Slave MP-alignments", log)

    log("[main] Loading contigs data...")
    master_ref = RefSequence.from_header(master_bam.ref_names,
                                         master_bam.ref_lengths)
    slave_ref = RefSequence.from_header(slave_bam.ref_names,
                                        slave_bam.ref_lengths)
    log(f"          Master Assembly: sequences = {len(master_ref)}\t"
        f"total length = {sum(r.length for r in master_ref)}")
    log(f"          Slave  Assembly: sequences = {len(slave_ref)}\t"
        f"total length = {sum(r.length for r in slave_ref)}")

    # ---- block filtering ----
    sl_blocks = paired.get_single_link_blocks(blocks)

    log("[main] Retrieving contigs without blocks...")
    master_nbc_bf, slave_nbc_bf = blocks_mod.no_blocks_contigs(
        len(master_ref), len(slave_ref), blocks)

    min_cov = min(master_bam.get_glob_coverage(),
                  slave_bam.get_glob_coverage()) / 2.0

    log("[main] Filtering blocks by coverage")
    blocks = blocks_mod.filter_blocks_by_coverage(
        blocks, sl_blocks, min_cov, opts.coverage_threshold)
    log(f"[main] Remaining blocks = {len(blocks)}")

    log("[main] Retrieving contigs with no blocks after coverage "
        "filtering...")
    m_has = np.ones(len(master_ref), bool)
    s_has = np.ones(len(slave_ref), bool)
    m_has[blocks.m_ctg] = False
    s_has[blocks.s_ctg] = False
    master_nbc_af = m_has & ~master_nbc_bf
    slave_nbc_af = s_has & ~slave_nbc_bf

    # ---- partition into graphs ----
    log("[main] Partitioning blocks")
    wire = region_score.WIRE
    wire0 = {k: wire[k] for k in ("bytes_up", "arena_bytes_up",
                                  "dispatches")}
    with metrics.phase("partition"):
        graphs, gstats, finish_weights = partition_blocks(
            blocks, master_bam, master_mp, slave_bam, slave_mp, devices,
            opts.no_multiplicity_filter, opts.output_graphs,
            defer_weights=True, shard=((pid, nproc) if nproc > 1 else None))
        stats_chunks.append(gstats.stats_text())

    metrics.count("partition_bytes_wire",
                  wire["bytes_up"] - wire0["bytes_up"])
    metrics.count("partition_arena_bytes",
                  wire["arena_bytes_up"] - wire0["arena_bytes_up"])
    metrics.count("partition_dispatches",
                  wire["dispatches"] - wire0["dispatches"])
    # the JAX package's per-shape compile times: no compile step here,
    # the key stays so both packages write one .metrics.json key set
    metrics.counters["partition_shape_first_call_s"] = {}
    if nproc > 1:
        # the sharded ingest: the alignment rows this host decoded (its
        # owned contig runs only)
        resident = sum(
            len(f.table)
            for mb2 in (master_bam, master_mp, slave_bam, slave_mp)
            if mb2 is not None for f in mb2.files)
        log(f"[dist] resident alignment rows after partition = {resident}")
        metrics.count("resident_rows", resident)

    # ---- sequences ----
    log("[main] Loading contig sequences")
    with metrics.phase("load_seqs"):
        m_num = master_ref.load_sequences(opts.master_fasta_file)
        log(f"       master sequences loaded = {m_num}")
        if m_num != len(master_ref):
            raise ValueError(
                "[error] the number of contigs loaded from the master fasta "
                "file is different from the number of sequences in master "
                "bam headers")
        s_num = slave_ref.load_sequences(opts.slave_fasta_file)
        log(f"       slave sequences loaded  = {s_num}")
        if s_num != len(slave_ref):
            raise ValueError(
                "[error] the number of contigs loaded from the slave fasta "
                "file is different from the number of sequences in slave "
                "bam headers")

    # the edge count ran on the device during the FASTA loads; fetch and
    # apply the weights now
    with metrics.phase("partition_fetch"):
        finish_weights()

    if os.environ.get("GAM_ARENA") == "1" and engine is not None:
        # resident sequence arena (opt-in, JAX models/merge.py:278-288):
        # both assemblies go to the card once, 4-bit packed, and the
        # align chunks ship window coordinates instead of window bytes
        engine.register_contigs(
            [master_ref[i].seq for i in range(len(master_ref))]
            + [slave_ref[i].seq for i in range(len(slave_ref))])

    # ---- slave contigs without blocks ----
    if is_writer:
        fn = opts.output_file_prefix + ".noblocks.BF.fasta"
        log(f"[merge] Writing contigs with no blocks to file: {fn}")
        with open(fn, "wb") as fh:
            for i in range(len(slave_nbc_bf)):
                if slave_nbc_bf[i]:
                    fh.write(format_record(slave_ref[i].name,
                                           slave_ref[i].seq))

        fn = opts.output_file_prefix + ".noblocks.AF.fasta"
        log(f"[merge] Writing contigs with no blocks (after filtering) to "
            f"file: {fn}")
        with open(fn, "wb") as fh:
            for i in range(len(slave_nbc_af)):
                if slave_nbc_af[i]:
                    fh.write(format_record(slave_ref[i].name,
                                           slave_ref[i].seq))

    # ---- build paired contigs (canonical sequential graph order) ----
    pctg_list = []
    cells0 = engine.cells_aligned if engine is not None else 0
    with metrics.phase("align"):
        if nproc > 1:
            pctg_list.extend(distributed_build_pctgs(
                graphs, master_ref, slave_ref, master_bam, slave_bam, engine,
                opts.no_multiplicity_filter, opts.debug, log=log))
        elif engine is not None:
            build_pctgs_batched(
                graphs, master_ref, slave_ref, master_bam, slave_bam,
                pctg_list, engine, opts.no_multiplicity_filter,
                opts.debug, log=log,
                progress=lambda p: log(f"[merge] Merging contigs {p}% done."),
                ckpt_dir=(opts.output_file_prefix + ".ckpt"
                          if opts.checkpoint else None))
        else:
            tot_vertices = sum(g.n for g in graphs)
            done = 0
            last_perc = 0
            for g in graphs:
                if g.n == 0:
                    continue
                try:
                    build_pctg(g, master_ref, slave_ref, master_bam,
                               slave_bam, pctg_list, bsw_align,
                               opts.no_multiplicity_filter, opts.debug,
                               log=(log if opts.debug else None))
                except Exception as exc:  # per-graph isolation (:326)
                    log(f"Something unexpected happened processing graph "
                        f"{g.cg_id}: {exc!r}")
                done += g.n
                if tot_vertices:
                    perc = int(100 * done / tot_vertices)
                    if perc > last_perc and perc % 5 == 0:
                        log(f"[merge] Merging contigs {perc}% done.")
                        last_perc = perc

    if engine is not None:
        metrics.count("aligned_cells", engine.cells_aligned - cells0)
        metrics.count("align_bytes_wire", engine.bytes_up)
        metrics.count("align_dispatches", engine.dispatches)
        if engine.arena_chunks:
            log(f"[merge] sequence arena: {engine.arena_problems} of "
                f"{engine.util['live']} problems, {engine.arena_chunks} of "
                f"{engine.dispatches} chunks")
        u = engine.util
        if u["batch"]:
            metrics.count("batch_fill_pct",
                          round(100.0 * u["live"] / u["batch"], 1))
            metrics.count("row_fill_pct",
                          round(100.0 * u["rows_live"]
                                / max(u["rows_padded"], 1), 1))
    metrics.count("pctgs", len(pctg_list))
    metrics.count("graphs", len(graphs))

    for k, p in enumerate(pctg_list):
        p.pctg_id = k
    pctg_id = len(pctg_list)
    log(f"[merge] Paired contigs built = {pctg_id}")

    # ---- unused slave contigs ----
    used = np.zeros(len(slave_ref), bool)
    for p in pctg_list:
        for cid in p.slave_ids:
            used[cid] = True
    used |= slave_nbc_bf
    used |= slave_nbc_af
    if is_writer:
        fn = opts.output_file_prefix + ".notmerged.fasta"
        log(f"[merge] writing slave's unused contigs (not even partially "
            f"merged) on file \"{fn}\"")
        with open(fn, "wb") as fh:
            for i in range(len(used)):
                if not used[i]:
                    fh.write(format_record(slave_ref[i].name,
                                           slave_ref[i].seq))

    # ---- unmerged master contigs as single-contig pctgs ----
    used_master = np.zeros(len(master_ref), bool)
    for p in pctg_list:
        for cid in p.master_ids:
            used_master[cid] = True
    ctg_ids = [i for i in range(len(master_ref)) if not used_master[i]]
    old_pctg_id = pctg_id
    generate_single_ctg_pctgs(pctg_list, ctg_ids, master_ref, pctg_id)

    # ---- outputs (host 0 only under a process group) ----
    if is_writer:
        fn = opts.output_file_prefix + ".gam.fasta"
        log(f"[merge] Writing paired contigs on file: {fn}")
        with open(fn, "wb") as fh:
            for p in pctg_list:
                fh.write(format_record(p.name, p.sequence()))

        fn = opts.output_file_prefix + ".pctgs"
        log(f"[merge] Writing paired contigs descriptors on file: {fn}")
        with open(fn, "w") as fh:
            write_pctg_descriptors(fh, pctg_list, master_ref, slave_ref,
                                   old_pctg_id)

        with open(opts.output_file_prefix + ".stats", "w") as fh:
            for chunk in stats_chunks:
                fh.write(chunk)

        metrics.write(opts.output_file_prefix + ".metrics.json")
    log(f"[merge] Total execution time = {format_time(time.time() - t_start)}")
    return pctg_list
