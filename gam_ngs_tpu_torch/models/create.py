"""gam create — block construction pipeline.

gam_ngs_tpu/models/create.py::run_create (CreateBlocks::execute,
CreateBlocks.cc:63) with the port's engines: `native` (the C++ scan),
`oracle` (the exact Python scan) and `device` (the sort / merge-join
block construction of ops/device_join.py as torch ops on
CreateOptions.device).  In a torch.distributed process group of more
than one process every process runs the sharded device join
(parallel/create_dist.py) and host 0 writes.  Produces <prefix>.blocks,
<master-list>.isize and <slave-list>.isize, identical to the JAX
package's.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass

import torch

from ..core import blocks as blocks_mod
from ..core.multibam import MultiBam
from ..io import blocks_io
from ..ops import device_join
from ..utils.metrics import Metrics
from ..utils.misc import format_time, path_basename


@dataclass
class CreateOptions:
    master_bam_file: str = ""
    slave_bam_file: str = ""
    min_block_size: int = 50
    no_multiplicity_filter: bool = False
    output_file_prefix: str = "out"
    debug: bool = False
    # block-construction engine: "auto" (the device join on cuda, which
    # needs a GPU), "native" (C++ scan), "oracle" (exact Python scan),
    # "device" (the device join on `device`)
    engine: str = "auto"
    device: torch.device | None = None


def run_create(opts: CreateOptions, log=print):
    t1 = time.time()
    metrics = Metrics()

    from ..device import resolve_device
    from ..parallel.distributed import proc_info

    pid, nproc = proc_info()
    if nproc > 1:
        log(f"[main] distributed create: process {pid}/{nproc}")

    engine, device = opts.engine, opts.device
    if engine == "auto":
        engine, device = "device", resolve_device("auto")
    if engine not in ("native", "oracle", "device"):
        raise ValueError(f"create engine {engine!r}: auto, native, oracle "
                         f"or device")
    if nproc > 1:
        # the sharded device join is the only multi-process path
        if device is None:
            device = resolve_device("auto")
        log(f"[main] {nproc} processes: create engine {engine} -> the "
            f"sharded device join on {device}")
        engine = "dist"
    if engine in ("device", "dist") and device is None:
        raise ValueError(f"create engine {engine!r} needs a torch device")
    joins0 = dict(device_join.launches)

    if opts.no_multiplicity_filter:
        log("[main] option --noMultiplicityFilter provided; reads will be "
            "processed as if they had unique mapping")

    log("[main] opening BAM files")
    master = MultiBam.open(opts.master_bam_file)

    log("[main] loading reads in memory")
    with metrics.phase("load_reads"):
        if engine == "dist":
            from ..parallel.create_dist import distributed_coverage_vectors

            master_cov = distributed_coverage_vectors(
                master, opts.no_multiplicity_filter, pid, nproc)
        else:
            master_cov = blocks_mod.coverage_vectors(
                master, opts.no_multiplicity_filter)
        if engine == "oracle":
            map1, map2 = blocks_mod.load_reads_map(
                master, opts.no_multiplicity_filter)

    # stats through the GetNextAlignment(update_stats=true) path
    if engine == "dist":
        from ..parallel.create_dist import distributed_library_stats

        distributed_library_stats(master, True, pid, nproc, device=device)
    else:
        master.compute_statistics(require_paired_flag=True)
    if pid == 0:
        master.write_stats_to_file(opts.master_bam_file + ".isize")

    log(f"[main] reads loaded in {format_time(time.time() - t1)}")
    log("[main] finding blocks")

    if engine == "dist":
        # range-decode only this host's slave contig shard: with a
        # .gidx index the streaming decoder inflates just that slice
        # (header lengths are the shard weights so every host derives
        # identical ranges without decoding anything first)
        import numpy as np

        from ..io import bamlist
        from ..io.bam import read_bam_header
        from ..parallel.create_dist import shard_ranges_by_weight

        s_paths, _, _ = bamlist.load_bam_file_names(opts.slave_bam_file)
        hdr = read_bam_header(s_paths[0])
        s_ranges = shard_ranges_by_weight(
            np.asarray(hdr.ref_lengths, np.int64) + 1, nproc)
        slave = MultiBam.open(opts.slave_bam_file,
                              ref_range=s_ranges[pid])
    else:
        slave = MultiBam.open(opts.slave_bam_file)
    with metrics.phase("find_blocks"):
        if engine == "dist":
            from ..parallel.create_dist import (
                distributed_coverage_vectors,
                distributed_find_blocks,
            )

            slave_cov = distributed_coverage_vectors(
                slave, opts.no_multiplicity_filter, pid, nproc,
                ranges=s_ranges)
            m_cols = blocks_mod.stream_columns(
                master, opts.no_multiplicity_filter)
            s_cols = blocks_mod.stream_columns(
                slave, opts.no_multiplicity_filter)
            log(f"[create] host {pid}: {len(s_cols[0])} slave rows in its "
                f"shard, contigs [{s_ranges[pid][0]}, {s_ranges[pid][1]})")
            cols = distributed_find_blocks(
                m_cols, s_cols, opts.min_block_size, pid, nproc,
                ctg_ranges=s_ranges, s_local=True, device=device)
            blocks = blocks_mod.block_table_from_columns(cols)
        else:
            slave_cov = blocks_mod.coverage_vectors(
                slave, opts.no_multiplicity_filter)
            if engine == "native":
                blocks = blocks_mod.find_blocks_fast(
                    master, slave, opts.min_block_size,
                    opts.no_multiplicity_filter)
                if blocks is None:
                    raise RuntimeError(
                        "create --device native: the native gamio library "
                        "is unavailable (build failed or GAM_NO_NATIVE is "
                        "set)")
            elif engine == "device":
                blocks = blocks_mod.find_blocks_device_path(
                    master, slave, opts.min_block_size,
                    opts.no_multiplicity_filter, device)
            else:
                blocks = blocks_mod.find_blocks(
                    slave, opts.min_block_size, map1, map2,
                    opts.no_multiplicity_filter)
        blocks_mod.update_coverages(blocks, master_cov, slave_cov)
    metrics.count("blocks", len(blocks))
    if engine in ("device", "dist"):
        joins = {k: device_join.launches[k] - joins0[k] for k in joins0}
        for k, v in joins.items():
            metrics.count(f"{k}_launches", v)
        # this process's join / analysis calls on the card (0 on the CPU)
        log(f"[create] host {pid}: device join launches = "
            f"{json.dumps(joins, sort_keys=True)} on {device}")

    if engine == "dist":
        from ..parallel.create_dist import distributed_library_stats

        distributed_library_stats(slave, True, pid, nproc,
                                  rows_are_local=True, device=device)
    else:
        slave.compute_statistics(require_paired_flag=True)
    if pid == 0:
        slave.write_stats_to_file(opts.slave_bam_file + ".isize")

    log(f"[main] blocks found = {len(blocks)}")
    if pid == 0:
        log(f"[main] writing blocks on file: "
            f"{path_basename(opts.output_file_prefix)}")
        blocks_io.write_blocks(opts.output_file_prefix + ".blocks", blocks)

        if opts.debug:
            _write_blocks_verbose(
                opts.output_file_prefix + ".blocks.verbose.txt", blocks,
                master.ref_names, slave.ref_names)

        metrics.write(opts.output_file_prefix + ".metrics.json")
    if nproc > 1:
        # Trailing barrier: without it nothing stops a non-writer host
        # from racing ahead into `gam merge` (load_blocks) before host 0
        # has durably written .blocks/.isize.  One tiny allgather after
        # the writes makes the inter-phase checkpoint contract
        # (Block.cc:732 -> Merge.cc:110) hold across hosts.
        from ..parallel.distributed import allgather_obj

        allgather_obj(("create_done", pid))
    log(f"[main] total execution time = {format_time(time.time() - t1)}")
    return blocks


def _write_blocks_verbose(path, blocks, master_names, slave_names):
    """Block::writeBlocksVerbose (Block.cc:749)."""
    with open(path, "w") as fh:
        fh.write("# This file should NOT be used as input for gam-merge "
                 "command. It is only provided to easily look how blocks "
                 "have been built.\n")
        fh.write(blocks_io.HEADER)
        for i in range(len(blocks)):
            r = blocks.row(i)
            reads_len = (r[5] + r[11]) // 2  # Block::getReadsLen
            fh.write(
                f"{r[0]}\t{master_names[r[1]]}\t{chr(r[2])}\t{r[3]}\t{r[4]}"
                f"\t{reads_len}\t{slave_names[r[7]]}\t{chr(r[8])}\t{r[9]}"
                f"\t{r[10]}\t{reads_len}\n")
