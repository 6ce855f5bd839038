"""gam create — block construction, single process, no device stage.

gam_ngs_tpu/models/create.py::run_create (CreateBlocks::execute,
CreateBlocks.cc:63) with the host engines only: `native` (the C++ scan)
and `oracle` (the exact Python scan).  The device join of the JAX
package (ops/device_join.py) is not ported yet.  Writes <prefix>.blocks,
<master-list>.isize and <slave-list>.isize, identical to the JAX
package's.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

from ..core import blocks as blocks_mod
from ..core.multibam import MultiBam
from ..io import blocks_io
from ..native import native_available
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
    # "native" (C++ scan), "oracle" (exact Python scan), "auto" (native
    # when the library builds and GAM_NO_NATIVE is unset, else oracle)
    engine: str = "auto"


def run_create(opts: CreateOptions, log=print):
    t1 = time.time()
    metrics = Metrics()
    engine = opts.engine
    if engine == "auto":
        engine = ("native" if native_available()
                  and not os.environ.get("GAM_NO_NATIVE") else "oracle")
    if engine not in ("native", "oracle"):
        raise ValueError(f"create engine {engine!r}: native, oracle or auto")

    if opts.no_multiplicity_filter:
        log("[main] option --noMultiplicityFilter provided; reads will be "
            "processed as if they had unique mapping")

    log("[main] opening BAM files")
    master = MultiBam.open(opts.master_bam_file)

    log("[main] loading reads in memory")
    with metrics.phase("load_reads"):
        master_cov = blocks_mod.coverage_vectors(
            master, opts.no_multiplicity_filter)
        if engine == "oracle":
            map1, map2 = blocks_mod.load_reads_map(
                master, opts.no_multiplicity_filter)

    # stats through the GetNextAlignment(update_stats=true) path
    master.compute_statistics(require_paired_flag=True)
    master.write_stats_to_file(opts.master_bam_file + ".isize")

    log(f"[main] reads loaded in {format_time(time.time() - t1)}")
    log("[main] finding blocks")

    slave = MultiBam.open(opts.slave_bam_file)
    with metrics.phase("find_blocks"):
        slave_cov = blocks_mod.coverage_vectors(
            slave, opts.no_multiplicity_filter)
        if engine == "native":
            blocks = blocks_mod.find_blocks_fast(
                master, slave, opts.min_block_size,
                opts.no_multiplicity_filter)
            if blocks is None:
                raise RuntimeError(
                    "create --device native: the native gamio library is "
                    "unavailable (build failed or GAM_NO_NATIVE is set)")
        else:
            blocks = blocks_mod.find_blocks(
                slave, opts.min_block_size, map1, map2,
                opts.no_multiplicity_filter)
        blocks_mod.update_coverages(blocks, master_cov, slave_cov)
    metrics.count("blocks", len(blocks))

    slave.compute_statistics(require_paired_flag=True)
    slave.write_stats_to_file(opts.slave_bam_file + ".isize")

    log(f"[main] blocks found = {len(blocks)}")
    log(f"[main] writing blocks on file: "
        f"{path_basename(opts.output_file_prefix)}")
    blocks_io.write_blocks(opts.output_file_prefix + ".blocks", blocks)
    if opts.debug:
        _write_blocks_verbose(
            opts.output_file_prefix + ".blocks.verbose.txt", blocks,
            master.ref_names, slave.ref_names)

    metrics.write(opts.output_file_prefix + ".metrics.json")
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
