"""`gam` command-line interface of the PyTorch/CUDA port.

    python -m gam_ngs_tpu_torch.cli {create,merge,n50,index} ...

The flags are those of gam_ngs_tpu/cli.py (the reference binaries'
flags).  merge --device picks the banded-SW engine's torch device:
`auto` and `cuda` need a CUDA GPU and fail without one, `cpu` runs the
kernels' plain PyTorch versions, `oracle` the exact host aligner.
`cuda:N` names one GPU.  create --device picks the block
construction: `native` (C++ scan), `oracle` (exact Python scan), the
device join on a torch device (`cuda`, `cuda:N`, or `cpu` for its
torch ops on the CPU), or `auto` (the device join on cuda, which fails
without a GPU, as merge's auto does).

--coordinator host:port --num-processes N --process-id k runs one of N
processes over a torch.distributed gloo group; every process runs the
same command and host 0 writes the outputs.  merge: each process aligns
its share of the graph partitions.  create: each process runs the
device join over its share of the slave contigs (the sharded join is
create's only multi-process path, whatever --device names).  Under
auto and cuda process k takes cuda:(k mod the GPUs it sees).
"""

from __future__ import annotations

import argparse
import os
import sys


def _add_dist(p):
    g = p.add_argument_group("multi-process (torch.distributed, gloo)")
    g.add_argument("--coordinator", default="",
                   help="coordinator address host:port; enables multi-"
                        "process mode (every process runs the same "
                        "command, host 0 writes the outputs)")
    g.add_argument("--num-processes", type=int, default=None)
    g.add_argument("--process-id", type=int, default=None)


def _add_create(sub):
    p = sub.add_parser("create", help="build blocks from two alignments")
    p.add_argument("--master-bam", required=True,
                   help="coordinate-sorted PE alignments of the master "
                        "assembly (BAM-list file)")
    p.add_argument("--slave-bam", required=True,
                   help="coordinate-sorted PE alignments of the slave "
                        "assembly (BAM-list file)")
    p.add_argument("--min-block-size", type=int, default=50,
                   help="minimum number of reads needed to build a block "
                        "[default=50]")
    p.add_argument("--no-mult-filter", action="store_true",
                   help="process all reads as if uniquely mapped")
    p.add_argument("--output", default="out", help="output-file's prefix")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--device", type=_create_device, default="auto",
                   help="block-construction engine: 'native' = C++ scan, "
                        "'oracle' = exact Python scan, cuda / cuda:N / "
                        "cpu = the device join on that torch device, "
                        "'auto' = the device join on cuda")
    _add_dist(p)


def _merge_device(name: str) -> str:
    if name in ("auto", "cuda", "cpu", "oracle") or (
            name.startswith("cuda:") and name[5:].isdigit()):
        return name
    raise argparse.ArgumentTypeError(
        f"invalid device {name!r} (auto, cuda, cuda:N, cpu, oracle)")


def _create_device(name: str) -> str:
    if name == "native":
        return name
    try:
        return _merge_device(name)
    except argparse.ArgumentTypeError:
        raise argparse.ArgumentTypeError(
            f"invalid device {name!r} (auto, native, oracle, cuda, cuda:N, "
            f"cpu)") from None


def _add_merge(sub):
    p = sub.add_parser("merge", help="merge two assemblies given blocks")
    p.add_argument("--master-bam", required=True)
    p.add_argument("--slave-bam", required=True)
    p.add_argument("--master-mp-bam", default="")
    p.add_argument("--slave-mp-bam", default="")
    p.add_argument("--blocks-file", required=True)
    p.add_argument("--master-fasta", required=True)
    p.add_argument("--slave-fasta", required=True)
    p.add_argument("--min-block-size", type=int, default=5)
    p.add_argument("--threads", type=int, default=1)
    p.add_argument("--coverage-filter", type=float, default=0.75)
    p.add_argument("--no-mult-filter", action="store_true")
    p.add_argument("--output-graphs", action="store_true")
    p.add_argument("--output", default="out")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--device", type=_merge_device, default="auto",
                   help="banded-SW engine: the CUDA kernels (auto, cuda, "
                        "cuda:N), their plain PyTorch versions (cpu) or "
                        "the exact host oracle")
    p.add_argument("--checkpoint", action="store_true",
                   help="partition-level resume via <output>.ckpt/")
    _add_dist(p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="gam",
        description="genomic assemblies merger (GAM-NGS capabilities), "
                    "PyTorch/CUDA port")
    sub = ap.add_subparsers(dest="cmd", required=True)
    _add_create(sub)
    _add_merge(sub)
    p50 = sub.add_parser("n50", help="FASTA N50/L50 statistics")
    p50.add_argument("fasta")
    pidx = sub.add_parser(
        "index", help="build <bam>.gidx contig-offset indexes so "
                      "multi-host create decodes only its shard")
    pidx.add_argument("bams", nargs="+", help="BAM files or bam-list files")
    args = ap.parse_args(argv)

    from .utils.misc import max_rss_line

    if args.cmd in ("create", "merge") and args.coordinator:
        from .parallel import distributed

        pid, n = distributed.init_distributed(
            args.coordinator, args.num_processes, args.process_id)
        print(f"[main] process {pid}/{n} joined {args.coordinator}",
              flush=True)

    if args.cmd == "create":
        from .models.create import CreateOptions, run_create

        if args.min_block_size < 1:
            print("WARNING: min-block-size is less than 1", file=sys.stderr)
        try:
            engine, device = args.device, None
            if engine not in ("auto", "native", "oracle"):
                from .device import resolve_device

                engine, device = "device", resolve_device(args.device)
            run_create(CreateOptions(
                master_bam_file=args.master_bam,
                slave_bam_file=args.slave_bam,
                min_block_size=args.min_block_size,
                no_multiplicity_filter=args.no_mult_filter,
                output_file_prefix=args.output,
                debug=args.debug,
                engine=engine,
                device=device,
            ))
        finally:
            if args.coordinator:
                distributed.shutdown()
        print(max_rss_line("[gam-create]"))  # src/gam-create.cc:64
        return 0

    if args.cmd == "merge":
        from .models.merge import MergeOptions, run_merge

        try:
            engine = None
            if args.device != "oracle":
                from .device import resolve_device
                from .ops.bsw_engine import BswEngine

                engine = BswEngine(resolve_device(args.device))
            run_merge(MergeOptions(
                master_bam_file=args.master_bam,
                slave_bam_file=args.slave_bam,
                master_mp_bam_file=args.master_mp_bam,
                slave_mp_bam_file=args.slave_mp_bam,
                blocks_file=args.blocks_file,
                master_fasta_file=args.master_fasta,
                slave_fasta_file=args.slave_fasta,
                min_block_size=args.min_block_size,
                threads_num=args.threads,
                coverage_threshold=args.coverage_filter,
                no_multiplicity_filter=args.no_mult_filter,
                output_file_prefix=args.output,
                output_graphs=args.output_graphs,
                debug=args.debug,
                engine=engine,
                checkpoint=args.checkpoint,
            ))
        finally:
            if args.coordinator:
                distributed.shutdown()
        print(max_rss_line("[main]"))  # src/gam-merge.cc:64
        return 0

    if args.cmd == "n50":
        from .models.n50 import run_n50

        run_n50(args.fasta)
        return 0

    if args.cmd == "index":
        from .io import bamlist
        from .native.bamdecode import available, build_index

        if not available():
            print("[error] native gamio library unavailable; "
                  "gam index requires it", file=sys.stderr)
            return 1
        paths = []
        for p in args.bams:
            if p.endswith(".bam"):
                paths.append(p)
            else:  # bam-list file
                names, _, _ = bamlist.load_bam_file_names(p)
                paths.extend(names)
        rc = 0
        for p in paths:
            # the native writer skips a failed write silently: check the
            # file exists before reporting success
            if build_index(p) and os.path.exists(p + ".gidx"):
                print(f"[index] wrote {p}.gidx")
            else:
                print(f"[error] failed to write {p}.gidx", file=sys.stderr)
                rc = 1
        return rc
    return 1


if __name__ == "__main__":
    sys.exit(main())
