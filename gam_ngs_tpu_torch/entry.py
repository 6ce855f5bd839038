"""Entry points: the forward kernel's example call and the multi-device
dry-run (the port's counterpart of the repo's __graft_entry__.py).

`entry(device)` returns the anti-diagonal banded semi-global
Smith-Waterman forward (ops.bsw_antidiag.forward_antidiag, the hottest
kernel of the merge, reference lib/src/alignment/banded_smith_waterman.cc:70)
with band 30 bound, and its arguments: a B=4, XW=256 near-diagonal batch
on `device`.

`dryrun_multichip(n, device)` runs the sharded pipeline step's dry-run
(parallel.step.dryrun_step) over n devices, then a tiny create and a
merge whose pctg build goes through
parallel.distributed.distributed_build_pctgs with an engine sharded over
the same devices, on the default path (anti-diagonal forward + device
walk) and on the row forward with the host traceback; each must give
back the 4000 bp genome.  The corpus is written by
tests/torch_problems.py's BAM/FASTA writer.

    python -m gam_ngs_tpu_torch.entry [n] [--device cpu|cuda]

n defaults to every GPU torch sees, or to 8 under --device cpu (eight
CPU shards, the JAX package's virtual mesh); without --device the
dry-run runs on the GPUs.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import tempfile

import numpy as np
import torch

from .ops.bsw_antidiag import forward_antidiag
from .parallel.mesh import device_mesh
from .device import as_devices
from .parallel.step import dryrun_step, pack_windows

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the contig length of __graft_entry__.py's batch: the JAX anti-diagonal
# kernel's a-window width at XW 256, band 30 (its antidiag_dims(256, 30)[2])
ENTRY_A_LEN = 640


def entry(device="cuda"):
    """(fn, example_args): fn(*example_args) -> (dirs, last_row, diag) of
    a B=4, XW=256, band=30 near-diagonal batch, packed, on `device`."""
    B, XW, band = 4, 256, 30
    fn = functools.partial(forward_antidiag, band=band)

    rng = np.random.default_rng(0)
    a = rng.integers(0, 5, size=(B, ENTRY_A_LEN)).astype(np.uint8)
    b = a[:, band:band + XW].copy()  # near-diagonal problem
    a_pk, b_pk = pack_windows(a, band, b, band)
    begin_a = np.full(B, band, np.int32)
    end_a = np.full(B, band + XW - 1, np.int32)
    a_len = np.full(B, ENTRY_A_LEN, np.int32)
    x_size = np.full(B, XW, np.int32)
    force_start = np.zeros(B, np.int32)
    example_args = tuple(
        torch.from_numpy(v).to(device)
        for v in (a_pk, b_pk, begin_a, end_a, a_len, x_size, force_start))
    return fn, example_args


def _torch_problems():
    """tests/torch_problems.py, the corpus writer of the port's tests."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_problems

    return torch_problems


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     devices=None) -> None:
    devs = as_devices(device_mesh(n_devices, device) if devices is None
                      else devices)
    dryrun_step(devs)

    from .core.multibam import MultiBam
    from .core.refseq import RefSequence
    from .graphs.partition import partition_blocks
    from .io import fasta
    from .models.create import CreateOptions, run_create
    from .ops.bsw_engine import BswEngine
    from .parallel.distributed import distributed_build_pctgs

    tp = _torch_problems()
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(5)
        genome = tp.random_genome(rng, 4000)
        m_recs, s_recs = [], []
        for i, p in enumerate(range(0, 4000 - 200, 8)):
            q = p + 150
            s1, s2 = genome[p:p + 50], genome[q:q + 50]
            if q + 50 <= 2000:
                m_recs += tp.pe_records(f"r{i}", s1, 0, p, s2, 0, q)
            elif p >= 2000:
                m_recs += tp.pe_records(f"r{i}", s1, 1, p - 2000, s2, 1,
                                        q - 2000)
            s_recs += tp.pe_records(f"r{i}", s1, 0, p, s2, 0, q)
        mp, sp = f"{tmp}/m.bam", f"{tmp}/s.bam"
        tp.write_sorted_bam(mp, ["M0", "M1"], [2000, 2000], m_recs)
        tp.write_sorted_bam(sp, ["S0"], [4000], s_recs)
        ml, sl = f"{tmp}/m.list", f"{tmp}/s.list"
        tp.write_bam_list(ml, mp)
        tp.write_bam_list(sl, sp)
        # the device join on the first device
        blocks = run_create(CreateOptions(
            master_bam_file=ml, slave_bam_file=sl, min_block_size=10,
            output_file_prefix=f"{tmp}/out", engine="device",
            device=devs[0]), log=lambda *_: None)
        master = MultiBam.open(ml)
        slave = MultiBam.open(sl)
        master.read_stats_from_file(ml + ".isize")
        slave.read_stats_from_file(sl + ".isize")
        # the resident edge count sharded over the devices
        graphs, _ = partition_blocks(blocks, master, None, slave, None,
                                     devs)
        m_ref = RefSequence.from_header(master.ref_names,
                                        master.ref_lengths)
        s_ref = RefSequence.from_header(slave.ref_names, slave.ref_lengths)
        mfa, sfa = f"{tmp}/m.fasta", f"{tmp}/s.fasta"
        tp.write_fasta(mfa, [("M0", genome[:2000]), ("M1", genome[2000:])])
        tp.write_fasta(sfa, [("S0", genome)])
        m_ref.load_sequences(mfa)
        s_ref.load_sequences(sfa)
        # the JAX package's ("pallas", "device") and ("xla", "host")
        for label, kw in (("default", {}), ("row forward + host traceback",
                                            {"kernel": "row",
                                             "traceback": "host"})):
            eng = BswEngine(devs, band=30, **kw)
            pctgs = distributed_build_pctgs(graphs, m_ref, s_ref, master,
                                            slave, eng)
            merged = sorted((fasta.codes_to_bytes(p.sequence()).decode()
                             for p in pctgs), key=len, reverse=True)
            if not merged or merged[0] != genome:
                raise AssertionError(
                    f"distributed merge over {len(devs)} devices ({label} "
                    f"engine) did not reconstruct the genome")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=None,
                    help="devices (default: every GPU, or 8 on the CPU)")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    args = ap.parse_args(argv)
    n = args.n
    if n is None:
        n = 8 if args.device == "cpu" else torch.cuda.device_count()
    dryrun_multichip(n, args.device)
    print(f"dryrun_multichip({n}) OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
