"""The port's create and merge with two real processes over a
torch.distributed gloo group on localhost (create / merge
--coordinator, --device cpu), counterparts of
tests/test_distributed_2proc.py and tests/test_multiway.py's
two-process test.  Both processes run the same command through the
port's CLI in a process where jax and gam_ngs_tpu cannot be imported.
The merge tests create in one process; host 0's six outputs must be
byte-identical to the port's one-process merge and to the JAX package's
sequential run_merge on the same inputs, and the two ranks' aligned
cells must sum to the one-process run's.  The create test runs the
sharded device join in both processes: host 0's .blocks must be the
one-process native create's, and the merge from them its outputs."""

import json
import os
import pathlib
import re
import socket
import subprocess
import sys
import time

import pytest
import torch

import testutil
import torch_problems as tp
from gam_ngs_tpu.io import fasta
from gam_ngs_tpu.models.create import CreateOptions as JaxCreateOptions
from gam_ngs_tpu.models.create import run_create as jax_run_create
from gam_ngs_tpu.models.merge import MergeOptions as JaxMergeOptions
from gam_ngs_tpu.models.merge import run_merge as jax_run_merge
from gam_ngs_tpu.ops.bsw_batch import BswEngine as JaxEngine
from gam_ngs_tpu_torch.core.multibam import MultiBam
from gam_ngs_tpu_torch.models.create import CreateOptions, run_create
from gam_ngs_tpu_torch.models.merge import MergeOptions, run_merge
from gam_ngs_tpu_torch.ops.bsw_engine import BswEngine
from test_merge_pipeline import _build_inputs
from test_multiway import _pairs, _records_for_assembly, _write_assembly

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUTPUTS = (".gam.fasta", ".pctgs", ".stats", ".noblocks.BF.fasta",
           ".noblocks.AF.fasta", ".notmerged.fasta")
CPU = torch.device("cpu")
quiet = lambda *_: None  # noqa: E731
# the CLI in a child process where neither JAX nor the JAX package loads
PROG = ("import sys; sys.modules['jax'] = None; "
        "sys.modules['gam_ngs_tpu'] = None; "
        "from gam_ngs_tpu_torch.cli import main; sys.exit(main(sys.argv[1:]))")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _outputs(prefix: str) -> dict:
    return {ext: pathlib.Path(prefix + ext).read_bytes() for ext in OUTPUTS}


def _merge_kw(ml, sl, mfa, sfa, blocks):
    return dict(master_bam_file=ml, slave_bam_file=sl, blocks_file=blocks,
                master_fasta_file=mfa, slave_fasta_file=sfa,
                min_block_size=10)


def merge_two_processes(workdir, ml, sl, mfa, sfa, blocks, out,
                        timeout_s: float = 240) -> list[str]:
    """Both ranks of `merge --coordinator`; returns their logs."""
    return run_ranks(workdir, [
        "merge", "--master-bam", ml, "--slave-bam", sl, "--blocks-file",
        blocks, "--master-fasta", mfa, "--slave-fasta", sfa,
        "--min-block-size", "10", "--output", out, "--device", "cpu"],
        pathlib.Path(out).name, timeout_s)


def run_ranks(workdir, argv, tag: str, timeout_s: float = 240
              ) -> list[str]:
    """Both ranks of the port's CLI command argv with --coordinator (hard
    deadline; every process is killed on expiry); returns their logs."""
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=str(ROOT), GAM_BARRIER_TIMEOUT="180",
               OMP_NUM_THREADS="2")
    procs = []
    for pid in range(2):
        logf = str(workdir / f"{tag}.rank{pid}.log")
        with open(logf, "w") as fh:
            procs.append((subprocess.Popen(
                [sys.executable, "-c", PROG, *argv, "--coordinator", coord,
                 "--num-processes", "2", "--process-id", str(pid)],
                stdout=fh, stderr=subprocess.STDOUT, env=env,
                cwd=str(workdir)), logf))
    deadline = time.monotonic() + timeout_s
    try:
        for p, logf in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{argv[0]} --coordinator hung; rank 0's log:"
                             "\n" + open(procs[0][1]).read()[-4000:]
                             ) from None
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = [open(logf).read() for _p, logf in procs]
    for (p, _), log in zip(procs, logs):
        assert p.returncode == 0, f"a rank failed:\n{log[-4000:]}"
    return logs


def check_ranks(logs, one_process_metrics: str) -> list[int]:
    """Each rank joined, aligned its share and reported it; the shares
    sum to the one-process run's aligned cells; only host 0 wrote.
    Returns each rank's aligned cells."""
    cells = []
    for pid, log in enumerate(logs):
        assert f"process {pid}/2 joined" in log, log[-2000:]
        m = re.search(rf"\[dist\] host {pid}: aligned cells = (\d+)", log)
        assert m, log[-2000:]
        cells.append(int(m.group(1)))
        wrote = "[merge] Writing paired contigs on file" in log
        assert wrote == (pid == 0), pid
    want = json.load(open(one_process_metrics))["counters"]["aligned_cells"]
    assert sum(cells) == want > 0, (cells, want)
    return cells


@pytest.mark.parametrize("corpus", ["junction", "two_partitions"])
def test_two_process_merge_byte_identical(tmp_path, corpus):
    """One graph (rank 1 aligns nothing) and two graphs (one each)."""
    if corpus == "junction":
        _genome, ml, sl, mfa, sfa = _build_inputs(tmp_path)
    else:
        _genomes, ml, sl, mfa, sfa = tp.two_partition_corpus(tmp_path)
    run_create(CreateOptions(master_bam_file=ml, slave_bam_file=sl,
                             min_block_size=10,
                             output_file_prefix=str(tmp_path / "out"),
                             engine="native"),
               log=quiet)
    kw = _merge_kw(ml, sl, mfa, sfa, str(tmp_path / "out.blocks"))
    jax_run_merge(JaxMergeOptions(output_file_prefix=str(tmp_path / "jax"),
                                  engine=JaxEngine(), **kw), log=quiet)
    run_merge(MergeOptions(output_file_prefix=str(tmp_path / "one"),
                           engine=BswEngine(CPU), **kw), log=quiet)
    logs = merge_two_processes(tmp_path, ml, sl, mfa, sfa,
                               str(tmp_path / "out.blocks"),
                               str(tmp_path / "two"))
    two = _outputs(str(tmp_path / "two"))
    assert two == _outputs(str(tmp_path / "one"))
    assert two == _outputs(str(tmp_path / "jax"))
    cells = check_ranks(logs, str(tmp_path / "one.metrics.json"))
    assert all(cells) == (corpus == "two_partitions"), cells


@pytest.mark.parametrize("corpus", ["junction", "two_partitions"])
def test_two_process_create_then_merge(tmp_path, corpus):
    """create --coordinator over two processes (the sharded device join
    on the CPU; one slave contig, all rank 0's, or two, one a rank)
    writes the one-process native create's .blocks and .isize files on
    host 0 only; the two-process merge from those blocks writes the
    one-process merge's six outputs."""
    if corpus == "junction":
        _genome, ml, sl, mfa, sfa = _build_inputs(tmp_path)
    else:
        _genomes, ml, sl, mfa, sfa = tp.two_partition_corpus(tmp_path)
    one = str(tmp_path / "one")
    run_create(CreateOptions(master_bam_file=ml, slave_bam_file=sl,
                             min_block_size=10, output_file_prefix=one,
                             engine="native"), log=quiet)
    isize = {p: pathlib.Path(p + ".isize").read_bytes() for p in (ml, sl)}
    for p in isize:
        os.unlink(p + ".isize")
    two = str(tmp_path / "two")
    logs = run_ranks(tmp_path, [
        "create", "--master-bam", ml, "--slave-bam", sl, "--min-block-size",
        "10", "--output", two, "--device", "cpu"], "create")
    assert pathlib.Path(two + ".blocks").read_bytes() == \
        pathlib.Path(one + ".blocks").read_bytes()
    assert {p: pathlib.Path(p + ".isize").read_bytes() for p in isize} \
        == isize
    n_slave = len(MultiBam.open(sl).ref_names)
    assert n_slave == (1 if corpus == "junction" else 2)
    for pid, log in enumerate(logs):
        assert f"process {pid}/2 joined" in log, log[-2000:]
        assert f"[create] host {pid}: " in log, log[-2000:]
        wrote = "[main] writing blocks on file" in log
        assert wrote == (pid == 0), pid
    kw = _merge_kw(ml, sl, mfa, sfa, two + ".blocks")
    run_merge(MergeOptions(output_file_prefix=one, engine=BswEngine(CPU),
                           **kw), log=quiet)
    logs = merge_two_processes(tmp_path, ml, sl, mfa, sfa, two + ".blocks",
                               two)
    assert _outputs(two) == _outputs(one)
    check_ranks(logs, one + ".metrics.json")


def test_scale_corpus_matches_bench_build_corpus(tmp_path):
    """tests/torch_problems.py::scale_corpus writes bench/e2e_scale.py::
    build_corpus's files, byte for byte, with and without breaks."""
    sys.path.insert(0, str(ROOT / "bench"))
    from e2e_scale import build_corpus

    for k in (0, 4):
        ours, theirs = tmp_path / f"ours{k}", tmp_path / f"theirs{k}"
        ours.mkdir()
        theirs.mkdir()
        c = tp.scale_corpus(0.3, ours, break_every=k)
        b = build_corpus(0.3, str(theirs), break_every=k)
        assert c["genome"] == b["genome"]
        for key in ("ml", "sl", "mfa", "sfa"):
            assert pathlib.Path(c[key]).name == pathlib.Path(b[key]).name
        # the lists name their BAMs by path; the rest byte for byte
        for lst in ("ml", "sl"):
            assert pathlib.Path(c[lst]).read_text().replace(str(ours), "") \
                == pathlib.Path(b[lst]).read_text().replace(str(theirs), "")
        names = sorted(f.name for f in ours.iterdir())
        assert names == sorted(f.name for f in theirs.iterdir())
        for name in names:
            if not name.endswith(".list"):
                assert (ours / name).read_bytes() == \
                    (theirs / name).read_bytes(), (k, name)


A_SPANS = [("A0", 0, 3000), ("A1", 3000, 3000), ("A2", 6000, 3000)]
B_SPANS = [("B0", 2000, 2500)]
C_SPANS = [("C0", 5000, 2500)]


def _round2_master(d: pathlib.Path, genome: str, pairs) -> None:
    """Round 2's master = round 1's merged assembly: locate each merged
    contig in the genome and fabricate its read alignments."""
    spans = []
    for name, seq in fasta.read_fasta(str(d / "r1.gam.fasta")):
        s = fasta.codes_to_bytes(seq).decode()
        off = genome.find(s)
        assert off >= 0
        spans.append((name, off, len(s)))
    testutil.write_sorted_bam(
        str(d / "m2.bam"), [n for n, _o, _l in spans],
        [l for _n, _o, l in spans],
        _records_for_assembly(genome, spans, pairs))
    testutil.write_bam_list(str(d / "m2.list"), [str(d / "m2.bam")],
                            [(100, 1000)])


def test_three_assembly_iterated_merge_two_process(tmp_path):
    """The iterated 3-assembly reconciliation: per round, create in one
    process, then merge with two processes; host 0's outputs of both
    rounds equal the port's one-process run and the JAX package's
    sequential run, and the final assembly is the genome."""
    import numpy as np

    rng = np.random.default_rng(7777)
    genome = testutil.random_genome(rng, 9000)
    pairs = _pairs(0, 9000)
    runs = {"jax": "jax", "one": "port", "two": "port"}
    for name in runs:
        d = tmp_path / name
        d.mkdir()
        for tag, spans in (("a", A_SPANS), ("b", B_SPANS), ("c", C_SPANS)):
            _write_assembly(d, tag, genome, spans, pairs)

    def rnd(name, tag, master, slave):
        d = tmp_path / name
        ml, sl = str(d / f"{master}.list"), str(d / f"{slave}.list")
        mfa = str(d / ("r1.gam.fasta" if master == "m2" else "a.fasta"))
        sfa = str(d / f"{slave}.fasta")
        prefix = str(d / tag)
        if runs[name] == "jax":
            jax_run_create(JaxCreateOptions(
                master_bam_file=ml, slave_bam_file=sl, min_block_size=10,
                output_file_prefix=prefix), log=quiet)
        else:
            run_create(CreateOptions(
                master_bam_file=ml, slave_bam_file=sl, min_block_size=10,
                output_file_prefix=prefix, engine="native"), log=quiet)
        kw = _merge_kw(ml, sl, mfa, sfa, prefix + ".blocks")
        if name == "jax":
            jax_run_merge(JaxMergeOptions(output_file_prefix=prefix,
                                          engine=JaxEngine(), **kw),
                          log=quiet)
        elif name == "one":
            run_merge(MergeOptions(output_file_prefix=prefix,
                                   engine=BswEngine(CPU), **kw), log=quiet)
        else:
            return merge_two_processes(d, ml, sl, mfa, sfa,
                                       prefix + ".blocks", prefix)

    for tag, master, slave in (("r1", "a", "b"), ("r2", "m2", "c")):
        logs = {}
        for name in runs:
            if tag == "r2":
                _round2_master(tmp_path / name, genome, pairs)
            logs[name] = rnd(name, tag, master, slave)
        two = _outputs(str(tmp_path / "two" / tag))
        assert two == _outputs(str(tmp_path / "one" / tag)), tag
        assert two == _outputs(str(tmp_path / "jax" / tag)), tag
        check_ranks(logs["two"], str(tmp_path / "one" / f"{tag}.metrics.json"))
    recs = fasta.read_fasta(str(tmp_path / "two" / "r2.gam.fasta"))
    assert [fasta.codes_to_bytes(s).decode() for _n, s in recs] == [genome]
