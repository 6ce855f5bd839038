"""The port's multi-process runtime (gam_ngs_tpu_torch/parallel/
distributed.py) and the sharded partition phase, in one process: the
LPT split against the JAX package's, the one-process distributed build
against the plain batched build, the collective's deadline, poison,
environment validation, injected gather and worker exceptions, and the
sharded ingestion of two lockstep threads against the sequential edge
props.  Counterparts of tests/test_parallel.py:67-247; the real
two-process runs are in test_torch_dist2proc.py."""

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import testutil
from gam_ngs_tpu.parallel.distributed import (
    shard_partitions as jax_shard_partitions,
)
from gam_ngs_tpu_torch.core.multibam import MultiBam
from gam_ngs_tpu_torch.core.refseq import RefSequence
from gam_ngs_tpu_torch.graphs.partition import partition_blocks
from gam_ngs_tpu_torch.io import blocks_io
from gam_ngs_tpu_torch.merge.builder import build_pctgs_batched
from gam_ngs_tpu_torch.models.create import CreateOptions, run_create
from gam_ngs_tpu_torch.ops.bsw_engine import BswEngine
from gam_ngs_tpu_torch.parallel import distributed
from gam_ngs_tpu_torch.parallel.distributed import (
    BarrierTimeout,
    allgather_obj,
    barrier_timeout_s,
    distributed_build_pctgs,
    proc_info,
    shard_partitions,
)
from test_merge_pipeline import _build_inputs

CPU = torch.device("cpu")
quiet = lambda *_: None  # noqa: E731


class LockstepGather:
    """In-process allgather for nproc lockstep threads (a copy of
    tests/test_create_dist.py's helper): each round every thread deposits
    its object, waits for all, reads the full list, then waits again
    before the next round may overwrite."""

    def __init__(self, nproc: int):
        self.nproc = nproc
        self.buf = [None] * nproc
        self.enter = threading.Barrier(nproc)
        self.exit = threading.Barrier(nproc)

    def for_pid(self, pid: int):
        def gather(obj):
            self.buf[pid] = obj
            self.enter.wait(timeout=60)
            out = list(self.buf)
            self.exit.wait(timeout=60)  # all read before next round writes
            return out

        return gather


def run_lockstep(fn, nproc: int) -> list:
    """Run fn(pid, gather) on nproc lockstep threads; return results."""
    g = LockstepGather(nproc)
    with ThreadPoolExecutor(nproc) as ex:
        futs = [ex.submit(fn, pid, g.for_pid(pid)) for pid in range(nproc)]
        return [f.result(timeout=120) for f in futs]


def test_shard_partitions_balanced_and_deterministic():
    sizes = [100, 1, 50, 50, 2, 99, 3, 1]
    shards = [shard_partitions(sizes, 3, h) for h in range(3)]
    # complete, disjoint
    allidx = sorted(i for s in shards for i in s)
    assert allidx == list(range(len(sizes)))
    # balanced: no host more than ~half the total
    loads = [sum(sizes[i] for i in s) for s in shards]
    assert max(loads) <= 110
    # single host owns everything
    assert shard_partitions(sizes, 1, 0) == list(range(len(sizes)))
    # the JAX package's assignment, host for host
    rng = np.random.default_rng(5)
    for n in (1, 2, 3, 7):
        sizes = rng.integers(0, 40, size=int(rng.integers(0, 30))).tolist()
        for h in range(n):
            assert shard_partitions(sizes, n, h) == \
                jax_shard_partitions(sizes, n, h)


def test_proc_info_without_a_group():
    assert proc_info() == (0, 1)
    assert allgather_obj({"k": 1}) == [{"k": 1}]


def test_distributed_build_matches_sequential(tmp_path):
    """One-process distributed build == plain batched build (the
    splice-by-graph-order path, collectives short-circuited)."""
    _genome, ml, sl, mfa, sfa = _build_inputs(tmp_path)
    run_create(CreateOptions(master_bam_file=ml, slave_bam_file=sl,
                             min_block_size=10,
                             output_file_prefix=str(tmp_path / "out"),
                             engine="native"),
               log=quiet)
    blocks = blocks_io.load_blocks(str(tmp_path / "out.blocks"), 10)
    master = MultiBam.open(ml)
    slave = MultiBam.open(sl)
    master.read_stats_from_file(ml + ".isize")
    slave.read_stats_from_file(sl + ".isize")
    master_ref = RefSequence.from_header(master.ref_names,
                                         master.ref_lengths)
    slave_ref = RefSequence.from_header(slave.ref_names,
                                        slave.ref_lengths)
    master_ref.load_sequences(mfa)
    slave_ref.load_sequences(sfa)
    graphs, _stats = partition_blocks(blocks, master, None, slave, None,
                                      CPU)
    seq_pctgs: list = []
    build_pctgs_batched(graphs, master_ref, slave_ref, master, slave,
                        seq_pctgs, BswEngine(CPU))
    dist_pctgs = distributed_build_pctgs(graphs, master_ref, slave_ref,
                                         master, slave, BswEngine(CPU))
    assert len(dist_pctgs) == len(seq_pctgs) > 0
    for a, b in zip(dist_pctgs, seq_pctgs):
        assert np.array_equal(a.sequence(), b.sequence())


def test_allgather_barrier_timeout():
    """A hung collective raises BarrierTimeout instead of blocking the
    group forever, and poisons the process: any later collective raises
    immediately rather than mismatching the orphaned in-flight one."""
    release = threading.Event()

    def hung_gather(_x):
        release.wait(30)

    try:
        with pytest.raises(BarrierTimeout, match="allgather"):
            allgather_obj({"k": 1}, timeout_s=0.2, _gather=hung_gather)
        # poisoned: even a would-be-fine collective refuses to run
        with pytest.raises(BarrierTimeout, match="poisoned"):
            allgather_obj({"k": 2}, timeout_s=5.0, _gather=lambda x: [x])
    finally:
        release.set()  # let the worker thread exit promptly
        distributed._reset_poison()


def test_barrier_timeout_env_validation(monkeypatch):
    monkeypatch.setenv("GAM_BARRIER_TIMEOUT", "12.5")
    assert barrier_timeout_s() == 12.5
    monkeypatch.setenv("GAM_BARRIER_TIMEOUT", "bogus")
    with pytest.raises(ValueError, match="GAM_BARRIER_TIMEOUT"):
        barrier_timeout_s()
    monkeypatch.setenv("GAM_BARRIER_TIMEOUT", "-1")
    with pytest.raises(ValueError, match="GAM_BARRIER_TIMEOUT"):
        barrier_timeout_s()


def test_allgather_injected_gather_roundtrip():
    """allgather_obj hands this process's object to the injected
    collective and returns every process's, in rank order (simulating 2
    hosts in one process)."""
    objs = [{"host": 0, "v": [1, 2]}, {"host": 1, "v": "x" * 100}]
    seen = []

    def fake_gather(obj):
        seen.append(obj)
        return [obj, objs[1]]

    got = allgather_obj(objs[0], timeout_s=5.0, _gather=fake_gather)
    assert got == objs and seen == [objs[0]]


def test_allgather_propagates_worker_exception():
    def broken_gather(_x):
        raise ValueError("peer died")

    with pytest.raises(ValueError, match="peer died"):
        allgather_obj([1], timeout_s=5.0, _gather=broken_gather)


def test_sharded_partition_ingestion_matches_sequential(tmp_path):
    """Multi-process partition phase: deferred MultiBams + per-host contig
    runs + owned-jobs-only edge weighting (the port's torch edge count on
    the CPU) + final-prop allgather must reproduce the sequential edge
    props exactly, while each host keeps strictly fewer alignment rows
    resident than a full decode."""
    rng = np.random.default_rng(77)
    # TWO independent components: S0 bridges M0|M1, S1 bridges M2|M3
    g1 = testutil.random_genome(rng, 6000)
    g2 = testutil.random_genome(rng, 6000)
    m_recs, s_recs = [], []
    READ_LEN, INSERT = 50, 200
    i = 0
    for base, g in ((0, g1), (1, g2)):
        for p in range(0, 6000 - INSERT, 8):
            q = p + INSERT - READ_LEN
            name = f"r{base}_{i}"
            i += 1
            s1, s2 = g[p:p + READ_LEN], g[q:q + READ_LEN]
            hi = q + READ_LEN
            mc = 2 * base
            if hi <= 3000:
                m_recs += testutil.make_pe_records(
                    name, s1, mc, p, False, s2, mc, q, True)
            elif p >= 3000:
                m_recs += testutil.make_pe_records(
                    name, s1, mc + 1, p - 3000, False, s2, mc + 1,
                    q - 3000, True)
            s_recs += testutil.make_pe_records(
                name, s1, base, p, False, s2, base, q, True)

    mp, sp = str(tmp_path / "m.bam"), str(tmp_path / "s.bam")
    testutil.write_sorted_bam(
        mp, ["M0", "M1", "M2", "M3"], [3000] * 4, m_recs)
    testutil.write_sorted_bam(sp, ["S0", "S1"], [6000, 6000], s_recs)
    ml, sl = str(tmp_path / "m.list"), str(tmp_path / "s.list")
    testutil.write_bam_list(ml, [mp], [(100, 1000)])
    testutil.write_bam_list(sl, [sp], [(100, 1000)])
    blocks = run_create(CreateOptions(
        master_bam_file=ml, slave_bam_file=sl, min_block_size=10,
        output_file_prefix=str(tmp_path / "out"), engine="native"), log=quiet)

    def open_pair(deferred):
        if deferred:
            m = MultiBam.open_deferred(ml)
            s = MultiBam.open_deferred(sl)
        else:
            m = MultiBam.open(ml)
            s = MultiBam.open(sl)
        m.read_stats_from_file(ml + ".isize")
        s.read_stats_from_file(sl + ".isize")
        return m, s

    def edge_props(graphs):
        return [[(g.prop[e]["weight"], g.prop[e]["rnum"],
                  g.prop[e]["min_cov"]) for e in g.edges()]
                for g in graphs]

    # sequential baseline
    m_seq, s_seq = open_pair(False)
    seq_graphs, seq_stats = partition_blocks(blocks, m_seq, None, s_seq,
                                             None, CPU)
    assert len(seq_graphs) == 2
    total_rows = sum(len(f.table) for mb in (m_seq, s_seq)
                     for f in mb.files)

    def host(pid, gather):
        m, s = open_pair(True)
        graphs, stats = partition_blocks(
            blocks, m, None, s, None, CPU, shard=(pid, 2),
            _allgather=gather)
        resident = sum(len(f.table) for mb in (m, s) for f in mb.files)
        return resident, edge_props(graphs), stats.stats_text()

    results = run_lockstep(host, 2)
    seq_props = edge_props(seq_graphs)
    for pid, (resident, props, stats_text) in enumerate(results):
        assert props == seq_props, f"host {pid} edge props diverged"
        assert stats_text == seq_stats.stats_text()
        assert resident < total_rows, \
            f"host {pid} decoded everything ({resident}/{total_rows})"
    # the two components split one per host
    assert sum(r for r, _, _ in results) <= total_rows


def test_device_per_rank(monkeypatch):
    """Under a process group --device auto|cuda gives rank k the GPU
    cuda:(k mod the GPUs it sees); cuda:N names one outright; the CLI
    takes cuda:N and refuses other names."""
    from gam_ngs_tpu_torch import cli, device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "gpu")
    for rank, count, want in ((1, 2, 1), (1, 1, 0), (3, 2, 1), (0, 4, 0)):
        monkeypatch.setattr(device, "proc_info", lambda r=rank: (r, 4))
        monkeypatch.setattr(torch.cuda, "device_count", lambda c=count: c)
        for name in ("auto", "cuda"):
            assert device.resolve_device(name) == \
                torch.device("cuda", want)
        assert device.resolve_device("cuda:3") == torch.device("cuda", 3)
    monkeypatch.setattr(device, "proc_info", lambda: (0, 1))
    assert device.resolve_device("auto") == torch.device("cuda")
    assert cli._merge_device("cuda:1") == "cuda:1"
    for bad in ("cuda:x", "tpu", "gpu"):
        with pytest.raises(Exception):
            cli._merge_device(bad)
