"""The port's partition edge count (torch ops, here on the CPU) against
the exact host replica (_count_job_host), the JAX package's count_jobs
and the sequential edge weighting, on the tests/test_region_score.py
corpus: resident range jobs (the default) and row-payload jobs
(GAM_RESIDENT=0).  Each package reads the corpus with its own loaders
and builds its own graphs.  Counts are integers: exact equality
throughout."""

import numpy as np
import pytest
import torch

from gam_ngs_tpu.graphs import assembly as jax_assembly
from gam_ngs_tpu.graphs import compact as jax_compact
from gam_ngs_tpu.graphs import paired as jax_paired
from gam_ngs_tpu.graphs.partition import (
    partition_blocks as jax_partition_blocks,
)
from gam_ngs_tpu.ops import region_score as jax_rs
from gam_ngs_tpu_torch.core.multibam import MultiBam
from gam_ngs_tpu_torch.graphs import assembly, compact, paired
from gam_ngs_tpu_torch.graphs.partition import partition_blocks
from gam_ngs_tpu_torch.models.create import CreateOptions, run_create
from gam_ngs_tpu_torch.ops import region_score as rs
import torch_problems as tp
from test_region_score import _pipeline_graphs, _random_job

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """{"jax": (blocks, master, slave) from the JAX package's loaders,
    "port": the same files read by the port's create and MultiBam}."""
    tmp = tmp_path_factory.mktemp("region")
    jax_side = _pipeline_graphs(tmp)
    ml, sl = str(tmp / "m.list"), str(tmp / "s.list")
    blocks = run_create(CreateOptions(
        master_bam_file=ml, slave_bam_file=sl, min_block_size=10,
        output_file_prefix=str(tmp / "port"),
        engine="native"), log=lambda *_: None)
    master, slave = MultiBam.open(ml), MultiBam.open(sl)
    master.read_stats_from_file(ml + ".isize")
    slave.read_stats_from_file(sl + ".isize")
    return {"jax": jax_side, "port": (blocks, master, slave)}


def _jobs(corpus, side="port", resident=True, monkeypatch=None):
    """Every graph's jobs, concatenated, built by one package's graph
    classes from its own inputs: resident range jobs, or with
    resident=False the row-payload jobs GAM_RESIDENT=0 plans."""
    asm, cmp_, par = ((assembly, compact, paired) if side == "port" else
                      (jax_assembly, jax_compact, jax_paired))
    blocks, master, slave = corpus[side]
    if not resident:
        monkeypatch.setenv("GAM_RESIDENT", "0")
    jobs = []
    for ag_id, rows in enumerate(
            par.partition_blocks_by_paired_contigs(blocks), start=1):
        cg = cmp_.CompactAssemblyGraph(asm.AssemblyGraph(blocks, rows, ag_id))
        jobs += cg.prepare_edge_weights(master, None, slave, None)
    if not resident:
        monkeypatch.delenv("GAM_RESIDENT")
    assert jobs and ("_mb" in jobs[0]) == resident
    return jobs


def test_count_matches_host_replica_and_jax(corpus):
    jobs = _jobs(corpus)
    d0 = rs.WIRE["dispatches"]
    got = rs.count_jobs(jobs, CPU)
    assert rs.WIRE["dispatches"] == d0 + 1
    jax_jobs = _jobs(corpus, "jax")
    assert got == jax_rs.count_jobs(jax_jobs)
    assert got == [jax_rs._count_job_host(jax_rs._materialize_resident(j))
                   for j in jax_jobs]
    assert got == [rs._count_job_host(rs._materialize_resident(j))
                   for j in jobs]
    assert any(n >= 10 for _g, _e, n in got)  # real evidence was counted


def test_row_cap_chunks_and_ov_cap_escape(corpus, monkeypatch):
    jobs = _jobs(corpus)
    want = rs.count_jobs(jobs, CPU)
    lens = [j["hi"] - j["lo"] for j in jobs]
    monkeypatch.setattr(rs, "ROW_CAP", max(lens))  # one job per chunk
    d0 = rs.WIRE["dispatches"]
    assert rs.count_jobs(jobs, CPU) == want
    assert rs.WIRE["dispatches"] - d0 >= 2
    # a job whose summed read lengths pass OV_CAP is counted on the host:
    # with the cap at 1000 every job goes there, and nothing is dispatched
    monkeypatch.setattr(rs, "OV_CAP", 1000)
    d0 = rs.WIRE["dispatches"]
    assert rs.count_jobs(jobs, CPU) == want
    assert rs.WIRE["dispatches"] == d0


def test_defer_and_empty(corpus):
    jobs = _jobs(corpus)
    fin = rs.count_jobs(jobs, CPU, defer=True)
    assert callable(fin) and fin() == rs.count_jobs(jobs, CPU)
    assert rs.count_jobs([], CPU) == []
    assert rs.count_jobs([], CPU, defer=True)() == []
    empty = dict(jobs[0], lo=jobs[0]["lo"], hi=jobs[0]["lo"])
    assert rs.count_jobs([empty], CPU) == [(0, 0, 0)]


def test_payload_count_matches_host_replica_and_jax(corpus, monkeypatch):
    """Row-payload jobs (GAM_RESIDENT=0) on the corpus's graphs, and
    random jobs of every read class, against the exact host replica and
    the JAX package's payload count; the payload and resident counts of
    the same edges agree."""
    jobs = _jobs(corpus, resident=False, monkeypatch=monkeypatch)
    d0, b0 = rs.WIRE["dispatches"], rs.WIRE["bytes_up"]
    got = rs.count_jobs(jobs, CPU)
    assert rs.WIRE["dispatches"] == d0 + 1
    # the rows travel at their wire widths: 5 int32 + 2 uint16 + 2 uint8
    # columns = 26 bytes a row, plus 8 int32 = 32 bytes a job
    rows = sum(len(j["pos"]) for j in jobs)
    assert rs.WIRE["bytes_up"] - b0 == 26 * rows + 32 * len(jobs)
    assert got == [rs._count_job_host(j) for j in jobs]
    assert got == jax_rs.count_jobs(_jobs(corpus, "jax", resident=False,
                                          monkeypatch=monkeypatch))
    assert got == rs.count_jobs(_jobs(corpus), CPU)
    assert any(n >= 10 for _g, _e, n in got)
    rng = np.random.default_rng(5)
    rand = [_random_job(rng, int(rng.integers(0, 400))) for _ in range(6)]
    rand[2]["nh"] = np.full(len(rand[2]["pos"]), 65537, np.int32)  # wraps
    rand[3]["no_mult"] = 1
    got = rs.count_jobs(rand, CPU)
    assert got == [rs._count_job_host(j) for j in rand]
    assert got == jax_rs.count_jobs(rand)
    fin = rs.count_jobs(rand, CPU, defer=True)
    assert callable(fin) and fin() == got


def test_payload_row_cap_and_ov_cap_route(monkeypatch):
    """Payload chunks split at job boundaries under ROW_CAP and OV_CAP;
    a job whose summed read lengths pass OV_CAP is counted on the host
    (tests/test_region_score.py::test_long_read_overflow_routes_to_host
    with the port's caps)."""
    rng = np.random.default_rng(6)
    big = _random_job(rng, 300, long_reads=True)
    small = _random_job(rng, 50)
    monkeypatch.setattr(rs, "OV_CAP", 10000)  # big alone exceeds it
    calls = []
    plain = rs.count_payload

    def spy(rows, jobs_t):
        calls.append(jobs_t.shape[1])
        return plain(rows, jobs_t)

    monkeypatch.setattr(rs, "count_payload", spy)
    got = rs.count_jobs([small, big, small], CPU)
    assert got[1] == rs._count_job_host(big)
    assert got[0] == got[2] == rs._count_job_host(small)
    # each small job weighs ~6250 (> cap/2): two dispatches of one job
    assert calls == [1, 1]
    monkeypatch.setattr(rs, "OV_CAP", 1 << 30)
    monkeypatch.setattr(rs, "ROW_CAP", 60)  # one small job a chunk
    calls.clear()
    assert rs.count_jobs([small, small, small], CPU) == [got[0]] * 3
    assert calls == [1, 1, 1]


def test_merge_payload_byte_identical(corpus, tmp_path, monkeypatch):
    """One whole merge under GAM_RESIDENT=0 writes the six outputs of the
    default (resident) merge."""
    from gam_ngs_tpu_torch.models.merge import MergeOptions, run_merge
    from gam_ngs_tpu_torch.ops.bsw_engine import BswEngine

    tmp = tmp_path
    _genome, ml, sl, mfa, sfa = tp.junction_corpus(tmp)
    run_create(CreateOptions(master_bam_file=ml, slave_bam_file=sl,
                             min_block_size=10,
                             output_file_prefix=str(tmp / "out"),
                             engine="native"),
               log=lambda *_: None)
    outs = {}
    for tag, resident in (("res", "1"), ("pay", "0")):
        monkeypatch.setenv("GAM_RESIDENT", resident)
        d0 = rs.WIRE["arena_bytes_up"]
        run_merge(MergeOptions(
            master_bam_file=ml, slave_bam_file=sl,
            blocks_file=str(tmp / "out.blocks"), master_fasta_file=mfa,
            slave_fasta_file=sfa, min_block_size=10,
            output_file_prefix=str(tmp / tag), engine=BswEngine(CPU)),
            log=lambda *_: None)
        assert (rs.WIRE["arena_bytes_up"] > d0) == (resident == "1")
        outs[tag] = {ext: (tmp / f"{tag}{ext}").read_bytes() for ext in (
            ".gam.fasta", ".pctgs", ".stats", ".noblocks.BF.fasta",
            ".noblocks.AF.fasta", ".notmerged.fasta")}
    assert outs["pay"] == outs["res"]


@pytest.mark.parametrize("device", [CPU, None])
def test_partition_blocks_matches_jax(corpus, device, tmp_path,
                                      monkeypatch):
    """The port's partition_blocks (torch edge count, or host weights
    with device=None) gives the JAX package's graphs, stats and edge
    properties, and writes the same .dot files."""
    blocks, master, slave = corpus["port"]
    jblocks, jmaster, jslave = corpus["jax"]
    monkeypatch.chdir(tmp_path)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    graphs, stats = partition_blocks(blocks, master, None, slave, None,
                                     device, output_graphs=True,
                                     graphs_dir="port")
    jgraphs, jstats = jax_partition_blocks(jblocks, jmaster, None, jslave,
                                           None, output_graphs=True,
                                           graphs_dir="jax")
    assert stats.stats_text() == jstats.stats_text()
    assert len(graphs) == len(jgraphs) >= 1
    for g, jg in zip(graphs, jgraphs):
        assert list(g.edges()) == list(jg.edges())
        for e in g.edges():
            assert [g.prop[e][k] for k in ("weight", "rnum", "min_cov")] == \
                [jg.prop[e][k] for k in ("weight", "rnum", "min_cov")]
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == \
            (tmp_path / "jax" / n).read_bytes()


def _edge_props(cg):
    return {e: tuple(cg.prop[e][k] for k in ("weight", "rnum", "min_cov"))
            for e in cg.edges()}


def _graphs(corpus):
    blocks, _master, _slave = corpus["port"]
    parts = paired.partition_blocks_by_paired_contigs(blocks)
    assert parts, "expected at least one partition"
    return [assembly.AssemblyGraph(blocks, rows, ag_id)
            for ag_id, rows in enumerate(parts, start=1)]


def test_batched_matches_sequential(corpus):
    """tests/test_region_score.py::test_batched_matches_sequential on the
    port: compute_edge_weights(batched=True, devices=cpu) = the
    sequential per-edge weights."""
    _blocks, master, slave = corpus["port"]
    checked = 0
    for ag in _graphs(corpus):
        cg_seq = compact.CompactAssemblyGraph(ag)
        cg_seq.compute_edge_weights(master, None, slave, None,
                                    batched=False)
        cg_bat = compact.CompactAssemblyGraph(ag)
        cg_bat.compute_edge_weights(master, None, slave, None,
                                    batched=True, devices=CPU)
        assert _edge_props(cg_bat) == _edge_props(cg_seq)
        checked += len(_edge_props(cg_seq))
    assert checked


def test_resident_overflow_routes_to_host(corpus, monkeypatch):
    """tests/test_region_score.py::test_resident_overflow_routes_to_host
    on the port: with OV_CAP at 1000 every resident job is counted by the
    exact host replica, nothing is dispatched, and the weights equal the
    sequential ones."""
    _blocks, master, slave = corpus["port"]
    monkeypatch.setenv("GAM_RESIDENT", "1")
    monkeypatch.setattr(rs, "OV_CAP", 1000)  # every job overflows
    d0 = rs.WIRE["dispatches"]
    for ag in _graphs(corpus):
        cg_seq = compact.CompactAssemblyGraph(ag)
        cg_seq.compute_edge_weights(master, None, slave, None,
                                    batched=False)
        cg_res = compact.CompactAssemblyGraph(ag)
        cg_res.compute_edge_weights(master, None, slave, None,
                                    batched=True, devices=[CPU, CPU])
        assert _edge_props(cg_res) == _edge_props(cg_seq)
    assert rs.WIRE["dispatches"] == d0


def test_batched_edge_weights_need_devices(corpus):
    """batched=True (the default) without devices raises ValueError naming
    the device rule (the JAX call takes no device; the port has no global
    device), never TypeError; batched=False needs none."""
    _blocks, master, slave = corpus["port"]
    cg = compact.CompactAssemblyGraph(_graphs(corpus)[0])
    with pytest.raises(ValueError, match="no global device"):
        cg.compute_edge_weights(master, None, slave, None)
    cg.compute_edge_weights(master, None, slave, None, batched=False)
