"""The port's partition edge count (torch ops, here on the CPU) against
the exact host replica (_count_job_host), the JAX package's count_jobs
and the sequential edge weighting, on the tests/test_region_score.py
corpus.  Each package reads the corpus with its own loaders and builds
its own graphs.  Counts are integers: exact equality throughout."""

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
from test_region_score import _pipeline_graphs

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
        output_file_prefix=str(tmp / "port")), log=lambda *_: None)
    master, slave = MultiBam.open(ml), MultiBam.open(sl)
    master.read_stats_from_file(ml + ".isize")
    slave.read_stats_from_file(sl + ".isize")
    return {"jax": jax_side, "port": (blocks, master, slave)}


def _jobs(corpus, side="port"):
    """Every graph's resident range jobs, concatenated, built by one
    package's graph classes from its own inputs."""
    asm, cmp_, par = ((assembly, compact, paired) if side == "port" else
                      (jax_assembly, jax_compact, jax_paired))
    blocks, master, slave = corpus[side]
    jobs = []
    for ag_id, rows in enumerate(
            par.partition_blocks_by_paired_contigs(blocks), start=1):
        cg = cmp_.CompactAssemblyGraph(asm.AssemblyGraph(blocks, rows, ag_id))
        jobs += cg.prepare_edge_weights(master, None, slave, None)
    assert jobs and "_mb" in jobs[0]
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


def test_payload_jobs_not_ported():
    rng = np.random.default_rng(5)
    n = 20
    pos = rng.integers(0, 5000, n).astype(np.int32)
    job = {"pos": pos, "end_pos": pos + 50, "flag": np.ones(n, np.int32),
           "nh": np.ones(n, np.int32), "xt": np.full(n, 85, np.int32),
           "ref_id": np.zeros(n, np.int32), "mate_ref": np.zeros(n, np.int32),
           "mate_pos": pos + 150, "goodq": np.ones(n, np.int32), "s1": 100,
           "s2": 4000, "t": 3000, "max_insert": 600, "seq_len": 9000,
           "no_mult": 0}
    with pytest.raises(NotImplementedError, match="GAM_RESIDENT"):
        rs.count_jobs([job], CPU)


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
