"""The port's engine and edge count over several devices in one process
(the JAX engine's mesh), on the CPU: a tuple of CPU devices stands in for
the GPUs.  Each chunk is sharded over the devices as the JAX shard_map
splits it; results and fill counters are held to the JAX engine over
conftest's virtual 8-device mesh and to the one-device engine, counts to
one device and to the JAX meshed count, and a whole merge to the
one-device merge.  Integers throughout: exact equality."""

import numpy as np
import pytest
import torch

import torch_problems as tp
from gam_ngs_tpu.graphs import assembly as jax_assembly
from gam_ngs_tpu.graphs import compact as jax_compact
from gam_ngs_tpu.graphs import paired as jax_paired
from gam_ngs_tpu.ops import region_score as jax_rs
from gam_ngs_tpu.ops.bsw_batch import BswEngine as JaxEngine
from gam_ngs_tpu.parallel import device_mesh
from gam_ngs_tpu_torch import device as device_mod
from gam_ngs_tpu_torch.core.multibam import MultiBam
from gam_ngs_tpu_torch.graphs import assembly, compact, paired
from gam_ngs_tpu_torch.io import fasta
from gam_ngs_tpu_torch.models.create import CreateOptions, run_create
from gam_ngs_tpu_torch.models.merge import MergeOptions, run_merge
from gam_ngs_tpu_torch.ops import region_score as rs
from gam_ngs_tpu_torch.ops.bsw_engine import BswEngine
from test_region_score import _pipeline_graphs

CPU = torch.device("cpu")
OUTPUTS = (".gam.fasta", ".pctgs", ".stats", ".noblocks.BF.fasta",
           ".noblocks.AF.fasta", ".notmerged.fasta")
quiet = lambda *_: None  # noqa: E731


def _mesh_problems():
    """tests/test_parallel.py::test_engine_sharded_over_mesh's 21
    problems (3 a device -> B=64 over 8 devices)."""
    rng = np.random.default_rng(31)
    probs = []
    for _ in range(21):
        a = rng.integers(0, 5, size=int(rng.integers(60, 200))).astype(
            np.uint8)
        b = a[5:].copy()
        m = rng.random(len(b)) < 0.05
        b[m] = (b[m] + 1) % 5
        probs.append((a, 0, len(a) - 1, b, 0, len(b) - 1, False, False))
    return probs


def test_engine_over_8_devices_matches_jax_mesh():
    probs = _mesh_problems()
    jeng = JaxEngine(band=20, mesh=device_mesh(8))
    want = jeng.align_many(probs)
    eng = BswEngine([CPU] * 8, band=20)
    got = eng.align_many(probs)
    assert eng.max_batch == jeng.max_batch == 512
    for g, w in zip(got, want):
        assert g.score == w.score and g.begin_a == w.begin_a
        assert g.edits.tolist() == w.edits.tolist()
    assert {k: eng.util[k] for k in jeng.util} == jeng.util
    # the plain walk takes a step an iteration
    assert eng.util["walk_iters"] == eng.util["walk_steps"] > 0
    assert eng.cells_aligned == jeng.cells_aligned
    # two window buckets, each chunk 8 rows a device; the shards past the
    # live problems are not dispatched
    assert eng.dispatches == 2 and eng.util["batch"] == 2 * 64
    assert eng.shard_runs[0] == 2 and eng.shard_runs[1] >= 1
    assert eng.shard_runs[-1] == 0


@pytest.mark.parametrize("kw", [{}, {"kernel": "row"}, {"traceback": "host"}],
                         ids=["antidiag", "row", "host"])
@pytest.mark.parametrize("max_batch", [64, 16])
def test_engine_over_8_devices_matches_one_device(kw, max_batch):
    problems = tp.soak_problems(40, seed=8, max_len=300)
    want = BswEngine(CPU, band=30, fetch="edits", max_batch=max_batch,
                     **kw).align_many(problems)
    eng = BswEngine([CPU] * 8, band=30, fetch="edits", max_batch=max_batch,
                    **kw)
    got = eng.align_many(problems)
    for k, (g, w) in enumerate(zip(got, want)):
        assert tp.same_alignment(g, w), k
    assert sum(v > 0 for v in eng.shard_runs) > 1
    assert eng.util["batch"] % 8 == 0


def test_engine_over_devices_resident_arena():
    """tests/test_parallel.py::test_engine_mesh_resident_arena on the
    port: the arena on every device, the problem rows sharded; forward
    and reverse-complement orientations oracle-exact."""
    eng = BswEngine([CPU] * 8, band=20, fetch="edits")
    rng = np.random.default_rng(41)
    contigs = [rng.integers(0, 5, size=int(rng.integers(80, 220))).astype(
        np.uint8) for _ in range(5)]
    eng.register_contigs(contigs)
    probs = []
    for k in range(11):
        a = contigs[k % 5]
        b0 = contigs[(k + 2) % 5]
        b = fasta.reverse_complement(b0) if k % 2 else b0
        probs.append((a, 0, len(a) - 1, b, 0, len(b) - 1, False,
                      k % 3 == 0))
    got = eng.align_many(probs)
    for g, p in zip(got, tp.oracle(probs, 20)):
        assert tp.same_alignment(g, p)
    assert eng.arena_problems == 11
    # four times over: more than 8 rows a bucket, so several shards
    got = eng.align_many(probs * 4)
    for g, p in zip(got, tp.oracle(probs * 4, 20)):
        assert tp.same_alignment(g, p)
    assert eng.arena_problems == 55
    assert sum(v > 0 for v in eng.shard_runs) > 1


@pytest.fixture(scope="module")
def region_corpus(tmp_path_factory):
    """tests/test_region_score.py's corpus read by each package."""
    tmp = tmp_path_factory.mktemp("region")
    jax_side = _pipeline_graphs(tmp)
    ml, sl = str(tmp / "m.list"), str(tmp / "s.list")
    blocks = run_create(CreateOptions(
        master_bam_file=ml, slave_bam_file=sl, min_block_size=10,
        output_file_prefix=str(tmp / "port"), engine="native"),
        log=quiet)
    master, slave = MultiBam.open(ml), MultiBam.open(sl)
    master.read_stats_from_file(ml + ".isize")
    slave.read_stats_from_file(sl + ".isize")
    return {"jax": jax_side, "port": (blocks, master, slave)}


def _jobs(corpus, side):
    asm, cmp_, par = ((assembly, compact, paired) if side == "port" else
                      (jax_assembly, jax_compact, jax_paired))
    blocks, master, slave = corpus[side]
    jobs = []
    for ag_id, rows in enumerate(
            par.partition_blocks_by_paired_contigs(blocks), start=1):
        cg = cmp_.CompactAssemblyGraph(asm.AssemblyGraph(blocks, rows, ag_id))
        jobs += cg.prepare_edge_weights(master, None, slave, None)
    return jobs


def test_count_jobs_over_devices(region_corpus, monkeypatch):
    """count_jobs over 4 devices: the chunks dealt out one a device equal
    one device's count and the JAX count over device_mesh(8)."""
    jobs = _jobs(region_corpus, "port")
    want = rs.count_jobs(jobs, CPU)
    assert want == jax_rs.count_jobs(_jobs(region_corpus, "jax"),
                                     mesh=device_mesh(8))
    # two distinct device keys, each dealt every other chunk (tensors on
    # cpu:1 live on the CPU: the column copies tell the devices apart)
    devs = [torch.device("cpu", 0), torch.device("cpu", 1)] * 2
    monkeypatch.setattr(rs, "LANES", 1)  # a chunk a device, however small
    seen = []
    plain = rs.count_resident

    def spy(cols, jobs_t, rows):
        seen.append(id(cols))
        return plain(cols, jobs_t, rows)

    monkeypatch.setattr(rs, "count_resident", spy)
    d0 = rs.WIRE["dispatches"]
    assert rs.count_jobs(jobs, devs) == want
    assert rs.WIRE["dispatches"] - d0 == len(seen) >= 2
    assert seen[0] != seen[1]
    assert seen == [seen[g % 2] for g in range(len(seen))]
    fin = rs.count_jobs(jobs, devs, defer=True)
    assert fin() == want


def test_resolve_devices(monkeypatch):
    """resolve_devices: every GPU for auto / cuda in one process, one for
    cuda:N and for each rank of a process group, the CPU by name, and an
    error without a GPU."""
    rd = device_mod.resolve_devices
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "GPU")
    monkeypatch.setattr(device_mod, "proc_info", lambda: (0, 1))
    for count in (1, 4):
        monkeypatch.setattr(torch.cuda, "device_count", lambda c=count: c)
        for name in ("auto", "cuda"):
            assert rd(name, multi_process=False) == tuple(
                torch.device("cuda", i) for i in range(count))
        assert rd("cuda:2", multi_process=False) == (torch.device("cuda", 2),)
    monkeypatch.setattr(device_mod, "proc_info", lambda: (5, 8))
    assert rd("auto", multi_process=True) == (torch.device("cuda", 1),)
    assert rd("cuda:3", multi_process=True) == (torch.device("cuda", 3),)
    assert rd("cpu", multi_process=False) == (CPU,)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("auto", "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA"):
            rd(name, multi_process=False)
    assert rd("cpu", multi_process=True) == (CPU,)


def test_merge_with_4_shard_engine_matches_one_device(tmp_path):
    """A whole merge with the engine (and edge count) over 4 devices
    writes the one-device merge's six outputs byte for byte."""
    genomes, ml, sl, mfa, sfa = tp.two_partition_corpus(tmp_path)
    run_create(CreateOptions(master_bam_file=ml, slave_bam_file=sl,
                             min_block_size=10,
                             output_file_prefix=str(tmp_path / "out"),
                             engine="native"), log=quiet)
    common = dict(master_bam_file=ml, slave_bam_file=sl,
                  blocks_file=str(tmp_path / "out.blocks"),
                  master_fasta_file=mfa, slave_fasta_file=sfa,
                  min_block_size=10)
    lines = []
    run_merge(MergeOptions(output_file_prefix=str(tmp_path / "one"),
                           engine=BswEngine(CPU), **common), log=quiet)
    eng = BswEngine([CPU] * 4)
    pctgs = run_merge(MergeOptions(output_file_prefix=str(tmp_path / "four"),
                                   engine=eng, **common), log=lines.append)
    for ext in OUTPUTS:
        assert (tmp_path / f"four{ext}").read_bytes() == \
            (tmp_path / f"one{ext}").read_bytes(), ext
    assert sorted(fasta.codes_to_bytes(p.sequence()).decode()
                  for p in pctgs) == sorted(genomes)
    assert "[merge] engine on 4 device(s): cpu, cpu, cpu, cpu" in lines
    assert eng.shard_runs[0] > 0
