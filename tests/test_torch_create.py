"""The port's device block construction (ops/device_join.py as torch ops,
here on the CPU), its multi-process create (parallel/create_dist.py in
in-process lockstep) and run_create with the CLI, against the JAX package's
find_blocks_device, its Python oracle find_blocks_from_columns, the
port's native scan and the JAX create_dist functions.  Blocks are held
column for column and files byte for byte; the moment-based library
stats within the tolerances of tests/test_create_dist.py."""

import copy
import pathlib

import numpy as np
import pytest
import torch

import torch_problems as tp
from gam_ngs_tpu.core.blocks import coverage_vectors as jax_coverage_vectors
from gam_ngs_tpu.core.blocks import find_blocks_from_columns
from gam_ngs_tpu.core.multibam import MultiBam as JaxMultiBam
from gam_ngs_tpu.core.stats import isize_stats_psum as jax_isize_stats_psum
from gam_ngs_tpu.ops.device_join import find_blocks_device as jax_fbd
from gam_ngs_tpu.parallel import create_dist as jax_cd
from gam_ngs_tpu_torch import cli
from gam_ngs_tpu_torch.core import blocks as blocks_mod
from gam_ngs_tpu_torch.core.multibam import MultiBam
from gam_ngs_tpu_torch.core.stats import isize_stats_psum
from gam_ngs_tpu_torch.models.create import CreateOptions, run_create
from gam_ngs_tpu_torch.native.loader import find_blocks_native, \
    native_available
from gam_ngs_tpu_torch.ops import device_join
from gam_ngs_tpu_torch.ops.device_join import find_blocks_device
from gam_ngs_tpu_torch.parallel import create_dist
from test_create_dist import CASES as DIST_CASES
from test_create_dist import run_lockstep
from test_device_join import CASES, _assert_same, _stream, _table_cols
from test_merge_pipeline import _build_inputs

CPU = torch.device("cpu")
quiet = lambda *_: None  # noqa: E731


def _check(m_cols, s_cols, mbs, ctx):
    """The port's join on the CPU == the JAX device join == the oracle;
    returns the port's columns."""
    got = find_blocks_device(m_cols, s_cols, mbs, device=CPU)
    _assert_same(got, _table_cols(find_blocks_from_columns(m_cols, s_cols,
                                                           mbs)), ctx)
    _assert_same(got, jax_fbd(m_cols, s_cols, mbs), ctx + " (jax)")
    return got


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_join_matches_jax_and_oracle(case, seed):
    n, n_ctg, span, lo, hi, names, mbs = CASES[case]
    rng = np.random.default_rng(1000 * case + seed)
    m_cols = _stream(rng, n, n_ctg, span, lo, hi, names)
    s_cols = _stream(rng, n, n_ctg, span, lo, hi, names)
    _check(m_cols, s_cols, mbs, f"case={case} seed={seed}")


@pytest.mark.parametrize("mbs", [1, 3, 10, 25, 60])
def test_min_block_size_sweep(mbs):
    rng = np.random.default_rng(77)
    m_cols = _stream(rng, 700, 3, 600, 8, 70, 200)
    s_cols = _stream(rng, 700, 3, 600, 8, 70, 200)
    stats: dict = {}
    jax_stats: dict = {}
    find_blocks_device(m_cols, s_cols, mbs, stats=stats, device=CPU)
    jax_fbd(m_cols, s_cols, mbs, stats=jax_stats)
    _check(m_cols, s_cols, mbs, f"mbs={mbs}")
    assert stats == jax_stats and stats["matched_reads"] > 0


def test_three_way_with_native():
    if not native_available():
        pytest.skip("native gamio unavailable")
    rng = np.random.default_rng(5)
    m_cols = _stream(rng, 900, 3, 800, 10, 80, 250)
    s_cols = _stream(rng, 900, 3, 800, 10, 80, 250)
    for mbs in (2, 15, 50):
        got = _check(m_cols, s_cols, mbs, f"mbs={mbs}")
        _assert_same(find_blocks_native(m_cols, s_cols, mbs), got,
                     f"native mbs={mbs}")


def test_empty_inputs_and_no_matches():
    z = (np.zeros(0, np.uint64), np.zeros(0, np.uint64),
         np.zeros(0, np.uint8), np.zeros(0, np.int32),
         np.zeros(0, np.int32), np.zeros(0, np.int32),
         np.zeros(0, np.uint8))
    rng = np.random.default_rng(0)
    s = _stream(rng, 50, 1, 100, 20, 30, 20)
    assert len(find_blocks_device(z, s, 1, device=CPU)["num_reads"]) == 0
    assert len(find_blocks_device(s, z, 1, device=CPU)["num_reads"]) == 0
    rng = np.random.default_rng(9)
    m = _stream(rng, 100, 1, 200, 20, 30, 50)
    s = list(_stream(rng, 100, 1, 200, 20, 30, 50))
    s[0] = s[0] + np.uint64(10 ** 12)  # disjoint name space
    assert len(find_blocks_device(m, tuple(s), 1,
                                  device=CPU)["num_reads"]) == 0


def _cols(rows, h1_of=lambda name: name * np.uint64(7919) + np.uint64(3)):
    """rows: (name, first, ctg, pos, end, rev) -> stream columns."""
    name = np.array([r[0] for r in rows], np.uint64)
    return (h1_of(name), name ^ np.uint64(0xABCDEF),
            np.array([r[1] for r in rows], np.uint8),
            np.array([r[2] for r in rows], np.int32),
            np.array([r[3] for r in rows], np.int32),
            np.array([r[4] for r in rows], np.int32),
            np.array([r[5] for r in rows], np.uint8))


def test_carry_chain_across_runs():
    """A short unmatched read leaves an empty slot that the next run's
    first read seeds (its strand evidence counts)."""
    master = _cols([(1, 1, 0, 100, 104, 0), (2, 1, 0, 200, 260, 0),
                    (3, 1, 0, 210, 270, 1)])
    slave = _cols([(1, 1, 0, 10, 14, 0), (2, 1, 0, 500, 560, 1),
                   (3, 1, 0, 510, 570, 1)])
    for mbs in (1, 5, 10):
        _check(master, slave, mbs, f"carry mbs={mbs}")


def test_repeated_master_name_last_write_wins():
    """A name twice in the master stream: the reference's map keeps the
    last row, so the slave reads join the second placement."""
    master = _cols([(1, 1, 0, 100, 160, 0), (2, 1, 0, 110, 170, 0),
                    (1, 1, 1, 500, 560, 0), (2, 1, 1, 510, 570, 0),
                    (3, 1, 1, 520, 580, 1)])
    slave = _cols([(1, 1, 0, 10, 70, 0), (2, 1, 0, 20, 80, 0),
                   (3, 1, 0, 30, 90, 1)])
    for mbs in (1, 2):
        got = _check(master, slave, mbs, f"mbs={mbs}")
        assert set(got["m_ctg"].tolist()) == {1}


def test_hashes_above_2_63():
    """Name hashes >= 2^63 are negative as int64 on the device: keys of
    both signs still meet only their own (and mates stay apart)."""
    rng = np.random.default_rng(3)
    m_cols = list(_stream(rng, 600, 2, 500, 20, 60, 150))
    s_cols = list(_stream(rng, 600, 2, 500, 20, 60, 150))
    top = np.uint64(1 << 63)
    for cols in (m_cols, s_cols):
        flip = (cols[1] & np.uint64(1)) == 1  # about half the names
        cols[0] = np.where(flip, cols[0] | top, cols[0] & ~top)
        cols[1] = cols[1] | top
    assert (m_cols[0] >= top).any() and (m_cols[0] < top).any()
    for mbs in (2, 20):
        got = _check(tuple(m_cols), tuple(s_cols), mbs, f"mbs={mbs}")
        assert len(got["num_reads"])


def test_seg_scan_max_matches_a_loop():
    rng = np.random.default_rng(8)
    seg = np.sort(rng.integers(0, 30, 500))
    val = rng.integers(-(2 ** 31), 2 ** 31, 500)
    got = device_join.seg_scan_max(torch.from_numpy(seg),
                                   torch.from_numpy(val)).numpy()
    exc = device_join.exclusive(torch.from_numpy(seg),
                                torch.from_numpy(got), -7).numpy()
    run = None
    for i in range(500):
        run = val[i] if i == 0 or seg[i] != seg[i - 1] else max(run, val[i])
        assert got[i] == run
        assert exc[i] == (got[i - 1] if i and seg[i] == seg[i - 1] else -7)


@pytest.mark.parametrize("n", [0, 1, 1024, 1025, 5000, 1024 * 1024 + 3])
def test_two_level_cummax(n):
    x = torch.from_numpy(np.random.default_rng(n).integers(
        -(2 ** 62), 2 ** 62, n))
    want = torch.cummax(x, 0).values if n else x
    assert torch.equal(device_join.cummax(x), want)


def test_cpu_runs_count_no_launches():
    rng = np.random.default_rng(1)
    m_cols = _stream(rng, 200, 2, 300, 30, 60, 80)
    s_cols = _stream(rng, 200, 2, 300, 30, 60, 80)
    before = dict(device_join.launches)
    find_blocks_device(m_cols, s_cols, 5, device=CPU)
    assert device_join.launches == before == {
        "join": before["join"], "analyze": before["analyze"]}


def test_scale_columns_are_the_scale_corpus_streams(tmp_path):
    """tests/torch_problems.py::scale_columns at the corpus's stride is
    stream_columns of scale_corpus's BAMs (the names hashed another way,
    the same rows sharing a name), and the join on its 50x columns equals
    the native scan."""
    c = tp.scale_corpus(0.3, tmp_path)
    cols = tp.scale_columns(0.3, 25)
    for side, lst in zip(cols, (c["ml"], c["sl"])):
        want = blocks_mod.stream_columns(MultiBam.open(lst), False)
        for k in range(2, 7):
            np.testing.assert_array_equal(np.asarray(side[k], np.int64),
                                          np.asarray(want[k], np.int64))
        for k in (0, 1):
            _, a = np.unique(side[k], return_inverse=True)
            _, b = np.unique(want[k], return_inverse=True)
            # equal names <-> equal hashes, row for row
            pairs = set(zip(a.tolist(), b.tolist()))
            assert len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))
    m_cols, s_cols = tp.scale_columns(0.2, 2, seed=4)
    assert len(s_cols[0]) > 190_000
    got = find_blocks_device(m_cols, s_cols, 10, device=CPU)
    _assert_same(got, find_blocks_native(m_cols, s_cols, 10), "stride 2")
    assert len(got["num_reads"]) >= 7


# ---- multi-process create in lockstep threads ----------------------------

def _dist(m_cols, s_cols, mbs, nproc, pkg):
    if pkg == "port":
        fn = lambda pid, g: create_dist.distributed_find_blocks(  # noqa
            m_cols, s_cols, mbs, pid, nproc, _allgather=g, device=CPU)
    else:
        fn = lambda pid, g: jax_cd.distributed_find_blocks(  # noqa
            m_cols, s_cols, mbs, pid, nproc, _allgather=g)
    return run_lockstep(fn, nproc)


@pytest.mark.parametrize("case", range(len(DIST_CASES)))
@pytest.mark.parametrize("nproc", [2, 3])
def test_distributed_find_blocks(case, nproc):
    n, n_ctg, span, lo, hi, names, mbs = DIST_CASES[case]
    rng = np.random.default_rng(4000 + case)
    m_cols = _stream(rng, n, n_ctg, span, lo, hi, names)
    s_cols = _stream(rng, n, n_ctg, span, lo, hi, names)
    want = find_blocks_device(m_cols, s_cols, mbs, device=CPU)
    jax_got = _dist(m_cols, s_cols, mbs, nproc, "jax")
    for pid, got in enumerate(_dist(m_cols, s_cols, mbs, nproc, "port")):
        ctx = f"case={case} nproc={nproc} pid={pid}"
        _assert_same(got, want, ctx)
        _assert_same(got, jax_got[pid], ctx + " (jax)")


@pytest.mark.parametrize("nproc", [2, 4, 7])
def test_distributed_blocks_min_block_sweep(nproc):
    """Empty-slot carries landing on shard boundaries, against the
    oracle."""
    rng = np.random.default_rng(99)
    m_cols = _stream(rng, 700, 6, 400, 8, 70, 200)
    s_cols = _stream(rng, 700, 6, 400, 8, 70, 200)
    for mbs in (1, 10, 25, 60):
        want = _table_cols(find_blocks_from_columns(m_cols, s_cols, mbs))
        got = _dist(m_cols, s_cols, mbs, nproc, "port")
        _assert_same(got[0], want, f"mbs={mbs} nproc={nproc}")


def test_distributed_find_blocks_more_procs_than_contigs():
    rng = np.random.default_rng(7)
    m_cols = _stream(rng, 200, 1, 200, 20, 40, 60)
    s_cols = _stream(rng, 200, 1, 200, 20, 40, 60)
    want = find_blocks_device(m_cols, s_cols, 3, device=CPU)
    for got in _dist(m_cols, s_cols, 3, 4, "port"):
        _assert_same(got, want, "1 contig, 4 procs")


@pytest.fixture(scope="module")
def lists(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("create")
    _genome, ml, sl, mfa, sfa = _build_inputs(tmp)
    return tmp, ml, sl


def test_distributed_library_stats(lists):
    _tmp, ml, _sl = lists
    mb, jmb = MultiBam.open(ml), JaxMultiBam.open(ml)
    mb.compute_statistics(require_paired_flag=True)
    want = (list(mb.isize_mean), list(mb.isize_std), list(mb.coverage))
    nproc = 3

    def job(pkg):
        def run(pid, gather):
            if pkg == "port":
                my = copy.copy(mb)
                create_dist.distributed_library_stats(
                    my, True, pid, nproc, _allgather=gather, device=CPU)
            else:
                my = copy.copy(jmb)
                jax_cd.distributed_library_stats(my, True, pid, nproc,
                                                 _allgather=gather)
            return my.isize_mean, my.isize_std, my.coverage
        return run

    jax_res = run_lockstep(job("jax"), nproc)
    for (mean, std, cov), (jmean, jstd, jcov) in zip(
            run_lockstep(job("port"), nproc), jax_res):
        np.testing.assert_allclose(mean, want[0], rtol=1e-9)
        np.testing.assert_allclose(std, want[1], rtol=1e-6)
        np.testing.assert_allclose(cov, want[2], rtol=1e-12)
        np.testing.assert_allclose(mean, jmean, rtol=1e-9)
        np.testing.assert_allclose(std, jstd, rtol=1e-6)
        np.testing.assert_allclose(cov, jcov, rtol=1e-12)


@pytest.mark.parametrize("nproc", [2, 3])
def test_distributed_coverage_vectors(lists, nproc):
    _tmp, ml, _sl = lists
    mb = MultiBam.open(ml)
    want = jax_coverage_vectors(JaxMultiBam.open(ml), False)
    assert len(want) < nproc + 1  # nproc 3: more processes than contigs
    for got in run_lockstep(
            lambda pid, g: create_dist.distributed_coverage_vectors(
                mb, False, pid, nproc, _allgather=g), nproc):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_isize_stats_psum_matches_jax(tmp_path):
    """Float64 moments on the tensor's device against the JAX version
    (float32 unless x64 is on), alone, summed over three lockstep
    processes each holding part of the inserts, and through
    allgather_obj over a one-process gloo group."""
    import torch.distributed as dist

    from gam_ngs_tpu_torch.parallel.distributed import allgather_obj

    rng = np.random.default_rng(12)
    ins = rng.integers(150, 260, 5000)
    mean, std, n = isize_stats_psum(torch.from_numpy(ins))
    jmean, jstd, jn = (float(v) for v in jax_isize_stats_psum(ins))
    assert mean.dtype == torch.float64 and float(n) == jn == 5000
    np.testing.assert_allclose(float(mean), jmean, rtol=1e-6)
    np.testing.assert_allclose(float(std), jstd, rtol=1e-4)
    x = ins.astype(np.float64)
    np.testing.assert_allclose(float(std), np.sqrt(
        (np.sum(x * x) - len(x) * x.mean() ** 2) / (len(x) + 1)), rtol=1e-9)
    parts = np.split(ins, [1000, 1000])  # the middle process holds none
    for got in run_lockstep(lambda pid, g: isize_stats_psum(
            torch.from_numpy(parts[pid]), allgather=g), 3):
        assert float(got[2]) == 5000
        np.testing.assert_allclose(float(got[0]), float(mean), rtol=1e-12)
        np.testing.assert_allclose(float(got[1]), float(std), rtol=1e-9)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        got = isize_stats_psum(torch.from_numpy(ins), allgather=allgather_obj)
    finally:
        dist.destroy_process_group()
    assert [float(v) for v in got] == [float(mean), float(std), float(n)]
    zero = isize_stats_psum(torch.zeros(0, dtype=torch.int64))
    assert [float(v) for v in zero] == [0.0, 0.0, 0.0]


# ---- run_create and the CLI --------------------------------------------

def _files(prefix, ml, sl) -> tuple:
    return tuple(pathlib.Path(p).read_bytes()
                 for p in (prefix + ".blocks", ml + ".isize", sl + ".isize"))


@pytest.mark.parametrize("corpus", ["junction", "fork_bubble"])
def test_cli_create_device_cpu_matches_native(tmp_path, corpus):
    if corpus == "junction":
        _g, ml, sl, _mfa, _sfa = tp.junction_corpus(tmp_path)
    else:
        ml, sl, _mfa, _sfa = tp.fork_bubble_corpus(tmp_path)
    out = {}
    for dev in ("native", "cpu", "oracle"):
        assert cli.main(["create", "--master-bam", ml, "--slave-bam", sl,
                         "--min-block-size", "10", "--output",
                         str(tmp_path / dev), "--device", dev]) == 0
        out[dev] = _files(str(tmp_path / dev), ml, sl)
    assert out["cpu"] == out["native"] == out["oracle"]
    assert out["cpu"][0].count(b"\n") > 2


def test_create_auto_never_falls_back_to_the_host(tmp_path, monkeypatch):
    """auto is the device join on cuda, as merge's auto is: with no GPU
    it raises whether or not the native library is there, and neither
    host scan runs; given a device it writes what native does."""
    _g, ml, sl, _mfa, _sfa = tp.junction_corpus(tmp_path)
    assert cli.main(["create", "--master-bam", ml, "--slave-bam", sl,
                     "--min-block-size", "10", "--output",
                     str(tmp_path / "native"), "--device", "native"]) == 0
    want = _files(str(tmp_path / "native"), ml, sl)
    opts = CreateOptions(master_bam_file=ml, slave_bam_file=sl,
                         min_block_size=10,
                         output_file_prefix=str(tmp_path / "auto"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(blocks_mod, "find_blocks",
                        lambda *a: pytest.fail("oracle scan ran"))
    monkeypatch.setattr(blocks_mod, "find_blocks_fast",
                        lambda *a: pytest.fail("native scan ran"))
    for no_native in ("1", None):
        if no_native:
            monkeypatch.setenv("GAM_NO_NATIVE", no_native)
        else:
            monkeypatch.delenv("GAM_NO_NATIVE", raising=False)
        with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
            run_create(opts, log=quiet)
        with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
            cli.main(["create", "--master-bam", ml, "--slave-bam", sl,
                      "--output", str(tmp_path / "auto"), "--device",
                      "auto"])
        assert not (tmp_path / "auto.blocks").exists()
    import gam_ngs_tpu_torch.device as device_mod

    seen = []
    monkeypatch.setattr(device_mod, "resolve_device",
                        lambda name: seen.append(name) or CPU)
    run_create(opts, log=quiet)
    assert seen == ["auto"]
    assert _files(str(tmp_path / "auto"), ml, sl) == want
    with pytest.raises(ValueError, match="needs a torch device"):
        run_create(CreateOptions(engine="device"), log=quiet)
    with pytest.raises(SystemExit):  # tpu is not a device of the port
        cli.main(["create", "--master-bam", ml, "--slave-bam", sl,
                  "--device", "tpu"])
