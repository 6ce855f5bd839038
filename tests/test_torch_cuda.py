"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: these run only where torch sees a CUDA GPU and nvcc can
build gam_ngs_tpu_torch/csrc (on the H100: `python -m pytest
tests/test_torch_cuda.py -m cuda`); elsewhere they skip.  The kernel and
its plain version run the same integer recurrence, so every output is
compared bit for bit; the engine is held to bsw_ref.bsw_align exactly.
"""

import pytest
import torch

import torch_problems as tp
from gam_ngs_tpu_torch import cli
from gam_ngs_tpu_torch.ops import bsw_antidiag, bsw_row, bsw_walk
from gam_ngs_tpu_torch.ops.bsw_antidiag import (
    forward_antidiag,
    forward_antidiag_torch,
)
from gam_ngs_tpu_torch.ops.bsw_engine import BswEngine
from gam_ngs_tpu_torch.ops.bsw_row import forward_row, forward_row_torch
from gam_ngs_tpu_torch.ops.bsw_walk import ROW, walk, walk_torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA GPU: the CUDA kernels cannot run here (their "
                    "plain versions are tested in test_torch_bsw.py)")
    return torch.device("cuda")


def _inputs(problems, band, dev):
    a_pk, b_pk, scal, _preps, xw = tp.pack_problems(problems, band)
    a, b, s = (torch.from_numpy(v).to(dev) for v in (a_pk, b_pk, scal))
    return (a, b, *s.unbind(0)), xw


PROBLEM_SETS = {
    "soak256_band150": (150, lambda: tp.soak_problems(256)),
    "edges_band30": (30, tp.edge_problems),
    "soak32_band300": (300, lambda: tp.soak_problems(32, seed=7,
                                                     max_len=700)),
    # x_size 1 .. the window in one chunk, begin_a < 0 tails
    "ragged_band30": (30, lambda: tp.ragged_problems(30)),
    "ragged_band300": (300, lambda: tp.ragged_problems(300)),
    # last row and diagonal share the find-max maximum
    "ties_band30": (30, tp.tie_problems),
    "ties_band150": (150, tp.tie_problems),
}
# the first and last band of each warp instance of the row forward and
# of its block kernel of one lane a thread (160-511), and 512 (ragged and
# soak problems, rows past the exact ones included)
PROBLEM_SETS |= {f"bounds_band{band}": (band, lambda band=band:
                                        tp.boundary_problems(band))
                 for band in tp.row_boundary_bands()}
# the anti-diagonal forward's four warps per problem; the row forward's
# two lanes a thread
WIDE_SETS = {
    "soak8_band700": (700, lambda: tp.soak_problems(8, seed=3, max_len=600)),
}
# past the anti-diagonal forward's band 1023: the row forward's four and
# eight lanes a thread (the walk stages 16 word rows of 2*band+1 lanes and
# takes the row form's words up to band 1023)
ROW_ONLY_SETS = {
    "soak4_band2000": (2000, lambda: tp.soak_problems(4, seed=9,
                                                      max_len=400)),
    "soak4_band4000": (4000, lambda: tp.soak_problems(4, seed=4,
                                                      max_len=300)),
}


@pytest.mark.parametrize("name", sorted(PROBLEM_SETS | WIDE_SETS))
def test_kernels_match_plain(dev, name):
    band, make = (PROBLEM_SETS | WIDE_SETS)[name]
    (a, b, ba, ea, al, xs, fs, fe), xw = _inputs(make(), band, dev)
    n0 = (bsw_antidiag.launches, bsw_walk.launches)
    fwd = forward_antidiag(a, b, ba, ea, al, xs, fs, band)
    plain = forward_antidiag_torch(a, b, ba, ea, al, xs, fs, band)
    for k, p in zip(fwd, plain):
        assert torch.equal(k, p)
    dirs, last_row, diag = fwd
    lmax = -(-(2 * xw + 2 * band + 8) // 4) * 4
    for edits in (False, True):
        got = walk(dirs, a, b, ba, ea, xs, fe, last_row, diag, band, lmax,
                   edits)
        want = walk_torch(dirs, a, b, ba, ea, xs, fe, last_row, diag, band,
                          lmax, edits)
        assert torch.equal(got[0], want[0])
        assert (got[1] is None) == (not edits)
        if edits:
            assert torch.equal(got[1], want[1])
    torch.cuda.synchronize()
    assert (bsw_antidiag.launches, bsw_walk.launches) == (n0[0] + 1,
                                                          n0[1] + 2)


@pytest.mark.parametrize("name", sorted(PROBLEM_SETS | WIDE_SETS
                                         | ROW_ONLY_SETS))
def test_row_kernel_and_row_walk_match_plain(dev, name):
    band, make = (PROBLEM_SETS | WIDE_SETS | ROW_ONLY_SETS)[name]
    (a, b, ba, ea, al, xs, fs, fe), xw = _inputs(make(), band, dev)
    n0 = (bsw_row.launches, bsw_walk.launches)
    fwd = forward_row(a, b, ba, ea, al, xs, fs, band)
    plain = forward_row_torch(a, b, ba, ea, al, xs, fs, band)
    for k, p in zip(fwd, plain):
        assert torch.equal(k, p)
    if name in ROW_ONLY_SETS:
        torch.cuda.synchronize()
        assert bsw_row.launches == n0[0] + 1
        return
    dirs, last_row, diag = fwd
    lmax = -(-(2 * xw + 2 * band + 8) // 4) * 4
    for edits in (False, True):
        args = (dirs, a, b, ba, ea, xs, fe, last_row, diag, band, lmax,
                edits)
        got = walk(*args, layout=ROW)
        want = walk_torch(*args, layout=ROW)
        assert torch.equal(got[0], want[0])
        if edits:
            assert torch.equal(got[1], want[1])
    torch.cuda.synchronize()
    assert (bsw_row.launches, bsw_walk.launches) == (n0[0] + 1, n0[1] + 2)


@pytest.mark.parametrize("B", [1, 8, 9])
def test_kernels_take_any_batch(dev, B):
    """B problems straight to the wrappers, B not a multiple of the
    problems a block holds: both forwards and both walk layouts equal
    their plain versions."""
    (a, b, *scal), xw = _inputs(tp.soak_problems(12, seed=B), 150, dev)
    args = [v[:B].contiguous() for v in (a, b, *scal)]
    a, b, ba, ea, al, xs, fs, fe = args
    lmax = -(-(2 * xw + 300 + 8) // 4) * 4
    for fwd, plain, layout in ((forward_antidiag, forward_antidiag_torch, 0),
                               (forward_row, forward_row_torch, ROW)):
        got = fwd(a, b, ba, ea, al, xs, fs, 150)
        for k, p in zip(got, plain(a, b, ba, ea, al, xs, fs, 150)):
            assert k.shape[0] == B and torch.equal(k, p)
        wargs = (got[0], a, b, ba, ea, xs, fe, got[1], got[2], 150, lmax,
                 True)
        for k, p in zip(walk(*wargs, layout=layout),
                        walk_torch(*wargs, layout=layout)):
            assert torch.equal(k, p)


def test_engine_chunks_in_flight_match_bsw_align(dev):
    """256 soak problems in chunks of at most 32, spread over the
    engine's stream pool, held to bsw_align."""
    problems = tp.soak_problems(256)
    eng = BswEngine(dev, max_batch=32)
    got = eng.align_many(problems)
    for k, (g, w) in enumerate(zip(got, tp.oracle(problems, 150))):
        assert tp.same_alignment(g, w), k
    assert eng.dispatches >= 3
    assert len(eng._streams) == BswEngine.STREAMS > 1


@pytest.mark.parametrize("traceback,fetch", [
    ("device", "lean"), ("device", "edits"), ("host", "edits")])
def test_row_engine_matches_bsw_align(dev, traceback, fetch):
    problems = tp.soak_problems(256)
    eng = BswEngine(dev, fetch=fetch, kernel="row", traceback=traceback)
    n0 = BswEngine.kernel_launches()
    got = eng.align_many(problems)
    for k, (g, w) in enumerate(zip(got, tp.oracle(problems, 150))):
        assert tp.same_alignment(g, w), k
    n1 = BswEngine.kernel_launches()
    assert n1["bsw_row"] > n0["bsw_row"]
    assert n1["bsw_antidiag"] == n0["bsw_antidiag"]
    assert (n1["bsw_walk"] > n0["bsw_walk"]) == (traceback == "device")


def test_row_wrapper_raises_on_mixed_devices(dev):
    (a, b, ba, ea, al, xs, fs, fe), xw = _inputs(tp.soak_problems(4), 150,
                                                 dev)
    with pytest.raises(ValueError, match="begin_a"):
        forward_row(a, b, ba.cpu(), ea, al, xs, fs, 150)
    with pytest.raises(ValueError, match="band"):
        forward_row(a, b, ba, ea, al, xs, fs, 4096)
    dirs, last_row, diag = forward_row(a, b, ba, ea, al, xs, fs, 150)
    lmax = -(-(2 * xw + 300 + 8) // 4) * 4
    with pytest.raises(ValueError, match="a_pk"):
        walk(dirs, a.cpu(), b, ba, ea, xs, fe, last_row, diag, 150, lmax,
             False, layout=ROW)
    with pytest.raises(ValueError, match="dirs"):  # row words, antidiag walk
        walk(dirs, a, b, ba, ea, xs, fe, last_row, diag, 150, lmax, False)


@pytest.mark.parametrize("band,kw", [(700, {"kernel": "row"}),
                                     (2000, {"traceback": "host"})])
def test_wide_band_row_engine_matches_bsw_align(dev, band, kw):
    """The row forward's wide instances inside the engine: band 700 with
    the device walk, band 2000 with the host walk."""
    problems = tp.soak_problems(6, seed=3, max_len=1600 if band == 700
                                else 400)
    n0 = bsw_row.launches
    got = BswEngine(dev, band=band, **kw).align_many(problems)
    for k, (g, w) in enumerate(zip(got, tp.oracle(problems, band))):
        assert tp.same_alignment(g, w), k
    assert bsw_row.launches > n0


@pytest.mark.parametrize("fetch", ["lean", "edits"])
def test_engine_matches_bsw_align(dev, fetch):
    problems = tp.soak_problems(256)
    got = BswEngine(dev, fetch=fetch).align_many(problems)
    for k, (g, w) in enumerate(zip(got, tp.oracle(problems, 150))):
        assert tp.same_alignment(g, w), k


def test_wrapper_checks_inputs(dev):
    (a, b, ba, ea, al, xs, fs, _fe), _xw = _inputs(tp.soak_problems(4), 150,
                                                  dev)
    with pytest.raises(ValueError, match="begin_a"):
        forward_antidiag(a, b, ba.long(), ea, al, xs, fs, 150)
    with pytest.raises(ValueError, match="a_pk"):
        forward_antidiag(a[:, :-1], b, ba, ea, al, xs, fs, 150)
    with pytest.raises(ValueError, match="band"):
        forward_antidiag(a, b, ba, ea, al, xs, fs, 1024)


@pytest.mark.parametrize("corpus", ["junction", "fork_bubble"])
def test_cuda_merge_matches_oracle(dev, tmp_path, corpus):
    if corpus == "junction":
        _genome, ml, sl, mfa, sfa = tp.junction_corpus(tmp_path)
    else:
        ml, sl, mfa, sfa = tp.fork_bubble_corpus(tmp_path)
    assert cli.main(["create", "--master-bam", ml, "--slave-bam", sl,
                     "--min-block-size", "10", "--output",
                     str(tmp_path / "out")]) == 0
    for device in ("cuda", "oracle"):
        assert cli.main([
            "merge", "--master-bam", ml, "--slave-bam", sl, "--blocks-file",
            str(tmp_path / "out.blocks"), "--master-fasta", mfa,
            "--slave-fasta", sfa, "--min-block-size", "10", "--output",
            str(tmp_path / device), "--device", device]) == 0
    for ext in (".gam.fasta", ".pctgs", ".stats", ".noblocks.BF.fasta",
                ".noblocks.AF.fasta", ".notmerged.fasta"):
        assert (tmp_path / f"cuda{ext}").read_bytes() == \
            (tmp_path / f"oracle{ext}").read_bytes(), ext


def test_device_join_on_the_card_matches_native(dev):
    """join and analyze on the card: the blocks of scale_columns' 50x
    stream equal the native scan's and the CPU run's, and each ran once
    on the card."""
    from gam_ngs_tpu_torch.native.loader import find_blocks_native
    from gam_ngs_tpu_torch.ops import device_join

    m_cols, s_cols = tp.scale_columns(0.5, 2, seed=1)
    before = dict(device_join.launches)
    got = device_join.find_blocks_device(m_cols, s_cols, 10, device=dev)
    assert {k: device_join.launches[k] - before[k] for k in before} == {
        "join": 1, "analyze": 1}
    cpu = device_join.find_blocks_device(m_cols, s_cols, 10,
                                         device=torch.device("cpu"))
    nat = find_blocks_native(m_cols, s_cols, 10)
    for k in nat:
        assert (got[k] == nat[k]).all() and (got[k] == cpu[k]).all(), k


def test_payload_count_on_the_card(dev):
    """Row-payload edge-count jobs (GAM_RESIDENT=0) on the card against
    the exact host replica."""
    import numpy as np

    from gam_ngs_tpu_torch.ops import region_score as rs

    rng = np.random.default_rng(5)
    jobs = []
    for _ in range(9):
        n = int(rng.integers(0, 400))
        pos = rng.integers(0, 5000, n).astype(np.int32)
        jobs.append({
            "pos": pos, "end_pos": pos + rng.integers(50, 200, n).astype(
                np.int32),
            "flag": rng.choice([1, 17, 9, 33, 49], n).astype(np.int32),
            "nh": rng.choice([1, 1, 1, 2], n).astype(np.int32),
            "xt": np.full(n, ord("U"), np.int32),
            "ref_id": np.zeros(n, np.int32),
            "mate_ref": rng.choice([0, 0, 0, 1], n).astype(np.int32),
            "mate_pos": rng.integers(0, 6000, n).astype(np.int32),
            "goodq": np.ones(n, np.int32), "s1": 100, "s2": 4000,
            "t": 3000, "max_insert": 600, "seq_len": 9000, "no_mult": 0})
    got = rs.count_jobs(jobs, dev)
    assert got == [rs._count_job_host(j) for j in jobs]
    assert any(n for _g, _e, n in got)


@pytest.mark.parametrize("corpus", ["junction", "fork_bubble"])
def test_cuda_create_matches_native(dev, tmp_path, corpus):
    if corpus == "junction":
        _genome, ml, sl, _mfa, _sfa = tp.junction_corpus(tmp_path)
    else:
        ml, sl, _mfa, _sfa = tp.fork_bubble_corpus(tmp_path)
    out = {}
    for device in ("native", "cuda"):
        assert cli.main(["create", "--master-bam", ml, "--slave-bam", sl,
                         "--min-block-size", "10", "--output",
                         str(tmp_path / device), "--device", device]) == 0
        out[device] = [open(p, "rb").read() for p in (
            str(tmp_path / device) + ".blocks", ml + ".isize",
            sl + ".isize")]
    assert out["cuda"] == out["native"]
