"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: these run only where torch sees a CUDA GPU and nvcc can
build gam_ngs_tpu_torch/csrc (on the H100: `python -m pytest
tests/test_torch_cuda.py -m cuda`); elsewhere they skip.  The kernel and
its plain version run the same integer recurrence, so every output is
compared bit for bit; the engine is held to bsw_ref.bsw_align exactly.
"""

import numpy as np
import pytest
import torch

import torch_problems as tp
from gam_ngs_tpu_torch import cli
from gam_ngs_tpu_torch.ops import (
    arena_gather,
    bsw_antidiag,
    bsw_row,
    bsw_walk,
)
from gam_ngs_tpu_torch.ops.arena_gather import (
    gather_windows,
    gather_windows_torch,
)
from gam_ngs_tpu_torch.ops.bsw_antidiag import (
    MAX_BAND as ANTIDIAG_MAX_BAND,
    a_width,
    forward_antidiag,
    forward_antidiag_torch,
)
from gam_ngs_tpu_torch.ops.bsw_engine import BswEngine
from gam_ngs_tpu_torch.ops.bsw_row import (
    MAX_BAND,
    forward_row,
    forward_row_torch,
)
from gam_ngs_tpu_torch.ops.bsw_walk import (
    ANSWER_ROWS,
    ANTIDIAG,
    ITERS,
    ROW,
    WIDE_RING_BAND,
    walk,
    walk_torch,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA GPU: the CUDA kernels cannot run here (their "
                    "plain versions are tested in test_torch_bsw.py)")
    return torch.device("cuda")


def same_walk(got, want) -> bool:
    """The kernel's walk (summary, edits) against the plain version's:
    the answer rows and the edit codes bit for bit, and its iterations
    between 1 and its steps where it stepped."""
    iters, cnt = got[0][ITERS], got[0][2]
    return (torch.equal(got[0][:ANSWER_ROWS], want[0][:ANSWER_ROWS])
            and bool((iters <= cnt).all())
            and bool(((iters > 0) == (cnt > 0)).all())
            and (got[1] is None) == (want[1] is None)
            and (got[1] is None or torch.equal(got[1], want[1])))


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
# the first and last band of each instance of the row forward, one warp
# (up to band 159), several warps in a block (160-767) or a cluster of
# blocks (768-4095) (ragged and soak problems, rows past the exact ones
# included): the row forward and its walk at every band, the
# anti-diagonal forward and its walk up to band 1023
BOUNDS_SETS = {f"bounds_band{band}": (band, lambda band=band:
                                      tp.boundary_problems(band))
               for band in tp.row_boundary_bands()}
PROBLEM_SETS |= {k: v for k, v in BOUNDS_SETS.items()
                 if v[0] <= ANTIDIAG_MAX_BAND}
# the anti-diagonal forward's four warps per problem; the row forward's
# sixteen warps of three lanes
WIDE_SETS = {
    "soak8_band700": (700, lambda: tp.soak_problems(8, seed=3, max_len=600)),
}
# past the anti-diagonal forward's band 1023: the row forward's clusters
# of two and eight blocks, and the walk over their words on its 3-row
# ring (from band 1024)
ROW_ONLY_SETS = {
    "soak4_band2000": (2000, lambda: tp.soak_problems(4, seed=9,
                                                      max_len=400)),
    "soak4_band4000": (4000, lambda: tp.soak_problems(4, seed=4,
                                                      max_len=300)),
} | {k: v for k, v in BOUNDS_SETS.items() if v[0] > ANTIDIAG_MAX_BAND}


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
        assert same_walk(got, want)
        assert (got[1] is None) == (not edits)
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
    dirs, last_row, diag = fwd
    lmax = -(-(2 * xw + 2 * band + 8) // 4) * 4
    for edits in (False, True):
        args = (dirs, a, b, ba, ea, xs, fe, last_row, diag, band, lmax,
                edits)
        got = walk(*args, layout=ROW)
        want = walk_torch(*args, layout=ROW)
        assert same_walk(got, want)
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
        assert same_walk(walk(*wargs, layout=layout),
                         walk_torch(*wargs, layout=layout))


def _one_warp_batch() -> int:
    """The least batch past 64 at which the forward's launcher takes one
    warp a problem at band 150 on this card: past the crossover."""
    return next(B for B in range(65, 1 << 16)
                if bsw_antidiag.instance(150, B)[0] == 1)


def _tiled(args, B):
    """The forward's inputs of the first problems, repeated to B rows."""
    n = args[0].shape[0]
    idx = torch.arange(B, device=args[0].device) % n
    return [v[idx].contiguous() for v in args]


@pytest.mark.parametrize("band", [70, 150, 300, 400, 511])
def test_split_and_one_warp_forwards_match_plain(dev, band):
    """The seam problems (tp.seam_problems) at B = 1, 8, 64 and the least
    batch at which the launcher takes one warp a problem at band 150: the
    split instance (R = 1 to 5 lanes a thread at these bands) at the
    small batches, and at the large one one warp below band 160 and the
    split from band 160, each equal to the plain version bit for bit,
    and the rows that two launches share equal to each other."""
    (a, b, ba, ea, al, xs, fs, _fe), _xw = _inputs(
        tp.seam_problems(band, 8, seed=band), band, dev)
    args = (a, b, ba, ea, al, xs, fs)
    plain = forward_antidiag_torch(*(v.cpu() for v in args), band)
    big = _one_warp_batch()
    taken, outs = set(), {}
    for B in (1, 8, 64, big):
        got = forward_antidiag(*_tiled(args, B), band)
        idx = torch.arange(B) % a.shape[0]
        for k, p in zip(got, plain):
            assert torch.equal(k.cpu(), p[idx]), (B, band)
        taken.add(bsw_antidiag.instance(band, B)[0])
        outs[B] = [k[:1].cpu() for k in got]
    assert taken == ({1, 4} if band < 160 else {4}), taken
    for B in (8, 64, big):
        assert all(torch.equal(x, y) for x, y in zip(outs[B], outs[1]))


def test_split_forward_on_a_90000_row_window(dev):
    """One problem of 90,000 rows at band 150 (the cell's longest
    windows): the split instance of B = 1 equals the plain version and
    the one-warp launch of the same problem repeated past the crossover,
    bit for bit."""
    (a, b, ba, ea, al, xs, fs, _fe), _xw = _inputs(
        tp.seam_problems(150, 1, seed=90, longest=90000), 150, dev)
    args = [v[:1].contiguous() for v in (a, b, ba, ea, al, xs, fs)]
    assert bsw_antidiag.instance(150, 1)[0] > 1
    split = forward_antidiag(*args, 150)
    for k, p in zip(split, forward_antidiag_torch(*(v.cpu() for v in args),
                                                  150)):
        assert torch.equal(k.cpu(), p)
    big = _one_warp_batch()
    one = forward_antidiag(*_tiled(args, big), 150)
    for k, s in zip(one, split):
        assert torch.equal(k[:1], s) and torch.equal(k[-1:], s)


@pytest.mark.parametrize("band", [30, 70, 150, 300, 400, 511, 700])
def test_forward_instance_is_the_launch_taken(dev, band):
    """bsw_antidiag.instance(band, B) names the kernel a launch runs (its
    template arguments <R, W, split> in the profiler's kernel name), and
    split_launches counts the launches of the split instance."""
    from torch.profiler import ProfilerActivity, profile

    (a, b, ba, ea, al, xs, fs, _fe), _xw = _inputs(
        tp.soak_problems(8, seed=band), band, dev)
    args = (a, b, ba, ea, al, xs, fs)
    for B in (1, 8, _one_warp_batch()):
        w, r = bsw_antidiag.instance(band, B)
        n0 = (bsw_antidiag.launches, bsw_antidiag.split_launches)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            forward_antidiag(*_tiled(args, B), band)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if "antidiag_forward_kernel" in e.key]
        # four warps a step apart, not the split, past band 511
        split = w > 1 and band < 512
        assert len(names) == 1 and (
            f"<{r}, {w}, {str(split).lower()}>" in names[0]), (
            B, names, (w, r))
        assert (bsw_antidiag.launches, bsw_antidiag.split_launches) == (
            n0[0] + 1, n0[1] + split)


def test_engine_counts_split_forwards(dev):
    """BswEngine.util["fwd_split"] counts the live problems whose forward
    ran the split instance: every one in chunks of at most 64, none in
    one chunk past the crossover; the answers equal bsw_align's."""
    rng = np.random.default_rng(5)
    problems = []
    for _ in range(300):  # one window bucket
        a = rng.integers(0, 4, size=400).astype(np.uint8)
        bb = tp.mutate(rng, a[150:250])[:90]
        problems.append((a, 150, 249, bb, 0, len(bb) - 1, False, False))
    want = tp.oracle(problems, 150)
    small = BswEngine(dev)
    big = BswEngine(dev, max_batch=512)  # one chunk of B = 512
    assert bsw_antidiag.instance(150, 512)[0] == 1
    for eng in (small, big):
        got = eng.align_many(problems)
        for k, (g, w) in enumerate(zip(got, want)):
            assert tp.same_alignment(g, w), k
    assert small.util["fwd_split"] == small.util["live"] == 300
    assert big.dispatches == 1 and big.util["fwd_split"] == 0


@pytest.mark.parametrize("layout,band", [
    (ANTIDIAG, 30), (ANTIDIAG, 150), (ANTIDIAG, 1023), (ROW, 30),
    (ROW, 150), (ROW, WIDE_RING_BAND - 1), (ROW, WIDE_RING_BAND),
    (ROW, 2047), (ROW, 4095)])
def test_walk_runs_match_plain(dev, layout, band):
    """Near-identical windows (tp.run_problems: the walk's diagonal runs,
    cut by indels at word rows' and lookaheads' edges, by row 0, by the
    band's lower edge and by lmax) over the kernel forward's words, with
    and without edit codes and with lmax cut to 1001: the kernel's walk
    equals the plain version's, where its lookahead's loads land late
    and its ring's copies too."""
    rows = 4000 if band <= WIDE_RING_BAND else 1500
    (a, b, ba, ea, al, xs, fs, fe), xw = _inputs(
        tp.run_problems(band, rows), band, dev)
    fwd = forward_row if layout == ROW else forward_antidiag
    dirs, last_row, diag = fwd(a, b, ba, ea, al, xs, fs, band)
    full = -(-(2 * xw + 2 * band + 8) // 4) * 4
    for edits, lmax in ((False, full), (True, full), (True, 1001)):
        args = (dirs, a, b, ba, ea, xs, fe, last_row, diag, band, lmax,
                edits)
        got = walk(*args, layout=layout)
        assert same_walk(got, walk_torch(*args, layout=layout)), (edits,
                                                                  lmax)
    assert int(got[0][ITERS].sum()) * 10 < int(got[0][2].sum())


@pytest.mark.parametrize("kernel", ["auto", "row"])
def test_engine_counts_walk_iterations(dev, kernel):
    """On near-identical windows the engine's walk_iters fall far below
    its walk_steps (the kernel takes a diagonal run an iteration), and
    its answers equal bsw_align's."""
    problems = tp.run_problems(150, 3000)
    eng = BswEngine(dev, kernel=kernel)
    got = eng.align_many(problems)
    for k, (g, w) in enumerate(zip(got, tp.oracle(problems, 150))):
        assert tp.same_alignment(g, w), k
    assert 0 < 10 * eng.util["walk_iters"] < eng.util["walk_steps"]


def test_engine_chunks_in_flight_match_bsw_align(dev):
    """256 soak problems in chunks of at most 32, spread over the
    engine's stream pool, held to bsw_align."""
    problems = tp.soak_problems(256)
    eng = BswEngine(dev, max_batch=32)
    got = eng.align_many(problems)
    for k, (g, w) in enumerate(zip(got, tp.oracle(problems, 150))):
        assert tp.same_alignment(g, w), k
    assert eng.dispatches >= 3
    assert [len(v) for v in eng._streams.values()] == [BswEngine.STREAMS]
    assert BswEngine.STREAMS > 1


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
                                     (2000, {"traceback": "host"}),
                                     (0, {"kernel": "row"}),
                                     (2000, {"kernel": "row"}),
                                     (MAX_BAND, {"kernel": "row"})])
def test_wide_band_row_engine_matches_bsw_align(dev, band, kw):
    """The row forward's instances inside the engine: band 0, 700, 2000
    and 4095 with the device walk (its 3-row ring from band 1024 on),
    band 2000 with the host walk."""
    problems = tp.soak_problems(6, seed=3, max_len=1600 if band == 700
                                else 400)
    n0 = (bsw_row.launches, bsw_walk.launches)
    eng = BswEngine(dev, band=band, **kw)
    got = eng.align_many(problems)
    for k, (g, w) in enumerate(zip(got, tp.oracle(problems, band))):
        assert tp.same_alignment(g, w), k
    torch.cuda.synchronize()
    assert bsw_row.launches > n0[0]
    assert (bsw_walk.launches > n0[1]) == (eng.traceback == "device")


@pytest.mark.parametrize("fetch", ["lean", "edits"])
def test_engine_matches_bsw_align(dev, fetch):
    problems = tp.soak_problems(256)
    got = BswEngine(dev, fetch=fetch).align_many(problems)
    for k, (g, w) in enumerate(zip(got, tp.oracle(problems, 150))):
        assert tp.same_alignment(g, w), k


def test_wrapper_checks_inputs(dev):
    (a, b, ba, ea, al, xs, fs, fe), xw = _inputs(tp.soak_problems(4), 150,
                                                dev)
    with pytest.raises(ValueError, match="begin_a"):
        forward_antidiag(a, b, ba.long(), ea, al, xs, fs, 150)
    with pytest.raises(ValueError, match="a_pk"):
        forward_antidiag(a[:, :-1], b, ba, ea, al, xs, fs, 150)
    with pytest.raises(ValueError, match="band"):
        forward_antidiag(a, b, ba, ea, al, xs, fs, 1024)
    # a band past each walk layout's bound raises before any launch
    dirs, last_row, diag = forward_antidiag(a, b, ba, ea, al, xs, fs, 150)
    lmax = -(-(2 * xw + 300 + 8) // 4) * 4
    n0 = bsw_walk.launches
    for band, layout in ((ANTIDIAG_MAX_BAND + 1, 0), (MAX_BAND + 1, ROW),
                         (-1, ROW)):
        with pytest.raises(ValueError, match=f"band {band}:"):
            walk(dirs, a, b, ba, ea, xs, fe, last_row, diag, band, lmax,
                 False, layout=layout)
    assert bsw_walk.launches == n0


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


@pytest.mark.parametrize("band", [30, 150])
def test_arena_gather_matches_plain_and_host(dev, band):
    """The gather kernel on the arena soak: bit for bit the plain
    version's bytes and the host's packed windows."""
    contigs, problems = tp.arena_problems(256)
    arena, cols, a_pk, b_pk, xw = tp.arena_chunk(contigs, problems, band)
    args = (torch.from_numpy(arena), torch.from_numpy(cols), band,
            a_width(xw, band), xw)
    n0 = arena_gather.launches
    ga, gb = gather_windows(args[0].to(dev), args[1].to(dev), *args[2:])
    torch.cuda.synchronize()
    assert arena_gather.launches == n0 + 1
    pa, pb = gather_windows_torch(*args)
    assert torch.equal(ga.cpu(), pa) and torch.equal(gb.cpu(), pb)
    assert torch.equal(pa, torch.from_numpy(a_pk))
    assert torch.equal(pb, torch.from_numpy(b_pk))


@pytest.mark.parametrize("band", [30, 150])
def test_arena_gather_phase_set_matches_plain_and_host(dev, band):
    """The gather kernel on tp.arena_phase_problems (every nibble phase,
    both orientations, both clips, the 2^20-code arena's last code): bit
    for bit the plain version's bytes and the host's packed windows; a
    misaligned arena or width raises."""
    arena, cols, a_pk, b_pk, xw = tp.arena_chunk(
        *tp.arena_phase_problems(band), band)
    args = (torch.from_numpy(arena).to(dev), torch.from_numpy(cols).to(dev),
            band, a_width(xw, band), xw)
    ga, gb = gather_windows(*args)
    pa, pb = gather_windows_torch(*args)
    assert torch.equal(ga, pa) and torch.equal(gb, pb)
    assert torch.equal(ga.cpu(), torch.from_numpy(a_pk))
    assert torch.equal(gb.cpu(), torch.from_numpy(b_pk))
    with pytest.raises(ValueError, match="16-byte"):
        gather_windows(args[0][1:], *args[1:])
    with pytest.raises(ValueError, match="multiples of 32"):
        gather_windows(*args[:3], a_width(xw, band) + 8, xw)


@pytest.mark.parametrize("kernel", ["antidiag", "row"])
@pytest.mark.parametrize("fetch", ["lean", "edits"])
def test_arena_engine_matches_bsw_align(dev, kernel, fetch):
    contigs, problems = tp.arena_problems(256)
    eng = BswEngine(dev, fetch=fetch, kernel=kernel)
    eng.register_contigs(contigs)
    n0 = arena_gather.launches
    got = eng.align_many(problems)
    for k, (g, w) in enumerate(zip(got, tp.oracle(problems, 150))):
        assert tp.same_alignment(g, w), k
    assert arena_gather.launches - n0 == eng.arena_chunks > 0
    assert 0 < eng.arena_problems < eng.util["live"]


@pytest.mark.parametrize("kw", [{}, {"kernel": "row"}, {"traceback": "host"}],
                         ids=["antidiag", "row", "host"])
def test_engine_over_two_shards_matches_one_device(dev, kw):
    problems = tp.soak_problems(256)
    want = BswEngine(dev, fetch="edits", **kw).align_many(problems)
    eng = BswEngine((dev, dev), fetch="edits", **kw)
    got = eng.align_many(problems)
    for k, (g, w) in enumerate(zip(got, want)):
        assert tp.same_alignment(g, w), k
    assert min(eng.shard_runs) > 0
