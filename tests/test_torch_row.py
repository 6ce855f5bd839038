"""The port's row-form forward (ops/bsw_row.py), the row-major walk and
the engine's row and host-traceback paths on the CPU (the plain
versions), against the JAX package's row-form Pallas kernel (interpret
mode), the JAX package's exact oracle (gam_ngs_tpu/ops/bsw_ref.py:
fill_matrix and bsw_align), and the JAX package's merge.

All quantities are integers, so every comparison is exact; homology is
compared with abs=1e-12.
"""

import os
import re

import numpy as np
import pytest
import torch

import torch_problems as tp
from gam_ngs_tpu.models.merge import MergeOptions as JaxMergeOptions
from gam_ngs_tpu.models.merge import run_merge as jax_run_merge
from gam_ngs_tpu.ops.bsw_batch import BswEngine as JaxEngine
from gam_ngs_tpu.ops.bsw_ref import bsw_align, fill_matrix
from gam_ngs_tpu_torch import cli
from gam_ngs_tpu_torch.models.create import CreateOptions, run_create
from gam_ngs_tpu_torch.models.merge import MergeOptions, run_merge
from gam_ngs_tpu_torch.ops import bsw_row
from gam_ngs_tpu_torch.ops.bsw_engine import BswEngine
from gam_ngs_tpu_torch.ops.bsw_row import forward_row, forward_row_torch
from gam_ngs_tpu_torch.ops.bsw_walk import ROW, walk
from test_merge_pipeline import _build_inputs
from test_torch_bsw import long_band300_problems, ref_dirs

CPU = torch.device("cpu")
OUTPUTS = (".gam.fasta", ".pctgs", ".stats", ".noblocks.BF.fasta",
           ".noblocks.AF.fasta", ".notmerged.fasta")
quiet = lambda *_: None  # noqa: E731


def oracle(problems, band):
    """The JAX package's bsw_align on each problem."""
    return [bsw_align(*pr, band=band) for pr in problems]


def row_forward(problems, band):
    a_pk, b_pk, scal, preps, xw = tp.pack_problems(problems, band)
    t = [torch.from_numpy(v) for v in (a_pk, b_pk, *scal[:5])]
    dirs, last_row, diag = forward_row(*t, band)
    return dirs.numpy(), last_row.numpy(), diag.numpy(), preps, xw


def dir_at(dirs, t, x, y):
    return (int(dirs[t, x >> 4, y]) >> (2 * (x & 15))) & 3


@pytest.mark.parametrize("all_full", [False, True])
def test_forward_row_matches_jax_row_kernel(all_full):
    """pallas_forward_raw (B=8, XW=128, AW=128+YP, band 30, interpret
    mode): all_full=False runs 2 exact and 6 lean tiles, all_full=True
    batches hold begin_a < 0.  Every band lane of rows < x_size (valid
    or not: both hold 0 there and derive the same directions), the last
    row, and the diagonal deposits of rows < x_size."""
    import jax

    from gam_ngs_tpu.ops.bsw_pallas import pallas_forward_raw

    band, xw, YS, YP = 30, 128, 61, 128
    pool = tp.soak_problems(200, seed=5, max_len=110)
    pos = [pr for pr in pool if pr[1] >= 0]
    neg = [pr for pr in pool if pr[1] < 0]
    problems = neg[:4] + pos[:4] if all_full else pos[:8]
    dirs, last_row, diag, preps, pxw = row_forward(problems, band)
    assert pxw == xw and len(preps) == 8
    a_win = np.full((8, xw + YP), 15, np.int32)
    b_win = np.zeros((8, xw), np.int32)
    sc = np.zeros((5, 8), np.int32)
    for t, p in enumerate(preps):
        a_win[t, :len(p.a_win)] = np.minimum(p.a_win, 15)
        b_win[t, :p.x_size] = p.b_win
        sc[:, t] = (p.begin_a, p.end_a, len(p.a), p.x_size,
                    int(p.force_start))
    fn = jax.jit(pallas_forward_raw(8, xw, xw + YP, band, interpret=True,
                                    all_full=all_full))
    jd, jlr, jdg = (np.asarray(v) for v in fn(a_win, b_win, *sc))
    jd = np.transpose(jd, (1, 0, 2))[:, :, :YS]  # (B, XW/16, YS)
    assert (last_row == jlr[:, :YS]).all()
    for t, p in enumerate(preps):
        rows = -(-p.x_size // 16)
        lanes_rows = np.arange(16 * rows) < p.x_size
        for w in range(rows):
            for r in range(16):
                if lanes_rows[16 * w + r]:
                    got = (dirs[t, w] >> (2 * r)) & 3
                    want = (jd[t, w] >> (2 * r)) & 3
                    assert (got == want).all(), (t, 16 * w + r)
        jdb = p.end_a - p.begin_a + band
        for jj in range(YS):
            if 0 <= jdb - jj < p.x_size:
                assert diag[t, jj] == jdg[t, jj], (t, jj)


def check_row_cells(problems, band):
    """Directions at every valid cell, the last row and the pos==end_a
    diagonal against the JAX package's fill_matrix.  Returns (cells
    checked, cells past the exact rows i <= band of a begin_a >= 0
    problem, which the lean body computes)."""
    dirs, last_row, diag, preps, _xw = row_forward(problems, band)
    checked = lean = 0
    for t, p in enumerate(preps):
        sw = fill_matrix(p.a, p.begin_a, p.b, p.begin_b, p.x_size, band,
                         p.force_start)
        for (x, y), d in ref_dirs(sw, p, band).items():
            assert dir_at(dirs, t, x, y) == d, (t, x, y)
            checked += 1
            lean += p.begin_a >= 0 and x > band
        xs = p.x_size
        for j in range(2 * band + 1):
            if 0 <= p.begin_a + xs - 1 + j - band < len(p.a):
                assert last_row[t, j] == sw[xs - 1][j], (t, j)
            i = p.end_a - p.begin_a + band - j
            if 0 <= i < xs and 0 <= p.end_a < len(p.a):
                assert diag[t, j] == sw[i][j], (t, j)
        # rows past x_size rounded up to 16 are never written
        assert not dirs[t, -(-xs // 16):].any()
    return checked, lean


@pytest.mark.parametrize("band,seed", [(30, 1), (150, 2), (300, 3)])
def test_forward_row_matches_fill_matrix(band, seed):
    checked, lean = check_row_cells(
        tp.soak_problems(10, seed=seed, max_len=160) + tp.edge_problems(),
        band)
    assert checked > 1000 and (band > 100 or lean > 1000)


@pytest.mark.parametrize("band,seed,max_len", [(700, 4, 1000),
                                               (2000, 5, 300)])
def test_forward_row_wide_bands_match_fill_matrix(band, seed, max_len):
    """The bands the CUDA kernel holds 2 and 4 lanes a thread for: a few
    problems each (at band 700 some rows past the exact ones)."""
    problems = tp.soak_problems(3, seed=seed, max_len=max_len)
    if band == 700:  # 760 rows, begin_a >= 0: rows 701.. run lean
        rng = np.random.default_rng(seed)
        a = rng.integers(0, 4, size=760 + 2 * band).astype(np.uint8)
        b = tp.mutate(rng, a[band:band + 760])
        problems.append((a, band - 20, len(a) - 1, b, 0, len(b) - 1, False,
                         True))
    checked, lean = check_row_cells(problems, band)
    assert checked > 1000 and (band > 1000 or lean > 10_000)


# bands where csrc/bsw_row.cu's launcher changes instance: a warp of one
# lane a thread up to band 15, two from 16, ten up to 159; a block of one
# lane a thread from 160 up to 511
@pytest.mark.parametrize("band", [15, 16, 159, 160, 511])
def test_forward_row_matches_fill_matrix_at_instance_bands(band):
    """Ragged x_size from 1 row to the window (begin_a < 0 tails, N,
    force_start and force_end) and the edge cases (force_end underflow
    windows of 2-12 rows), against fill_matrix cell for cell."""
    problems = tp.ragged_problems(band, seed=band) + tp.edge_problems()
    checked, _lean = check_row_cells(problems, band)
    assert checked > 10_000


def test_forward_row_band300_lean_rows_match_fill_matrix():
    """Band 300, 450-700 rows: mostly the lean body (rows > 300)."""
    checked, lean = check_row_cells(long_band300_problems(), 300)
    assert lean > 200_000 and checked > lean


def test_row_walk_matches_oracle_length():
    """The walk over row-major words (layout ROW) gives the oracle's
    alignment length and score on every problem."""
    band = 30
    problems = tp.edge_problems()
    a_pk, b_pk, scal, preps, xw = tp.pack_problems(problems, band)
    a, b, ba, ea, al, xs, fs, fe = (torch.from_numpy(v)
                                    for v in (a_pk, b_pk, *scal))
    dirs, last_row, diag = forward_row(a, b, ba, ea, al, xs, fs, band)
    lmax = -(-(2 * xw + 2 * band + 8) // 4) * 4
    summary, edits = walk(dirs, a, b, ba, ea, xs, fe, last_row, diag, band,
                          lmax, True, layout=ROW)
    assert len(preps) == len(problems)
    for k, w in enumerate(oracle(problems, band)):
        if summary[12, k]:
            assert int(summary[2, k]) == w.length, k
            assert int(summary[11, k]) == w.score, k
        else:
            assert w.length == 0, k
        assert (edits[k, int(summary[2, k]):] == 0).all()
    with pytest.raises(ValueError, match="layout"):
        walk(dirs, a, b, ba, ea, xs, fe, last_row, diag, band, lmax, True,
             layout=2)


ROW_SETS = {
    "soak16_band150": (150, lambda: tp.soak_problems(16)),
    "edges_band30": (30, tp.edge_problems),
    "long_band300": (300, long_band300_problems),
}


@pytest.mark.parametrize("name,traceback,fetch", [
    (name, tb, fetch) for name in sorted(ROW_SETS)
    for tb, fetch in (("device", "lean"), ("device", "edits"),
                      ("host", "lean"), ("host", "edits"))]
    + [("edges_band30", "host_python", "edits")])
def test_row_engine_matches_bsw_align(name, traceback, fetch, monkeypatch):
    """kernel="row" with the device walk, and the host walk (C++, and its
    Python twin under GAM_NO_NATIVE), against the JAX package's
    bsw_align."""
    band, make = ROW_SETS[name]
    if traceback == "host_python":
        monkeypatch.setenv("GAM_NO_NATIVE", "1")
        traceback = "host"
    problems = make()
    eng = BswEngine(CPU, band=band, fetch=fetch, kernel="row",
                    traceback=traceback)
    got = eng.align_many(problems)
    for k, (g, w) in enumerate(zip(got, oracle(problems, band))):
        assert tp.same_alignment(g, w), k
    # the host walk always gives edit strings
    want_lean = traceback == "device" and fetch == "lean"
    assert all((g.lean is not None) == want_lean for g in got if g.length)


def test_gam_kernel_row_selects_the_row_path(monkeypatch):
    calls = []
    plain = bsw_row.forward_row_torch

    def spy(*args):
        calls.append(args[0].shape)
        return plain(*args)

    monkeypatch.setattr(bsw_row, "forward_row_torch", spy)
    problems = tp.soak_problems(12)
    want = oracle(problems, 150)
    before = BswEngine.kernel_launches()
    for env, kw, rows in ((None, {}, False), ("row", {}, True),
                          ("row", {"kernel": "antidiag"}, False),
                          (None, {"traceback": "host"}, True)):
        if env is None:
            monkeypatch.delenv("GAM_KERNEL", raising=False)
        else:
            monkeypatch.setenv("GAM_KERNEL", env)
        calls.clear()
        got = BswEngine(CPU, **kw).align_many(problems)
        assert bool(calls) == rows, (env, kw)
        assert all(tp.same_alignment(g, w) for g, w in zip(got, want))
    assert BswEngine.kernel_launches() == before  # CPU: no launch
    jax_eng = JaxEngine(band=30, kernel="row", traceback="host")
    port = BswEngine.from_reference(jax_eng, CPU)
    assert (port.kernel, port.traceback) == ("row", "host")
    with pytest.raises(ValueError, match="traceback"):
        BswEngine(CPU, traceback="xla")


def test_wrapper_raises_off_cpu_and_counts_nothing_on_cpu():
    a_pk, b_pk, scal, _p, xw = tp.pack_problems(tp.soak_problems(4), 30)
    t = [torch.from_numpy(v) for v in (a_pk, b_pk, *scal[:5])]
    n0 = bsw_row.launches
    forward_row(*t, 30)
    assert bsw_row.launches == n0
    with pytest.raises(ValueError):
        forward_row(*[v.to("meta") for v in t], 30)
    dirs, lr, dg = forward_row_torch(*t, 30)
    assert dirs.shape == (8, xw // 16, 61) and lr.shape == dg.shape == (8, 61)


@pytest.mark.parametrize("corpus", ["junction", "fork_bubble"])
def test_row_merges_match_jax(tmp_path, corpus, monkeypatch):
    """merge --device cpu under GAM_KERNEL=row (device walk) and
    run_merge with a traceback="host" engine: the six outputs byte for
    byte those of the JAX package's merge."""
    if corpus == "junction":
        _genome, ml, sl, mfa, sfa = _build_inputs(tmp_path)
    else:
        ml, sl, mfa, sfa = tp.fork_bubble_corpus(tmp_path)
    run_create(CreateOptions(master_bam_file=ml, slave_bam_file=sl,
                             min_block_size=10,
                             output_file_prefix=str(tmp_path / "out"),
                             engine="native"),
               log=quiet)
    common = dict(master_bam_file=ml, slave_bam_file=sl,
                  blocks_file=str(tmp_path / "out.blocks"),
                  master_fasta_file=mfa, slave_fasta_file=sfa,
                  min_block_size=10)
    jax_run_merge(JaxMergeOptions(output_file_prefix=str(tmp_path / "jax"),
                                  engine=JaxEngine(), **common), log=quiet)
    monkeypatch.setenv("GAM_KERNEL", "row")
    calls = []
    plain = bsw_row.forward_row_torch
    monkeypatch.setattr(bsw_row, "forward_row_torch",
                        lambda *a: calls.append(1) or plain(*a))
    assert cli.main(["merge", "--master-bam", ml, "--slave-bam", sl,
                     "--blocks-file", common["blocks_file"],
                     "--master-fasta", mfa, "--slave-fasta", sfa,
                     "--min-block-size", "10", "--output",
                     str(tmp_path / "row"), "--device", "cpu"]) == 0
    monkeypatch.delenv("GAM_KERNEL")
    eng = BswEngine(CPU, traceback="host")
    run_merge(MergeOptions(output_file_prefix=str(tmp_path / "host"),
                           engine=eng, **common), log=quiet)
    assert calls and eng.dispatches > 0
    for tag in ("row", "host"):
        for ext in OUTPUTS:
            assert (tmp_path / f"{tag}{ext}").read_bytes() == \
                (tmp_path / f"jax{ext}").read_bytes(), (tag, ext)


WARP_WIDTHS = bsw_row.WARP_WIDTHS  # row_warp_kernel<R>'s band lanes a thread
MULTIWARP_WIDTHS = bsw_row.MULTIWARP_WIDTHS  # row_warps_kernel's (W, R), C = 1
CLUSTER_WIDTHS = bsw_row.CLUSTER_WIDTHS  # row_warps_kernel's (C, W, R)
NEG, GAP = bsw_row.NEG, bsw_row.GAP


def warp_scan_model(c, s, R, lean, rng, W=1, C=1):
    """row_warp_kernel's (W = 1) and row_warps_kernel's row scan in int32
    numpy, step for step: W warps of 32 threads of R consecutive lanes in
    each of C blocks, G = C*W warps in all, warp g = k*W + w holding the
    lanes of block rank k's warp w; lanes past the row are padding, here
    random, since no band lane may read them.  Exact (maps (c, s)): each
    thread composes its R maps in order, a 5-level shuffle scan of the
    thread totals in each warp (thread t takes thread t-d's partial when
    t >= d), the warps' totals (lane 31's) composed in warp order, rank
    by rank, into each warp's carry (NEG for warp 0), thread t's
    exclusive prefix (thread t-1's total) applied to the carry (thread 0
    starts at it), then the lanes in order; every composition clamps at
    NEG.  Lean (c only): each thread's prefix max of c - GAP*k over its
    lanes k, a max scan of those totals less GAP*j0 (j0 = (32*g + t)*R)
    shifted by one thread, which a shuffle returns unchanged below lane
    d, the max of the totals of the warps before each warp (each warp's
    max of its threads' totals; in one block a running max over the
    block's warps, in a cluster lane l of warp g taking the totals of
    warps l and l + 32 below g and the warp their max), then each lane's
    max(that + GAP*j0, prefix) + GAP*k.  c, s: (B, n) int32,
    n <= 32*G*R.  Returns (row, firsts): firsts (B, G-1), each warp's
    first lane recomputed as the warp before it does for its up
    neighbour (in a cluster, the last warp of a block from the map the
    next rank's first warp pushed), from the map (c, s) that warp
    published, (c, GAP) for lean, and the row at the lane before."""
    W = C * W  # the problem's warps, in order
    B, n = c.shape
    N = 32 * W * R
    i32 = np.int32
    cc = np.concatenate([c, rng.integers(-500, 500, (B, N - n))],
                        axis=1).astype(i32).reshape(B, W, 32, R)
    k = np.arange(R, dtype=i32)
    j0 = (np.arange(32 * W, dtype=i32) * R).reshape(W, 32)
    if lean:
        pl = np.maximum.accumulate(cc - i32(GAP) * k, axis=3)
        tot = (pl[..., R - 1] - i32(GAP) * j0).max(axis=2)
        y = np.full((B, W, 32), NEG, i32)
        y[:, :, 1:] = pl[:, :, :-1, R - 1] - i32(GAP) * j0[:, :-1]
        for d in (1, 2, 4, 8, 16):
            up = y.copy()
            up[:, :, d:] = y[:, :, :-d]
            y = np.maximum(y, up)
        carry = np.full((B, W), NEG, i32)
        if C == 1:
            for w in range(1, W):
                carry[:, w] = np.maximum(carry[:, w - 1], tot[:, w - 1])
        else:
            lane = np.arange(32)
            for g in range(1, W):
                z = np.full((B, 32), NEG, i32)
                for slot in (lane, lane + 32):
                    on = slot < g
                    z[:, on] = np.maximum(z[:, on], tot[:, slot[on]])
                carry[:, g] = z.max(axis=1)
        x = np.maximum(y, carry[:, :, None]) + i32(GAP) * j0
        row = np.maximum(x[..., None], pl) + i32(GAP) * k
        c_first = cc[:, 1:, 0, 0]
        s_first = np.full_like(c_first, GAP)
    else:
        pad_s = rng.choice(np.array([0, GAP, NEG], i32), (B, N - n))
        ss = np.concatenate([s, pad_s], axis=1).astype(i32).reshape(
            B, W, 32, R)
        C, S = cc[..., 0].copy(), ss[..., 0].copy()
        for q in range(1, R):
            C = np.maximum(cc[..., q], np.maximum(ss[..., q] + C, i32(NEG)))
            S = np.maximum(S + ss[..., q], i32(NEG))
        t = np.arange(32)
        for d in (1, 2, 4, 8, 16):
            c_l, s_l = C.copy(), S.copy()
            c_l[:, :, d:], s_l[:, :, d:] = C[:, :, :-d], S[:, :, :-d]
            on = t >= d
            C, S = (np.where(on, np.maximum(C, np.maximum(S + c_l,
                                                          i32(NEG))), C),
                    np.where(on, np.maximum(s_l + S, i32(NEG)), S))
        carry = np.full((B, W), NEG, i32)
        for w in range(1, W):
            carry[:, w] = np.maximum(C[:, w - 1, 31], np.maximum(
                S[:, w - 1, 31] + carry[:, w - 1], i32(NEG)))
        x = np.empty((B, W, 32), i32)
        x[:, :, 0] = carry
        x[:, :, 1:] = np.maximum(C[:, :, :-1], np.maximum(
            S[:, :, :-1] + carry[:, :, None], i32(NEG)))
        row = np.empty_like(cc)
        for q in range(R):
            x = np.maximum(cc[..., q], np.maximum(ss[..., q] + x, i32(NEG)))
            row[..., q] = x
        c_first, s_first = cc[:, 1:, 0, 0], ss[:, 1:, 0, 0]
    row = row.reshape(B, N)
    firsts = np.maximum(c_first,
                        s_first + row[:, 32 * R * np.arange(1, W) - 1])
    return row[:, :n], firsts


def scan_model_widths(W, R, C=1):
    """The narrowest and widest row (2*band+1 lanes, odd) that the
    instance of C blocks of W warps of R lanes a thread takes, and one
    between."""
    caps = ([32 * r for r in WARP_WIDTHS]
            + [32 * w * r for w, r in MULTIWARP_WIDTHS]
            + [32 * c * w * r for c, w, r in CLUSTER_WIDTHS])
    hi = 32 * C * W * R
    lo = caps[caps.index(hi) - 1] + 1 if caps.index(hi) else 1
    return sorted({lo, (lo + hi - 1) // 2 | 1, hi - 1})


def check_scan_model(W, R, rng, C=1):
    """warp_scan_model against the plain version's _scan_exact and
    _scan_lean on random scores with runs of NEG slopes; each warp's
    recomputed first lane against the plain row there."""
    W_all = C * W
    for n in scan_model_widths(W, R, C):
        B = 48
        c = rng.integers(-3000, 3000, (B, n)).astype(np.int32)
        c[:4] = 0  # invalid lanes hold 0
        s = rng.choice(np.array([0, GAP, GAP, GAP, NEG], np.int32), (B, n))
        for row in range(B):  # runs of blocked lanes, some the whole row
            start = int(rng.integers(0, n))
            s[row, start:start + int(rng.integers(1, n + 1))] = NEG
        s[-1] = NEG
        firsts = 32 * R * np.arange(1, W_all)
        inside = firsts < n
        for lean in (False, True):
            if lean:
                want = bsw_row._scan_lean(torch.from_numpy(c)).numpy()
                got, got_firsts = warp_scan_model(c, None, R, True, rng, W,
                                                  C)
            else:
                want = bsw_row._scan_exact(torch.from_numpy(c),
                                           torch.from_numpy(s)).numpy()
                got, got_firsts = warp_scan_model(c, s, R, False, rng, W, C)
            assert (got == want).all(), (C, W, R, n, lean)
            assert (got_firsts[:, inside] == want[:, firsts[inside]]).all(), \
                (C, W, R, n, lean)


@pytest.mark.parametrize("R", WARP_WIDTHS)
def test_warp_scan_model_matches_plain_scans(R):
    """The numpy model of the warp kernel's exact and lean row scans
    against the plain version's _scan_exact and _scan_lean, at the
    narrowest and widest row width (2*band+1 lanes) each instance takes,
    on random scores with runs of NEG slopes."""
    check_scan_model(1, R, np.random.default_rng(R))


@pytest.mark.parametrize("W,R", MULTIWARP_WIDTHS,
                         ids=[f"{w}x{r}" for w, r in MULTIWARP_WIDTHS])
def test_multiwarp_scan_model_matches_plain_scans(W, R):
    """The same for the instances of W warps a problem: each warp's own
    scan, the carry of the warps before it (their totals, composed in
    order or their maxima), and the first lane that the warp before
    recomputes from the map this warp published, at the narrowest and
    widest row each instance takes."""
    check_scan_model(W, R, np.random.default_rng(100 * W + R))


@pytest.mark.parametrize("C,W,R", CLUSTER_WIDTHS,
                         ids=[f"{c}x{w}x{r}" for c, w, r in CLUSTER_WIDTHS])
def test_cluster_scan_model_matches_plain_scans(C, W, R):
    """The same for the instances of C blocks of a cluster: the carry of
    the warps of the ranks before (their totals composed in order, or
    their max as lanes l and l + 32 of each warp take it), and the first
    lane of the next rank, at the narrowest and widest row each instance
    takes."""
    check_scan_model(W, R, np.random.default_rng(1000 * C + 100 * W + R), C)


def test_instance_widths_match_the_launcher():
    """ops/bsw_row.py's WARP_WIDTHS, MULTIWARP_WIDTHS and CLUSTER_WIDTHS,
    from which the tests take each instance's first and last band, are
    the launcher's own list of GAM_WARP(W, R) and GAM_CLUSTER(C, W, R)
    instances in csrc/bsw_row.cu, in order, and row_instance(band) is
    the first of them that holds 2*band+1 lanes."""
    src = open(os.path.join(os.path.dirname(bsw_row.__file__), os.pardir,
                            "csrc", "bsw_row.cu")).read()
    launched = [(1, int(w), int(r)) if c is None else (int(c), int(w), int(r))
                for c, w, r in (
                    (m[1], m[2], m[3]) if m[1] else (None, m[4], m[5])
                    for m in re.finditer(
                        r"^\s*(?:GAM_CLUSTER\((\d+), (\d+), (\d+)\)"
                        r"|GAM_WARP\((\d+), (\d+)\));", src, re.M))]
    assert launched == ([(1, 1, r) for r in WARP_WIDTHS]
                        + [(1, w, r) for w, r in MULTIWARP_WIDTHS]
                        + list(CLUSTER_WIDTHS))
    for band in (0, 159, 160, 511, 512, 1023, 1024, bsw_row.MAX_BAND):
        inst = bsw_row.row_instance(band)
        assert inst == next(i for i in launched
                            if 2 * band + 1 <= 32 * i[0] * i[1] * i[2])
