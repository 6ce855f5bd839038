"""The port's banded-SW forward, walk and engine on the CPU (their plain
PyTorch versions) against the exact oracle (ops/bsw_ref.py) and the JAX
package's anti-diagonal Pallas kernel and engine (interpret mode).

All quantities are integers, so every comparison is exact; homology is
compared with abs=1e-12.  Against the JAX kernel only valid band cells
are compared: invalid lanes of its lean body hold drifting values
(bsw_pallas.py:699-707), and the port's lane layout differs there.
"""

import numpy as np
import pytest
import torch

import torch_problems as tp
from gam_ngs_tpu.ops.bsw_batch import BswEngine as JaxEngine
from gam_ngs_tpu.ops.bsw_ref import (
    FORCE_MAXGAP_LEN,
    GAP,
    SCORING_MATRIX,
    bsw_align,
    fill_matrix,
)
from gam_ngs_tpu_torch import _build
from gam_ngs_tpu_torch.device import resolve_device
from gam_ngs_tpu_torch.ops import bsw_antidiag, bsw_walk
from gam_ngs_tpu_torch.ops.bsw_antidiag import (
    antidiag_dims,
    forward_antidiag,
    forward_antidiag_torch,
)
from gam_ngs_tpu_torch.ops.bsw_engine import BswEngine
from gam_ngs_tpu_torch.ops.bsw_walk import find_max_torch, walk

CPU = torch.device("cpu")


def ref_dirs(sw, p, band):
    """The reference traceback's decision (bsw_ref.traceback) at every
    valid cell: {(x, y): 0 diag | 1 up | 2 left}."""
    xs, ys = sw.shape
    a, b, ba, fs = p.a, p.b, p.begin_a, p.force_start
    out = {}
    for x in range(xs):
        for y in range(ys):
            pos = ba + x + y - band
            if not 0 <= pos < len(a):
                continue
            s = SCORING_MATRIX[int(a[pos]), int(b[p.begin_b + x])]
            v = sw[x][y]
            if pos == 0:
                left_ok = not (fs and x > FORCE_MAXGAP_LEN)
                if v == s:
                    d = 0
                elif y == ys - 1 or (left_ok and v == GAP):
                    d = 2
                else:
                    d = 1
            else:
                diag = (sw[x - 1][y] if x > 0 else 0) + s
                up = sw[x - 1][y + 1] + GAP if (x > 0 and y < ys - 1) else GAP
                if fs and x == 0:
                    up = GAP if pos <= FORCE_MAXGAP_LEN else None
                if v == diag:
                    d = 0
                elif 0 < y < ys - 1:
                    d = 1 if v == up else 2
                else:
                    d = 1 if y < ys - 1 else 2
            out[(x, y)] = d
    return out


def port_forward(problems, band):
    a_pk, b_pk, scal, preps, xw = tp.pack_problems(problems, band)
    t = [torch.from_numpy(v) for v in (a_pk, b_pk, *scal[:5])]
    dirs, last_row, diag = forward_antidiag(*t, band)
    return dirs.numpy(), last_row.numpy(), diag.numpy(), preps, xw


def dir_at(word, x, y):
    t = 2 * x + y
    return (int(word) >> ((t & 15) * 2)) & 3


def check_forward_cells(problems, band):
    """Directions at every valid cell, the last row and the pos==end_a
    diagonal against bsw_ref.fill_matrix.  Returns (cells checked, cells
    past the exact-mask prefix t <= 2*band+2 of a begin_a >= 0 problem,
    which the lean body computes)."""
    dirs, last_row, diag, preps, _xw = port_forward(problems, band)
    checked = lean = 0
    for t, p in enumerate(preps):
        sw = fill_matrix(p.a, p.begin_a, p.b, p.begin_b, p.x_size, band,
                         p.force_start)
        for (x, y), d in ref_dirs(sw, p, band).items():
            assert dir_at(dirs[t, (2 * x + y) >> 4, y >> 1], x, y) == d, \
                (t, x, y)
            checked += 1
            lean += p.begin_a >= 0 and 2 * x + y > 2 * band + 2
        xs = p.x_size
        for j in range(2 * band + 1):
            if 0 <= p.begin_a + xs - 1 + j - band < len(p.a):
                assert last_row[t, j] == sw[xs - 1][j], (t, j)
            i = p.end_a - p.begin_a + band - j
            if 0 <= i < xs and 0 <= p.end_a < len(p.a):
                assert diag[t, j] == sw[i][j], (t, j)
    return checked, lean


@pytest.mark.parametrize("band,seed", [(30, 1), (150, 2), (300, 3)])
def test_forward_matches_fill_matrix(band, seed):
    """Soak problems against bsw_ref.fill_matrix (band 300 included: the
    port has no ANTI_BPAD-style bound)."""
    checked, _lean = check_forward_cells(
        tp.soak_problems(10, seed=seed, max_len=160), band)
    assert checked > 1000


def long_band300_problems(seed=4, band=300):
    """Windows of 450-700 rows at band 300, mostly past the exact-mask
    prefix (rows i > 301): the region where the JAX anti-diagonal path's
    ANTI_BPAD front pad runs out.  N in the first, force_start in the
    second, force_end in the third."""
    rng = np.random.default_rng(seed)
    problems = []
    for k in range(4):
        n = int(rng.integers(450, 700))
        a = rng.integers(0, 5 if k == 0 else 4,
                         size=n + 2 * band).astype(np.uint8)
        b = tp.mutate(rng, a[band:band + n])
        # the force_end window ends where b's source ends
        end_a = band + n - 1 if k == 2 else len(a) - 1 - 30 * k
        problems.append((a, band - 40 * k, end_a, b, 0, len(b) - 1, k == 1,
                         k == 2))
    return problems


def test_forward_band300_lean_rows_match_fill_matrix():
    """Band 300 far past the exact prefix, where only the lean body runs,
    against bsw_ref.fill_matrix (never against the JAX engine)."""
    checked, lean = check_forward_cells(long_band300_problems(), 300)
    assert lean > 500_000 and checked > lean


@pytest.mark.parametrize("fetch", ["lean", "edits"])
def test_engine_band300_long_matches_bsw_align(fetch):
    problems = long_band300_problems()
    got = BswEngine(CPU, band=300, fetch=fetch).align_many(problems)
    for k, (g, w) in enumerate(zip(got, tp.oracle(problems, 300))):
        assert w.length > 400 and tp.same_alignment(g, w), k


def check_against_jax_kernel(problems, all_full):
    """Valid cells of the port's forward against
    pallas_forward_antidiag_raw (B=8, XW=128, band=30, interpret
    mode)."""
    import jax

    from gam_ngs_tpu.ops.bsw_pallas import (
        antidiag_dims as jax_dims,
        pallas_forward_antidiag_raw,
    )

    band, xw = 30, 128
    dirs, last_row, diag, preps, pxw = port_forward(problems, band)
    assert pxw == xw and len(preps) == 8
    aw_j = jax_dims(xw, band)[2]
    a_win = np.full((8, aw_j), 15, np.int32)
    b_win = np.zeros((8, xw), np.int32)
    sc = np.zeros((5, 8), np.int32)
    for t, p in enumerate(preps):
        a_win[t, :len(p.a_win)] = np.minimum(p.a_win, 15)
        b_win[t, :p.x_size] = p.b_win
        sc[:, t] = (p.begin_a, p.end_a, len(p.a), p.x_size,
                    int(p.force_start))
    fn = jax.jit(pallas_forward_antidiag_raw(8, xw, band, interpret=True,
                                             all_full=all_full))
    jd, jlr, jdg = (np.asarray(v) for v in fn(a_win, b_win, *sc))
    for t, p in enumerate(preps):
        xs = p.x_size
        for x in range(xs):
            for y in range(2 * band + 1):
                if 0 <= p.begin_a + x + y - band < len(p.a):
                    w = (2 * x + y) >> 4
                    assert dir_at(dirs[t, w, y >> 1], x, y) == \
                        dir_at(jd[w, t, y >> 1], x, y), (t, x, y)
        for j in range(2 * band + 1):
            if 0 <= p.begin_a + xs - 1 + j - band < len(p.a):
                assert last_row[t, j] == jlr[t, j], (t, j)
            i = p.end_a - p.begin_a + band - j
            if 0 <= i < xs and 0 <= p.end_a < len(p.a):
                assert diag[t, j] == jdg[t, j], (t, j)


@pytest.mark.parametrize("all_full", [False, True])
def test_forward_matches_jax_antidiag_kernel(all_full):
    """Valid cells against pallas_forward_antidiag_raw (B=8, XW=128,
    band=30, interpret mode); all_full=True batches hold begin_a < 0."""
    pool = tp.soak_problems(200, seed=5, max_len=110)
    pos = [pr for pr in pool if pr[1] >= 0]
    neg = [pr for pr in pool if pr[1] < 0]
    check_against_jax_kernel(neg[:4] + pos[:4] if all_full else pos[:8],
                             all_full)


def test_ragged_forward_matches_jax_antidiag_kernel():
    """A ragged bucket (x_size 1 to 128, each problem stopping at its own
    last step, two begin_a < 0 tails) against the JAX kernel."""
    problems = [pr for k, pr in enumerate(tp.ragged_problems(30))
                if k not in (2, 6)]
    check_against_jax_kernel(problems, all_full=True)


@pytest.mark.parametrize("band", [30, 300])
def test_forward_stops_at_each_problems_last_step(band):
    """In a ragged bucket (x_size 1 up to the window) every direction
    bit and word past a problem's last step, 2*(x_size-1) + 2*band, is
    0, and the valid cells still equal bsw_ref.fill_matrix."""
    problems = tp.ragged_problems(band)
    dirs, _lr, _dg, preps, _xw = port_forward(problems, band)
    words = dirs.astype(np.int64) & 0xffffffff
    short = 0
    for t, p in enumerate(preps):
        last = 2 * (p.x_size - 1) + 2 * band
        w, bits = last >> 4, 2 * ((last & 15) + 1)
        assert (words[t, w + 1:] == 0).all(), t
        assert (words[t, w] >> bits == 0).all(), t
        assert words[t, w].any() or words[t, :w].any(), t
        short += w + 1 < dirs.shape[1]
    assert short >= 5
    checked, lean = check_forward_cells(problems, band)
    assert checked > 1000 and lean > 0


@pytest.mark.parametrize("fetch", ["lean", "edits"])
def test_engine_matches_bsw_align_soak(fetch):
    problems = tp.soak_problems(32)
    eng = BswEngine(CPU, fetch=fetch)
    got = eng.align_many(problems)
    for k, (g, w) in enumerate(zip(got, tp.oracle(problems, 150))):
        assert tp.same_alignment(g, w), k
    assert all((g.lean is None) == (fetch == "edits")
               for g in got if g.length)
    assert eng.dispatches >= 2 and eng.cells_aligned > 0
    assert eng.util["live"] == len(problems)


@pytest.mark.parametrize("fetch", ["lean", "edits"])
def test_engine_edge_cases_band30(fetch):
    """force_end underflow windows (x_size <= 10 -> null alignment),
    negative begin_a, force_start with a deep pos==0 cell, mixed
    flags."""
    problems = tp.edge_problems()
    got = BswEngine(CPU, band=30, fetch=fetch).align_many(problems)
    want = tp.oracle(problems, 30)
    for k, (g, w) in enumerate(zip(got, want)):
        assert tp.same_alignment(g, w), k
    # the underflow windows x_size 2, 5, 10 give the null alignment
    assert [want[6 + k].length for k in range(3)] == [0, 0, 0]


def test_engine_matches_jax_engine():
    """The JAX engine on its anti-diagonal fused path (pallas, device
    traceback, interpret mode), one bucket."""
    problems = [pr for pr in tp.edge_problems() if len(pr[3]) <= 128][:6]
    jax_eng = JaxEngine(band=30, backend="pallas", traceback="device",
                        fetch="edits")
    port = BswEngine.from_reference(jax_eng, CPU)
    assert (port.band, port.max_batch, port.hbm_budget, port.fetch) == (
        30, jax_eng.max_batch, jax_eng.hbm_budget, "edits")
    for k, (g, w) in enumerate(zip(port.align_many(problems),
                                   jax_eng.align_many(problems))):
        assert tp.same_alignment(g, w), k


def test_engine_empty_and_clipped_problems():
    a = np.array([0, 1, 2, 3] * 10, np.uint8)
    problems = [(a, 0, 39, a, 5, 4),           # end_b < begin_b: empty
                (a, 0, 39, a, 0, 10_000),      # end_b clipped to len(b)
                (a, 100, 39, a, 0, 39)]        # begin_a past a: x_size <= 0
    got = BswEngine(CPU, band=30, fetch="edits").align_many(problems)
    want = tp.oracle(problems, 30)
    for k, (g, w) in enumerate(zip(got, want)):
        assert tp.same_alignment(g, w), k
    assert got[0].length == 0 and got[2].length == 0


@pytest.mark.parametrize("band", [30, 150])
def test_find_max_and_walk_match_reference(band):
    """find-max (first maximum of last row then diagonal, the force_end
    unsigned-underflow quirk) against bsw_ref.find_max, and the walk's
    step count against the oracle's alignment length; edits past a
    walk's end stay 0."""
    from gam_ngs_tpu.ops.bsw_ref import find_max

    problems = tp.soak_problems(12, seed=9, max_len=200) + \
        tp.edge_problems()[6:11] + tp.tie_problems()
    a_pk, b_pk, scal, preps, xw = tp.pack_problems(problems, band)
    t = [torch.from_numpy(v) for v in (a_pk, b_pk, *scal)]
    a, b, ba, ea, al, xs, fs, fe = t
    dirs, last_row, diag = forward_antidiag(a, b, ba, ea, al, xs, fs, band)
    mi, mj, score, found = find_max_torch(last_row, diag, ba, ea, xs, fe,
                                          band)
    lmax = -(-(2 * xw + 2 * band + 8) // 4) * 4
    summary, edits = walk(dirs, a, b, ba, ea, xs, fe, last_row, diag, band,
                          lmax, True)
    assert summary.shape == (13, len(mi)) and edits.shape == (len(mi), lmax)
    for k, p in enumerate(preps):
        sw = fill_matrix(p.a, p.begin_a, p.b, p.begin_b, p.x_size, band,
                         p.force_start)
        want = find_max(sw, p.begin_a, p.end_a, band, p.force_end)
        got = (bool(found[k]), int(mi[k]), int(mj[k]), int(score[k]))
        assert got == (want if want[0] else (False, 0, 0, 0)), k
        assert bool(summary[12, k]) == want[0]
        cnt = int(summary[2, k])
        if want[0]:
            assert cnt == bsw_align(*problems[k], band=band).length, k
        assert (edits[k, cnt:] == 0).all()


def test_wrappers_count_launches_only_on_the_kernel():
    """CPU tensors run the plain versions and leave the launch counts
    alone; a tensor on another device raises."""
    before = (bsw_antidiag.launches, bsw_walk.launches)
    a_pk, b_pk, scal, _p, _xw = tp.pack_problems(tp.soak_problems(4), 30)
    t = [torch.from_numpy(v) for v in (a_pk, b_pk, *scal[:5])]
    forward_antidiag(*t, 30)
    assert (bsw_antidiag.launches, bsw_walk.launches) == before
    with pytest.raises(ValueError):
        forward_antidiag(*[v.to("meta") for v in t], 30)


def test_scoring_constants_come_from_bsw_ref():
    """The kernels take bsw_ref's scoring as four numbers: valid only
    while SCORING_MATRIX is uniform over A, T, C, G."""
    want = np.full((5, 5), bsw_antidiag.MISMATCH_S)
    np.fill_diagonal(want, bsw_antidiag.MATCH_S)
    want[4, :] = want[:, 4] = bsw_antidiag.NX_S
    want[4, 4] = bsw_antidiag.NN_S
    assert (SCORING_MATRIX == want).all()


def test_plain_forward_dims():
    K, T, NP, AW = antidiag_dims(128, 150)
    assert (K, T, NP, AW) == (151, 2 * 127 + 301, -(-555 // 16), 430)
    a_pk, b_pk, scal, _p, xw = tp.pack_problems(tp.soak_problems(3), 150)
    dirs, lr, dg = forward_antidiag_torch(
        *[torch.from_numpy(v) for v in (a_pk, b_pk, *scal[:5])], 150)
    assert dirs.shape == (8, antidiag_dims(xw, 150)[2], 151)
    assert lr.shape == dg.shape == (8, 301)


def test_resolve_device(monkeypatch):
    assert resolve_device("cpu") == CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("auto", "cuda", "cuda:0"):
        with pytest.raises(RuntimeError):
            resolve_device(name)
    with pytest.raises(ValueError):
        resolve_device("tpu")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()
    # the library name is keyed by the sources and flags
    assert _build.library_path().startswith(
        _build.BUILD_DIR + "/libgam_kernels_")
    assert [p.rsplit("/", 1)[1] for p in _build.sources()] == [
        "bsw_antidiag.cu", "bsw_row.cu", "bsw_walk.cu"]


@pytest.mark.parametrize("fail", [False, True])
def test_build_compiles_each_source_then_links(monkeypatch, tmp_path, fail):
    """With a stand-in nvcc on PATH: one compile per source, then one
    link, and the library appears only when every step succeeded."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    log = tmp_path / "calls"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo \"$*\" >> {log}\n"
        + ("case \"$*\" in *bsw_row.cu*) echo bad >&2; exit 3;; esac\n"
           if fail else "")
        + "while [ $# -gt 1 ]; do [ \"$1\" = -o ] && : > \"$2\"; shift; "
          "done\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}:/usr/bin:/bin")
    so = tmp_path / "lib.so"
    if fail:
        with pytest.raises(RuntimeError, match="exit 3"):
            _build._compile_and_link(str(tmp_path), str(so))
        assert not so.exists()
    else:
        _build._compile_and_link(str(tmp_path), str(so))
        assert so.exists()
    calls = log.read_text().splitlines()
    compiles = [c for c in calls if " -c " in f" {c} "]
    assert len(compiles) == len(_build.sources()) == 3
    assert [c for c in calls if "-shared" in c] == ([] if fail else
                                                    [calls[-1]])
