"""The plain reference against alignments known from how the problems
were made, against the port's exact host aligner, and its int16 control
against it."""

import numpy as np
import pytest

from gpubench import reference as R

rng = np.random.default_rng(3)


def _seq(n):
    return rng.integers(0, 4, n).astype(np.uint8)


def _problem(a, b, begin_a, begin_b, n):
    return (a, begin_a, begin_a + n - 1, b, begin_b, begin_b + n - 1,
            False, False)


def test_identical_window_is_all_matches():
    a = _seq(3000)
    b = a.copy()
    got = R.align([_problem(a, b, 400, 400, 1500)], 150)[0]
    begin_a, begin_b, a_size, b_size, score, hom, n, m, first, last = got
    assert (begin_a, begin_b, a_size, b_size) == (400, 400, 3000, 3000)
    assert (score, hom, n, m) == (5 * 1500, 100.0, 1500, 1500)
    assert first == (True, (400, 400)) and last == (True, (1899, 1899))


def test_substitution_and_deletion_where_they_were_made():
    a = _seq(3000)
    b = a.copy()
    b[1000] = (b[1000] + 1) % 4                      # one substitution
    b = np.concatenate([b[:1200], b[1202:]])         # a 2 bp deletion
    got = R.align([_problem(a, b, 400, 400, 1500)], 150)
    g = got[0]
    # the window's master stretch ends at end_a = 1899, slave row 1497
    # after the deletion, and the aligner may not pass end_a: rows 0-1497
    # hold 1497 matches and the mismatch, and the two master bases the
    # slave lacks are one 2 bp gap
    assert g[4] == 5 * 1497 - 4 - 2 * 8
    assert (g[6], g[7]) == (1500, 1497)
    assert g[0] == 400 and g[1] == 400


def test_matches_the_ports_exact_aligner():
    pytest.importorskip("torch")
    from gam_ngs_tpu_torch.ops.bsw_ref import bsw_align

    probs = []
    for _ in range(60):
        m = int(rng.integers(30, 700))
        hi = 5 if rng.random() < 0.3 else 4
        a = rng.integers(0, hi, m).astype(np.uint8)
        b = a.copy()
        noise = rng.random(m) < rng.uniform(0.0, 0.15)
        b[noise] = (b[noise] + 1) % 4
        if rng.random() < 0.4:
            cut, dl = int(rng.integers(1, m)), int(rng.integers(1, 30))
            b = np.concatenate([b[:cut], b[cut + dl:]]).astype(np.uint8)
        if len(b) < 2:
            continue
        ba = int(rng.integers(-100, m // 2))
        ea = int(rng.integers(max(ba, 0), m))
        bb = int(rng.integers(0, max(1, len(b) // 3)))
        eb = int(rng.integers(bb - 2, len(b) + 40))
        probs.append((a, ba, ea, b, bb, eb, bool(rng.random() < 0.3),
                      bool(rng.random() < 0.3)))
    for band in (30, 150):
        got = R.align(probs, band)
        for p, g in zip(probs, got):
            w = bsw_align(*p, band=band)
            e = np.asarray(w.edits, np.uint8)
            want = R.summary(w.begin_a, w.begin_b, w.a_size, w.b_size,
                             w.score, e, int((e == R.MATCH).sum()))
            assert g == want


def test_parallel_equals_serial():
    probs = [_problem(a, a, 200, 200, 800) for a in (_seq(1500),
                                                      _seq(2000),
                                                      _seq(1200))]
    assert R.align_parallel(probs, 150, workers=2) == R.align(probs, 150)


def test_int16_control_fails_past_its_range():
    """A window whose score passes 32767 (6,554 matches) wraps in int16:
    the control's answer differs; a short one's does not."""
    a = _seq(9000)
    long_p = _problem(a, a.copy(), 300, 300, 8000)
    short_p = _problem(a, a.copy(), 300, 300, 2000)
    want = R.align([long_p, short_p], 150)
    got = R.align([long_p, short_p], 150, np.int16)
    assert got[0] != want[0]
    assert got[1] == want[1]
