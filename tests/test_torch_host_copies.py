"""The port's copies of the last host-only pieces of the JAX package:
ops/fsw_ref.py (the reference's unbanded FullSmithWaterman, which the
merge never calls) with the cases of tests/test_bsw.py::TestFullSW and
against the JAX copy on random windows, and the ThreadSanitizer harness
native/gamio_tsan_main.cc built against the port's native/gamio.cc
(tests/test_native_io.py::test_tsan_threaded_decoder; it skips where the
TSAN toolchain is missing)."""

import os
import subprocess

import numpy as np
import pytest

import testutil
from gam_ngs_tpu.ops.fsw_ref import full_sw_align as jax_full_sw_align
from gam_ngs_tpu_torch.ops.editops import GAP_A, GAP_B
from gam_ngs_tpu_torch.ops.fsw_ref import full_sw_align

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_fsw_identical():
    a = np.array([0, 1, 2, 3, 0, 1, 2, 3], np.uint8)
    r = full_sw_align(a, 0, 7, a, 0, 7)
    assert r.score == 40
    assert r.homology == 100.0
    assert len(r.edits) == 8


def test_fsw_substitution_and_gap():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 4, size=40).astype(np.uint8)
    b = np.concatenate([a[:20], a[21:]])  # one deletion in b
    r = full_sw_align(a, 0, 39, b, 0, 38)
    assert (r.edits == GAP_A).sum() + (r.edits == GAP_B).sum() == 1
    assert r.homology > 95


def test_fsw_no_n_wildcard():
    """N against a base is a plain mismatch (no N rule, unlike the
    banded kernel)."""
    a = np.full(10, 4, np.uint8)  # NNNN...
    b = np.zeros(10, np.uint8)    # AAAA...
    r = full_sw_align(a, 0, 9, b, 0, 9)
    assert r.score <= 0  # pure mismatches, clamped by the empty prefix


@pytest.mark.parametrize("seed", range(4))
def test_fsw_matches_jax_copy(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 5, size=int(rng.integers(20, 90))).astype(np.uint8)
    b = a[int(rng.integers(0, 10)):].copy()
    b[rng.random(len(b)) < 0.1] = 3
    ba, bb = int(rng.integers(0, 5)), int(rng.integers(0, 5))
    ea, eb = len(a) - 1 - int(rng.integers(0, 5)), len(b) - 1
    got = full_sw_align(a, ba, ea, b, bb, eb)
    want = jax_full_sw_align(a, ba, ea, b, bb, eb)
    for f in ("score", "homology", "begin_a", "begin_b", "a_size",
              "b_size"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.edits, want.edits)


def test_tsan_threaded_decoder(tmp_path):
    """The native decoder's rolling-window parallel inflate compiled with
    -fsanitize=thread and driven over a multi-contig BAM: zero TSAN
    reports."""
    src = os.path.join(ROOT, "gam_ngs_tpu_torch", "native",
                       "gamio_tsan_main.cc")
    binary = str(tmp_path / "gamio_tsan")
    try:
        subprocess.run(
            ["g++", "-O1", "-g", "-fsanitize=thread", "-o", binary, src,
             "-I", os.path.dirname(src), "-lz", "-pthread"],
            check=True, capture_output=True, text=True, timeout=300)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        pytest.skip(f"tsan toolchain unavailable: "
                    f"{getattr(e, 'stderr', e)}"[:300])

    rng = np.random.default_rng(11)
    recs = []
    for c in range(5):
        genome = testutil.random_genome(rng, 3000)
        for i in range(200):
            p = int(rng.integers(0, 2600))
            recs += testutil.make_pe_records(
                f"c{c}r{i}" + "y" * int(rng.integers(0, 30)),
                genome[p:p + 50], c, p, False,
                genome[p + 150:p + 200], c, p + 150, True)
    bam = str(tmp_path / "tsan.bam")
    testutil.write_sorted_bam(bam, [f"C{c}" for c in range(5)],
                              [3000] * 5, recs)

    res = subprocess.run([binary, bam, "8", "8192"],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, f"harness failed:\n{res.stderr[-3000:]}"
    assert "TSAN_HARNESS_OK" in res.stdout
    assert "ThreadSanitizer" not in res.stderr, \
        f"TSAN report:\n{res.stderr[-4000:]}"
