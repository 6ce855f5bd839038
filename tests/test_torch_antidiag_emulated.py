"""The anti-diagonal forward's CUDA source run on the CPU.

gam_ngs_tpu_torch/csrc/bsw_antidiag.cu is compiled by g++ against
tests/cuda_emu/cuda_runtime.h (each warp 32 host threads meeting at
every shuffle, a problem's warps at its named barrier), and its C entry
point bsw_antidiag_forward_taken is called on host arrays, bit for bit
against the plain version forward_antidiag_torch on dirs, last_row and
diag.  The launcher picks its instance from the batch, the band and the
card's SM count, which the stand-in runtime lets the test set: each case
runs every instance the launcher can take for its batch (one warp a
problem below band 160, and from band 64 the split instance of four
warps a problem with its halo strips, R = 1 to 5 lanes a thread), and
holds the instance the launch reports to bsw_antidiag_instance's, at
bands 30, 70, 150, 300, 400 and 511 and B = 1 and 8, on
ragged windows of up to 1000 rows whose last-row and pos == end_a cells
cross every strip seam and halo, with force_start and begin_a < 0
(every block exact).  The card's tests (tests/test_torch_cuda.py) hold the
compiled kernel.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import torch_problems as tp
from gam_ngs_tpu_torch.ops.bsw_antidiag import (
    MATCH_S,
    MISMATCH_S,
    NN_S,
    NX_S,
    antidiag_dims,
    forward_antidiag_torch,
)
from gam_ngs_tpu_torch.ops.bsw_ref import FORCE_MAXGAP_LEN, GAP

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, os.pardir, "gam_ngs_tpu_torch", "csrc",
                   "bsw_antidiag.cu")


class Emulated:
    """The source's entry points built for the host, with the stand-in
    card's SM count settable."""

    def __init__(self, tmp):
        gxx = shutil.which("g++")
        assert gxx, "g++ builds the port's native code; it is needed here too"
        src = re.sub(r"([\w:]+(?:<[^<>]*>)?)<<<(.*?)>>>\(",
                     r"emu::launch(\1, \2, ", open(SRC).read())
        src += ('\nextern "C" void emu_set_sms(int n) '
                '{ emu::sm_count = n; }\n')
        cc, so = tmp / "bsw_antidiag_host.cc", tmp / "libbsw_antidiag_host.so"
        cc.write_text(src)
        r = subprocess.run([gxx, "-std=c++20", "-O1", "-fwrapv", "-pthread",
                            "-shared", "-fPIC", "-Wall",
                            "-Wno-unknown-pragmas", "-I",
                            os.path.join(HERE, "cuda_emu"), str(cc), "-o",
                            str(so)], capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
        assert "warning" not in r.stderr, r.stderr
        lib = ctypes.CDLL(str(so))
        self.forward = lib.bsw_antidiag_forward_taken
        self.forward.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 12
                                 + [ctypes.c_void_p] * 5)
        self.forward.restype = ctypes.c_int
        self._instance = lib.bsw_antidiag_instance
        self._instance.argtypes = [ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p]
        self._instance.restype = ctypes.c_int
        self.set_sms = lib.emu_set_sms
        self.set_sms.argtypes = [ctypes.c_int]

    def instance(self, band, B):
        info = (ctypes.c_int * 2)()
        assert self._instance(band, B, ctypes.addressof(info)) == 0
        return tuple(info)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return Emulated(tmp_path_factory.mktemp("bsw_antidiag_emu"))


def run_emulated(emu, packed, band):
    """The forward's outputs, and (W, R, split) of the instance launched."""
    a_pk, b_pk, scal, _preps, xw = packed
    B = a_pk.shape[0]
    K, T, NP, _ = antidiag_dims(xw, band)
    ins = [np.ascontiguousarray(v) for v in (a_pk, b_pk, *scal[:5])]
    outs = [np.zeros((B, NP, K), np.int32),
            np.zeros((B, 2 * band + 1), np.int32),
            np.zeros((B, 2 * band + 1), np.int32)]
    taken = (ctypes.c_int * 3)()
    err = emu.forward(*(v.ctypes.data for v in ins), B, 2 * a_pk.shape[1],
                      xw, band, T, NP, MATCH_S, MISMATCH_S, NN_S, NX_S, GAP,
                      FORCE_MAXGAP_LEN, *(v.ctypes.data for v in outs), None,
                      ctypes.addressof(taken))
    assert err == 0
    return outs, tuple(taken)


def instances(emu, band, B):
    """{(W, R): SM count} of each instance the launcher takes for B
    problems at `band` on some card."""
    out = {}
    for sms in (0, B):
        emu.set_sms(sms)
        out.setdefault(emu.instance(band, B), sms)
    return out


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("band", [30, 70, 150, 300, 400, 511])
def test_antidiag_kernel_source_matches_plain(emulated, band, B):
    a_pk, b_pk, scal, preps, xw = tp.pack_problems(
        tp.seam_problems(band, B, seed=band + B), band)
    # the launch holds the B problems alone, not the bucket's padding rows
    packed = a_pk[:B], b_pk[:B], scal[:, :B], preps, xw
    a_pk, b_pk, scal = packed[:3]
    want = forward_antidiag_torch(*(torch.from_numpy(v)
                                    for v in (a_pk, b_pk, *scal[:5])), band)
    taken = instances(emulated, band, B)
    # one warp a problem where the card is full, the split instance of
    # four warps a problem where the batch leaves it empty, from the band
    # where it takes two lanes a thread off (one lane a thread at band
    # 70); from band 160 the split at every batch
    assert sorted(w for w, _r in taken) == (
        [1] if band < 64 else [1, 4] if band < 160 else [4])
    for (w, r), sms in sorted(taken.items()):
        emulated.set_sms(sms)
        got, launched = run_emulated(emulated, packed, band)
        assert launched == (w, r, w > 1), (band, B, launched)
        for name, g, x in zip(("dirs", "last_row", "diag"), got, want):
            assert (g == x.numpy()).all(), (band, B, w, r, name)
