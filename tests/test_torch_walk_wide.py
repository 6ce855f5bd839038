"""The port's row engine with the device walk at bands 1024-4095, on the
CPU, against the JAX package.

BswEngine(torch.device("cpu"), band=b, kernel="row") runs the row
forward's and the walk's plain versions (the kernels the card runs from
band 1024 on: the row forward's clusters, the walk's 3-row ring), with
lean and edits fetch, against the JAX engine's device traceback
(BswEngine(band=b, backend="xla", traceback="device"), and at one band
its Pallas row kernel in interpret mode, kernel="row") and
bsw_ref.bsw_align, on the ragged bucket's seven shortest problems,
tp.ragged_problems(b)[:7] (x_size 1, 2, 3, 5, 16, 17 and 96: up to
seven word rows, N, begin_a < 0, force_start and force_end).  Begin,
score, length and edits exact; homology abs=1e-12.
"""

import pytest
import torch

import torch_problems as tp
from gam_ngs_tpu.ops.bsw_batch import BswEngine as JaxEngine
from gam_ngs_tpu.ops.bsw_ref import bsw_align
from gam_ngs_tpu_torch.ops.bsw_engine import BswEngine
from gam_ngs_tpu_torch.ops.bsw_row import MAX_BAND
from gam_ngs_tpu_torch.ops.bsw_walk import WIDE_RING_BAND

CPU = torch.device("cpu")
BANDS = [WIDE_RING_BAND, 2047, MAX_BAND]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions' tensors here pass torch's parallel grain, and a
    parallel region of many small ops waits on every intra-op thread: on
    a machine whose cores the other test processes fill, one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

_want: dict = {}


def problems_and_oracle(band):
    """tp.ragged_problems(band)[:7] and the JAX package's bsw_align on
    each, once a band."""
    if band not in _want:
        problems = tp.ragged_problems(band)[:7]
        _want[band] = (problems, [bsw_align(*p, band=band)
                                  for p in problems])
    return _want[band]


@pytest.mark.parametrize("band", BANDS)
@pytest.mark.parametrize("fetch", ["lean", "edits"])
def test_row_engine_device_walk_matches_bsw_align(band, fetch):
    problems, want = problems_and_oracle(band)
    eng = BswEngine(CPU, band=band, fetch=fetch, kernel="row")
    assert eng.traceback == "device"
    got = eng.align_many(problems)
    for k, (g, w) in enumerate(zip(got, want)):
        assert tp.same_alignment(g, w), k
    assert all((g.lean is not None) == (fetch == "lean")
               for g in got if g.length)


@pytest.mark.parametrize("band", BANDS)
def test_row_engine_matches_jax_xla_device_traceback(band):
    problems, want = problems_and_oracle(band)
    jax_got = JaxEngine(band=band, backend="xla", traceback="device",
                        fetch="edits").align_many(problems)
    got = BswEngine(CPU, band=band, fetch="edits",
                    kernel="row").align_many(problems)
    for k, (g, j, w) in enumerate(zip(got, jax_got, want)):
        assert tp.same_alignment(j, w), k
        assert tp.same_alignment(g, j), k


def test_row_engine_matches_jax_pallas_row_kernel():
    """The JAX engine's GAM_KERNEL=row configuration with its device
    traceback (the Pallas row kernel in interpret mode) at the widest
    band."""
    band = MAX_BAND
    problems, want = problems_and_oracle(band)
    jax_eng = JaxEngine(band=band, backend="pallas", kernel="row",
                        traceback="device", fetch="edits")
    port = BswEngine.from_reference(jax_eng, CPU)
    assert (port.band, port.kernel, port.traceback) == (band, "row",
                                                         "device")
    for k, (g, j, w) in enumerate(zip(port.align_many(problems),
                                      jax_eng.align_many(problems), want)):
        assert tp.same_alignment(j, w), k
        assert tp.same_alignment(g, j), k
