"""The port's device mesh, sharded pipeline step and entry points
(gam_ngs_tpu_torch/parallel/{mesh,step}.py, gam_ngs_tpu_torch/entry.py)
on the CPU, against the JAX package's (parallel/mesh.py, parallel/step.py
over conftest's virtual 8-device mesh, and __graft_entry__.py's Pallas
kernel in interpret mode).

Directions, last rows, diagonals and total_best are integers: exact
equality on every valid cell.  The JAX step sums the statistics in
float32 (x64 is off); at the dry-run's size every partial sum is an
integer below 2^24, so its float32 results must equal the port's float64
results exactly."""

import numpy as np
import pytest
import torch

from gam_ngs_tpu.parallel import device_mesh as jax_device_mesh
from gam_ngs_tpu.parallel import dryrun_step as jax_dryrun_step
from gam_ngs_tpu.parallel import mesh_axes as jax_mesh_axes
from gam_ngs_tpu_torch import entry as entry_mod
from gam_ngs_tpu_torch import parallel
from gam_ngs_tpu_torch.device import as_devices
from gam_ngs_tpu_torch.parallel import distributed
from gam_ngs_tpu_torch.parallel.mesh import device_mesh, mesh_axes
from gam_ngs_tpu_torch.parallel.step import (
    dryrun_inputs,
    dryrun_step,
    make_pipeline_step,
)
from test_torch_bsw import assert_valid_cells_equal

CPU = torch.device("cpu")
BAND, XW = 8, 64  # the dry-run's
YS = 2 * BAND + 1


@pytest.fixture(scope="module")
def dryruns():
    """(the port's dryrun_step outputs over 8 CPU devices, the JAX
    dryrun_step outputs over device_mesh(8) as numpy)."""
    port = dryrun_step(device_mesh(8, "cpu"))
    jax = [np.asarray(v) for v in jax_dryrun_step(jax_device_mesh(8))]
    return port, jax


def cat(parts) -> np.ndarray:
    return np.concatenate([t.numpy() for t in parts])


def unpack_dirs(dirs: np.ndarray, xw: int, band: int) -> np.ndarray:
    """The port's anti-diagonal words (B, NP, band+1) -> one direction a
    cell, (B, xw, 2*band+1): cell (x, y) is in word (2x+y) >> 4, lane
    y >> 1, bits 2*((2x+y) & 15)."""
    x = np.arange(xw).reshape(-1, 1)
    y = np.arange(2 * band + 1).reshape(1, -1)
    t = 2 * x + y
    words = dirs[:, t >> 4, y >> 1].astype(np.int64) & 0xFFFFFFFF
    return (words >> (2 * (t & 15))) & 3


@pytest.mark.parametrize("n,want", [(8, (2, 4)), (6, (2, 3)), (7, (1, 7)),
                                    (1, (1, 1))])
def test_mesh_axes_matches_jax(n, want):
    assert mesh_axes(n) == jax_mesh_axes(n) == want


def test_device_mesh_cpu_shapes():
    mesh = device_mesh(8, "cpu")
    assert mesh.shape == (2, 4) == jax_device_mesh(8).devices.shape
    assert all(d == CPU for d in mesh.ravel())
    assert as_devices(mesh) == (CPU,) * 8  # a mesh reads row-major
    assert device_mesh(None, "cpu").shape == (1, 1)
    assert device_mesh(6, "cpu").shape == (2, 3)
    with pytest.raises(ValueError, match="cuda or cpu"):
        device_mesh(2, "tpu")


def test_device_mesh_cuda_needs_the_gpus(monkeypatch):
    """The default is the card, with no fallback: too few GPUs raise as
    the JAX device_mesh does."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="need 2 devices, have 1"):
        device_mesh(2, "cuda")
    assert device_mesh(1).ravel().tolist() == [torch.device("cuda", 0)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="need 1 devices, have 0"):
        device_mesh()


def test_parallel_package_exports():
    for name in ("device_mesh", "mesh_axes", "make_pipeline_step",
                 "dryrun_step"):
        assert callable(getattr(parallel, name))
    assert parallel.dryrun_step is dryrun_step
    with pytest.raises(AttributeError):
        parallel.no_such_name  # noqa: B018


def test_dryrun_statistics_match_jax(dryruns):
    port, jax = dryruns
    for k in (3, 4, 5):  # count, sum, sum of squares
        assert jax[k].dtype == np.float32
        assert port[k][0].dtype == torch.float64
        np.testing.assert_array_equal(port[k][0].numpy(), jax[k])
    assert int(port[6][0]) == int(jax[6]) > 0


def test_dryrun_forward_matches_jax(dryruns):
    """Directions on every cell (every cell of the dry-run is valid: the
    contigs are 256 codes long), last row and valid diagonal lanes."""
    port, jax = dryruns
    dirs, last_row, diag = (cat(port[k]) for k in range(3))
    jdirs, jlr, jdg = jax[:3]
    assert jdirs.shape == (16, XW, 128) and dirs.shape[0] == 16
    np.testing.assert_array_equal(unpack_dirs(dirs, XW, BAND),
                                  jdirs[:, :, :YS])
    np.testing.assert_array_equal(last_row, jlr[:, :YS])
    # lane j of the diagonal holds row end_a - begin_a + band - j: rows
    # past x_size (j < band here) are no cells
    valid = XW - 1 + BAND - np.arange(YS) < XW
    assert valid.sum() == BAND + 1
    np.testing.assert_array_equal(diag[:, valid], jdg[:, :YS][:, valid])
    # total_best: the JAX maximum runs over its 128 padded lanes, which
    # hold 0 here, below each problem's band maximum
    assert (jlr[:, YS:] == 0).all() and (jlr[:, :YS].max(1) > 0).all()


def test_step_outputs_on_their_devices(dryruns):
    port, _jax = dryruns
    devs = device_mesh(8, "cpu").ravel().tolist()
    for k in range(7):
        assert len(port[k]) == 8
        for d, t in enumerate(port[k]):
            assert t.device == devs[d]
    for k in range(3):  # each shard holds its B/8 = 2 problems
        assert all(t.shape[0] == 2 for t in port[k])
    for k in range(3, 7):  # the statistics come back once a device
        assert all(torch.equal(t, port[k][0]) for t in port[k])


def test_step_refuses_uneven_shapes():
    (B, XW_, AW, band, n_reads, n_libs), args, _ab = dryrun_inputs(8)
    with pytest.raises(ValueError, match="B = 16 does not split over 3"):
        make_pipeline_step([CPU] * 3, B, XW_, AW, band, 48, n_libs)
    with pytest.raises(ValueError, match="n_reads = 130 does not split"):
        make_pipeline_step([CPU] * 8, B, XW_, AW, band, 130, n_libs)
    with pytest.raises(ValueError, match="AW = 256"):
        make_pipeline_step([CPU] * 8, B, XW_, 256, band, n_reads, n_libs)
    step = make_pipeline_step([CPU] * 8, B, XW_, AW, band, n_reads, n_libs)
    with pytest.raises(ValueError, match="isize: want shape"):
        step(*args[:8], args[8][:-8], args[9])


def test_step_over_8_shards_equals_one():
    dims, args, _ab = dryrun_inputs(8)
    one = make_pipeline_step(CPU, *dims)(*args)
    mesh = device_mesh(8, "cpu")
    eight = make_pipeline_step(mesh, *dims)(*args)
    for k in range(3):
        assert len(one[k]) == 1
        np.testing.assert_array_equal(cat(eight[k]), one[k][0].numpy())
    for k in range(3, 7):
        assert torch.equal(eight[k][0], one[k][0])


def test_entry_matches_jax_entry():
    """entry()'s forward on the CPU (the kernel's plain version) against
    __graft_entry__.entry()'s Pallas kernel in interpret mode, on the
    same batch, on every valid cell; the port's arguments are the JAX
    ones cut and packed as the engine packs them."""
    import jax

    import __graft_entry__

    jfn, jargs = __graft_entry__.entry()
    fn, args = entry_mod.entry(device="cpu")
    assert all(t.device == CPU for t in args)
    band, xw = fn.keywords["band"], 2 * args[1].shape[1]
    a_win = np.asarray(jargs[0])
    assert (band, xw, a_win.shape[1]) == (30, 256, entry_mod.ENTRY_A_LEN)
    codes = np.stack([args[0].numpy() & 15, args[0].numpy() >> 4], 2)
    codes = codes.reshape(4, -1)
    np.testing.assert_array_equal(codes[:, :xw + 2 * band],
                                  a_win[:, :xw + 2 * band])
    assert (codes[:, xw + 2 * band:] == 15).all()
    for got, want in zip(args[2:], jargs[2:]):
        np.testing.assert_array_equal(got.numpy(), want)
    port = [t.numpy() for t in fn(*args)]
    jout = [np.asarray(v) for v in jax.block_until_ready(jfn(*jargs))]
    rows = [tuple(int(v[t]) for v in (jargs[2], jargs[3], jargs[4],
                                      jargs[5])) for t in range(4)]
    assert_valid_cells_equal(port, jout, rows, band)


def test_dryrun_multichip_reconstructs_on_both_engines(monkeypatch):
    """dryrun_multichip(8, device="cpu"): the step's dry-run, then the
    tiny create and the distributed merge on the default engine and on
    the row forward with the host traceback, each over the 8 devices,
    each giving back the genome (it raises otherwise)."""
    engines = []
    plain = distributed.distributed_build_pctgs

    def spy(graphs, m_ref, s_ref, master, slave, eng, *a, **kw):
        engines.append((len(eng.devices), eng.kernel, eng.traceback))
        out = plain(graphs, m_ref, s_ref, master, slave, eng, *a, **kw)
        assert eng.dispatches > 0 and eng.cells_aligned > 0
        return out

    monkeypatch.setattr(distributed, "distributed_build_pctgs", spy)
    entry_mod.dryrun_multichip(8, device="cpu")
    assert [e[0] for e in engines] == [8, 8]
    assert engines[0][2] == "device"
    assert engines[1][1:] == ("row", "host")
