"""The sharded device pipeline step: batched DP + library statistics.

gam_ngs_tpu/parallel/step.py over torch devices.  The JAX step is one
jitted function whose shardings deal the batch over a (host, part) mesh
and let XLA insert the reductions; here the same work is spelled out:

  * the batched banded-SW forward (ops.bsw_antidiag.forward_antidiag: the
    CUDA kernel for CUDA tensors, its plain version for CPU tensors, in
    place of the JAX forward_builder) on contiguous row blocks of the
    problem batch, one block a device, in the mesh's row-major order;
  * per-library insert-size moments (count, sum and sum of squares of
    the masked inserts, float64; the sufficient statistics behind the
    reference's Welford stream) over the read table dealt the same way,
    computed on each block's device and summed over the blocks;
  * a total score, the sum over problems of each last row's maximum,
    summed over the blocks as int64.

The batch-leading outputs come back as one tensor a block, each on its
device (their concatenation is the JAX global array); the statistics and
the total come back once a device, as the JAX step replicates them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import as_devices
from ..ops.bsw_antidiag import a_width, forward_antidiag
from ..ops.bsw_host import _pack4

# the dry-run's contig length: the JAX dry-run's a-window width (AW = 256
# codes in gam_ngs_tpu/parallel/step.py)
DRYRUN_A_LEN = 256


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def library_moments(lib_id, isize, read_mask, n_libs: int) -> torch.Tensor:
    """(3, n_libs) float64 on the inputs' device: per library the count,
    sum and sum of squares of the inserts whose mask is set (the JAX
    step's one-hot segment sums)."""
    libs = torch.arange(n_libs, device=lib_id.device)
    w = ((lib_id.reshape(-1, 1) == libs)
         & read_mask.reshape(-1, 1)).to(torch.float64)
    s = isize.to(torch.float64).reshape(-1, 1)
    ws = w * s
    return torch.stack([w.sum(0), ws.sum(0), (ws * s).sum(0)])


def pack_windows(a: np.ndarray, begin_a: int, b: np.ndarray, band: int):
    """Rows of contigs `a` (B, L) and windows `b` (B, XW) uint8 -> the
    forward's 4-bit packed (a_pk, b_pk): each a window band-aligned,
    a_win[q] = a[begin_a - band + q] for the XW + 2*band codes the band
    reads (as BswEngine._pack_chunk cuts it), the sentinel after."""
    B, xw = b.shape
    start = begin_a - band
    if start < 0:
        raise ValueError(f"begin_a {begin_a} < band {band}")
    width = min(xw + 2 * band, a.shape[1] - start)
    a_win = np.full((B, a_width(xw, band)), 255, np.uint8)
    a_win[:, :width] = a[:, start:start + width]
    return _pack4(a_win), _pack4(b)


class PipelineStep:
    """fn(a_pk, b_pk, begin_a, end_a, a_len, x_size, force_start, lib_id,
    isize, read_mask) -> (dirs, last_row, diag, lib_count, lib_sum,
    lib_sumsq, total_best).  Inputs are torch tensors or numpy arrays
    (the windows 4-bit packed, ops/bsw_antidiag.py); each output is a
    list in device order."""

    def __init__(self, devices, B: int, XW: int, AW: int, band: int,
                 n_reads: int, n_libs: int):
        self.devices = as_devices(devices)
        n = len(self.devices)
        for name, v in (("B", B), ("n_reads", n_reads)):
            if v % n:
                raise ValueError(f"{name} = {v} does not split over {n} "
                                 f"devices")
        if AW != a_width(XW, band):
            raise ValueError(f"AW = {AW}: the packed a window holds "
                             f"a_width({XW}, {band}) = "
                             f"{a_width(XW, band)} codes")
        self.B, self.XW, self.AW, self.band = B, XW, AW, band
        self.n_reads, self.n_libs = n_reads, n_libs

    def _shards(self, x, total: int, width: int | None, name: str):
        """x's contiguous row blocks, block d on device d."""
        t = _tensor(x)
        want = (total,) if width is None else (total, width)
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: want shape {want}, got "
                             f"{tuple(t.shape)}")
        per = total // len(self.devices)
        return [t[d * per:(d + 1) * per].to(dev)
                for d, dev in enumerate(self.devices)]

    def forward(self, a_pk, b_pk, begin_a, end_a, a_len, x_size,
                force_start):
        """Each block's (dirs, last_row, diag) on its device: three lists."""
        B = self.B
        cols = [self._shards(a_pk, B, self.AW // 2, "a_pk"),
                self._shards(b_pk, B, self.XW // 2, "b_pk")]
        cols += [self._shards(v, B, None, name) for name, v in (
            ("begin_a", begin_a), ("end_a", end_a), ("a_len", a_len),
            ("x_size", x_size), ("force_start", force_start))]
        outs = [forward_antidiag(*shard, self.band) for shard in zip(*cols)]
        return tuple(list(v) for v in zip(*outs))

    def _replicate(self, parts: list) -> list:
        """The sum of one partial a block, a copy on each device."""
        total = parts[0]
        for p in parts[1:]:
            total = total + p.to(total.device)
        return [total.to(dev) for dev in self.devices]

    def statistics(self, lib_id, isize, read_mask):
        """(lib_count, lib_sum, lib_sumsq), each a list of one (n_libs,)
        float64 copy a device."""
        n = self.n_reads
        parts = [library_moments(*shard, self.n_libs) for shard in zip(
            self._shards(lib_id, n, None, "lib_id"),
            self._shards(isize, n, None, "isize"),
            self._shards(read_mask, n, None, "read_mask"))]
        mom = self._replicate(parts)
        return tuple([m[k] for m in mom] for k in range(3))

    def __call__(self, a_pk, b_pk, begin_a, end_a, a_len, x_size,
                 force_start, lib_id, isize, read_mask):
        dirs, last_row, diag = self.forward(a_pk, b_pk, begin_a, end_a,
                                            a_len, x_size, force_start)
        lib_count, lib_sum, lib_sumsq = self.statistics(lib_id, isize,
                                                        read_mask)
        total_best = self._replicate(
            [lr.max(dim=1).values.to(torch.int64).sum() for lr in last_row])
        return (dirs, last_row, diag, lib_count, lib_sum, lib_sumsq,
                total_best)


def make_pipeline_step(devices, B: int, XW: int, AW: int, band: int,
                       n_reads: int, n_libs: int) -> PipelineStep:
    """The step over `devices` (a mesh from device_mesh, or a sequence of
    devices) for B problems of window XW (AW = a_width(XW, band) packed a
    codes) and n_reads reads of n_libs libraries; B and n_reads must
    split evenly over the devices."""
    return PipelineStep(devices, B, XW, AW, band, n_reads, n_libs)


def dryrun_inputs(n_dev: int):
    """The JAX dry-run's inputs for n devices
    (gam_ngs_tpu/parallel/step.py:81-104: B = 2n
    problems of 64 rows at band 8, 16n reads of 2 libraries, from
    np.random.default_rng(0)), the windows packed the port's way:
    ((B, XW, AW, band, n_reads, n_libs), the step's ten arguments,
    (a, b) unpacked)."""
    B, XW, band = 2 * n_dev, 64, 8
    n_reads, n_libs = 16 * n_dev, 2

    rng = np.random.default_rng(0)
    a = rng.integers(0, 4, size=(B, DRYRUN_A_LEN)).astype(np.uint8)
    # b = noisy copy of a's diagonal so alignments are non-trivial
    b = a[:, band:band + XW].copy()
    flip = rng.random(b.shape) < 0.05
    b[flip] = (b[flip] + 1) % 4
    begin_a = np.full(B, band, np.int32)
    end_a = np.full(B, band + XW - 1, np.int32)
    a_len = np.full(B, DRYRUN_A_LEN, np.int32)
    x_size = np.full(B, XW, np.int32)
    fstart = np.zeros(B, np.int32)
    lib_id = rng.integers(0, n_libs, size=n_reads).astype(np.int32)
    isize = rng.integers(150, 450, size=n_reads).astype(np.int32)
    mask = rng.random(n_reads) < 0.9

    a_pk, b_pk = pack_windows(a, band, b, band)
    dims = (B, XW, a_width(XW, band), band, n_reads, n_libs)
    return dims, (a_pk, b_pk, begin_a, end_a, a_len, x_size, fstart, lib_id,
                  isize, mask), (a, b)


def dryrun_step(devices):
    """One step over the n devices on dryrun_inputs(n); checks the
    statistics against numpy, that total_best > 0, and an engine over the
    same devices against bsw_align.  Returns the step's outputs."""
    from ..ops.bsw_engine import BswEngine
    from ..ops.bsw_ref import bsw_align

    devs = as_devices(devices)
    n_dev = len(devs)
    dims, args, (a, b) = dryrun_inputs(n_dev)
    _B, XW, _AW, band, _n_reads, n_libs = dims
    out = make_pipeline_step(devs, *dims)(*args)

    # every partial sum is an integer below 2^53: float64 sums are exact
    lib_id, isize, mask = args[7:]
    want = np.zeros((3, n_libs))
    for lib in range(n_libs):
        sel = isize[mask & (lib_id == lib)].astype(np.int64)
        want[:, lib] = (len(sel), sel.sum(), (sel * sel).sum())
    for d in range(n_dev):
        got = np.stack([out[k][d].cpu().numpy() for k in (3, 4, 5)])
        if not np.array_equal(got, want):
            raise AssertionError(f"sharded library statistics on device {d}"
                                 f": {got.tolist()} != {want.tolist()}")
        if int(out[6][d]) <= 0:
            raise AssertionError("total_best should be positive")

    # and the engine sharded over the same devices (traceback included)
    eng = BswEngine(devs, band=band)
    aln = eng.align_one(a[0], band, band + XW - 1, b[0], 0, XW - 1)
    ref = bsw_align(a[0], band, band + XW - 1, b[0], 0, XW - 1, band=band)
    if aln.score != ref.score:
        raise AssertionError("sharded engine diverged from bsw_align")
    return out
