"""Device meshes for the sharded pipeline step (parallel/step.py).

gam_ngs_tpu/parallel/mesh.py with torch devices: a mesh is a numpy
object array of torch.devices of shape mesh_axes(n), read in row-major
order as the JAX `P((HOST_AXIS, DATA_AXIS))` sharding deals the batch.
The workload is data-parallel (alignment problems and read-table rows
are independent), so both axes shard the batch and the only reductions
are the library statistics and the total score.  The DP band is never
split across devices: one band row fits one warp.

There is no global device: "cuda" names the GPUs torch sees and raises
when there are too few; "cpu" (n copies of the CPU, the JAX package's
virtual CPU mesh) runs only when asked for by name.
"""

from __future__ import annotations

import numpy as np
import torch

DATA_AXIS = "part"   # graph-partition / problem-batch axis
HOST_AXIS = "host"   # outer axis for multi-host layouts


def mesh_axes(n_devices: int) -> tuple[int, int]:
    """Factor n into (host-like, chip-like) axes: outer = the largest
    divisor ≤ √n (8 → (2, 4), 6 → (2, 3), 7 → (1, 7))."""
    outer = 1
    for d in range(1, int(np.sqrt(n_devices)) + 1):
        if n_devices % d == 0:
            outer = d
    return (outer, n_devices // outer)


def device_mesh(n_devices: int | None = None, device: str = "cuda"):
    """A (host, part) array of n torch.devices: the first n GPUs torch
    sees ("cuda"), or n copies of the CPU ("cpu").  n=None takes every
    GPU, or one CPU."""
    if device == "cpu":
        n = n_devices or 1
        devs = [torch.device("cpu")] * n
    elif device == "cuda":
        have = torch.cuda.device_count()
        n = n_devices or max(have, 1)
        if have < n:
            raise RuntimeError(f"need {n} devices, have {have}")
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        raise ValueError(f"device {device!r}: cuda or cpu")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return arr.reshape(mesh_axes(n))
