"""Device selection: a name from the command line -> torch.device(s).

There is no fallback: `auto` and `cuda` need a CUDA device and raise
without one; the CPU runs only when it is asked for by name.  Under a
torch.distributed process group, `auto` and `cuda` give rank k the GPU
cuda:(k mod the GPUs this process sees), so ranks on one host spread
over its GPUs and share them when there are more ranks than GPUs.  In
one process, merge's engine takes every GPU the process sees
(resolve_devices: the JAX CLI's local mesh)."""

from __future__ import annotations

import numpy as np
import torch

from .parallel.distributed import proc_info


def as_devices(device) -> tuple:
    """A torch.device, a name, a sequence of them or a mesh
    (parallel.mesh.device_mesh, read in row-major order) -> a non-empty
    tuple of torch.devices."""
    if isinstance(device, (str, torch.device)):
        return (torch.device(device),)
    if isinstance(device, np.ndarray):
        device = device.ravel().tolist()
    devices = tuple(torch.device(d) for d in device)
    if not devices:
        raise ValueError("no device given")
    return devices


def resolve_device(name: str) -> torch.device:
    """'auto' | 'cuda' | 'cuda:N' -> a CUDA device (raises when CUDA is
    unavailable); 'cpu' -> the CPU."""
    if name == "cpu":
        return torch.device("cpu")
    if name == "auto" or name == "cuda" or name.startswith("cuda:"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} needs a CUDA GPU and torch sees none; "
                f"pass --device cpu to run the plain PyTorch path")
        if name.startswith("cuda:"):
            return torch.device(name)
        rank, world = proc_info()
        if world == 1:
            return torch.device("cuda" if name == "auto" else name)
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        print(f"[main] process {rank}/{world}: --device {name} -> {dev} "
              f"({torch.cuda.get_device_name(dev)})", flush=True)
        return dev
    raise ValueError(f"unknown device {name!r} (auto, cuda, cpu)")


def resolve_devices(name: str, multi_process: bool) -> tuple:
    """The merge engine's devices: 'auto' | 'cuda' in one process -> every
    GPU torch.cuda.device_count() reports (the JAX CLI's local mesh,
    gam_ngs_tpu/cli.py:132-145); under a process group (multi_process)
    one GPU a rank, as resolve_device gives it; 'cuda:N' -> that GPU;
    'cpu' -> the CPU.  Raises without a GPU, as resolve_device does."""
    dev = resolve_device(name)
    if dev.type == "cuda" and not multi_process and name in ("auto",
                                                             "cuda"):
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (dev,)
