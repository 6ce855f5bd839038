"""Device selection: a name from the command line -> torch.device.

There is no fallback: `auto` and `cuda` need a CUDA device and raise
without one; the CPU runs only when it is asked for by name.  Under a
torch.distributed process group, `auto` and `cuda` give rank k the GPU
cuda:(k mod the GPUs this process sees), so ranks on one host spread
over its GPUs and share them when there are more ranks than GPUs."""

from __future__ import annotations

import torch

from .parallel.distributed import proc_info


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
