"""Multi-process merge and create over torch.distributed (gloo):
partition sharding, one-deadline collectives and the canonical-order
regather (distributed), the sharded block join and summed library
stats (create_dist); and the sharded pipeline step over the devices of
one process with its dry-run (mesh, step).

device_mesh, mesh_axes, make_pipeline_step and dryrun_step load on first
use: step imports device, which imports parallel.distributed, so an
import here would run before device has finished loading."""

import importlib

_EXPORTS = {"device_mesh": "mesh", "mesh_axes": "mesh",
            "make_pipeline_step": "step", "dryrun_step": "step"}
__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__),
                   name)
