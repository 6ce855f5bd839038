"""BENCHMARK.json and the files it names, found by name.

A cell `<config>.<traffic>` of BENCHMARK.json's workloads reads
configs/<config>.json (the file its config entry names) and
traffic/<traffic>.json; every metric `<name>` is read by
metrics/<name>.py, a module with `read(run) -> float | None`.  Adding a
configuration, a traffic mix or a metric is adding files and entries:
nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def cell(bench: dict, workload: str, root: str = ROOT) -> dict:
    """The workload entry with its configuration, its traffic mix and the
    metrics it reports, each metric entry with its reader and its kind."""
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        names = ", ".join(w["name"] for w in bench["workloads"])
        raise SystemExit(f"unknown workload {workload!r} (one of {names})")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    with open(os.path.join(root, conf["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(root, "gpubench", "traffic", wl["traffic"] + ".json")) as fh:
        traffic = json.load(fh)
    metrics = []
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            if workload in m.get("workloads", [workload]):
                metrics.append(dict(m, kind=kind,
                                    read=reader(m["name"], root)))
    return {"workload": wl, "config": config, "traffic": traffic,
            "metrics": metrics}


def reader(name: str, root: str = ROOT):
    """metrics/<name>.py's read function (names may hold dots, so the
    module is loaded from its path)."""
    path = os.path.join(root, "gpubench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
