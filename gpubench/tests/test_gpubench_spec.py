"""BENCHMARK.json against the benchmark's contract, and the harness
finding a configuration, a traffic mix and a metric added as files."""

import json
import os
import re
import subprocess
import sys

import pytest

from gpubench import spec
from gpubench.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_names_and_units():
    b = _bench()
    assert set(b) == KEYS
    assert len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert any(c["file"].startswith(p + "/") for p in b["paths"])
        names.append(c["name"])
    cells = []
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        cells.append(w["name"])
    assert len(set(cells)) == len(cells)
    assert all(any(w["config"] == c for w in b["workloads"]) for c in names)
    e2e = {}
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        e2e[m["name"]] = m
    assert "setup_s" in e2e
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m.get("workloads", cells):
            assert w in e2e[m["moves"]].get("workloads", cells)
    all_names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(all_names)) == len(all_names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
        assert callable(spec.reader(m["name"]))
    for w in cells:  # setup_s, another end-to-end metric, a per-layer one
        assert sum(w in m.get("workloads", cells)
                   for m in b["end_to_end"]) >= 2
        assert any(w in m.get("workloads", cells) for m in b["per_layer"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10


def test_every_cell_loads():
    b = _bench()
    for w in b["workloads"]:
        cell = spec.cell(b, w["name"])
        assert cell["config"]["name"] == w["config"]
        assert cell["traffic"]["name"] == w["traffic"]
        assert cell["config"]["reduced"] == next(
            c["reduced"] for c in b["configs"] if c["name"] == w["config"])


def test_run_refuses_without_enough_devices(tmp_path):
    """Without a CUDA device, run.py exits non-zero and prints nothing on
    standard output."""
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, os.path.join(ROOT, "gpubench",
                                                       "run.py"),
                          "--workload", "gage-rsph.align", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout == ""
