"""A whole run of a cell on the CPU (the kernels' plain versions, the
harness's look for a chip skipped) at a tiny size: sound, `correct`
comes out true; with the timed path broken underneath, false.  The
faults this cell can have: a round answered with the previous round's
answers (the state left unchanged), half of a round's answers left
out, and an answer altered where the engine decodes it.  The cell runs
on one chip, so it has no exchange between chips to leave out."""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

from gpubench import harness
from gpubench.tests.conftest import ROOT

SEED = 2**31 + 97


def _run(root, hook=None, workload="gage-rsph.align"):
    import torch

    return harness.run_cell(root, workload, SEED, 2.0, False,
                            device=torch.device("cpu"), engine_hook=hook)


def _stale(engine, _checked):
    real = engine.align_many
    last = []

    def align_many(problems):
        got = real(problems)
        out = (last * len(got))[:len(got)] if last else got
        last[:] = got
        return out

    engine.align_many = align_many


def _half(engine, _checked):
    from gam_ngs_tpu_torch.ops.editops import Alignment

    real = engine.align_many

    def align_many(problems):
        got = real(problems)
        keep = (len(got) + 1) // 2
        return got[:keep] + [Alignment() for _ in got[keep:]]

    engine.align_many = align_many


def _altered(engine, _checked):
    real = engine._collect

    def collect(pend, preps, out):
        real(pend, preps, out)
        for i in pend[0][:1]:  # the chunk's first answer
            out[i] = dataclasses.replace(out[i], score=out[i].score + 5)

    engine._collect = collect


def test_sound_run_is_correct(tiny_root, one_thread):
    result, checks = _run(tiny_root)
    assert result["correct"] is True and result["failed"] == 0
    assert checks["wrong_answers"] == {"value": 0, "limit": 0}
    assert result["attempted"] > 0
    assert {"align_Gcells_per_s", "setup_s"} <= set(result["metrics"])


@pytest.mark.parametrize("fault", [_stale, _half, _altered],
                         ids=["state_unchanged", "half_batch",
                              "answer_altered"])
def test_broken_path_is_not_correct(tiny_root, one_thread, fault):
    result, checks = _run(tiny_root, fault)
    assert result["correct"] is False
    assert checks["wrong_answers"]["value"] > 0


def test_added_files_make_a_new_cell(tiny_root, one_thread):
    """A configuration, a traffic mix and a metric added as files, and
    their entries in BENCHMARK.json: the harness runs the new cell and
    reports the new metric, with no edit to its code."""
    g = os.path.join(tiny_root, "gpubench")
    with open(os.path.join(g, "configs", "gage-rsph.json")) as fh:
        cfg = json.load(fh)
    cfg.update(name="tiny-other", genome_bp=4000)
    with open(os.path.join(g, "configs", "tiny-other.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(g, "traffic", "align.json")) as fh:
        traffic = json.load(fh)
    traffic.update(name="sparse", check_problems=4, layout_seed=5)
    with open(os.path.join(g, "traffic", "sparse.json"), "w") as fh:
        json.dump(traffic, fh)
    with open(os.path.join(g, "metrics", "problems_per_s.py"), "w") as fh:
        fh.write("def read(run):\n    return run.problems / run.window_s\n")
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as fh:
        bench = json.load(fh)
    bench["configs"].append({"name": "tiny-other", "source": "a test",
                             "file": "gpubench/configs/tiny-other.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny-other.sparse",
                               "config": "tiny-other", "traffic": "sparse",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "problems_per_s",
                                "unit": "problems/s", "better": "higher",
                                "bound": 0.1, "source": "host_clock",
                                "workloads": ["tiny-other.sparse"]})
    with open(path, "w") as fh:
        json.dump(bench, fh)
    result, _ = _run(tiny_root, workload="tiny-other.sparse")
    assert result["correct"] is True
    assert result["metrics"]["problems_per_s"]["value"] > 0
    assert result["metrics"]["problems_per_s"]["unit"] == "problems/s"


@pytest.mark.cuda
def test_cell_on_the_card():
    """run.py's whole path on a CUDA device: one short run of the first
    cell, its result line and its checks."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    res = subprocess.run([sys.executable, os.path.join(ROOT, "gpubench",
                                                       "run.py"),
                          "--workload", "gage-rsph.align", "--seed",
                          str(SEED), "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, timeout=900,
                         cwd=ROOT)
    assert res.returncode == 0, res.stderr[-4000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu"
    assert res.stderr.strip().splitlines()[-1].startswith(
        "check wrong_answers 0 limit 0")


def test_int16_control_is_not_correct(tiny_root, one_thread):
    """The control (control.py: the int16 reference in the program's
    place) through a whole run: windows long enough for a score past
    32767 wrap in int16, and the run reads false."""
    import torch

    from gpubench import control

    path = os.path.join(tiny_root, "gpubench", "configs", "gage-rsph.json")
    with open(path) as fh:
        cfg = json.load(fh)
    cfg["genome_bp"] = 16000  # the longest window 11,232 rows
    cfg["master"]["contig_n50_bp"] = 9000
    cfg["slave"]["contig_n50_bp"] = 12000
    cfg["blocks"].update(repeat_every_bp=14000, repeat_bp=50)
    with open(path, "w") as fh:
        json.dump(cfg, fh)
    result, checks = control.control_run(tiny_root, "gage-rsph.align", SEED,
                                         2.0, device=torch.device("cpu"))
    assert result["correct"] is False
    assert checks["wrong_answers"]["value"] > 0
