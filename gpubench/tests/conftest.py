import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU and nvcc (the hand-written "
        "kernels have no CPU mode); skipped without one")


# a genome a few kbp long, windows of a few hundred bp: the kernels' plain
# versions fill it in seconds on the CPU
TINY = {"genome_bp": 3000,
        "master": {"contig_n50_bp": 500}, "slave": {"contig_n50_bp": 800},
        "blocks": {"repeat_every_bp": 200, "repeat_bp": 20}}
TINY_TRAFFIC = {"pool_cells": 1e6, "min_stages": 2, "check_problems": 10,
                "check_workers": 2}


def copy_benchmark(dst: str) -> str:
    """BENCHMARK.json and gpubench's data and metric files under `dst`,
    every configuration cut to TINY and the traffic to TINY_TRAFFIC."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(ROOT, "gpubench", sub),
                        os.path.join(dst, "gpubench", sub))
    for sub, cut in (("configs", TINY), ("traffic", TINY_TRAFFIC)):
        d = os.path.join(dst, "gpubench", sub)
        for name in os.listdir(d):
            with open(os.path.join(d, name)) as fh:
                data = json.load(fh)
            for key, val in cut.items():
                if isinstance(val, dict):
                    data[key] = dict(data[key], **val)
                else:
                    data[key] = val
            with open(os.path.join(d, name), "w") as fh:
                json.dump(data, fh)
    return dst


@pytest.fixture
def tiny_root(tmp_path):
    return copy_benchmark(str(tmp_path))


@pytest.fixture
def one_thread():
    """The plain kernels pass torch's parallel grain: one intra-op thread
    keeps the runs steady beside other test workers."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
