"""Nothing the benchmark runs imports JAX or the JAX package, compared
by whole top-level module name (gam_ngs_tpu_torch begins with
gam_ngs_tpu), and nothing reads the older benchmark (bench/, bench.py)."""

import ast
import glob
import os
import re
import subprocess
import sys

from gpubench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "gam_ngs_tpu", "bench"}


def _sources():
    return [p for p in glob.glob(os.path.join(ROOT, "gpubench", "**",
                                              "*.py"), recursive=True)
            if os.sep + "tests" + os.sep not in p]


def test_no_forbidden_import_in_the_sources():
    for path in _sources():
        with open(path) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = [node.module.split(".")[0]]
            else:
                continue
            assert not set(tops) & FORBIDDEN, (path, tops)
        with open(path) as fh:
            text = fh.read()
        assert not re.search(r"(?<![A-Za-z0-9_])bench(/|\.py)", text), path


def test_no_forbidden_module_once_loaded():
    """Import every module the harness and the program's engine load, in
    a fresh interpreter, and look at sys.modules by whole top-level
    names."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import gpubench.harness, gpubench.control, gpubench.check\n"
        "import gam_ngs_tpu_torch.ops.bsw_engine, gam_ngs_tpu_torch.device\n"
        "from gpubench import spec\n"
        "b = spec.load_benchmark()\n"
        "for w in b['workloads']: spec.cell(b, w['name'])\n"
        "from gpubench.harness import forbidden_modules\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "assert 'gam_ngs_tpu_torch' in tops\n"
        "print(sorted(tops & %r), forbidden_modules())\n" % (ROOT, FORBIDDEN))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[] []"


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from gpubench.harness import forbidden_modules

    monkeypatch.setitem(sys.modules, "gam_ngs_tpu_torch_x", sys)
    assert "gam_ngs_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "gam_ngs_tpu.ops", sys)
    assert "gam_ngs_tpu" in forbidden_modules()
