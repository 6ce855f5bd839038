"""The port's create + merge end to end on the CPU (the kernels' plain
PyTorch versions) against the JAX package's merge with its BswEngine:
the six outputs byte for byte and the same .metrics.json keys; plus the
oracle path, --checkpoint resume, the CLI in a process where neither JAX
nor the JAX package can be imported, and a guard that no module of the
port imports either."""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import torch_problems as tp
from gam_ngs_tpu.io import fasta
from gam_ngs_tpu.models.merge import MergeOptions as JaxMergeOptions
from gam_ngs_tpu.models.merge import run_merge as jax_run_merge
from gam_ngs_tpu.ops.bsw_batch import BswEngine as JaxEngine
from gam_ngs_tpu_torch import cli
from gam_ngs_tpu_torch.models.create import CreateOptions, run_create
from gam_ngs_tpu_torch.models.merge import MergeOptions, run_merge
from gam_ngs_tpu_torch.ops.bsw_engine import BswEngine
from test_merge_pipeline import _build_inputs

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUTPUTS = (".gam.fasta", ".pctgs", ".stats", ".noblocks.BF.fasta",
           ".noblocks.AF.fasta", ".notmerged.fasta")
CPU = torch.device("cpu")
quiet = lambda *_: None  # noqa: E731


def _create(tmp, ml, sl):
    return run_create(CreateOptions(
        master_bam_file=ml, slave_bam_file=sl, min_block_size=10,
        output_file_prefix=str(tmp / "out"), engine="native"), log=quiet)


def _common(tmp, ml, sl, mfa, sfa):
    return dict(master_bam_file=ml, slave_bam_file=sl,
                blocks_file=str(tmp / "out.blocks"), master_fasta_file=mfa,
                slave_fasta_file=sfa, min_block_size=10)


def _outputs(tmp, tag):
    return {ext: (tmp / f"{tag}{ext}").read_bytes() for ext in OUTPUTS}


def _key_set(path):
    m = json.load(open(path))
    return [sorted(m)] + [sorted(m[k]) for k in ("phases", "counters",
                                                 "rates")]


@pytest.mark.parametrize("corpus", ["junction", "two_partitions",
                                    "fork_bubble"])
def test_merge_matches_jax(tmp_path, corpus):
    genomes = None  # the fork's slave misjoin reconstructs no genome
    if corpus == "junction":
        genome, ml, sl, mfa, sfa = _build_inputs(tmp_path)
        genomes = [genome]
    elif corpus == "two_partitions":
        genomes, ml, sl, mfa, sfa = tp.two_partition_corpus(tmp_path)
    else:
        ml, sl, mfa, sfa = tp.fork_bubble_corpus(tmp_path)
    blocks = _create(tmp_path, ml, sl)
    assert len(blocks) >= 2
    common = _common(tmp_path, ml, sl, mfa, sfa)
    jax_run_merge(JaxMergeOptions(output_file_prefix=str(tmp_path / "jax"),
                                  engine=JaxEngine(), **common), log=quiet)
    eng = BswEngine(CPU)
    pctgs = run_merge(MergeOptions(output_file_prefix=str(tmp_path / "port"),
                                   engine=eng, **common), log=quiet)
    assert _outputs(tmp_path, "port") == _outputs(tmp_path, "jax")
    assert _key_set(tmp_path / "port.metrics.json") == \
        _key_set(tmp_path / "jax.metrics.json")
    if genomes is None:
        stats = (tmp_path / "port.stats").read_text()
        assert "Forks = 1\nBubbles = 1\n" in stats
    else:
        merged = sorted(fasta.codes_to_bytes(p.sequence()).decode()
                        for p in pctgs)
        assert merged == sorted(genomes)
    assert eng.dispatches > 0 and eng.cells_aligned > 0


def test_oracle_path_and_checkpoint_resume(tmp_path):
    genome, ml, sl, mfa, sfa = _build_inputs(tmp_path)
    _create(tmp_path, ml, sl)
    common = _common(tmp_path, ml, sl, mfa, sfa)
    run_merge(MergeOptions(output_file_prefix=str(tmp_path / "oracle"),
                           **common), log=quiet)
    for _ in range(2):  # first run writes the checkpoints, second resumes
        run_merge(MergeOptions(output_file_prefix=str(tmp_path / "ck"),
                               engine=BswEngine(CPU), checkpoint=True,
                               **common), log=quiet)
        assert _outputs(tmp_path, "ck") == _outputs(tmp_path, "oracle")
        assert os.listdir(tmp_path / "ck.ckpt")
    m = json.load(open(tmp_path / "ck.metrics.json"))
    assert m["counters"]["aligned_cells"] == 0  # every graph resumed


# run first in a child process: neither JAX nor the JAX package loads
BLOCK_JAX = ("import sys; sys.modules['jax'] = None; "
             "sys.modules['gam_ngs_tpu'] = None; ")


def test_cli_runs_without_jax(tmp_path):
    """create --device native and merge --device cpu through the port's
    CLI in a process where `import jax` and `import gam_ngs_tpu` fail."""
    genome, ml, sl, mfa, sfa = _build_inputs(tmp_path)
    prog = (BLOCK_JAX + "from gam_ngs_tpu_torch.cli import main; "
            "sys.exit(main(sys.argv[1:]))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = str(tmp_path / "out")
    for argv in (["create", "--master-bam", ml, "--slave-bam", sl,
                  "--min-block-size", "10", "--output", out,
                  "--device", "native"],
                 ["merge", "--master-bam", ml, "--slave-bam", sl,
                  "--blocks-file", out + ".blocks", "--master-fasta", mfa,
                  "--slave-fasta", sfa, "--min-block-size", "10",
                  "--output", out, "--device", "cpu"]):
        r = subprocess.run([sys.executable, "-c", prog, *argv], env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
    recs = fasta.read_fasta(out + ".gam.fasta")
    assert [fasta.codes_to_bytes(s).decode() for _n, s in recs] == [genome]


def test_cli_n50_matches_and_refusals(tmp_path, capsys):
    from gam_ngs_tpu import cli as jax_cli

    genome, ml, sl, mfa, sfa = _build_inputs(tmp_path)
    assert cli.main(["n50", mfa]) == 0
    ours = capsys.readouterr().out
    assert jax_cli.main(["n50", mfa]) == 0
    assert ours == capsys.readouterr().out and ours
    # create and merge --coordinator run (test_torch_dist2proc.py); a
    # coordinator without the group's size and rank is refused
    with pytest.raises(ValueError, match="needs --num-processes"):
        cli.main(["create", "--master-bam", ml, "--slave-bam", sl,
                  "--coordinator", "localhost:1234"])
    with pytest.raises(SystemExit):  # tpu is not a device of the port
        cli.main(["merge", "--master-bam", ml, "--slave-bam", sl,
                  "--blocks-file", "x", "--master-fasta", mfa,
                  "--slave-fasta", sfa, "--device", "tpu"])


def test_port_never_imports_jax():
    """No module of gam_ngs_tpu_torch imports jax, jax.*, gam_ngs_tpu or
    gam_ngs_tpu.*: the port keeps its own copies of the host layers."""
    files = sorted((ROOT / "gam_ngs_tpu_torch").rglob("*.py"))
    assert len(files) >= 50
    assert ROOT / "gam_ngs_tpu_torch" / "parallel" / "distributed.py" in files
    for f in files + [ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("jax", "gam_ngs_tpu"), (f, n)


def test_port_imports_without_the_jax_package():
    """Every module of the port, tests/torch_problems.py and chip_smoke.py
    (module import, no main()) load in a process where jax and
    gam_ngs_tpu cannot be imported, and no gam_ngs_tpu module loads."""
    prog = BLOCK_JAX + """
import importlib, pathlib
mods = [".".join(f.with_suffix("").parts).removesuffix(".__init__")
        for f in sorted(pathlib.Path("gam_ngs_tpu_torch").rglob("*.py"))]
assert "gam_ngs_tpu_torch.parallel.distributed" in mods
for name in mods:
    importlib.import_module(name)
sys.path.insert(0, "tests")
import torch_problems, chip_smoke
bad = [k for k, v in sys.modules.items() if v is not None
       and k.split(".")[0] in ("jax", "gam_ngs_tpu")]
assert not bad, bad
print(len(mods))
"""
    r = subprocess.run([sys.executable, "-c", prog], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert int(r.stdout.split()[-1]) >= 50


def test_smoke_never_imports_the_jax_package():
    """chip_smoke.py and the helper it loads import nothing of
    gam_ngs_tpu (nor the test fabric and bench scripts built on it)."""
    banned = ("jax", "gam_ngs_tpu", "testutil", "e2e_scale")
    for f in (ROOT / "chip_smoke.py", ROOT / "tests" / "torch_problems.py"):
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in banned, (f, n)
