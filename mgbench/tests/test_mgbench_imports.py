"""Nothing of mgbench imports JAX or the JAX package, and the reference
imports nothing of the port. Module names are compared by their top-level
name, whole: the port's name begins with the JAX package's."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from mgbench.harness import runner

BENCH_DIR = Path(__file__).resolve().parents[1]
PORT = "mixed_precision_multigrid_solvers_for_pdes_torch"
FILES = sorted(BENCH_DIR.rglob("*.py"))


def imported_top_levels(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


def test_the_forbidden_names_are_whole_top_levels():
    assert "mixed_precision_multigrid_solvers_for_pdes_tpu" in \
        runner.FORBIDDEN
    assert PORT not in runner.FORBIDDEN
    assert PORT.split(".")[0] != "mixed_precision_multigrid_solvers_for_pdes"


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(BENCH_DIR)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not imported_top_levels(path) & set(runner.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_port():
    for path in sorted((BENCH_DIR / "reference").rglob("*.py")):
        names = imported_top_levels(path)
        assert PORT not in names and "mgbench" not in names, path
        tree = ast.parse(path.read_text())
        assert not any(isinstance(n, ast.ImportFrom) and n.level
                       for n in ast.walk(tree)), path  # no relative import


def test_a_run_loads_no_jax(tmp_path):
    """A short run on the CPU at a tiny size, in a fresh process: once its
    window has closed, sys.modules holds none of the forbidden names."""
    code = (
        "import sys, time, torch\n"
        "from mgbench.harness import runner, spec\n"
        "conf = spec.config('poisson3d-513'); conf['n'] = 9\n"
        "mix = spec.traffic('ir-1e-9'); mix['samples'] = 1\n"
        "res, lines = runner.run_cell(conf, mix, seed=3, seconds=0.2,"
        " trace=False, device=torch.device('cpu'), per_layer=[],"
        " end_to_end=[], t_start=time.perf_counter())\n"
        "assert res['correct'], res\n"
        "print(runner.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH_DIR.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
