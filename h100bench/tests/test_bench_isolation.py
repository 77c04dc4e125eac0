"""What a run may load and read: no JAX, no JAX package, nothing of bench.py
or benchmarks/; and no run without a card."""

import ast
import json
import subprocess
import sys

import pytest

import harness
from smallcells import ROOT

BENCH = harness.BENCH


@pytest.mark.parametrize("loaded, found", [
    (["jax"], ["jax"]), (["jax.numpy"], ["jax"]), (["jaxlib.xla"], ["jaxlib"]),
    (["flax"], ["flax"]), (["tpu_multigrid.cycles"], ["tpu_multigrid"]),
    (["tpu_multigrid_torch", "jax_helpers", "flaxen", "tpu_multigrid_x"], [])])
def test_forbidden_modules_compare_whole_top_level_names(loaded, found):
    code = (f"import sys, types\nsys.path.insert(0, {str(BENCH)!r})\n"
            f"sys.path.insert(1, {str(ROOT)!r})\nimport harness\n"
            f"for m in {loaded!r}: sys.modules[m] = types.ModuleType(m)\n"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == repr(found)


def test_a_cpu_run_loads_no_jax():
    code = (f"import sys\nsys.path.insert(0, {str(BENCH / 'tests')!r})\n"
            f"sys.path.insert(0, {str(BENCH)!r})\n"
            f"sys.path.insert(1, {str(ROOT)!r})\n"
            "import harness, smallcells\n"
            "smallcells.run_small('poisson3d-513.vcycles-3', 0.2)\n"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_import_no_jax_nor_the_old_benchmarks():
    for path in BENCH.rglob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in harness.FORBIDDEN + ("bench", "benchmarks"), (
                path, name)
        if "tests" not in path.parts:
            text = path.read_text()
            assert "bench.py" not in text and "benchmarks/" not in text, path


@pytest.mark.parametrize("cell", ["poisson2d-8193.refined-1e-7",
                                  "poisson3d-513.vcycles-3"])
def test_no_card_no_result(cell):
    """Without a CUDA card the command exits non-zero and prints no line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "h100bench/run.py", "--workload",
                          cell, "--seed", "1", "--seconds", "1", "--trace",
                          "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr
    with pytest.raises(json.JSONDecodeError):
        json.loads(out.stdout or "x")
