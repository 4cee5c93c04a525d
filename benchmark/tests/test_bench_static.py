"""What the benchmark's sources import, and what ``run.py`` does where
there is no card."""

import ast
import subprocess
import sys

from bench_tiny import BENCH, CHECKOUT

JAX = {"jax", "jaxlib", "flax", "gotennet_tpu"}


def imported(path):
    """Top-level names of every module ``path`` imports."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        names = set(imported(f))
        # top-level names compared whole: gotennet_tpu_torch is the port
        assert not names & JAX, (f, names & JAX)


def test_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").glob("*.py")):
        assert "gotennet_tpu_torch" not in set(imported(f)), f


def test_run_fails_without_a_card():
    """No card here: the run exits non-zero and prints no result."""
    import torch
    assert not torch.cuda.is_available()
    p = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", "qm9_train",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=CHECKOUT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "card" in p.stderr


def test_run_fails_outside_a_checkout(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark, the card's
    look left out: the run stops at the missing program."""
    import shutil
    shutil.copytree(BENCH, tmp_path / "benchmark")
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    code = ("import json, sys, time; sys.path[:0] = ['benchmark'];"
            "from harness.runner import run_cell;"
            "from pathlib import Path;"
            "b = json.load(open('BENCHMARK.json'));"
            "print(run_cell(Path('benchmark'), b, 'qm9_screen', 1, 1.0,"
            " False, 'cpu', time.perf_counter()))")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "gotennet_tpu_torch" in p.stderr
