"""The port stands alone: no module of ``gotennet_tpu_torch``, and not
``chip_smoke.py``, imports JAX, flax, optax, orbax, PyYAML or the JAX
package, and all of them import in a fresh interpreter where those names
are blocked."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "gotennet_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
BLOCKED = ("jax", "flax", "optax", "orbax", "yaml", "gotennet_tpu")

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
for name in %r:
    sys.modules[name] = None
import gotennet_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gotennet_tpu_torch.__path__,
                                               "gotennet_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(" ".join(names))
print(len(names))
""" % (BLOCKED,)


def test_every_module_imports_with_jax_blocked():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    # ops, nn, graph, data, models, tasks, train, utils and their modules,
    # the command line, the heads, the MD readers, the edge-list layout's
    # batch, segment ops and norms, and the tools among them
    assert int(out.stdout.split()[-1]) >= 55
    names = set(out.stdout.split())
    for module in ("cli", "data.md17", "models.heads", "utils.convert",
                   "train.trainer", "graph.batch", "graph.segment",
                   "nn.norms", "data.molecule3d", "parallel",
                   "parallel.mesh", "parallel.collectives",
                   "parallel.distributed", "parallel.data_parallel",
                   "utils.params", "utils.hub", "utils.sweep",
                   "utils.profiling", "utils.bench_multichip"):
        assert f"gotennet_tpu_torch.{module}" in names, module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_statement_names_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [node.module.split(".")[0]]
        else:
            continue
        assert not set(roots) & set(BLOCKED), (path.name, node.lineno)
