"""A copy of the benchmark, cut to a size that the CPU runs in seconds:
every configuration at 32 channels and 4 heads, every pool and batch
small.  ``tiny_tree(tmp)`` writes it under ``tmp`` (with its own
``BENCHMARK.json``) and returns ``(benchmark root, bench dict)``."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
CHECKOUT = BENCH.parent
for p in (str(BENCH), str(CHECKOUT)):
    if p not in sys.path:
        sys.path.insert(0, p)

SEED = 2 ** 31 + 11


def tiny_tree(tmp) -> tuple:
    tmp = Path(tmp)
    root = tmp / "benchmark"
    shutil.copytree(BENCH, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        p = tmp / c["file"]
        cfg = json.loads(p.read_text())
        cfg["model"].update(n_atom_basis=32, num_heads=4, n_rbf=16,
                            head_hidden=32)
        p.write_text(json.dumps(cfg))
    for p in root.glob("workloads/*.json"):
        t = json.loads(p.read_text())
        if t["pool"]["kind"] == "molecules":
            t["pool"].update(n=256, min_atoms=5, max_atoms=14)
            t["batch_atoms"] = [8, 16]
            sizes = {"batch_size": 16, "request_size": 64, "chunk": 16,
                     "reference_block": 8}
        else:
            t["pool"].update(n=16, n_atoms=20)
            t["batch_atoms"] = [24]
            sizes = {"batch_size": 4, "request_size": 4, "chunk": 4,
                     "reference_block": 2}
        t.update({k: v for k, v in sizes.items() if k in t})
        t["trace_iterations"] = 2
        p.write_text(json.dumps(t))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, bench


def run(root, bench, cell, seconds=0.5, trace=False, fault=None,
        seed=SEED):
    import time
    from harness.runner import run_cell
    return run_cell(root, bench, cell, seed, seconds, trace, "cpu",
                    time.perf_counter(), fault)
