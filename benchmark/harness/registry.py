"""Finding a cell's files by the names in ``BENCHMARK.json``: nothing here
knows a configuration, traffic mix, metric or kernel by name.

- ``configs/<config>.json``: the model and the paths it runs;
- ``workloads/<traffic>.json``: the traffic mix, whose ``mode`` names the
  loop ``traffic/<mode>.py`` that runs it;
- ``limits/<cell>.json``: the limit of each number compared for the cell;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(data)``;
- ``kernels/<wrapper>.py``: a kernel wrapper's bound.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List


def load_module(path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"the benchmark has no file {path}")
    return json.loads(path.read_text())


class Registry:
    def __init__(self, root: Path, bench: dict):
        self.root = Path(root)
        self.bench = bench

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return _json(self.root.parent / c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _json(self.root / "workloads" / f"{name}.json")

    def mode(self, name: str) -> ModuleType:
        return load_module(self.root / "traffic" / f"{name}.py")

    def limits(self, cell: str) -> dict:
        return _json(self.root / "limits" / f"{cell}.json")

    def metrics_of(self, cell: str, group: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics the cell reports."""
        return [m for m in self.bench[group]
                if "workloads" not in m or cell in m["workloads"]]

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.root / "metrics" / f"{metric}.py")

    def kernels(self) -> List[ModuleType]:
        return [load_module(p) for p in
                sorted((self.root / "kernels").glob("*.py"))
                if not p.name.startswith("_")]
