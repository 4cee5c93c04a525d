"""One run of one cell: set-up, the measured window, the optional traced
stretch, the comparison with the reference, and the result's line.

``run_cell`` takes the device as it is given: the look for a card is
``run.py``'s, so that a test can drive a whole run on the CPU."""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from harness.compare import judge
from harness.registry import Registry

FORBIDDEN = ("jax", "jaxlib", "flax", "gotennet_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


class Context:
    """What a traffic loop gets: the cell, its files, the seed, the window,
    the device, and the fault to plant (tests and calibration only)."""

    def __init__(self, reg: Registry, cell: str, seed: int, seconds: float,
                 trace: bool, device, fault: Optional[str] = None):
        self.reg = reg
        self.cell = reg.cell(cell)
        self.name = cell
        self.config = reg.config(self.cell["config"])
        self.traffic = reg.traffic(self.cell["traffic"])
        # every generator takes a non-negative seed
        self.seed = int(seed) % 2 ** 63
        self.seconds = float(seconds)
        self.trace = trace
        self.device = torch.device(device)
        self.fault = fault

    def peak_bytes(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def reset_peak(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def run_cell(root: Path, bench: dict, cell: str, seed: int, seconds: float,
             trace: bool, device, t_start: float,
             fault: Optional[str] = None) -> Dict:
    """The result object of one run (without printing it)."""
    reg = Registry(root, bench)
    ctx = Context(reg, cell, seed, seconds, trace, device, fault)
    loop = reg.mode(ctx.traffic["mode"]).Loop(ctx)
    loop.setup()
    setup_s = time.perf_counter() - t_start
    print("set-up seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in [("before the loop", setup_s - sum(
            loop.stages.values()))] + list(loop.stages.items())),
        file=sys.stderr)
    out = loop.measure()
    out["e2e"]["setup_s"] = setup_s
    memory_peak = ctx.peak_bytes()
    out["e2e"]["peak_mem_gib"] = memory_peak / 2 ** 30
    data = out.get("data", {})
    if trace:
        data["trace"] = loop.traced()
    loop.release()
    t_check = time.perf_counter()
    numbers = loop.check()
    numbers["_check_s"] = time.perf_counter() - t_check
    correct, checks = judge(numbers, reg.limits(cell)["limits"])
    correct = correct and out["failed"] == 0

    group = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in reg.metrics_of(cell, group):
        if group == "end_to_end":
            value = out["e2e"][m["name"]]
        else:
            value = reg.reader(m["name"]).read(data)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(ctx.device)
                    if ctx.device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": memory_peak}
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace and data.get("trace"):
        tr = data["trace"]
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["notes"] = {k: v for k, v in numbers.items()
                       if k.startswith("_")}
    result["notes"]["numbers"] = {k: v for k, v in numbers.items()
                                  if not k.startswith("_")}
    if trace and data.get("trace"):
        result["notes"].update({k: data["trace"][k] for k in (
            "kernel_launches", "kernel_launches_seen", "kernel_spans",
            "kernel_bound_s", "kernel_time_s", "host_op_s", "host_busy_s",
            "host_window_s")})
    result["checks"] = checks
    return result


def emit(result: Dict) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
