"""Trace capture and a time breakdown over ``torch.profiler``
(``gotennet_tpu/utils/profiling.py``).

``capture_trace`` runs a callable under the profiler (CPU and, where there
is a card, CUDA activity) and writes its Chrome trace; ``summarize_trace``
sums the trace's complete events by category: CUDA kernels, memcpy and
memset (the device's), and CPU ops (each thread's outermost ops, so nested
ones count once).  ``total_us`` is the device total, or the CPU ops' where
the trace holds no device event (a run on the CPU); ``top_ops`` are the
events of that same total by name.  ``profile_fn`` does both and prints
the total and the categories.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
from typing import Callable, Dict, Optional

import torch

__all__ = ["capture_trace", "summarize_trace", "profile_fn"]

TRACE_FILE = "trace.json"
# Chrome-trace categories of torch.profiler's events
_DEVICE = {"kernel": "CUDA kernels", "gpu_memcpy": "memcpy",
           "gpu_memset": "memset"}
_CPU = "cpu_op"


def capture_trace(fn: Callable[[], None],
                  trace_dir: Optional[str] = None) -> str:
    """Run ``fn`` under ``torch.profiler`` and write ``trace.json`` into
    ``trace_dir`` (a new temporary directory when None); returns the
    directory.  Where there is a card, the device is synchronised before
    the window closes, so the kernels ``fn`` launched land in it."""
    from torch.profiler import ProfilerActivity, profile

    trace_dir = trace_dir or tempfile.mkdtemp(prefix="gotennet_trace_")
    os.makedirs(trace_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
    return trace_dir


def _outermost(events):
    """The events not inside another one of the same thread."""
    by_thread = collections.defaultdict(list)
    for e in events:
        by_thread[(e.get("pid"), e.get("tid"))].append(e)
    for evs in by_thread.values():
        end = float("-inf")
        for e in sorted(evs, key=lambda e: (e["ts"], -e["dur"])):
            if e["ts"] >= end:
                end = e["ts"] + e["dur"]
                yield e


def summarize_trace(trace_dir: str, top_k: int = 15) -> Dict:
    """``{'total_us', 'by_category_us', 'top_ops': [{'name', 'us'}]}`` of
    the trace in ``trace_dir`` (microseconds)."""
    path = os.path.join(trace_dir, TRACE_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no trace file under {trace_dir}")
    with open(path) as f:
        trace = json.load(f)
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in _DEVICE]
    cpu = list(_outermost([e for e in events if e.get("cat") == _CPU]))
    by_cat = collections.Counter()
    for e in device:
        by_cat[_DEVICE[e["cat"]]] += e["dur"]
    by_cat["CPU ops"] += sum(e["dur"] for e in cpu)
    counted = device or cpu
    by_op = collections.Counter()
    for e in counted:
        by_op[e["name"]] += e["dur"]
    return {
        "total_us": sum(e["dur"] for e in counted),
        "by_category_us": dict(by_cat.most_common()),
        "top_ops": [{"name": n, "us": us}
                    for n, us in by_op.most_common(top_k)],
    }


def profile_fn(fn: Callable[[], None], top_k: int = 15,
               print_summary: bool = True) -> Dict:
    """Capture and summarise ``fn`` in one call; print the total (device,
    or CPU where no device event was seen) and each category's ms."""
    s = summarize_trace(capture_trace(fn), top_k)
    if print_summary:
        where = ("device" if any(s["by_category_us"].get(c)
                                 for c in _DEVICE.values()) else "CPU")
        print(f"{where} total: {s['total_us'] / 1e3:.2f} ms")
        for cat, us in s["by_category_us"].items():
            print(f"  {us / 1e3:9.2f} ms  {cat}")
    return s
