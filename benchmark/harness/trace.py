"""Reading a ``torch.profiler`` Chrome trace.

``outermost`` and the device categories are copied from the program's
``gotennet_tpu_torch/utils/profiling.py`` (``_outermost``,
``summarize_trace``): each thread's outermost CPU ops, so that nested ones
count once. The host's time inside them leaves out the synchronising
runtime calls and copies nested in them, which wait for the device. The
rest is the benchmark's: the union of the device's intervals (kernels,
copies, sets), the idle gaps between them named by the benchmark span open
on the host meanwhile, the device ops that took the most time, and the
device time of the work launched inside each kernel wrapper's span, found
through the launch's correlation id (the runtime call that launched a
kernel lies inside the span on the same thread)."""

from __future__ import annotations

import bisect
import collections
import json
from typing import Dict, List, Optional

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
CPU_CAT = "cpu_op"
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
SPAN_CAT = "user_annotation"


def outermost(events):
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


def union(intervals) -> List[List[float]]:
    """Merged ``[start, end]`` intervals, in order."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost_span(spans, t: float) -> Optional[str]:
    """The name of the shortest span that holds time ``t``."""
    best = None
    for s in spans:
        if s["ts"] <= t <= s["ts"] + s["dur"]:
            if best is None or s["dur"] < best["dur"]:
                best = s
    return best["name"] if best is not None else None


def read(path: str, top: int = 10) -> Dict:
    """Everything the per-layer metrics and the breakdown take from one
    trace file (times in seconds)."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    cpu = list(outermost([e for e in events if e.get("cat") == CPU_CAT]))
    spans = [e for e in events if e.get("cat") == SPAN_CAT
             and str(e.get("name", "")).startswith("bench.")]
    merged = union((e["ts"], e["ts"] + e["dur"]) for e in device)
    busy_us = sum(e - s for s, e in merged)

    by_op = collections.Counter()
    for e in device:
        by_op[e["name"]] += e["dur"]

    # idle gaps inside the traced region, named by the host's span
    region = [s for s in spans if s["name"] == "bench.trace"]
    gaps = collections.Counter()
    if region:
        lo, hi = region[0]["ts"], region[0]["ts"] + region[0]["dur"]
        inner = [s for s in spans if s["name"] != "bench.trace"
                 and not s["name"].startswith("bench.kernel.")]
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        for a, b in zip(edges[0::2], edges[1::2]):
            a, b = max(a, lo), min(b, hi)
            if b > a:
                name = _innermost_span(inner, 0.5 * (a + b)) or "bench.none"
                gaps[name[len("bench."):]] += b - a

    # device time of the work launched inside each kernel wrapper's span
    launch_at = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS:
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                launch_at[c] = (e.get("tid"), e["ts"])
    kspans = collections.defaultdict(list)
    for s in spans:
        if s["name"].startswith("bench.kernel."):
            kspans[s.get("tid")].append(s)
    starts = {t: sorted(v, key=lambda s: s["ts"]) for t, v in kspans.items()}
    keys = {t: [s["ts"] for s in v] for t, v in starts.items()}
    kernel_us = collections.Counter()
    for e in device:
        c = (e.get("args") or {}).get("correlation")
        tid, ts = launch_at.get(c, (None, None))
        if tid not in starts:
            continue
        i = bisect.bisect_right(keys[tid], ts) - 1
        if i >= 0:
            s = starts[tid][i]
            if ts <= s["ts"] + s["dur"]:
                kernel_us[s["name"][len("bench.kernel."):]] += e["dur"]
    # host time inside the outermost ops, less their waits for the device
    waits = collections.defaultdict(list)
    for e in events:
        if e.get("cat") in LAUNCH_CATS and (
                "Synchronize" in e["name"] or
                e["name"].startswith(("cudaMemcpy", "cuMemcpy"))):
            waits[e.get("tid")].append((e["ts"], e["dur"]))
    host_us = 0.0
    for e in cpu:
        host_us += e["dur"] - sum(
            d for ts, d in waits.get(e.get("tid"), ())
            if e["ts"] <= ts <= e["ts"] + e["dur"])
    return {
        "busy_s": busy_us / 1e6,
        "host_op_s": host_us / 1e6,
        "device_ops": [[n, us / 1e6] for n, us in by_op.most_common(top)],
        "idle_gaps": [[n, us / 1e6] for n, us in gaps.most_common(top)],
        "kernel_device_s": {k: us / 1e6 for k, us in kernel_us.items()},
        "kernel_spans": sum(len(v) for v in kspans.values()),
    }
