"""The program's tracer, trace capture and a time breakdown over
``torch.profiler`` (``gotennet_tpu/utils/profiling.py``).

**The tracer.** ``span(name, wait=False)`` marks a stretch of host work
(``traced(name, wait=False)`` every call of a function) and
``count(name, n)`` adds to a counter, where the work happens: the
loaders' collation, the batch's copy to the device, the training step and
its phases, a ``Predictor`` request, the model's forward and its layers,
and every call that waits for the device (``wait=True``).  The tracer is
active while ``enable()`` is in force (``trace=true`` on the command line)
or while a ``torch.profiler`` session is open; otherwise a span costs one
flag check and reads no clock.  An active span takes its host-clock
duration and, under a profiler, also opens
``record_function("gotennet.<name>")``, so that it lands in the Chrome
trace on the clock of the device's kernels.

Spans and counters go into the open **record**, which a ``step``
(``train_step``), ``request`` (``Predictor.predict`` and
``predict_with_forces``) or ``evaluate`` (``Trainer.evaluate``) span
closes: a record holds every span of the thread that closes it since the
previous record closed (the batch's fetch and copy before a step, say),
and the spans and counts of other threads (a prefetching loader's
collation) made meanwhile.  ``records()`` returns the closed records,
oldest first, up to the last 4,096; each is a dict::

    {"seq": 12, "kind": "step",
     "ms": {span: ms, ...}, "calls": {span: n, ...},
     "self_ms": {span: ms less its child spans, ...},
     "counts": {"pairs.padded": ..., "pairs.atom": ...},
     "host_self_ms": ..., "device_wait_ms": ..., "loader_wait_ms": ...,
     "waits": n}

``host_self_ms`` is the closing thread's time outside its device waits:
its outermost spans less the device waits among them and ``loader.wait``.
It is the host's own work only while the host keeps ahead of the device:
once CUDA's launch queue is full, a kernel launch blocks until the device
drains it, and that wait, inside the launching span, counts here too;
``device_wait_ms`` and ``waits`` are its outermost ``wait=True`` spans
(``wait``, ``batch.to_device``); ``loader_wait_ms`` its wait for a
prefetched batch.  The dense collators count each batch's padded pairs
(``pairs.padded``, ``G M^2``) and its molecules' atom pairs
(``pairs.atom``, ``n (n - 1)`` each), ``collate_ell`` its table's slots
(``pairs.ell_slot``, ``N K``) and the real edges in them
(``pairs.ell_edge``, self-loops included).  ``summary(records)`` gives the
records' means, and the atom pairs' share of the padded ones
(``atom_pair_pct``).  Nothing of the tracer lives on the device.

**Traces.** ``capture_trace`` runs a callable under the profiler (CPU and,
where there is a card, CUDA activity) and writes its Chrome trace;
``summarize_trace`` reads it: the device total (the union of the device's
intervals: kernels, copies and sets), the device time by category and by
op, the device's idle gaps named by the innermost ``gotennet.`` span open
on the host meanwhile, and each span's calls, time and self time.  With
no device event (a run on the CPU) the total is the CPU ops' (each
thread's outermost ops).  ``profile_fn`` does both and prints them.
"""

from __future__ import annotations

import collections
import functools
import json
import os
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["span", "traced", "count", "active", "enable", "disable",
           "reset", "records", "summary", "capture_trace", "summarize_trace",
           "profile_fn"]

TRACE_FILE = "trace.json"
PREFIX = "gotennet."
# Chrome-trace categories of torch.profiler's events
_DEVICE = {"kernel": "CUDA kernels", "gpu_memcpy": "memcpy",
           "gpu_memset": "memset"}
_CPU = "cpu_op"
_SPAN = "user_annotation"
_HOST = {_CPU, _SPAN, "cuda_runtime", "cuda_driver"}

# ---- the tracer -------------------------------------------------------------
RECORD_SPANS = frozenset({"step", "request", "evaluate"})
MAX_RECORDS = 4096

if hasattr(_autograd_profiler, "_is_profiler_enabled"):
    def _profiling() -> bool:
        return _autograd_profiler._is_profiler_enabled
else:   # older releases keep the flag in C++ only
    _profiling = torch._C._autograd._profiler_enabled

_enabled = False
_lock = threading.Lock()
_local = threading.local()
_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_seq = 0


class _Pending:
    """The open record: totals by thread, so that the thread closing it
    can tell its own spans from other threads'."""

    def __init__(self):
        self.ns = collections.defaultdict(collections.Counter)   # tid, name
        self.top_ns = collections.Counter()                      # tid
        self.wait_ns = collections.Counter()                     # tid
        self.waits = collections.Counter()                       # tid
        self.calls = collections.Counter()
        self.self_ns = collections.Counter()
        self.counts = collections.Counter()


_pending = _Pending()


def enable() -> None:
    """Trace from now on, with or without a profiler."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Trace only while a ``torch.profiler`` session is open."""
    global _enabled
    _enabled = False


def reset() -> None:
    """Forget every record and the open one."""
    global _pending
    with _lock:
        _records.clear()
        _pending = _Pending()


def records() -> List[Dict]:
    """The closed records, oldest first (a new list)."""
    with _lock:
        return list(_records)


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "wait", "parent", "in_wait", "in_record",
                 "child_ns", "t0", "rf")

    def __init__(self, name: str, wait: bool):
        self.name, self.wait = name, wait

    def __enter__(self):
        st = _stack()
        p = self.parent = st[-1] if st else None
        self.in_wait = p is not None and (p.wait or p.in_wait)
        self.in_record = p is not None and (p.name in RECORD_SPANS
                                            or p.in_record)
        self.child_ns = 0
        self.rf = None
        if _profiling():
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        st.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        _stack().pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if self.parent is not None:
            self.parent.child_ns += dt
        tid = threading.get_ident()
        with _lock:
            p = _pending
            p.ns[tid][self.name] += dt
            p.calls[self.name] += 1
            p.self_ns[self.name] += dt - self.child_ns
            if self.parent is None:
                p.top_ns[tid] += dt
            if self.wait and not self.in_wait:
                p.wait_ns[tid] += dt
                p.waits[tid] += 1
            if self.name in RECORD_SPANS and not self.in_record:
                _close(self.name, tid)
        return False


def _close(kind: str, tid: int) -> None:
    """Close the open record on thread ``tid`` (the lock held)."""
    global _pending, _seq
    p, _pending = _pending, _Pending()
    _seq += 1
    ns = collections.Counter()
    for by_name in p.ns.values():
        ns.update(by_name)
    own = p.ns[tid]
    _records.append({
        "seq": _seq, "kind": kind,
        "ms": {k: v / 1e6 for k, v in ns.items()},
        "calls": dict(p.calls),
        "self_ms": {k: v / 1e6 for k, v in p.self_ns.items()},
        "counts": dict(p.counts),
        "host_self_ms": (p.top_ns[tid] - p.wait_ns[tid]
                         - own["loader.wait"]) / 1e6,
        "device_wait_ms": p.wait_ns[tid] / 1e6,
        "loader_wait_ms": own["loader.wait"] / 1e6,
        "waits": p.waits[tid]})


def span(name: str, wait: bool = False):
    """A context manager that traces the work inside it as ``name``;
    ``wait`` marks a call that blocks on the device."""
    if not (_enabled or _profiling()):
        return _OFF
    return _Span(name, wait)


def traced(name: str, wait: bool = False) -> Callable:
    """A decorator: ``span(name, wait)`` round every call of the function."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not (_enabled or _profiling()):
                return fn(*args, **kwargs)
            with _Span(name, wait):
                return fn(*args, **kwargs)
        return call
    return wrap


def active() -> bool:
    """Whether spans and counts are being recorded (``enable()``, or a
    profiler open)."""
    return _enabled or _profiling()


def count(name: str, n) -> None:
    """Add ``n`` to the open record's counter ``name``."""
    if not (_enabled or _profiling()):
        return
    with _lock:
        _pending.counts[name] += n


def summary(recs: List[Dict]) -> Dict[str, float]:
    """Means over ``recs`` of the host's own ms, the device waits' ms, the
    loader waits' ms, the collation's ms and the count of device waits,
    and the atom pairs' share of the padded pairs over all of them (%;
    absent where no pair was counted)."""
    n = max(len(recs), 1)
    out = {k: sum(r[k] for r in recs) / n for k in
           ("host_self_ms", "device_wait_ms", "loader_wait_ms", "waits")}
    out["collate_ms"] = sum(r["ms"].get("loader.collate", 0.0)
                            for r in recs) / n
    padded = sum(r["counts"].get("pairs.padded", 0) for r in recs)
    if padded:
        out["atom_pair_pct"] = 100.0 * sum(
            r["counts"].get("pairs.atom", 0) for r in recs) / padded
    return out


# ---- traces -----------------------------------------------------------------
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


def _union(intervals) -> List[List[float]]:
    """Merged ``[start, end]`` intervals, in order."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _span_table(spans) -> List[Dict]:
    """Calls, time and self time (less the child spans of the same
    thread) of each span name, by self time."""
    us, self_us, calls = (collections.Counter() for _ in range(3))
    by_thread = collections.defaultdict(list)
    for e in spans:
        by_thread[(e.get("pid"), e.get("tid"))].append(e)
    for evs in by_thread.values():
        open_ = []
        for e in sorted(evs, key=lambda e: (e["ts"], -e["dur"])):
            while open_ and e["ts"] >= open_[-1]["ts"] + open_[-1]["dur"]:
                open_.pop()
            name = e["name"][len(PREFIX):]
            us[name] += e["dur"]
            self_us[name] += e["dur"]
            calls[name] += 1
            if open_:
                self_us[open_[-1]["name"][len(PREFIX):]] -= e["dur"]
            open_.append(e)
    return [{"name": n, "calls": calls[n], "us": us[n], "self_us": s}
            for n, s in self_us.most_common()]


def _idle_gaps(merged, spans, lo: float, hi: float) -> Dict[str, float]:
    """The device's idle time in ``[lo, hi]``, by the innermost span open
    at each gap's middle (``none`` where none is)."""
    gaps = collections.Counter()
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        t, best = 0.5 * (a + b), None
        for s in spans:
            if s["ts"] <= t <= s["ts"] + s["dur"] and (
                    best is None or s["dur"] < best["dur"]):
                best = s
        gaps[best["name"][len(PREFIX):] if best else "none"] += b - a
    return gaps


def summarize_trace(trace_dir: str, top_k: int = 15) -> Dict:
    """``{'total_us', 'by_category_us', 'top_ops': [{'name', 'us'}],
    'idle_gaps': [{'name', 'us'}], 'spans': [{'name', 'calls', 'us',
    'self_us'}]}`` of the trace in ``trace_dir`` (microseconds).  The
    total is the union of the device's intervals (the CPU ops' sum where
    there is none); the idle gaps lie between the device's intervals,
    from the trace's first host event to its last event."""
    path = os.path.join(trace_dir, TRACE_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no trace file under {trace_dir}")
    with open(path) as f:
        trace = json.load(f)
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in _DEVICE]
    cpu = list(_outermost([e for e in events if e.get("cat") == _CPU]))
    spans = [e for e in events if e.get("cat") == _SPAN
             and str(e.get("name", "")).startswith(PREFIX)]
    by_cat = collections.Counter()
    for e in device:
        by_cat[_DEVICE[e["cat"]]] += e["dur"]
    by_cat["CPU ops"] += sum(e["dur"] for e in cpu)
    counted = device or cpu
    by_op = collections.Counter()
    for e in counted:
        by_op[e["name"]] += e["dur"]
    gaps = collections.Counter()
    if device:
        merged = _union((e["ts"], e["ts"] + e["dur"]) for e in device)
        total = sum(b - a for a, b in merged)
        host = [e for e in events if e.get("cat") in _HOST]
        lo = min(e["ts"] for e in host + device)
        hi = max(e["ts"] + e["dur"] for e in host + device)
        gaps = _idle_gaps(merged, spans, lo, hi)
    else:
        total = sum(e["dur"] for e in cpu)
    return {
        "total_us": total,
        "by_category_us": dict(by_cat.most_common()),
        "top_ops": [{"name": n, "us": us}
                    for n, us in by_op.most_common(top_k)],
        "idle_gaps": [{"name": n, "us": us}
                      for n, us in gaps.most_common(top_k)],
        "spans": _span_table(spans)[:top_k],
    }


def profile_fn(fn: Callable[[], None], top_k: int = 15,
               print_summary: bool = True) -> Dict:
    """Capture and summarise ``fn`` in one call; print the total (device,
    or CPU where no device event was seen), each category's ms, the
    program's spans by self time and the device's idle gaps by span."""
    s = summarize_trace(capture_trace(fn), top_k)
    if print_summary:
        where = ("device" if any(s["by_category_us"].get(c)
                                 for c in _DEVICE.values()) else "CPU")
        print(f"{where} total: {s['total_us'] / 1e3:.2f} ms")
        for cat, us in s["by_category_us"].items():
            print(f"  {us / 1e3:9.2f} ms  {cat}")
        if s["spans"]:
            print("spans (self ms, ms, calls):")
            for r in s["spans"]:
                print(f"  {r['self_us'] / 1e3:9.2f} {r['us'] / 1e3:9.2f} "
                      f"{r['calls']:6d}  {r['name']}")
        if s["idle_gaps"]:
            print("device idle, by the span open on the host:")
            for r in s["idle_gaps"]:
                print(f"  {r['us'] / 1e3:9.2f} ms  {r['name']}")
    return s
