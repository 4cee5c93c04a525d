"""What the traffic loops share: the pool and its counts, the seeded
weights, the window's clock, and the traced stretch."""

from __future__ import annotations

import contextlib
import tempfile
import time
from pathlib import Path

import torch

from harness import generators, pairs, trace
from harness.flops import MULTIPLIER, forward_flop
from harness.kernels import KernelSpans
from harness.spans import Spans
from harness.weights import make_weights


class BaseLoop:
    """``setup`` (everything before the first timed iteration, warm-up
    included), ``measure`` (the window), ``traced`` (a stretch under the
    profiler), ``release`` (the program's state freed) and ``check`` (the
    reference, then the numbers compared)."""

    work = "forward"

    def __init__(self, ctx):
        self.ctx = ctx
        self.t = ctx.traffic
        self.m = ctx.config["model"]
        self.dev = ctx.device
        self.spans = Spans()
        self.stages = {}
        self._mark = time.perf_counter()

    def stage(self, name: str) -> None:
        """Close the set-up stage ``name`` (its seconds go to stderr)."""
        now = time.perf_counter()
        self.stages[name] = now - self._mark
        self._mark = now

    def make_pool(self) -> None:
        ctx = self.ctx
        self.pool = generators.make_pool(self.t["pool"], ctx.seed)
        self.atoms, self.edges = pairs.count(
            self.pool, self.m["cutoff"], self.m["max_num_neighbors"])
        self.flop = forward_flop(self.m, self.atoms, self.edges) \
            * MULTIPLIER[self.work]
        if ctx.config["head"]["standardize"]:
            self.mean, self.std = generators.energy_stats(self.pool)
        else:
            self.mean, self.std = 0.0, 1.0
        self.stage("pool")
        self.weights = make_weights(self.m, ctx.seed, self.dev, self.mean,
                                    self.std)
        self.stage("weights")

    def iterate(self):
        """One timed iteration; returns the molecule indices it served."""
        raise NotImplementedError

    def run_for(self, seconds: float) -> dict:
        """Iterations until ``seconds`` have passed, from a synchronised
        start; the last ends past the deadline and counts whole."""
        self.ctx.sync()
        self.spans.reset()
        n = mols = 0
        flop = real = 0.0
        self.padded = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            idx = self.iterate()
            n += 1
            mols += len(idx)
            flop += float(self.flop[idx].sum())
            real += float(self.edges[idx].sum())
        self.ctx.sync()
        elapsed = time.perf_counter() - t0
        return {"seconds": elapsed, "iterations": n, "molecules": mols,
                "flop": flop, "real_pairs": real,
                "padded_pairs": float(self.padded),
                "spans": {k: (self.spans.total[k], self.spans.count[k])
                          for k in self.spans.total}}

    def _stretch(self, acts, path: str, kspans=None) -> dict:
        """``trace_iterations`` iterations under ``torch.profiler`` with
        ``acts``, read from the trace written to ``path``."""
        from torch.profiler import profile
        n = self.t["trace_iterations"]
        self.ctx.sync()
        with contextlib.ExitStack() as stack:
            if kspans is not None:
                stack.enter_context(kspans)
            prof = stack.enter_context(profile(activities=acts))
            t0 = time.perf_counter()
            with torch.profiler.record_function("bench.trace"):
                for _ in range(n):
                    self.iterate()
                self.ctx.sync()
            window = time.perf_counter() - t0
        prof.export_chrome_trace(path)
        del prof
        out = trace.read(path)
        out["window_s"] = window
        out["iterations"] = n
        return out

    def traced(self) -> dict:
        """Two stretches under the profiler.  The device's: the card's
        activity alone, so that recording the host's ops adds nothing to
        its idle time (busy and window seconds, the device ops).  The
        host's: host and device, the kernel wrappers inside spans (host
        time in ops, the kernels' time and bounds, the idle gaps by span);
        its own busy and window seconds show what recording the host's ops
        costs."""
        from torch.profiler import ProfilerActivity
        cuda = self.dev.type == "cuda"
        with tempfile.TemporaryDirectory() as tmp:
            dev = self._stretch([ProfilerActivity.CUDA if cuda
                                 else ProfilerActivity.CPU],
                                str(Path(tmp) / "device.json"))
            self.spans.annotate = True
            kspans = KernelSpans(self.ctx.reg.kernels())
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                             if cuda else [])
            try:
                out = self._stretch(acts, str(Path(tmp) / "host.json"),
                                    kspans)
            finally:
                self.spans.annotate = False
        bounds = kspans.bounds_ms()
        dev_s = out["kernel_device_s"]
        seen = [k for k in bounds if dev_s.get(k, 0.0) > 0.0]
        out["kernel_bound_s"] = sum(bounds[k] for k in seen) / 1e3
        out["kernel_time_s"] = sum(dev_s[k] for k in seen)
        out["kernel_launches"] = len(bounds)
        out["kernel_launches_seen"] = len(seen)
        out["host_busy_s"], out["host_window_s"] = (out["busy_s"],
                                                    out["window_s"])
        out.update(busy_s=dev["busy_s"], window_s=dev["window_s"],
                   device_ops=dev["device_ops"])
        return out
