"""The benchmark's spans: host-clock totals around its calls into the
program's layers, and, while a trace is taken, ``record_function`` ranges
named ``bench.<name>`` that the trace reader finds."""

from __future__ import annotations

import collections
import contextlib
import time

import torch


class Spans:
    def __init__(self):
        self.total = collections.defaultdict(float)
        self.count = collections.defaultdict(int)
        self.annotate = False

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        if self.annotate:
            with torch.profiler.record_function("bench." + name):
                yield
        else:
            yield
        self.total[name] += time.perf_counter() - t0
        self.count[name] += 1

    def reset(self) -> None:
        self.total.clear()
        self.count.clear()
