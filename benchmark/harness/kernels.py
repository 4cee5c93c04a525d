"""Spans around the program's kernel wrappers, and each launch's bound.

Every file ``kernels/<wrapper>.py`` names a wrapper of the program
(``MODULE``, ``WRAPPER``), the argument whose sign marks the valid pairs
(``VALID_ARG``, or None) and ``bound_ms(args, kwargs, valid)``.  While a
trace is taken, each wrapper is replaced in its module by one that opens
the span ``bench.kernel.<WRAPPER>#<n>`` around the call and keeps the
launch's shapes (as ``meta`` tensors) and its count of valid pairs (a
device tensor, read after the trace, so that nothing waits for the device
inside the traced region)."""

from __future__ import annotations

import importlib
import itertools
from typing import Dict, List

import torch


def _meta(x):
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    if isinstance(x, (list, tuple)):
        return type(x)(_meta(v) for v in x)
    return x


class KernelSpans:
    def __init__(self, specs: List):
        self.specs = specs
        self.launches: Dict[str, tuple] = {}
        self._saved = []
        self._n = itertools.count()

    def __enter__(self):
        for spec in self.specs:
            mod = importlib.import_module(spec.MODULE)
            orig = getattr(mod, spec.WRAPPER)
            self._saved.append((mod, spec.WRAPPER, orig))
            setattr(mod, spec.WRAPPER, self._wrap(spec, orig))
        return self

    def __exit__(self, *exc):
        for mod, name, orig in reversed(self._saved):
            setattr(mod, name, orig)
        self._saved.clear()

    def _wrap(self, spec, orig):
        def launch(*args, **kwargs):
            key = f"{spec.WRAPPER}#{next(self._n)}"
            with torch.profiler.record_function("bench.kernel." + key):
                out = orig(*args, **kwargs)
            valid = (None if spec.VALID_ARG is None
                     else (args[spec.VALID_ARG] >= 0).sum())
            self.launches[key] = (spec, _meta(args), _meta(kwargs), valid)
            return out
        return launch

    def bounds_ms(self) -> Dict[str, float]:
        """The bound of every launch, by span name."""
        out = {}
        for key, (spec, args, kwargs, valid) in self.launches.items():
            n = None if valid is None else int(valid)
            out[key] = spec.bound_ms(args, kwargs, n)[0]
        return out
