"""The per-layer metrics read from the program's own tracer
(``gotennet_tpu_torch.utils.profiling``): the records of the traced run's
steps or requests, kept by the program in this process.

In a ``--trace 1`` run the tracer is active only inside the two traced
stretches (``harness/loop.py`` ``traced``), each of
``data["trace"]["iterations"]`` iterations, one step or one request each.
The device's stretch, which records the card's activity alone and no host
op, runs first, so its records are the first ``iterations``: the times
are read from those.  A count does not depend on what the profiler
records, so the pair counters are read from both stretches' records: a
training stretch of a few steps can fall where the prefetching loader has
already collated the epoch's last batches, and then counts nothing.  A
reader reads nothing where the program kept any other number of records
than twice ``iterations``, or records of another kind, or where the
program has no tracer."""

from __future__ import annotations

from typing import List, Optional

KIND = {"train": "step", "infer": "request"}


def program_records() -> Optional[List[dict]]:
    """The program's records in this process, or None where the program
    keeps none."""
    try:
        from gotennet_tpu_torch.utils import profiling
    except ImportError:
        return None
    records = getattr(profiling, "records", None)
    return records() if records is not None else None


def traced(data, kind: str, recs=None) -> Optional[List[dict]]:
    """Both stretches' records: exactly twice ``iterations``, each of the
    cell's kind."""
    t = data.get("trace") if data.get("kind") == kind else None
    if recs is None:
        recs = program_records()
    if not t or recs is None:
        return None
    n = t["iterations"]
    if not n or len(recs) != 2 * n or any(
            r.get("kind") != KIND[kind] for r in recs):
        return None
    return recs


def device_stretch(data, kind: str, recs=None) -> Optional[List[dict]]:
    """The device's stretch's records: the first half of ``traced``."""
    both = traced(data, kind, recs)
    return both[:len(both) // 2] if both is not None else None


def mean(data, kind: str, field: str, recs=None) -> Optional[float]:
    """The mean of a record's ``field`` over the device's stretch."""
    first = device_stretch(data, kind, recs)
    if first is None:
        return None
    return sum(r[field] for r in first) / len(first)


def span_ms(data, kind: str, span: str, recs=None) -> Optional[float]:
    """Mean ms of the program's span ``span`` (every thread) a step or
    request of the device's stretch."""
    first = device_stretch(data, kind, recs)
    if first is None:
        return None
    return sum(r["ms"].get(span, 0.0) for r in first) / len(first)


def atom_pair_pct(data, kind: str, recs=None) -> Optional[float]:
    """The molecules' atom pairs over the padded pairs of the batches
    collated in both traced stretches (%)."""
    both = traced(data, kind, recs)
    if both is None:
        return None
    padded = sum(r["counts"].get("pairs.padded", 0) for r in both)
    if not padded:
        return None
    return 100.0 * sum(r["counts"].get("pairs.atom", 0)
                       for r in both) / padded
