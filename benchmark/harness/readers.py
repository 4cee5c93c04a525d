"""The arithmetic of the per-layer metrics; each ``metrics/<name>.py``
calls one of these for its kind of cell (``train`` or ``infer``).  A
reader that finds nothing to read returns None and the metric is left out
of the line."""

from __future__ import annotations

from typing import Optional

from harness.peaks import BF16_FLOPS


def _window(data, kind):
    return data.get("window") if data.get("kind") == kind else None


def _trace(data, kind):
    return data.get("trace") if data.get("kind") == kind else None


def span_ms(data, kind: str, span: str) -> Optional[float]:
    """Mean ms of a benchmark span an iteration of the window."""
    w = _window(data, kind)
    if not w or span not in w["spans"] or not w["iterations"]:
        return None
    return w["spans"][span][0] / w["iterations"] * 1e3


def real_pair_pct(data, kind: str) -> Optional[float]:
    w = _window(data, kind)
    if not w or not w["padded_pairs"]:
        return None
    return 100.0 * w["real_pairs"] / w["padded_pairs"]


def mfu_pct(data, kind: str) -> Optional[float]:
    """Model FLOP of the window's completed work over its seconds, against
    the bf16 dense peak."""
    w = _window(data, kind)
    if not w or not w["flop"]:
        return None
    return 100.0 * w["flop"] / (w["seconds"] * BF16_FLOPS)


def host_op_ms(data, kind: str) -> Optional[float]:
    t = _trace(data, kind)
    if not t or not t["host_op_s"]:
        return None
    return t["host_op_s"] / t["iterations"] * 1e3


def kernels_roofline_pct(data, kind: str) -> Optional[float]:
    t = _trace(data, kind)
    if not t or not t["kernel_time_s"]:
        return None
    return 100.0 * t["kernel_bound_s"] / t["kernel_time_s"]


def device_idle_pct(data, kind: str) -> Optional[float]:
    t = _trace(data, kind)
    if not t or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
