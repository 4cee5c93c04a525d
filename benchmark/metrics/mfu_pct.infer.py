"""Model FLOP of the window's answered requests over its seconds, against the
H100's bf16 dense peak (harness/flops.py)."""

from harness import readers


def read(data):
    return readers.mfu_pct(data, "infer")
