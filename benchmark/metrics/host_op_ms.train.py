"""Host ms a step inside PyTorch's outermost CPU ops, from the host's traced
stretch (every op recorded, so it carries the profiler's own cost)."""

from harness import readers


def read(data):
    return readers.host_op_ms(data, "train")
