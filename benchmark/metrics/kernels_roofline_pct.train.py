"""The bound of every kernel launch of the traced stretch over the device time
of the work launched inside the kernel wrappers' spans."""

from harness import readers


def read(data):
    return readers.kernels_roofline_pct(data, "train")
