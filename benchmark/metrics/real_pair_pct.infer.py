"""Real pairs over the padded pairs of the requests' chunks, in the window."""

from harness import readers


def read(data):
    return readers.real_pair_pct(data, "infer")
