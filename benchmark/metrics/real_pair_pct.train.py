"""Real pairs (within the cutoff and the neighbour cap, self-loops counted)
over the padded pairs of the loader's batches, in the window."""

from harness import readers


def read(data):
    return readers.real_pair_pct(data, "train")
