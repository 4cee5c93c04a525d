"""Mean ms a training step waits for its batch from the prefetching loader and
its copy to the card (the benchmark's span)."""

from harness import readers


def read(data):
    return readers.span_ms(data, "train", "loader_wait")
