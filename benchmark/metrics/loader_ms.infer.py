"""Mean ms a request spends in the iterator that Predictor.loader returns (the
host's collation; the benchmark's span)."""

from harness import readers


def read(data):
    return readers.span_ms(data, "infer", "loader")
