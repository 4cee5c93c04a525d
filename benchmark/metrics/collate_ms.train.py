"""Ms of the loader's collation a step, by the program's
``loader.collate`` span on every thread (the device's traced stretch)."""

from harness import program_spans


def read(data):
    return program_spans.span_ms(data, "train", "loader.collate")
