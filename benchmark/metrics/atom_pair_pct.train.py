"""The molecules' atom pairs over the padded pairs of the batches the
loader collated, by the program's ``pairs.atom`` and ``pairs.padded``
counters (both traced stretches): the loader's padding waste."""

from harness import program_spans


def read(data):
    return program_spans.atom_pair_pct(data, "train")
