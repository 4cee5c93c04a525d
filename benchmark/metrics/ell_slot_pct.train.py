"""The real edges (self-loops included) over the slots of the ELL tables
the loader collated, by the program's ``pairs.ell_edge`` and
``pairs.ell_slot`` counters (both traced stretches): how full the
neighbour table is, which its ``K`` and ``block_rows`` decide."""

from harness import program_spans


def read(data):
    both = program_spans.traced(data, "train")
    if both is None:
        return None
    slots = sum(r["counts"].get("pairs.ell_slot", 0) for r in both)
    if not slots:
        return None
    return 100.0 * sum(r["counts"].get("pairs.ell_edge", 0)
                       for r in both) / slots
