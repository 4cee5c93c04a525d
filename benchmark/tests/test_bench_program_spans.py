"""The readers of the program's tracer records on records written by hand:
the times from the first ``iterations`` of exactly twice that many, the
pair counters from all of them, nothing on a count or kind mismatch; and
a tiny traced run on the CPU reports every one of them."""

import pytest

from bench_tiny import BENCH  # noqa: F401  (puts the benchmark on the path)
from bench_tiny import run, tiny_tree
from harness import program_spans
from harness.registry import load_module


def record(kind, host, wait, collate, atom, padded):
    return {"kind": kind, "host_self_ms": host, "device_wait_ms": wait,
            "ms": {"loader.collate": collate, kind: host + wait},
            "counts": ({"pairs.atom": atom, "pairs.padded": padded}
                       if padded else {})}


TRAIN = {"kind": "train", "trace": {"iterations": 2}}
RECS = [record("step", 10.0, 2.0, 1.0, 60, 100),
        record("step", 20.0, 4.0, 0.0, 0, 0),
        record("step", 90.0, 9.0, 9.0, 30, 100),     # the host's stretch
        record("step", 90.0, 9.0, 9.0, 0, 0)]


def test_times_from_the_device_stretch_counts_from_both():
    assert program_spans.mean(TRAIN, "train", "host_self_ms",
                              RECS) == pytest.approx(15.0)
    assert program_spans.mean(TRAIN, "train", "device_wait_ms",
                              RECS) == pytest.approx(3.0)
    assert program_spans.span_ms(TRAIN, "train", "loader.collate",
                                 RECS) == pytest.approx(0.5)
    assert program_spans.atom_pair_pct(TRAIN, "train",
                                       RECS) == pytest.approx(45.0)


@pytest.mark.parametrize("data, recs", [
    (TRAIN, RECS[:3]),                                    # not 2n
    (TRAIN, RECS + RECS),                                 # an earlier run's
    ({"kind": "infer", "trace": {"iterations": 2}}, RECS),  # the cell's kind
    (TRAIN, RECS[:3] + [record("request", 1.0, 1.0, 1.0, 1, 1)]),
    ({"kind": "train"}, RECS),                            # no traced run
    (TRAIN, None),                                        # no tracer
])
def test_nothing_on_a_mismatch(data, recs, monkeypatch):
    monkeypatch.setattr(program_spans, "program_records", lambda: None)
    for kind in ("train", "infer"):
        assert program_spans.mean(data, kind, "host_self_ms", recs) is None
        assert program_spans.span_ms(data, kind, "loader.collate",
                                     recs) is None
        assert program_spans.atom_pair_pct(data, kind, recs) is None


def test_no_pairs_counted_reads_nothing():
    recs = [record("step", 1.0, 1.0, 1.0, 0, 0)] * 4
    assert program_spans.atom_pair_pct(TRAIN, "train", recs) is None


def test_a_program_without_a_tracer_reads_nothing(monkeypatch):
    """The parent of the tracer: its profiling module has no records."""
    from gotennet_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "records")
    assert program_spans.program_records() is None
    for name in ("host_self_ms", "device_wait_ms", "collate_ms",
                 "atom_pair_pct"):
        reader = load_module(BENCH / "metrics" / f"{name}.train.py")
        assert reader.read(TRAIN) is None


@pytest.mark.parametrize("cell, kind", [("qm9_screen", "infer"),
                                        ("qm9_train", "train")])
def test_a_traced_run_reports_them(tmp_path, cell, kind):
    from gotennet_tpu_torch.utils import profiling
    root, bench = tiny_tree(tmp_path)
    profiling.reset()
    try:
        r = run(root, bench, cell, trace=True)
    finally:
        profiling.reset()
    m = r["metrics"]
    for name in ("host_self_ms", "device_wait_ms", "collate_ms"):
        assert m[f"{name}.{kind}"]["value"] >= 0.0
    assert m[f"host_self_ms.{kind}"]["value"] > 0.0
    assert 0.0 < m[f"atom_pair_pct.{kind}"]["value"] < 100.0
