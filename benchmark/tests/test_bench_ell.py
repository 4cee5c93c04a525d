"""The ELL training cell, ``large_ell_train``, whole on the CPU at the
tiny tree's size (``bench_tiny``: molecules of 5-14 atoms, 16 a chunk, 32
channels): a sound run is correct and compares every limited number; each
planted fault and the lower-precision control fail its limits; the table
fill ``ell_slot_pct.train`` reads in a traced run of it and in no dense
cell."""

import pytest

from bench_tiny import run, tiny_tree

CELL = "large_ell_train"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("bench_ell"))


@pytest.fixture(scope="module")
def traced(tree):
    root, bench = tree
    return run(root, bench, CELL, trace=True)


def test_sound_traced_run_is_correct_and_compares_every_limit(tree, traced):
    from harness.registry import Registry
    root, bench = tree
    assert traced["correct"], traced["checks"]
    assert traced["attempted"] >= 1 and traced["failed"] == 0
    assert set(traced["checks"]) == set(Registry(root, bench).limits(CELL)
                                        ["limits"])
    assert list(traced)[-1] == "checks"


def test_table_fill_reads_in_the_traced_run(traced):
    value = traced["metrics"]["ell_slot_pct.train"]["value"]
    assert 0.0 < value <= 100.0


def test_table_fill_reads_nothing_in_a_dense_cell(tree):
    """The reader asked in ``qm9_train`` too: the dense collators count no
    ELL slot, so the metric stays out of the line."""
    root, bench = tree
    for m in bench["per_layer"]:
        if m["name"] == "ell_slot_pct.train":
            m["workloads"].append("qm9_train")
    try:
        r = run(root, bench, "qm9_train", trace=True)
    finally:
        for m in bench["per_layer"]:
            if m["name"] == "ell_slot_pct.train":
                m["workloads"].remove("qm9_train")
    assert "ell_slot_pct.train" not in r["metrics"]
    assert "real_pair_pct.train" in r["metrics"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_faults_fail(tree, fault):
    """A step that leaves the state unchanged; the second half of each
    chunk's frames left out of the loss and the graph."""
    root, bench = tree
    r = run(root, bench, CELL, fault=fault)
    assert r["correct"] is False, r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0


def test_lower_precision_control_fails(tree):
    """The reference in bfloat16, in the program's place, against the
    float32 reference: not correct by the cell's limits."""
    from harness.compare import judge
    from harness.registry import Registry
    from harness.runner import Context
    root, bench = tree
    reg = Registry(root, bench)
    ctx = Context(reg, CELL, 12345, 0.3, False, "cpu")
    loop = reg.mode(ctx.traffic["mode"]).Loop(ctx)
    loop.setup()
    loop.measure()
    loop.release()
    loop.check()
    ok, checks = judge(loop.control(), reg.limits(CELL)["limits"])
    assert not ok, checks
