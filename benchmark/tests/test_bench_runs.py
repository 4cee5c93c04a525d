"""Whole runs on the CPU at a small size (the card's look left out): a
configuration, traffic mix, limit, metric and kernel bound added as files
alone; each fault the cells can have turns ``correct`` false; the
lower-precision control fails the limits."""

import json
import shutil

import pytest

from bench_tiny import run, tiny_tree


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("bench"))


def test_files_added_alone_run(tmp_path):
    root, bench = tiny_tree(tmp_path)
    cfg = json.loads((root / "configs/qm9_flagship.json").read_text())
    cfg["model"]["n_interactions"] = 3
    (root / "configs/qm9_three.json").write_text(json.dumps(cfg))
    t = json.loads((root / "workloads/qm9_screen_1024.json").read_text())
    t["request_size"] = 48
    (root / "workloads/screen_48.json").write_text(json.dumps(t))
    shutil.copy(root / "limits/qm9_screen.json",
                root / "limits/qm9_three_screen.json")
    (root / "metrics/requests_seen.infer.py").write_text(
        "def read(data):\n"
        "    return float(data['window']['iterations'])\n")
    (root / "kernels/plain_gata_forward.py").write_text(
        (root / "kernels/fused_gata_forward.py").read_text().replace(
            'WRAPPER = "fused_gata_forward"',
            'WRAPPER = "fused_gata_forward_reference"'))
    bench["configs"].append({"name": "qm9_three", "source": "test",
                             "file": "benchmark/configs/qm9_three.json",
                             "reduced": ["n_interactions"], "why": "test"})
    bench["workloads"].append({"name": "qm9_three_screen",
                               "config": "qm9_three", "traffic": "screen_48",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "requests_seen.infer", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "Request", "moves": "infer_mol_per_s",
                               "workloads": ["qm9_three_screen"]})
    for m in bench["end_to_end"]:
        if m["name"] == "infer_mol_per_s":
            m["workloads"].append("qm9_three_screen")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    r = run(root, bench, "qm9_three_screen", trace=True)
    assert r["correct"]
    assert r["metrics"]["requests_seen.infer"]["value"] >= 1
    from harness.registry import Registry
    names = [k.WRAPPER for k in Registry(root, bench).kernels()]
    assert "fused_gata_forward_reference" in names and len(names) == 9
    r = run(root, bench, "qm9_three_screen")
    assert set(r["metrics"]) == {"infer_mol_per_s", "peak_mem_gib",
                                 "setup_s"}
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("fault", [None, "half_batch"])
def test_accumulated_steps_added_as_data(tmp_path, fault):
    """A training cell whose steps accumulate two chunks, added as data
    alone: a sound run compares every limited number, and half of each
    chunk left out turns it false."""
    root, bench = tiny_tree(tmp_path)
    t = json.loads((root / "workloads/qm9_train_b256.json").read_text())
    t["accum"] = 2
    (root / "workloads/qm9_train_accum.json").write_text(json.dumps(t))
    shutil.copy(root / "limits/qm9_train.json",
                root / "limits/qm9_train_accum.json")
    bench["workloads"].append({"name": "qm9_train_accum",
                               "config": "qm9_flagship",
                               "traffic": "qm9_train_accum", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "qm9_train" in m.get("workloads", []):
            m["workloads"].append("qm9_train_accum")
    r = run(root, bench, "qm9_train_accum", fault=fault)
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["checks"]) == set(json.loads(
        (root / "limits/qm9_train.json").read_text())["limits"])
    if fault:
        assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("cell,fault", [
    ("qm9_train", "unchanged"), ("qm9_train", "half_batch"),
    ("md22_force_train", "unchanged"), ("md22_force_train", "half_batch"),
    ("md22_force_eval", "answer"), ("qm9_screen", "answer")])
def test_faults_fail(tree, cell, fault):
    """The timed path broken underneath: a step that leaves the state
    unchanged, half of each batch left out (the mean over the rest), one
    answer of each request altered where it is produced."""
    root, bench = tree
    r = run(root, bench, cell, fault=fault)
    assert r["correct"] is False, r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0


@pytest.mark.parametrize("cell", ["qm9_train", "md22_force_train",
                                  "md22_force_eval", "qm9_screen"])
def test_sound_runs_compare_every_limited_number(tree, cell):
    """A sound run at this size completes and compares each number that
    has a limit (whether it is correct at the cell's size is shown on the
    card)."""
    from harness.registry import Registry
    root, bench = tree
    r = run(root, bench, cell)
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["checks"]) == set(Registry(root, bench).limits(cell)
                                   ["limits"])
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell,control", [
    ("qm9_train", "bf16"), ("md22_force_train", "bf16"),
    ("md22_force_eval", "bf16"), ("qm9_screen", "bf16"),
    ("md22_force_eval", "fp8_pairs")])
def test_lower_precision_control_fails(tree, cell, control):
    """The reference in bfloat16 (or, where the forces are held against
    it, in float32 with float8 pair values), in the program's place,
    against the float32 reference: not correct by the cell's limits."""
    import torch
    from harness.compare import judge
    from harness.registry import Registry
    from harness.runner import Context
    root, bench = tree
    reg = Registry(root, bench)
    ctx = Context(reg, cell, 12345, 0.3, False, "cpu")
    loop = reg.mode(ctx.traffic["mode"]).Loop(ctx)
    loop.setup()
    loop.measure()
    loop.release()
    loop.check()
    numbers = (loop.control() if control == "bf16" else loop.control(
        torch.float32, (torch.float8_e4m3fn, False)))
    ok, checks = judge(numbers, reg.limits(cell)["limits"])
    assert not ok, checks
