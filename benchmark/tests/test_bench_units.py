"""The generators repeat for a seed; the FLOP count and each copied bound
on small shapes worked out by hand; the trace reader on a trace written
by hand."""

import json
import math

import numpy as np
import pytest
import torch

from bench_tiny import BENCH  # noqa: F401  (puts the benchmark on the path)
from harness import flops, generators, pairs, trace
from harness.registry import load_module

SEED = 2 ** 33 + 5     # above 32 bits: seeds may be that large


def test_generators_repeat_for_a_seed():
    for spec in ({"kind": "molecules", "n": 40, "min_atoms": 12,
                  "max_atoms": 29, "box": 4.0},
                 {"kind": "trajectory", "n": 5, "n_atoms": 30, "box": 6.3,
                  "jitter": 0.1}):
        a = generators.make_pool(spec, SEED)
        b = generators.make_pool(spec, SEED)
        c = generators.make_pool(spec, SEED + 1)
        for x, y in zip(a, b):
            assert np.array_equal(x[0], y[0])
            assert np.array_equal(x[1], y[1])
            assert x[2] == y[2]
        assert any(not np.array_equal(x[1], y[1]) for x, y in zip(a, c))


def test_every_seed_gets_the_same_sizes():
    s1 = generators.balanced_sizes(8192, 12, 29, SEED)
    s2 = generators.balanced_sizes(8192, 12, 29, 7)
    assert sorted(s1) == sorted(s2)
    assert not np.array_equal(s1, s2)
    assert np.bincount(s1)[12:].min() >= 8192 // 18


def test_pair_potential_forces_are_its_gradient():
    (z, pos, e, f), = generators.synthetic_molecules([6], SEED,
                                                     with_forces=True)
    p = pos.astype(np.float64)
    h = 1e-5
    p2 = p.copy()
    p2[2, 1] += h
    e2, _ = generators.pair_potential(z, p2)
    e1, _ = generators.pair_potential(z, p)
    assert math.isclose(-(e2 - e1) / h, f[2, 1], rel_tol=1e-3,
                        abs_tol=1e-5)


def test_real_edges_by_hand():
    # a chain 0 - 1 - 2 at 1 A spacing and an atom 9 A away
    pos = np.asarray([[0, 0, 0], [1, 0, 0], [2, 0, 0], [9, 0, 0]],
                     np.float32)
    # within 1.5 A: 0-1, 1-0, 1-2, 2-1; plus 4 self-loops
    assert pairs.real_edges(pos, 1.5, 32) == 4 + 4
    # cap 1: atom 1 keeps one of its two neighbours
    assert pairs.real_edges(pos, 1.5, 1) == 3 + 4
    # every pair within 10 A: 12 directed pairs
    assert pairs.real_edges(pos, 10.0, 32) == 12 + 4


def test_forward_flop_by_hand():
    m = {"n_atom_basis": 2, "n_rbf": 3, "n_interactions": 2, "lmax": 1,
         "sep_dir": True, "sep_tensor": True, "head_hidden": 4}
    # D 2, R 3, C 3 x 2 = 6, L 3, two layers
    per_edge = 2 * 3 * 2 + 2 * (4 + 12) + 1 * 4              # 48
    per_atom = (3 * 4 + 2 * (2 * (4 + 12) + 2 * 4) + 1 * (2 * 3 * 4)
                + 2 * (4 * 4 + 3 * 4) + 2 * 4 + 4)             # 184
    assert per_edge == 48 and per_atom == 184
    got = flops.forward_flop(m, np.asarray([5]), np.asarray([7]))
    assert got[0] == 2 * (48 * 7 + 184 * 5)
    assert flops.MULTIPLIER == {"forward": 1, "force": 2, "train": 3,
                                "force_train": 6}


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_kernel_bounds_by_hand():
    k = {p.stem: load_module(p) for p in (BENCH / "kernels").glob("*.py")}
    assert len(k) == 8
    G, M, D, L, C = 1, 2, 4, 3, 12
    bf = torch.bfloat16
    args = [_meta(G, M, M, D), _meta(G, M, D, dtype=bf),
            _meta(G, M, D, dtype=bf), _meta(G, M, C, dtype=bf),
            _meta(G, M, C, dtype=bf), _meta(G, M, M, L), _meta(G, M, L, D),
            _meta(G, M, M), _meta(G, M, M), _meta(D, D), _meta(D),
            _meta(D, C), _meta(C)]
    # float32: t, rl, X, env, scale, W_re, b_re, W_rs, b_rs; bf16: q, k,
    # x_g, v
    n_in = 4 * (16 + 12 + 24 + 4 + 4 + 16 + 4 + 48 + 12) \
        + 2 * (8 + 8 + 24 + 24)
    n_out = 4 * (8 + 24)
    flop = 2.0 * D * (D + C) * 3
    want = max((n_in + n_out) / 3.35e12 * 1e3, flop / 989e12 * 1e3)
    got = k["fused_gata_forward"].bound_ms(args, {"pair_dtype": bf}, 3)[0]
    assert got == pytest.approx(want, rel=1e-12)
    # the HTR update: t, EQ, EK, rl, W_g, b_g; every pair
    hargs = [_meta(G, M, M, D), _meta(G, M, L, D, dtype=bf),
             _meta(G, M, L, D, dtype=bf), _meta(G, M, M, L), _meta(D, D),
             _meta(D)]
    n = 4 * 16 + 2 * 24 * 2 + 4 * 12 + 4 * 16 + 4 * 4 + 4 * 16
    want = max(n / 3.35e12 * 1e3, 2.0 * 16 * 4 / 67e12 * 1e3)
    got = k["fused_htr_forward"].bound_ms(hargs, {"pair_dtype":
                                                  torch.float32})[0]
    assert got == pytest.approx(want, rel=1e-12)


def test_trace_reader_by_hand(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.trace",
         "ts": 0, "dur": 100, "tid": 1, "pid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "bench.train_step",
         "ts": 0, "dur": 60, "tid": 1, "pid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "bench.loader_wait",
         "ts": 60, "dur": 40, "tid": 1, "pid": 1},
        {"ph": "X", "cat": "user_annotation",
         "name": "bench.kernel.fused_gata_forward#0", "ts": 10, "dur": 5,
         "tid": 1, "pid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 2, "dur": 4,
         "tid": 1, "pid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 3, "dur": 1,
         "tid": 1, "pid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 50,
         "dur": 8, "tid": 1, "pid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
         "ts": 51, "dur": 6, "tid": 1, "pid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 4, "dur": 1, "tid": 1, "pid": 1, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 12, "dur": 1, "tid": 1, "pid": 1,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 10, "dur": 20,
         "tid": 7, "pid": 0, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "fused", "ts": 25, "dur": 15,
         "tid": 7, "pid": 0, "args": {"correlation": 2}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 70, "dur": 10,
         "tid": 7, "pid": 0, "args": {"correlation": 3}},
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    r = trace.read(str(p))
    assert r["busy_s"] == pytest.approx(40e-6)       # [10, 40] and [70, 80]
    # the outermost ops, less the wait inside aten::item
    assert r["host_op_s"] == pytest.approx((4 + 8 - 6) * 1e-6)
    assert r["kernel_device_s"] == {"fused_gata_forward#0":
                                    pytest.approx(15e-6)}
    gaps = dict(r["idle_gaps"])
    # [0, 10] and [40, 70] (its middle at 55) under train_step, [80, 100]
    # under loader_wait
    assert gaps["train_step"] == pytest.approx(40e-6)
    assert gaps["loader_wait"] == pytest.approx(20e-6)
    assert r["device_ops"][0] == ["gemm", pytest.approx(20e-6)]


def test_compared_numbers_by_hand():
    """Loss gaps over the largest reference loss and over each step's own,
    the leaves' norm gaps against the larger of their own norm and the
    median leaf's, and the answers' gaps."""
    from harness.compare import answer_numbers, train_numbers
    t = torch.tensor
    ref = {"losses": [100.0, 10.0, 2.0],
           "grad1": {"a": t([3.0, 4.0]), "b": t([1.0]), "c": t([0.0])},
           "change": {"a": t([1.0]), "b": t([2.0]), "c": t([5.0])}}
    prog = {"losses": [101.0, 10.0, 3.0],
            "grad1": {"a": t([3.0, 4.0]), "b": t([1.5]), "c": t([0.1])},
            "change": {"a": t([1.0]), "b": t([2.5]), "c": t([9.0])}}
    n = train_numbers(prog, ref)
    assert n["loss_gap"] == pytest.approx(0.01)       # 1 / 100
    assert n["loss_step_gap"] == pytest.approx(0.5)   # 1 / 2
    assert n["loss1_gap"] == pytest.approx(0.01)
    # norms 5, 1, 0; median 1: gaps 0, 0.5, 0.1
    assert n["grad_gap"] == pytest.approx(0.5)
    assert n["grad_gap_median"] == pytest.approx(0.1)
    # leaf c's gradient is under a thousandth of the median: left out
    assert n["change_gap"] == pytest.approx(0.25)     # b: 0.5 / max(2, 1.5)
    assert n["_left_out"] == 1
    a = answer_numbers([1.0, -2.5], [1.5, -2.0], [[[3.0, 4.0, 0.0]]],
                       [[[3.0, 4.0, 1.0]]], n_atoms=[5, 2])
    assert a["energy_gap"] == pytest.approx(0.5 / 2.0)
    assert a["energy_atom_gap"] == pytest.approx(0.25)   # 0.5 / 2 atoms
    assert a["force_gap"] == pytest.approx(1.0 / 4.0)
    assert a["force_rms_gap"] == pytest.approx((1 / 3) ** 0.5 / (26 / 3) ** 0.5)
