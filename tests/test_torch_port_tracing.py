"""The port's tracer (``gotennet_tpu_torch/utils/profiling.py``) on the
CPU, with tiny models: off, it records nothing and enters no profiler
range; on, one record a training step, request or evaluation, with the
named spans nested and the pair counters worked out by hand (the plain
HTR update's once a call, absent where the kernel updates, free when
off); under ``torch.profiler`` the spans land in the Chrome trace as
nested ``gotennet.*`` ranges and records are kept only while it runs;
the ELL layout's spans (``model.embed``, ``model.layer``,
``graph.neighbors`` for a frame the loader has not cached) and table
counters (``pairs.ell_slot``, ``pairs.ell_edge``), nothing of them when
off; spans and counts of the prefetching loader's thread land in the records,
whatever the threads' interleaving; ``Trainer.fit`` logs the traced means;
``summarize_trace`` on traces written by hand (the device total as a union,
idle gaps by the innermost program span, spans' self times); and
``prefetch`` over a loader of ``(indices, batch)`` pairs."""

import dataclasses
import json
import sys
import threading
from unittest import mock

import numpy as np
import pytest
import torch

from gotennet_tpu_torch.data.dataset import (DenseLoader, ELLLoader,
                                             synthetic_molecules)
from gotennet_tpu_torch.data.prefetch import prefetch
from gotennet_tpu_torch.graph.dense_batch import (collate_dense,
                                                  collate_dense_packed)
from gotennet_tpu_torch.graph.ell_batch import collate_ell
from gotennet_tpu_torch.models.gotennet import GotenNetConfig
from gotennet_tpu_torch.models.model import GotenModel, HeadConfig
from gotennet_tpu_torch.ops import fused_gata
from gotennet_tpu_torch.serve import Predictor
from gotennet_tpu_torch.tasks.base import Task
from gotennet_tpu_torch.train.optim import make_optimizer
from gotennet_tpu_torch.train.trainer import (Trainer, TrainerConfig,
                                              make_loss_fn, train_step)
from gotennet_tpu_torch.utils import profiling

TINY = GotenNetConfig(n_atom_basis=16, n_interactions=2, lmax=1,
                      num_heads=2, n_rbf=8)
FORCE_HEAD = HeadConfig(derivative=True)


@pytest.fixture(autouse=True)
def tracer():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def molecules(n=5, seed=1):
    ds = synthetic_molecules(n, seed=seed, min_atoms=3, max_atoms=9)
    return ds, [{"z": ds.z[i], "pos": ds.pos[i]} for i in range(n)]


def run_train_step():
    ds, _ = molecules()
    model = GotenModel(TINY, HeadConfig(), "dense", device="cpu")
    opt = make_optimizer(model.parameters(), 1e-3)
    chunks = list(DenseLoader(ds, 3))
    train_step(model, opt, chunks, 5.0,
               loss_fn=make_loss_fn(model, Task(None)))


def run_predict():
    Predictor(TINY, HeadConfig(), chunk=2, device="cpu").predict(
        molecules()[1])


def run_predict_with_forces():
    Predictor(TINY, FORCE_HEAD, chunk=2, device="cpu").predict_with_forces(
        molecules()[1])


CALLS = {"train_step": (run_train_step, "step",
                        {"step": ["step.forward", "step.backward",
                                  "step.clip", "step.optimizer", "wait"]}),
         "predict": (run_predict, "request",
                     {"request": ["loader.collate", "batch.to_device",
                                  "model.forward", "wait"]}),
         "predict_with_forces": (run_predict_with_forces, "request",
                                 {"request": ["loader.collate",
                                              "batch.to_device",
                                              "request.forces", "wait"],
                                  "request.forces": ["model.forward"]})}
MODEL = {"model.forward": ["model.embed", "model.layer", "model.head"]}


def test_off_records_nothing_and_enters_no_profiler_range():
    rf = mock.MagicMock(side_effect=AssertionError("record_function"))
    with mock.patch.object(torch.profiler, "record_function", rf):
        assert profiling.span("step") is profiling.span("request")
        for fn, _, _ in CALLS.values():
            fn()
    assert profiling.records() == []
    assert not rf.called


@pytest.mark.parametrize("call", list(CALLS))
def test_one_record_a_call_with_its_spans_nested(call):
    fn, kind, children = CALLS[call]
    profiling.enable()
    fn()
    recs = profiling.records()
    assert [r["kind"] for r in recs] == [kind]
    r = recs[0]
    assert r["calls"][kind] == 1
    assert r["calls"]["model.layer"] == TINY.n_interactions * \
        r["calls"]["model.forward"]
    for parent, names in {**children, **MODEL}.items():
        assert r["ms"][parent] >= sum(r["ms"][n] for n in names)
        assert r["self_ms"][parent] < r["ms"][parent]
    for leaf in ("loader.collate", "model.embed", "model.head", "wait"):
        if leaf in r["ms"]:
            assert r["self_ms"][leaf] == pytest.approx(r["ms"][leaf])
    # one thread: the self times add up to the outermost spans' time (the
    # closing span's, and the step's batches' collation before it)
    top = r["ms"][kind] + (r["ms"]["loader.collate"] if kind == "step"
                           else 0.0)
    assert sum(r["self_ms"].values()) == pytest.approx(top, abs=1e-3)
    assert r["waits"] >= 1 and r["device_wait_ms"] >= 0.0
    assert r["host_self_ms"] == pytest.approx(top - r["device_wait_ms"],
                                              abs=1e-3)
    if kind == "request":
        assert r["counts"]["pairs.padded"] > r["counts"]["pairs.atom"] > 0


@pytest.mark.parametrize("packed", [False, True])
def test_pair_counters_by_hand(packed):
    """Molecules of 3, 5 and 7 atoms: 6 + 20 + 42 atom pairs; four slabs
    of 8 slots (256 pairs), or packed two a slab into two slabs (128)."""
    rng = np.random.default_rng(0)
    graphs = [{"z": np.full(n, 6), "pos": rng.normal(size=(n, 3))}
              for n in (3, 5, 7)]
    profiling.enable()
    with profiling.span("request"):
        if packed:
            collate_dense_packed(graphs, 2, 8, 2)
        else:
            collate_dense(graphs, 4, 8)
    (r,) = profiling.records()
    assert r["counts"] == {"pairs.atom": 68,
                           "pairs.padded": 128 if packed else 256}
    assert r["calls"]["loader.collate"] == 1
    assert profiling.summary([r])["atom_pair_pct"] == pytest.approx(
        100.0 * 68 / (128 if packed else 256))


def _forward(cfg):
    """One forward of a 3-graph batch of ``cfg``'s model, inside a
    ``request`` span; the batch's G and M."""
    ds, _ = molecules(3)
    batch = next(iter(DenseLoader(ds, 3)))
    model = GotenModel(cfg, HeadConfig(), "dense", device="cpu")
    with profiling.span("request"), torch.no_grad():
        model(batch)
    return batch.z.shape


@pytest.mark.parametrize("layers", [2, 3])
def test_plain_htr_update_counted_once_a_call(layers):
    """``pairs.htr_plain``: G M^2 for each layer with an update (all but
    the last)."""
    profiling.enable()
    G, M = _forward(dataclasses.replace(TINY, n_interactions=layers))
    (r,) = profiling.records()
    assert r["calls"]["model.layer"] == layers
    assert r["counts"]["pairs.htr_plain"] == (layers - 1) * G * M * M


def test_plain_htr_counter_absent_where_the_kernel_updates():
    profiling.enable()
    _forward(dataclasses.replace(TINY, fused=True, fused_htr=True))
    (r,) = profiling.records()
    assert "pairs.htr_plain" not in r["counts"]
    assert r["counts"]["pairs.padded"] > 0


def test_plain_htr_counter_costs_nothing_when_off():
    """Off, the counter returns before the lock and the open record."""
    lock = mock.MagicMock()
    lock.__enter__.side_effect = AssertionError("lock taken")
    with mock.patch.object(profiling, "_lock", lock):
        _forward(TINY)
    assert not lock.__enter__.called
    assert profiling.records() == []
    assert "pairs.htr_plain" not in profiling._pending.counts


@pytest.mark.parametrize("call", ["train_step", "predict_with_forces"])
def test_fused_gata_backward_counts_its_pairs_each_call(call):
    """``pairs.gata_bwd``: G M^2 for each backward through ``FusedGATA``
    (one a layer and chunk), a step's or a force request's."""
    cfg = dataclasses.replace(TINY, fused=True)
    ds, mols = molecules()
    shapes = []
    backward = fused_gata.fused_gata_backward

    def spy(*args, **kwargs):
        shapes.append(tuple(args[0].shape[:2]))
        return backward(*args, **kwargs)

    profiling.enable()
    with mock.patch.object(fused_gata, "fused_gata_backward", spy):
        if call == "train_step":
            model = GotenModel(cfg, HeadConfig(), "dense", device="cpu")
            chunks = list(DenseLoader(ds, 3))
            train_step(model, make_optimizer(model.parameters(), 1e-3),
                       chunks, 5.0, loss_fn=make_loss_fn(model, Task(None)))
            n_chunks = len(chunks)
        else:
            Predictor(cfg, FORCE_HEAD, chunk=2,
                      device="cpu").predict_with_forces(mols)
            n_chunks = -(-len(mols) // 2)
    (r,) = profiling.records()
    assert len(shapes) == cfg.n_interactions * n_chunks
    assert r["counts"]["pairs.gata_bwd"] == sum(G * M * M for G, M in shapes)


def test_ell_table_counters_by_hand():
    """A 2-atom molecule 1 A apart (2 edges and 2 self-loops), a 3-atom one
    with one atom beyond the cutoff (2 + 3) and a lone atom (1): 10 real
    edges in an 8-row table of 4 slots (32)."""
    graphs = [{"z": np.full(n, 6),
               "pos": np.asarray([[x, 0.0, 0.0] for x in xs])}
              for n, xs in ((2, (0.0, 1.0)), (3, (0.0, 1.0, 10.0)),
                            (1, (0.0,)))]
    profiling.enable()
    with profiling.span("request"):
        batch = collate_ell(graphs, 8, 4, 3, cutoff=5.0)
    (r,) = profiling.records()
    assert r["counts"] == {"pairs.ell_slot": 32, "pairs.ell_edge": 10}
    assert int(batch.nbr_mask.sum()) == 10
    assert r["calls"]["loader.collate"] == 1
    # the collation built each molecule's graph itself
    assert r["calls"]["graph.neighbors"] == 3


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("layers", [2, 3])
def test_ell_model_records_embed_and_each_layer(fused, layers):
    ds, _ = molecules(3)
    batch = next(iter(ELLLoader(ds, 3)))
    cfg = dataclasses.replace(TINY, n_interactions=layers, fused=fused,
                              fused_htr=fused)
    model = GotenModel(cfg, HeadConfig(), "ell", device="cpu")
    profiling.enable()
    with profiling.span("request"), torch.no_grad():
        model(batch)
    (r,) = profiling.records()
    assert r["calls"]["model.embed"] == 1
    assert r["calls"]["model.layer"] == layers
    assert r["calls"]["model.forward"] == 1
    assert r["ms"]["model.forward"] >= (r["ms"]["model.embed"]
                                       + r["ms"]["model.layer"])
    assert r["self_ms"]["model.embed"] == pytest.approx(
        r["ms"]["model.embed"])


def test_ell_neighbors_span_only_for_frames_not_cached():
    """The loader builds each frame's graph once: the first epoch's
    batches trace one ``graph.neighbors`` a frame, the second's none."""
    ds, _ = molecules(5)
    loader = ELLLoader(ds, 2, max_neighbors=12)
    profiling.enable()
    for _ in range(2):
        with profiling.span("request"):
            list(loader.batches())
    first, second = profiling.records()
    assert first["calls"]["graph.neighbors"] == len(ds)
    assert first["calls"]["loader.collate"] == len(loader)
    assert "graph.neighbors" not in second["calls"]
    assert second["calls"]["loader.collate"] == len(loader)
    assert second["counts"] == first["counts"]


def test_ell_off_records_nothing_and_enters_no_profiler_range():
    rf = mock.MagicMock(side_effect=AssertionError("record_function"))
    lock = mock.MagicMock()
    lock.__enter__.side_effect = AssertionError("lock taken")
    ds, _ = molecules(4)
    with mock.patch.object(torch.profiler, "record_function", rf), \
            mock.patch.object(profiling, "_lock", lock):
        loader = ELLLoader(ds, 2, max_neighbors=12)
        model = GotenModel(dataclasses.replace(TINY, fused=True),
                           HeadConfig(), "ell", device="cpu")
        opt = make_optimizer(model.parameters(), 1e-3)
        train_step(model, opt, list(loader), 5.0,
                   loss_fn=make_loss_fn(model, Task(None)))
    assert not rf.called and not lock.__enter__.called
    assert profiling.records() == []
    assert not profiling._pending.counts


def test_profiler_ranges_nested_and_records_only_while_profiling(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    run_predict()
    assert profiling.records() == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_predict()
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    assert [r["kind"] for r in profiling.records()] == ["request"]
    run_predict()
    assert len(profiling.records()) == 1
    ev = [e for e in json.loads((tmp_path / "t.json").read_text())
          ["traceEvents"] if e.get("cat") == "user_annotation"
          and e["name"].startswith("gotennet.")]

    def inside(name, outer):
        out = [e for e in ev if e["name"] == "gotennet." + outer]
        return all(any(o["ts"] <= e["ts"] and e["ts"] + e["dur"]
                       <= o["ts"] + o["dur"] for o in out)
                   for e in ev if e["name"] == "gotennet." + name)

    names = {e["name"] for e in ev}
    assert {"gotennet.request", "gotennet.model.forward",
            "gotennet.model.layer", "gotennet.loader.collate",
            "gotennet.wait"} <= names
    assert inside("model.forward", "request")
    assert inside("model.layer", "model.forward")
    assert inside("loader.collate", "request")


def test_producer_thread_collation_lands_in_the_records():
    ds, _ = molecules(9)
    model = GotenModel(TINY, HeadConfig(), "dense", device="cpu")
    opt = make_optimizer(model.parameters(), 1e-3)
    profiling.enable()
    main = threading.get_ident()
    for idx, batch in prefetch(DenseLoader(ds, 3).batches()):
        assert isinstance(idx, np.ndarray)
        train_step(model, opt, [batch.to("cpu")], 5.0)
    recs = profiling.records()
    assert len(recs) == 3
    assert sum(r["calls"].get("loader.collate", 0) for r in recs) == 3
    assert sum(r["calls"]["loader.wait"] for r in recs) == 3
    sizes = [len(z) for z in ds.z]
    assert sum(r["counts"].get("pairs.atom", 0) for r in recs) == sum(
        m * (m - 1) for m in sizes)
    # the producer's collation is not the caller's own time
    for r in recs:
        assert r["host_self_ms"] == pytest.approx(
            r["ms"]["step"] + r["ms"]["batch.to_device"]
            - r["device_wait_ms"], abs=1e-3)
        assert r["loader_wait_ms"] == pytest.approx(r["ms"]["loader.wait"])
    assert threading.get_ident() == main


def test_threads_lose_no_count():
    """More threads than cores counting into records that the main thread
    closes meanwhile: every count lands in exactly one record."""
    n_threads, per = 16, 300
    profiling.enable()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    stop = threading.Event()

    def worker():
        for _ in range(per):
            with profiling.span("loader.collate"):
                profiling.count("pairs.atom", 1)

    def closer():
        while not stop.is_set():
            with profiling.span("step"):
                pass

    try:
        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        close = threading.Thread(target=closer)
        close.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        stop.set()
        close.join(timeout=60)
        assert not any(t.is_alive() for t in threads + [close])
        with profiling.span("step"):
            pass
    finally:
        sys.setswitchinterval(old)
    recs = profiling.records()
    assert sum(r["counts"].get("pairs.atom", 0) for r in recs) == \
        n_threads * per
    assert sum(r["calls"].get("loader.collate", 0) for r in recs) == \
        n_threads * per


def test_fit_logs_the_traced_means(tmp_path):
    ds, _ = molecules(8)
    model = GotenModel(TINY, HeadConfig(), "dense", device="cpu")
    task = Task(None)
    cfg = TrainerConfig(max_epochs=1, log_every=2, workdir=str(tmp_path))
    profiling.enable()
    Trainer(model, task, cfg).fit(model.state_dict(), DenseLoader(ds, 2),
                                  DenseLoader(ds, 4))
    logs = [json.loads(line) for line in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in logs if r.get("phase") == "train"]
    assert [r["step"] for r in train] == [2, 4]
    for r in train:
        assert r["host_self_ms"] > 0.0 and r["device_wait_ms"] >= 0.0
        assert r["loader_wait_ms"] >= 0.0 and r["collate_ms"] >= 0.0
        # the loss and the logs' values, read in the step's own record
        assert r["waits"] == 1.0
    assert 0.0 < train[0]["atom_pair_pct"] <= 100.0
    val = [r for r in logs if r.get("phase") == "val_epoch"]
    assert val[0]["epoch_time_s"] > 0.0
    kinds = [r["kind"] for r in profiling.records()]
    assert kinds.count("step") == 4 and kinds.count("evaluate") == 1
    for r in profiling.records():
        if r["kind"] == "step":
            assert r["calls"]["wait"] == r["waits"] == 1


def test_fit_logs_nothing_of_the_tracer_when_off(tmp_path):
    ds, _ = molecules(4)
    model = GotenModel(TINY, HeadConfig(), "dense", device="cpu")
    cfg = TrainerConfig(max_epochs=1, log_every=1, workdir=str(tmp_path))
    Trainer(model, Task(None), cfg).fit(model.state_dict(),
                                        DenseLoader(ds, 2), DenseLoader(ds, 4))
    train = [json.loads(line) for line in
             (tmp_path / "metrics.jsonl").read_text().splitlines()
             if '"train"' in line]
    assert train and not any("host_self_ms" in r for r in train)


def test_cli_trace_switch_writes_the_records(tmp_path):
    from gotennet_tpu_torch import cli
    cfg = {"trace": True, "workdir": str(tmp_path)}
    assert not cli._start_trace({"workdir": str(tmp_path)})
    assert not profiling.active()
    assert cli._start_trace(cfg) and profiling.active()
    run_predict()
    run_predict()
    cli._write_trace(cfg)
    assert not profiling.active()
    lines = (tmp_path / "trace.jsonl").read_text().splitlines()
    assert [json.loads(x)["kind"] for x in lines] == ["request", "request"]


# ---- summarize_trace ---------------------------------------------------------
def _write(tmp_path, events):
    (tmp_path / profiling.TRACE_FILE).write_text(
        json.dumps({"traceEvents": [dict(e, ph="X", pid=1) for e in events]}))
    return str(tmp_path)


def test_summary_totals_the_union_and_names_gaps_by_span(tmp_path):
    ev = [
        {"cat": "user_annotation", "name": "gotennet.request", "ts": 0,
         "dur": 100, "tid": 1},
        {"cat": "user_annotation", "name": "gotennet.model.forward",
         "ts": 5, "dur": 40, "tid": 1},
        {"cat": "user_annotation", "name": "gotennet.wait", "ts": 80,
         "dur": 20, "tid": 1},
        {"cat": "user_annotation", "name": "bench.trace", "ts": 0,
         "dur": 100, "tid": 1},
        {"cat": "cpu_op", "name": "aten::mm", "ts": 6, "dur": 4, "tid": 1},
        {"cat": "kernel", "name": "gemm", "ts": 10, "dur": 30, "tid": 7},
        {"cat": "kernel", "name": "add", "ts": 20, "dur": 30, "tid": 8},
        {"cat": "gpu_memcpy", "name": "copy", "ts": 85, "dur": 10,
         "tid": 7},
        {"cat": "gpu_user_annotation", "name": "gotennet.request", "ts": 10,
         "dur": 85, "tid": 7},
    ]
    s = profiling.summarize_trace(_write(tmp_path, ev))
    # [10, 50] and [85, 95]: overlapping kernels count once
    assert s["total_us"] == pytest.approx(50.0)
    assert s["by_category_us"]["CUDA kernels"] == pytest.approx(60.0)
    gaps = {g["name"]: g["us"] for g in s["idle_gaps"]}
    # [0, 10] inside model.forward; [50, 85] (middle 67.5) in request
    # alone; [95, 100] inside wait
    assert gaps == {"model.forward": pytest.approx(10.0),
                    "request": pytest.approx(35.0),
                    "wait": pytest.approx(5.0)}
    spans = {r["name"]: r for r in s["spans"]}
    assert set(spans) == {"request", "model.forward", "wait"}
    assert spans["request"]["self_us"] == pytest.approx(40.0)
    assert spans["request"]["us"] == pytest.approx(100.0)
    assert spans["model.forward"]["self_us"] == pytest.approx(40.0)
    assert spans["wait"]["calls"] == 1


def test_summary_on_the_cpu_totals_the_outermost_ops(tmp_path):
    ev = [{"cat": "cpu_op", "name": "aten::linear", "ts": 0, "dur": 10,
           "tid": 1},
          {"cat": "cpu_op", "name": "aten::mm", "ts": 2, "dur": 5,
           "tid": 1},
          {"cat": "cpu_op", "name": "aten::add", "ts": 20, "dur": 3,
           "tid": 2}]
    s = profiling.summarize_trace(_write(tmp_path, ev))
    assert s["total_us"] == pytest.approx(13.0)
    assert s["idle_gaps"] == [] and s["spans"] == []


def test_profile_fn_prints_the_spans(capsys):
    profile = profiling.profile_fn(run_predict)
    out = capsys.readouterr().out
    assert "spans (self ms, ms, calls):" in out and "model.layer" in out
    assert {r["name"] for r in profile["spans"]} >= {"request",
                                                     "model.forward"}


# ---- prefetch ----------------------------------------------------------------
def test_prefetch_iterates_index_batch_pairs_and_reraises():
    ds, _ = molecules(5)
    got = list(prefetch(DenseLoader(ds, 2).batches()))
    want = list(DenseLoader(ds, 2).batches())
    assert len(got) == len(want) == 3
    for (i, b), (j, c) in zip(got, want):
        np.testing.assert_array_equal(i, j)
        assert torch.equal(b.z, c.z)

    def broken():
        yield from DenseLoader(ds, 2).batches()
        raise RuntimeError("producer failed")

    it = prefetch(broken())
    for _ in range(3):
        next(it)
    with pytest.raises(RuntimeError, match="producer failed"):
        next(it)
    # an item that looks like the old error marker is only an item
    item = ("__error__", RuntimeError("not raised"))
    assert list(prefetch(iter([item]))) == [item]
