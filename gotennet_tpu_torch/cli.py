"""The train, test, sweep and parity entry points (``gotennet_tpu/cli.py``).

    python -m gotennet_tpu_torch.cli train experiment=smoke
    python -m gotennet_tpu_torch.cli train experiment=qm9_u0 \
        datamodule.dataset_root=<dir with gdb9.sdf>
    python -m gotennet_tpu_torch.cli train experiment=md17_aspirin \
        datamodule.dataset_root=<dir with rmd17_aspirin.npz>
    python -m gotennet_tpu_torch.cli train experiment=qm9_u0_tpu
    python -m gotennet_tpu_torch.cli train experiment=qm9_u0_tpu label=mu
    python -m gotennet_tpu_torch.cli train experiment=md22_atat \
        datamodule.dataset_root=<dir with md22_AT-AT-CG-CG.npz>
    python -m gotennet_tpu_torch.cli train experiment=molecule3d \
        datamodule.dataset_root=<dir with shard_*.npz, or *.sdf>
    torchrun --nproc-per-node 2 -m gotennet_tpu_torch.cli train \
        experiment=molecule3d trainer.distributed=true \
        trainer.data_parallel=2
    python -m gotennet_tpu_torch.cli train experiment=qm9_u0_tpu \
        model.representation.scan_layers=true
    python -m gotennet_tpu_torch.cli test checkpoint=runs/x/ckpt_best
    python -m gotennet_tpu_torch.cli test checkpoint=gotennet_U0.ckpt
    python -m gotennet_tpu_torch.cli test checkpoint=QM9_small_homo
    python -m gotennet_tpu_torch.cli sweep experiment=smoke \
        model.representation.lmax=1,2 sweep_dir=runs/sweep
    python -m gotennet_tpu_torch.cli sweep experiment=smoke sampler=adaptive \
        n_trials=8 "model.lr=loguniform(1e-5,1e-3)"
    python -m gotennet_tpu_torch.cli parity checkpoints=a.ckpt,b.ckpt \
        out=parity.md
    python -m gotennet_tpu_torch.cli train experiment=... device=cpu

Composes the YAML config tree in ``configs/`` (``utils/config.py``), builds
the data pipeline, task, model and ``Trainer``, runs ``fit`` and/or the
evaluation, and writes the metrics, checkpoints and ``test_results.json``
into ``workdir``.  ``test`` takes a checkpoint directory, a reference
Lightning ``.ckpt`` or a published alias (``utils/hub.py``); ``sweep`` runs
a grid, random or adaptive search over the overrides (``utils/sweep.py``;
its own keys ``sampler``, ``n_trials``, ``seed``, ``metric`` and
``sweep_dir``), each trial a ``train`` in a workdir of the sweep's;
``parity`` tests each of ``checkpoints=`` and appends the MAE table to
``out`` (default ``BASELINE.md``).  Entry points run on ``cuda`` unless the
top-level ``device`` override says otherwise.

Fields the YAML leaves out take the JAX package's defaults, so the same
experiment builds the same model in both packages (``fused`` absent is
False, ``layout`` absent is ``"edge"``, the edge-list layout and its
``BatchLoader``).  The rMD17, MD17 and MD22 experiments read local
trajectories (``data/md17.py``) and train on forces, with ``fused`` False
on the dense and ELL layouts.  Molecule3D reads a local copy
(``data/molecule3d.py``); ``datamodule.pack=true`` packs dense batches.

``trace=true`` turns the program's tracer on (``utils/profiling.py``):
``train`` then logs, in each ``log_every`` train record, the means of the
traced steps since the last one (host ms, device-wait ms, loader-wait ms,
collation ms, the atom pairs' share of the padded pairs, device waits a
step), and both entry points write every record into
``workdir/trace.jsonl``.

``trainer.distributed=true`` starts the process group
(``parallel.initialize_distributed``: torchrun's variables, NCCL on CUDA)
before anything else; every rank then reads only its shard of each loader
(``set_shard`` by its data index), or, where the Molecule3D root holds NPZ
shards, only its range of shards.  ``trainer.data_parallel`` /
``edge_parallel`` lay the ranks out as the JAX package's mesh.
The nvcc build cache under ``build/`` stands in for the JAX package's
persistent XLA cache.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import sys
from typing import Dict, List, Optional

import torch

from gotennet_tpu_torch.utils import profiling
from gotennet_tpu_torch.utils.config import load_config
from gotennet_tpu_torch.utils.device import resolve_device
from gotennet_tpu_torch.utils.logging import is_main_process

__all__ = ["train", "test", "parity", "main", "main_train", "main_test",
           "CONFIG_DIR"]

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "configs")


def _build_data(cfg: Dict, label: str):
    """``(train_loader, val_loader, test_loader, dataset_meta)``."""
    from gotennet_tpu_torch.data.dataset import (BatchLoader, DenseLoader,
                                                 ELLLoader, center_positions,
                                                 make_splits,
                                                 standardize_energy,
                                                 synthetic_molecules)
    dm = cfg["datamodule"]
    workdir = cfg["workdir"]
    os.makedirs(workdir, exist_ok=True)
    # under distributed, loaders shard by the data index: the ranks of one
    # edge line share their batches
    world, rank = 1, 0
    if cfg["trainer"].get("distributed"):
        import torch.distributed as dist
        if dist.is_initialized():
            world = cfg["trainer"].get("data_parallel", 1)
            rank = dist.get_rank() // cfg["trainer"].get("edge_parallel", 1)
    # set when the dataset is split across ranks already (Molecule3D NPZ
    # shards): the loaders must not split it again
    host_sharded = False

    if dm["dataset"] == "QM9":
        from gotennet_tpu_torch.data.qm9 import load_qm9
        ds = load_qm9(dm["dataset_root"], label=label)
    elif dm["dataset"] in ("rMD17", "MD17", "MD22"):
        from gotennet_tpu_torch.data.md17 import load_md_dataset
        ds = load_md_dataset(dm["dataset_root"], label,
                             max_frames=dm.get("max_frames"))
    elif dm["dataset"] == "Molecule3D":
        from gotennet_tpu_torch.data.molecule3d import (is_shard_dir,
                                                        load_molecule3d)
        host_sharded = world > 1 and is_shard_dir(dm["dataset_root"])
        ds = load_molecule3d(dm["dataset_root"], label=label,
                             max_molecules=dm.get("max_molecules"),
                             host=rank if host_sharded else 0,
                             n_hosts=world if host_sharded else 1)
    elif dm["dataset"] == "synthetic":
        ds = synthetic_molecules(dm.get("n_molecules", 256),
                                 seed=dm.get("seed", 1),
                                 min_atoms=dm.get("min_atoms", 6),
                                 max_atoms=dm.get("max_atoms", 24),
                                 box=dm.get("box", 4.0),
                                 with_forces=dm.get("with_forces", False))
    else:
        raise ValueError(f"Unknown dataset {dm['dataset']!r}")

    if dm.get("normalize_positions"):
        ds = center_positions(ds)

    idx_train, idx_val, idx_test = make_splits(
        len(ds), dm["train_size"], dm["val_size"], dm.get("test_size"),
        dm.get("seed", 1),
        os.path.join(workdir, "splits.npz") if is_main_process() else None,
        dm.get("splits"))

    mean = std = None
    if dm.get("standardize"):
        use_ar = dm.get("prior_model") == "Atomref"
        mean, std = standardize_energy(ds, idx_train, use_atomref=use_ar)

    layout = cfg["model"].get("layout", "edge")
    if layout == "ell":
        mk = dict(cutoff=cfg["model"]["representation"]["cutoff"],
                  max_num_neighbors=dm.get("max_num_neighbors", 32),
                  neighbor_probe=dm.get("neighbor_probe", 64),
                  spatial_sort=dm.get("spatial_sort", False),
                  block_rows=dm.get("block_rows"))
        make = ELLLoader
    elif layout == "dense":
        max_atoms = max((len(z) for z in ds.z), default=8)
        mk = dict(max_atoms=((max_atoms + 7) // 8) * 8,
                  bucket=dm.get("bucket", False), pack=dm.get("pack", False))
        make = DenseLoader
    else:
        mk = dict(cutoff=cfg["model"]["representation"]["cutoff"],
                  max_num_neighbors=dm.get("max_num_neighbors", 32),
                  neighbor_probe=dm.get("neighbor_probe", 64))
        make = BatchLoader
    infer_bs = dm.get("inference_batch_size", dm["batch_size"])
    train_loader = make(ds.subset(idx_train), dm["batch_size"], shuffle=True,
                        seed=dm.get("seed", 1), **mk)
    val_loader = make(ds.subset(idx_val), infer_bs, **mk)
    test_loader = make(ds.subset(idx_test), infer_bs, **mk)
    if world > 1 and not host_sharded:
        # training leaves out the trailing batches that do not fill every
        # rank; evaluation wraps round (torch's DistributedSampler)
        train_loader.set_shard(world, rank)
        val_loader.set_shard(world, rank, pad=True)
        test_loader.set_shard(world, rank, pad=True)
    meta = {"mean": mean, "std": std, "atomref": ds.atomref}
    return train_loader, val_loader, test_loader, meta


# Every key each config section may carry; unknown keys are rejected.
_MODEL_KEYS = {
    "lr", "lr_decay", "lr_patience", "lr_minlr", "lr_warmup_steps",
    "weight_decay", "grad_clip", "scheduler", "cosine_t_max", "ema_rate",
    "ema_stages", "use_ema_in_loss", "task_loss", "task_config", "layout",
    "representation", "output",
}
_OUTPUT_KEYS = {"n_hidden", "n_layers", "activation"}
_TRAINER_KEYS = {
    "max_epochs", "early_stopping_patience", "monitor",
    "monitor_checkpoint", "log_every", "logger", "tensorboard", "resume",
    "grad_accum_steps", "data_parallel", "edge_parallel", "distributed",
}
_DATAMODULE_KEYS = {
    "dataset", "dataset_root", "batch_size", "inference_batch_size",
    "standardize", "train_size", "val_size", "test_size", "splits",
    "seed", "max_num_neighbors", "prior_model", "normalize_positions",
    "n_molecules", "with_forces", "max_frames", "neighbor_probe",
    "max_molecules", "bucket", "pack", "spatial_sort", "block_rows",
    "min_atoms", "max_atoms", "box",
}


def _check_keys(section: Dict, allowed: set, name: str) -> None:
    unknown = sorted(set(section) - allowed)
    if unknown:
        raise ValueError(f"unknown config key(s) {unknown} in '{name}'; "
                         f"allowed: {sorted(allowed)}")


def _build_trainer_config(cfg: Dict):
    """``TrainerConfig`` from the model's LR block and the trainer
    block."""
    from gotennet_tpu_torch.train.trainer import TrainerConfig

    mc = cfg["model"]
    tr = cfg["trainer"]
    _check_keys(tr, _TRAINER_KEYS, "trainer")
    return TrainerConfig(
        lr=mc.get("lr", 1e-4), weight_decay=mc.get("weight_decay", 0.0),
        grad_clip=mc.get("grad_clip", 5.0),
        lr_warmup_steps=mc.get("lr_warmup_steps", 0),
        scheduler=mc.get("scheduler", "plateau"),
        lr_decay=mc.get("lr_decay", 0.8),
        lr_patience=mc.get("lr_patience", 15),
        lr_minlr=mc.get("lr_minlr", 1e-7),
        cosine_t_max=mc.get("cosine_t_max", 1_000_000),
        max_epochs=tr.get("max_epochs", 1000),
        early_stopping_patience=tr.get("early_stopping_patience", 150),
        monitor=tr.get("monitor", "val_loss"),
        monitor_checkpoint=tr.get("monitor_checkpoint"),
        ema_rate=mc.get("ema_rate", 0.0),
        ema_stages=tuple(mc.get("ema_stages", ("train", "validation"))),
        use_ema_in_loss=mc.get("use_ema_in_loss", False),
        seed=cfg.get("seed", 1),
        log_every=tr.get("log_every", 50),
        workdir=cfg["workdir"],
        logger=tr.get("logger", "jsonl"),
        tensorboard=tr.get("tensorboard", False),
        resume=tr.get("resume", False),
        grad_accum_steps=tr.get("grad_accum_steps", 1),
        data_parallel=tr.get("data_parallel", 1),
        edge_parallel=tr.get("edge_parallel", 1),
        distributed=tr.get("distributed", False),
    )


def model_config(cfg: Dict):
    """The ``GotenNetConfig`` of a composed config: the YAML's
    ``model.representation`` over the JAX package's defaults (``fused``
    absent is False), the pair and node types from ``bf16`` strings, the
    neighbour cap from the datamodule's when the model has none."""
    from gotennet_tpu_torch.models.gotennet import GotenNetConfig

    rep = dict(cfg["model"]["representation"])
    for key in ("pair_dtype", "node_dtype"):
        if rep.get(key) in ("bf16", "bfloat16"):
            rep[key] = torch.bfloat16
        else:
            rep.pop(key, None)
    rep.setdefault("max_num_neighbors",
                   cfg["datamodule"].get("max_num_neighbors", 32))
    rep.setdefault("fused", False)
    return GotenNetConfig(**rep)


def _build_model_and_trainer(cfg: Dict, meta: Dict, device: torch.device):
    from gotennet_tpu_torch.models.model import GotenModel
    from gotennet_tpu_torch.tasks import TASK_DICT
    from gotennet_tpu_torch.train.trainer import Trainer

    mc = cfg["model"]
    _check_keys(mc, _MODEL_KEYS, "model")
    _check_keys(cfg["datamodule"], _DATAMODULE_KEYS, "datamodule")
    gcfg = model_config(cfg)
    task_cls = TASK_DICT[cfg["task"]]
    tkw = {"task_loss": mc.get("task_loss", "L1Loss")}
    tkw.update(mc.get("task_config") or {})
    task = task_cls(cfg["label"], dataset_meta=meta, task_config=tkw)
    head = task.build_head()
    out_cfg = dict(mc.get("output") or {})
    _check_keys(out_cfg, _OUTPUT_KEYS, "model.output")
    if out_cfg:
        head = dataclasses.replace(head, **out_cfg)
    model = GotenModel(gcfg, head, mc.get("layout", "edge"),
                       seed=cfg.get("seed", 1), device=device)
    return model, task, Trainer(model, task, _build_trainer_config(cfg))


def _print_config(cfg: Dict, indent: int = 0) -> None:
    for k, v in cfg.items():
        if isinstance(k, str) and k.startswith("_"):
            continue  # bookkeeping keys (_overrides)
        if isinstance(v, dict):
            print("  " * indent + f"{k}:")
            _print_config(v, indent + 1)
        else:
            print("  " * indent + f"{k}: {v}")


def _write_results(cfg: Dict, results: Dict[str, float]) -> None:
    print("test:", json.dumps(results))
    if is_main_process():
        with open(os.path.join(cfg["workdir"], "test_results.json"),
                  "w") as f:
            json.dump(results, f, indent=1)


def _start_trace(cfg: Dict) -> bool:
    """``trace=true``: the tracer on, from no record."""
    if not cfg.get("trace", False):
        return False
    profiling.reset()
    profiling.enable()
    return True


def _write_trace(cfg: Dict) -> None:
    """The tracer's records into ``workdir/trace.jsonl``; the tracer off."""
    profiling.disable()
    if is_main_process():
        with open(os.path.join(cfg["workdir"], "trace.jsonl"), "w") as f:
            for r in profiling.records():
                f.write(json.dumps(r) + "\n")


def train(cfg: Dict) -> Dict[str, float]:
    """Train (``cfg['train']``) and test the best checkpoint
    (``cfg['test']``); returns the test results."""
    from gotennet_tpu_torch.train.checkpoint import load_checkpoint

    if cfg["trainer"].get("distributed"):
        # before anything else: the loaders shard by the rank
        from gotennet_tpu_torch.parallel import initialize_distributed
        info = initialize_distributed()
        print(f"distributed: process {info['process_index']}/"
              f"{info['process_count']} ({info['backend']})")
    _print_config(cfg)
    traced = _start_trace(cfg)
    device = resolve_device(cfg.get("device"))
    label = cfg["label"]
    train_loader, val_loader, test_loader, meta = _build_data(cfg, label)
    model, task, trainer = _build_model_and_trainer(cfg, meta, device)

    if is_main_process():
        with open(os.path.join(cfg["workdir"], "config.json"), "w") as f:
            json.dump({k: v for k, v in cfg.items()}, f, indent=1,
                      default=str)
    n_params = sum(p.numel() for p in model.parameters() if p.requires_grad)
    print(f"model parameters: {n_params:,}")

    state = model.state_dict()
    if cfg.get("train", True):
        state, _ = trainer.fit(state, train_loader, val_loader)
        # test the best checkpoint, not the final weights
        best = os.path.join(cfg["workdir"], "ckpt_best")
        if os.path.isdir(best):
            _, state, _ = load_checkpoint(best, device)

    results = {}
    if cfg.get("test", True):
        results = trainer.evaluate(state, test_loader, phase="test")
        _write_results(cfg, results)
    if traced:
        _write_trace(cfg)
    return results


def test(cfg: Dict) -> Dict[str, float]:
    """Evaluate ``cfg['checkpoint']``: a checkpoint directory, a reference
    Lightning ``.ckpt``, or a URL or alias the hub resolves.  The
    checkpoint's own config builds the model (its cutoff and layout also
    set the data pipeline's); the label and task come from its meta (a
    ``.ckpt``'s hyper-parameters, an int label read as a QM9 target)
    unless the command line sets them."""
    from gotennet_tpu_torch.tasks import TASK_DICT
    from gotennet_tpu_torch.train.checkpoint import load_checkpoint, load_meta
    from gotennet_tpu_torch.train.trainer import Trainer
    from gotennet_tpu_torch.utils.hub import resolve_checkpoint

    ckpt = resolve_checkpoint(cfg["checkpoint"])
    device = resolve_device(cfg.get("device"))
    if os.path.isfile(ckpt) and ckpt.endswith(".ckpt"):
        from gotennet_tpu_torch.data.qm9 import QM9_TARGETS
        from gotennet_tpu_torch.utils.convert import load_reference_model
        model, hp = load_reference_model(ckpt, device)
        ref_label = hp.get("label")
        if isinstance(ref_label, int):
            ref_label = QM9_TARGETS[ref_label]
        meta = {"label": ref_label, "task": hp.get("task", "QM9")}
    else:
        model, _, _ = load_checkpoint(ckpt, device)
        if model is None:
            raise ValueError(f"checkpoint {ckpt} has no embedded config")
        meta = load_meta(ckpt)

    cli_keys = set(cfg.get("_overrides") or ())
    label = ((cfg.get("label") if "label" in cli_keys else None)
             or meta.get("label") or cfg.get("label") or "U0")
    task_name = ((cfg.get("task") if "task" in cli_keys else None)
                 or meta.get("task") or cfg.get("task", "QM9"))

    cfg = copy.deepcopy(cfg)
    cfg["model"]["representation"]["cutoff"] = model.cfg.cutoff
    cfg["model"]["layout"] = model.layout
    _, _, test_loader, dmeta = _build_data(cfg, label)
    task = TASK_DICT[task_name](
        label, dataset_meta=dmeta,
        task_config={"task_loss": cfg["model"].get("task_loss", "L1Loss")})
    trainer = Trainer(model, task, _build_trainer_config(cfg))
    traced = _start_trace(cfg)
    results = trainer.evaluate(None, test_loader, phase="test")
    _write_results(cfg, results)
    if traced:
        _write_trace(cfg)
    return results


def parity(cfg: Dict, checkpoints: List[str],
           out: str = "BASELINE.md") -> List[Dict[str, float]]:
    """``test`` of each checkpoint (each in its own workdir under
    ``workdir/parity``), then a markdown MAE table of them appended to
    ``out``; returns each checkpoint's results."""
    import datetime

    rows = []
    for ck in checkpoints:
        c = copy.deepcopy(cfg)
        c["checkpoint"] = ck
        c["workdir"] = os.path.join(cfg["workdir"], "parity",
                                    ck.replace("/", "_").replace(":", "_"))
        os.makedirs(c["workdir"], exist_ok=True)
        rows.append((ck, test(c)))

    lines = ["", "## Measured reference-checkpoint parity "
             f"({datetime.date.today().isoformat()})", "",
             "Produced by `cli parity checkpoints=" + ",".join(checkpoints)
             + "`.", "", "| Checkpoint | MAE | MSE | val_loss |",
             "|---|---|---|---|"]
    for ck, r in rows:
        lines.append(
            f"| {ck} | {r.get('MeanAbsoluteError', float('nan')):.6g} "
            f"| {r.get('MeanSquaredError', float('nan')):.6g} "
            f"| {r.get('val_loss', float('nan')):.6g} |")
    with open(out, "a") as f:
        f.write("\n".join(lines) + "\n")
    print(f"parity: wrote {len(rows)} rows to {out}")
    return [r for _, r in rows]


def _sweep(overrides: List[str]) -> None:
    """The sweep mode: its own keys (``sampler`` grid, random or adaptive,
    ``n_trials``, ``seed``, ``metric``, ``sweep_dir``) out of the
    overrides, the rest per trial."""
    from gotennet_tpu_torch.utils.sweep import (run_adaptive_search,
                                                run_random_search, run_sweep)
    meta = {"sampler": "grid", "n_trials": "8", "seed": "0",
            "metric": "MeanAbsoluteError", "sweep_dir": "runs/sweep"}
    trial_ovs = []
    for ov in overrides:
        key, _, val = ov.partition("=")
        if key in meta:
            meta[key] = val
        else:
            trial_ovs.append(ov)

    def load(extra):
        return load_config(CONFIG_DIR, "train.yaml", extra)

    if meta["sampler"] in ("random", "adaptive"):
        search = (run_random_search if meta["sampler"] == "random"
                  else run_adaptive_search)
        search(train, load, trial_ovs, n_trials=int(meta["n_trials"]),
               seed=int(meta["seed"]), sweep_dir=meta["sweep_dir"],
               metric=meta["metric"])
    else:
        run_sweep(train, load, trial_ovs, sweep_dir=meta["sweep_dir"],
                  metric=meta["metric"])


def main_train(argv: Optional[List[str]] = None) -> int:
    return main(["train"] + list(sys.argv[1:] if argv is None else argv))


def main_test(argv: Optional[List[str]] = None) -> int:
    return main(["test"] + list(sys.argv[1:] if argv is None else argv))


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    mode, overrides = argv[0], argv[1:]
    if mode == "train":
        train(load_config(CONFIG_DIR, "train.yaml", overrides))
    elif mode == "test":
        test(load_config(CONFIG_DIR, "train.yaml", overrides))
    elif mode == "sweep":
        _sweep(overrides)
    elif mode == "parity":
        cks, out, rest = None, "BASELINE.md", []
        for ov in overrides:
            key, _, val = ov.partition("=")
            if key == "checkpoints":
                cks = val.split(",")
            elif key == "out":
                out = val
            else:
                rest.append(ov)
        if not cks:
            raise SystemExit("parity needs checkpoints=alias1,alias2,...")
        parity(load_config(CONFIG_DIR, "train.yaml", rest), cks, out)
    else:
        raise SystemExit(
            f"unknown mode {mode!r}; use train|test|sweep|parity")
    return 0


if __name__ == "__main__":
    sys.exit(main())
