"""Training: the ``Trainer`` (``gotennet_tpu/train/trainer.py``) and the
bare training step (``bench.py``'s ``one_step``).

One step takes a batch cut into accumulation chunks: the loss of each
chunk is differentiated (through the fused kernels' backward on the
card), the gradients are summed and divided by the number of chunks that
hold a real graph, clipped by their global norm, and AdamW steps.

    losses = train_steps(cfg, head, molecules, n_steps=3)   # on cuda

``Trainer.fit`` runs epochs of such steps over a loader
(``grad_accum_steps`` consecutive batches a step; a trailing partial group
counts only its own batches), with warm-up times plateau or cosine LR, the
per-stage loss EMA (and ``use_ema_in_loss``'s gradient rescale), early
stopping, ``ckpt_best`` / ``ckpt_last`` checkpoints and a full-state
``resume``; ``Trainer.evaluate`` gives the loss and the task's metrics,
summed in float64.

More than one device runs one process per device, in a
``torch.distributed`` process group of ``data_parallel * edge_parallel``
ranks (``parallel.initialize_distributed``; ``torchrun``), laid out as the
JAX package's ``(data, edge)`` mesh (``parallel.make_mesh``).  A step
averages the ranks' gradients, loss and logs over the mesh before the clip
and AdamW, so every rank keeps the same parameters.  The ranks of one edge
line share a batch: the edge-list layout splits its edges among them, the
ELL layout its destination rows (``edge_parallel``; the dense layout
cannot).  Without ``distributed`` every rank reads the whole loader and
takes the batch its JAX device slot would get (group g of ``data_parallel``
accumulation groups, slot = its data index; a trailing partial group is
left out of training and padded with a repeat in evaluation, whose repeats
are not counted).  With ``distributed`` each rank's loader holds its own
shard (``set_shard`` by data index, or Molecule3D's per-rank NPZ shards),
evaluation sums reduce over the ranks, and a step runs only while every
rank has a batch.  Only rank 0 logs and writes checkpoints.

A force loss (a head with ``derivative``, ``MD17Task`` / ``MD22Task``)
trains through the gradient of the forces, a gradient of a gradient.  The
unfused paths give it (plain tensor ops, ``fused=False``); the fused
kernels' backward is differentiable once only, as the JAX package's Pallas
VJP is, so a force head on a path that would launch a fused kernel raises
``ValueError`` before its first step (``check_force_training``).
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gotennet_tpu_torch.data.dataset import (BatchLoader, DenseLoader,
                                             ELLLoader, MoleculeDataset)
from gotennet_tpu_torch.graph.batch import GraphBatch
from gotennet_tpu_torch.graph.dense_batch import DenseBatch
from gotennet_tpu_torch.graph.ell_batch import ELLBatch
from gotennet_tpu_torch.models.gotennet import GotenNetConfig, kernel_paths
from gotennet_tpu_torch.models.model import (GotenModel, HeadConfig,
                                             apply_with_forces, set_edge_axis)
from gotennet_tpu_torch.tasks.base import Task
from gotennet_tpu_torch.train.metrics import MetricAccumulator
from gotennet_tpu_torch.train.optim import (PlateauState, clip_by_global_norm,
                                            cosine_scale, make_optimizer,
                                            plateau_update, set_lr,
                                            warmup_scale)
from gotennet_tpu_torch.utils import profiling

__all__ = ["make_loss_fn", "make_chunks", "accum_grads", "train_step",
           "train_steps", "check_force_training", "TrainerConfig", "Trainer"]


def make_loss_fn(model: GotenModel, task: Task) -> Callable:
    """``loss_fn(batch) -> (total, logs, out)``: the weighted sum of the
    task's losses on one batch, the model run through
    ``apply_with_forces`` (so a force task's loss has its force term, and
    its forces keep their graph where gradients are enabled: the loss is
    then differentiated)."""
    specs = task.get_losses()

    def loss_fn(batch: GraphBatch | DenseBatch | ELLBatch):
        out = apply_with_forces(model, batch,
                                create_graph=torch.is_grad_enabled())
        targets = task.get_targets(batch)
        total = torch.zeros((), dtype=torch.float32, device=batch.z.device)
        logs = {}
        for spec in specs:
            pred = out[spec["prediction"]]
            tgt, mask = targets[spec["target"]]
            li = spec["loss_fn"](pred.reshape(tgt.shape), tgt, mask)
            logs[spec["name"]] = li.detach()
            total = total + spec["loss_weight"] * li
        return total, logs, out

    return loss_fn


def check_force_training(cfg: GotenNetConfig, head: HeadConfig,
                         layout: str, chunks: Sequence = ()) -> None:
    """Raise ``ValueError`` where a force loss (``head.derivative``) would
    train through a fused kernel: for any chunk (on the ELL layout; the
    layout alone on the others) for which ``kernel_paths`` picks one.  The
    kernels' backward is differentiable once only (``once_differentiable``),
    as the JAX package's Pallas VJP is: its ``jax.value_and_grad`` of a force
    loss fails there too, which is why its force experiments leave ``fused``
    at False."""
    if not head.derivative:
        return
    if layout == "ell":
        paths = [kernel_paths(cfg, layout, b.nbr.shape[0], b.nbr.shape[0],
                              b.gather_halo) for b in chunks]
    else:
        paths = [kernel_paths(cfg, layout)]
    if any(any(p) for p in paths):
        raise ValueError(
            f"training on forces (a head with derivative=True) through the "
            f"fused kernels on the {layout} layout: their backward is "
            "differentiable once only, and the force loss needs the "
            "gradient of the forces; set fused=False (the unfused message "
            "and update)")


def make_chunks(molecules: Sequence[dict], chunk: int,
                device: Optional[str | torch.device] = None,
                bucket: bool = True, layout: str = "dense",
                cutoff: float = 5.0, max_num_neighbors: int = 32
                ) -> List[GraphBatch | DenseBatch | ELLBatch]:
    """The accumulation chunks of one batch, as ``bench.py`` cuts them:
    ``chunk`` graphs each, on ``device``.  Dense: with ``bucket`` the
    molecules are sorted by size over one window spanning the batch and each
    chunk is padded to its own largest molecule; without it (``bench.py``'s
    MD22 mode) they keep their order and every chunk is padded to the
    batch's largest molecule (rounded up to a multiple of 8).  ELL
    (``bench.py``'s large mode): in order, atoms spatially sorted, 64-row
    gather windows, every chunk at the batch's node and neighbour capacity,
    as ``Predictor(layout="ell")`` cuts a request.  Edge list: in order,
    every chunk at the capacities ``BatchLoader`` probes over the batch, as
    ``bench.py`` cuts them.  Molecules that all
    carry force targets (``dy``) give chunks that carry them."""
    ds = MoleculeDataset(
        z=[np.asarray(m["z"], np.int32) for m in molecules],
        pos=[np.asarray(m["pos"], np.float32) for m in molecules],
        y=np.asarray([np.asarray(m["y"], np.float32).reshape(-1)
                      for m in molecules]),
        dy=([np.asarray(m["dy"], np.float32) for m in molecules]
            if all("dy" in m for m in molecules) else None))
    if layout == "edge":
        loader = BatchLoader(ds, batch_size=chunk, cutoff=cutoff,
                             max_num_neighbors=max_num_neighbors)
    elif layout == "ell":
        loader = ELLLoader(ds, batch_size=chunk, cutoff=cutoff,
                           max_num_neighbors=max_num_neighbors,
                           spatial_sort=True, block_rows=64)
    else:
        loader = DenseLoader(ds, batch_size=chunk, bucket=bucket,
                             bucket_window=math.ceil(len(molecules) / chunk))
    return [b.to(device) for b in loader]


def accum_grads(model: GotenModel, loss_fn: Callable,
                chunks: Sequence[DenseBatch],
                logs: Optional[dict] = None) -> torch.Tensor:
    """Gradients of the mean loss over ``chunks`` into ``p.grad``.  Chunks
    without a real graph add zero and are left out of the divisor, as in
    the JAX package's ``_accum_grads``.  Returns the mean loss (a tensor
    on the model's device); ``logs``, when given, receives the per-loss
    values of a single chunk.  A force head on a fused path raises before
    any forward (``check_force_training``)."""
    check_force_training(model.cfg, model.head, model.layout, chunks)
    params = [p for p in model.parameters() if p.requires_grad]
    for p in params:
        p.grad = None
    l_sum = n_real = 0.0
    for batch in chunks:
        with profiling.span("step.forward"):
            loss, chunk_logs, _ = loss_fn(batch)
        with profiling.span("step.backward"):
            loss.backward()
        if logs is not None and len(chunks) == 1:
            logs.update(chunk_logs)
        l_sum = l_sum + loss.detach()
        n_real = n_real + batch.graph_mask.any().to(torch.float32)
    n_real = torch.clamp(torch.as_tensor(n_real), min=1.0)
    for p in params:
        p.grad.div_(n_real)
    return l_sum / n_real


@profiling.traced("step")
def train_step(model: GotenModel, optimizer: torch.optim.Optimizer,
               chunks: Sequence[DenseBatch], grad_clip: Optional[float] = 5.0,
               *, loss_fn: Optional[Callable] = None, grad_scale: float = 1.0,
               logs: Optional[dict] = None, axes=None) -> float:
    """One optimizer step over the accumulation ``chunks``: mean gradient,
    times ``grad_scale``, global-norm clip at ``grad_clip`` (None: none),
    then ``optimizer.step()``.  ``loss_fn`` defaults to the base task's L1
    loss on the property.  ``logs``, when given, receives the gradients'
    global norm before the clip (``grad_norm``) and, for a single chunk,
    the per-loss values, as host floats.  ``axes``: mesh axes over whose
    ranks the scaled gradients, the loss and the logs are averaged before
    the clip (the JAX package's ``pmean`` in its sharded step).  Returns
    the mean loss."""
    model.train()
    if loss_fn is None:
        loss_fn = make_loss_fn(model, Task(None))
    loss = accum_grads(model, loss_fn, chunks, logs=logs)
    params = [p for p in model.parameters() if p.grad is not None]
    if grad_scale != 1.0:
        for p in params:
            p.grad.mul_(grad_scale)
    if axes is not None:
        from gotennet_tpu_torch.parallel.collectives import pmean
        from gotennet_tpu_torch.parallel.data_parallel import pmean_grads
        pmean_grads([p for p in model.parameters() if p.requires_grad], axes)
        params = [p for p in model.parameters() if p.grad is not None]
        loss = pmean(torch.as_tensor(loss, dtype=torch.float32,
                                     device=params[0].device), axes)
        if logs is not None:
            for k, v in logs.items():
                logs[k] = pmean(v, axes)
    with profiling.span("step.clip"):
        if grad_clip is not None:
            g_norm = clip_by_global_norm(params, grad_clip)
        elif logs is not None:
            g_norm = torch.sqrt(sum(torch.sum(p.grad.float() ** 2)
                                    for p in params))
    with profiling.span("step.optimizer"):
        optimizer.step()
    with profiling.span("wait", wait=True):
        if logs is not None:
            logs["grad_norm"] = g_norm
            logs.update({k: float(v) for k, v in logs.items()})
        return float(loss)


def train_steps(cfg: GotenNetConfig, head: HeadConfig,
                molecules: Sequence[dict], n_steps: int, *, chunk: int = 16,
                lr: float = 1e-4, seed: int = 0,
                state_dict: Optional[Dict[str, torch.Tensor]] = None,
                device: Optional[str | torch.device] = None,
                bucket: bool = True, layout: str = "dense",
                task: Optional[Task] = None) -> List[float]:
    """Train a model from a seeded init (or ``state_dict``) for
    ``n_steps`` steps on one batch of ``molecules`` (dicts with ``z``,
    ``pos`` and ``y``), cut into ``chunk``-graph accumulation chunks
    (see ``make_chunks``; ``bucket`` applies to the dense layout), with
    AdamW(lr, eps=1e-7, no weight decay) after a global-norm clip at 5.0.
    ``layout`` is "edge", "dense" or "ell".  ``device=None`` means
    ``cuda``.
    Returns the loss of each step.  ``task`` gives the loss (None: the
    base task's L1 loss on the property); a force task's molecules carry
    ``dy``, and a force head on a fused path raises before the first
    step."""
    check_force_training(cfg, head, layout)
    model = GotenModel(cfg, head, layout, seed=seed, device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    chunks = make_chunks(molecules, chunk, next(model.parameters()).device,
                         bucket, layout, cfg.cutoff, cfg.max_num_neighbors)
    check_force_training(cfg, head, layout, chunks)
    optimizer = make_optimizer(model.parameters(), lr)
    loss_fn = make_loss_fn(model, task or Task(None))
    return [train_step(model, optimizer, chunks, optimizer.grad_clip,
                       loss_fn=loss_fn) for _ in range(n_steps)]


@dataclasses.dataclass
class TrainerConfig:
    """The JAX package's ``TrainerConfig``: the same fields and defaults."""

    lr: float = 1e-4
    weight_decay: float = 0.0
    grad_clip: Optional[float] = 5.0
    lr_warmup_steps: int = 0
    scheduler: str = "plateau"          # 'plateau' | 'cosine' | 'none'
    lr_decay: float = 0.8               # plateau factor
    lr_patience: int = 15
    lr_minlr: float = 1e-7
    cosine_t_max: int = 1_000_000
    max_epochs: int = 1000
    early_stopping_patience: int = 150
    # early-stop and plateau monitor
    monitor: str = "val_loss"
    # checkpoint-selection monitor; None means ``monitor``
    monitor_checkpoint: Optional[str] = None
    # loss-value EMA: replaces the logged and monitored loss of the stages
    # in ``ema_stages``; with ``use_ema_in_loss`` the gradients are also
    # scaled by ``ema_rate`` (before clipping) from the second train batch
    ema_rate: float = 0.0               # 0 = off
    ema_stages: Tuple[str, ...] = ("train", "validation")
    use_ema_in_loss: bool = False
    seed: int = 1
    log_every: int = 50
    workdir: str = "runs/default"
    logger: str = "jsonl"
    tensorboard: bool = False
    resume: bool = False                # continue from ckpt_last
    grad_accum_steps: int = 1
    data_parallel: int = 1
    edge_parallel: int = 1
    distributed: bool = False


def _grouped(it: Iterable, n: int):
    """Lists of ``n`` consecutive items; the trailing partial one as is."""
    buf = []
    for b in it:
        buf.append(b)
        if len(buf) == n:
            yield buf
            buf = []
    if buf:
        yield buf


class Trainer:
    """Trainer over ``model`` (a ``GotenModel`` on its device) for
    ``task``, on this process's device: alone, or as one rank of a
    ``data_parallel x edge_parallel`` mesh (the process group must be up).
    ``fit`` trains the model in place; both ``fit`` and ``evaluate`` take a
    state dict to start from (``evaluate``: None keeps the model's weights).
    With ``edge_parallel > 1`` the model takes its collectives over the
    mesh's ``edge`` axis (``models.model.set_edge_axis``)."""

    def __init__(self, model: GotenModel, task, cfg: TrainerConfig):
        from gotennet_tpu_torch.utils.logging import make_logger
        self.model = model
        self.task = task
        self.cfg = cfg
        self.device = next(model.parameters()).device
        self.mesh = None
        self.edge_axis = None
        n_dev = cfg.data_parallel * cfg.edge_parallel
        if n_dev > 1 or cfg.distributed:
            import torch.distributed as dist

            from gotennet_tpu_torch.parallel.mesh import make_mesh
            if not dist.is_initialized():
                raise ValueError(
                    f"data_parallel={cfg.data_parallel}, edge_parallel="
                    f"{cfg.edge_parallel}, distributed={cfg.distributed} "
                    "run one process per device: start the process group "
                    "first (parallel.initialize_distributed, or torchrun)")
            if n_dev != dist.get_world_size():
                raise ValueError(
                    f"data_parallel*edge_parallel ({n_dev}) must equal the "
                    f"number of processes ({dist.get_world_size()})")
            if cfg.edge_parallel > 1 and model.layout not in ("edge", "ell"):
                raise ValueError(
                    "edge_parallel > 1 requires the 'edge' layout (edge "
                    "partitioning) or 'ell' (destination-row sharding)")
            self.mesh = make_mesh((cfg.data_parallel, cfg.edge_parallel),
                                  ("data", "edge"))
            self.edge_axis = "edge" if cfg.edge_parallel > 1 else None
            set_edge_axis(model, self.edge_axis)
        self.loss_fn = make_loss_fn(model, task)
        self.ema: Dict[str, float] = {}
        self.plateau = PlateauState(cfg.lr_decay, cfg.lr_patience,
                                    cfg.lr_minlr)
        os.makedirs(cfg.workdir, exist_ok=True)
        self._logger = make_logger(cfg.workdir, cfg.logger,
                                   tensorboard=cfg.tensorboard)
        self._traced = 0    # the last traced step's record in a log

    # ---- schedules and the loss EMA --------------------------------------
    def lr_scale(self, step: int) -> float:
        w = warmup_scale(step, self.cfg.lr_warmup_steps)
        if self.cfg.scheduler == "plateau":
            return w * self.plateau.scale
        if self.cfg.scheduler == "cosine":
            return w * cosine_scale(step, self.cfg.cosine_t_max)
        return w

    def _update_ema(self, key: str, value: float) -> float:
        """ema <- rate * value + (1 - rate) * ema, replacing the value."""
        rate = self.cfg.ema_rate
        if not (0.0 < rate < 1.0) or math.isnan(value):
            return value
        prev = self.ema.get(key)
        ema = value if prev is None else rate * value + (1 - rate) * prev
        self.ema[key] = ema
        return ema

    def _stage_ema(self, stage: str, value: float) -> float:
        if stage in self.cfg.ema_stages:
            return self._update_ema(f"{stage}_loss", value)
        return value

    def _ema_grad_scale(self) -> float:
        """``use_ema_in_loss``: the backpropagated loss is rate * loss +
        (1 - rate) * the detached EMA, so the gradients scale by the rate
        once an EMA value exists."""
        cfg = self.cfg
        if (cfg.use_ema_in_loss and 0.0 < cfg.ema_rate < 1.0
                and "train" in cfg.ema_stages and "train_loss" in self.ema):
            return cfg.ema_rate
        return 1.0

    # ---- the mesh -----------------------------------------------------------
    def _reduce(self, values, axis="data") -> torch.Tensor:
        """``values`` (float64) summed over the ranks of ``axis``; every
        edge line holds the same values, so the data axis alone sums each
        once."""
        from gotennet_tpu_torch.parallel.collectives import psum
        x = torch.as_tensor(values, dtype=torch.float64, device=self.device)
        return psum(x, axis) if self.mesh is not None else x

    def _local(self, batch):
        """This rank's piece of a batch (the edge layout's edge block under
        edge_parallel), on the device."""
        if self.edge_axis is not None:
            from gotennet_tpu_torch.parallel.data_parallel import \
                shard_graph_batch
            batch = shard_graph_batch(batch, self.mesh, self.edge_axis,
                                      self.model.layout)
        return batch.to(self.device)

    def _train_groups(self, loader: Iterable):
        """The accumulation chunks of each of this rank's optimizer steps:
        ``grad_accum_steps`` consecutive batches; without ``distributed``
        on a mesh, the data index's slot of every full group of
        ``data_parallel`` of them."""
        groups = _grouped(loader, max(1, self.cfg.grad_accum_steps))
        if self.mesh is not None and not self.cfg.distributed:
            dp, slot = self.cfg.data_parallel, self.mesh.index("data")
            groups = (g[slot] for g in _grouped(groups, dp) if len(g) == dp)
        for chunks in groups:
            yield [self._local(b) for b in chunks]

    def _all_have(self, have: bool) -> bool:
        """Whether every rank has a step to take (a rank of a distributed
        run whose shard ran out stops the others)."""
        if self.mesh is None or not self.cfg.distributed:
            return have
        from gotennet_tpu_torch.parallel.collectives import psum
        flag = torch.tensor([0.0 if have else 1.0], device=self.device)
        with profiling.span("wait", wait=True):
            return float(psum(flag, ("data", "edge"))) == 0.0

    def _generator_states(self, generator) -> Dict[str, Any]:
        """The dropout generator's state for ``train_state``: this rank's,
        and on a mesh every rank's (``generators``, by rank)."""
        state = generator.get_state()
        out = {"generator": state.tolist()}
        if self.mesh is not None and self.mesh.size(("data", "edge")) > 1:
            from gotennet_tpu_torch.parallel.collectives import psum
            rows = torch.zeros(self.mesh.size(("data", "edge")),
                               state.numel(), dtype=torch.int64,
                               device=self.device)
            rows[self.mesh.rank] = state.to(self.device, torch.int64)
            out["generators"] = psum(rows, ("data", "edge")).tolist()
        return out

    # ---- one optimizer step ----------------------------------------------
    def _train_step(self, optimizer, chunks, lr_scale: float,
                    ema_scale: float) -> Dict[str, float]:
        cfg = self.cfg
        set_lr(optimizer, cfg.lr * lr_scale)
        logs: Dict[str, Any] = {}
        loss = train_step(self.model, optimizer, chunks, cfg.grad_clip,
                          loss_fn=self.loss_fn, grad_scale=ema_scale,
                          logs=logs,
                          axes=self.mesh.axis_names if self.mesh else None)
        grad_norm = logs.pop("grad_norm")
        if cfg.grad_accum_steps > 1:
            logs = {}   # the per-loss values are logged without accumulation
        return {**logs, "loss": loss, "grad_norm": grad_norm}

    # ---- loops ------------------------------------------------------------
    def fit(self, state_dict: Dict[str, torch.Tensor], train_loader: Iterable,
            val_loader: Iterable, max_steps: Optional[int] = None
            ) -> Tuple[Dict[str, torch.Tensor], List[Dict[str, float]]]:
        """Train from ``state_dict`` (or, with ``resume``, from the
        workdir's ``ckpt_last`` and its full training state).  Returns the
        final state dict and one validation record per epoch."""
        from gotennet_tpu_torch.data.prefetch import prefetch
        from gotennet_tpu_torch.train.checkpoint import (load_checkpoint,
                                                         load_train_state)
        cfg, model = self.cfg, self.model
        # a force loss on the dense fused path raises before anything runs
        # (an ELL batch's path is checked as its step starts)
        check_force_training(model.cfg, model.head, model.layout)
        if (self.edge_axis is not None and model.layout == "edge"
                and model.cfg.aggr == "max"):
            raise ValueError(
                "aggr='max' under edge_parallel cannot train: the maximum "
                "over the edge axis has no gradient (nor has JAX's pmax); "
                "use aggr='add' or 'mean', or edge_parallel=1")
        model.load_state_dict(state_dict)
        optimizer = make_optimizer(model.parameters(), cfg.lr,
                                   cfg.weight_decay, cfg.grad_clip)
        generator = model.dropout_generator
        # each rank draws its own dropout masks, from (seed, rank)
        rank = self.mesh.rank if self.mesh is not None else 0
        generator.manual_seed(cfg.seed if rank == 0 else int(
            np.random.SeedSequence([cfg.seed, rank]).generate_state(1)[0]))
        step = start_epoch = bad_epochs = 0
        monitor_ckpt = cfg.monitor_checkpoint or cfg.monitor
        best_stop = best_ckpt = math.inf
        last = os.path.join(cfg.workdir, "ckpt_last")
        if cfg.resume and os.path.isdir(last):
            # full state: weights, AdamW moments, schedules, EMA, epoch,
            # best values and the dropout generator
            _, saved, step = load_checkpoint(last, self.device)
            model.load_state_dict(saved)
            ts = load_train_state(last, optimizer)
            if ts:
                start_epoch = int(ts.get("epoch", -1)) + 1
                best_stop = float(ts.get("best_stop", math.inf))
                best_ckpt = float(ts.get("best_ckpt", math.inf))
                bad_epochs = int(ts.get("bad_epochs", 0))
                self.ema = dict(ts.get("ema") or {})
                if ts.get("plateau"):
                    self.plateau = dataclasses.replace(self.plateau,
                                                       **ts["plateau"])
                saved_gen = ts.get("generator")
                if len(ts.get("generators") or ()) > rank:
                    saved_gen = ts["generators"][rank]
                if saved_gen is not None:
                    generator.set_state(torch.tensor(saved_gen,
                                                     dtype=torch.uint8))
        history = []
        for epoch in range(start_epoch, cfg.max_epochs):
            # the shuffle is a function of (seed, epoch): a resumed run
            # repeats the uninterrupted run's batch order
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            t0 = time.perf_counter()
            model.train()
            train_losses = []
            steps = iter(prefetch(self._train_groups(train_loader)))
            while True:
                chunks = next(steps, None)
                if not self._all_have(chunks is not None):
                    break
                logs = self._train_step(optimizer, chunks,
                                        self.lr_scale(step),
                                        self._ema_grad_scale())
                step += 1
                loss = self._stage_ema("train", logs["loss"])
                if step % cfg.log_every == 0:
                    self._log({"phase": "train", "step": step, **logs,
                               "loss": loss, **self._trace_means()})
                train_losses.append(loss)
                if max_steps is not None and step >= max_steps:
                    break

            val = self.evaluate(None, val_loader, phase="validation")
            val["train_loss"] = (float(np.mean(train_losses))
                                 if train_losses else math.nan)
            val["epoch"] = epoch
            val["step"] = step
            val["lr_scale"] = self.lr_scale(step)
            val["epoch_time_s"] = time.perf_counter() - t0
            history.append(val)
            self._log({"phase": "val_epoch", **val})

            for key in {cfg.monitor, monitor_ckpt}:
                if key not in val:
                    raise KeyError(
                        f"monitor {key!r} not among validation metrics "
                        f"{sorted(val)}")
            monitored = val[cfg.monitor]
            if cfg.scheduler == "plateau":
                self.plateau = plateau_update(self.plateau, monitored,
                                              cfg.lr)
            improved_ckpt = val[monitor_ckpt] < best_ckpt
            if improved_ckpt:
                best_ckpt = val[monitor_ckpt]
            if monitored < best_stop:
                best_stop = monitored
                bad_epochs = 0
            else:
                bad_epochs += 1
            train_state = {
                "epoch": epoch, "best_stop": best_stop,
                "best_ckpt": best_ckpt, "bad_epochs": bad_epochs,
                "ema": dict(self.ema),
                "plateau": {"best": self.plateau.best,
                            "num_bad": self.plateau.num_bad,
                            "scale": self.plateau.scale},
                **self._generator_states(generator),
            }
            if improved_ckpt:
                self.save_checkpoint(optimizer, step, "best", train_state)
            self.save_checkpoint(optimizer, step, "last", train_state)
            if bad_epochs > cfg.early_stopping_patience:
                break
            if max_steps is not None and step >= max_steps:
                break
        return {k: v.detach().clone() for k, v in
                model.state_dict().items()}, history

    @profiling.traced("evaluate")
    @torch.no_grad()
    def evaluate(self, state_dict: Optional[Dict[str, torch.Tensor]],
                 loader: Iterable, phase: str = "test") -> Dict[str, float]:
        """``val_loss`` (the mean of the per-batch losses, each through the
        stage's EMA) and each of the task's metrics over ``loader``.  On a
        mesh every rank returns the same values: the whole loader's
        without ``distributed`` (each rank evaluates its slot of every group
        of ``data_parallel`` batches), the sum over the ranks' shards with
        it (the EMA then applies once, to the epoch's loss)."""
        from gotennet_tpu_torch.data.prefetch import prefetch
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.model.eval()
        metrics = self.task.get_metrics()
        accs = {m["name"]: MetricAccumulator() for m in metrics}
        grouped = self.mesh is not None and not self.cfg.distributed
        dp = self.cfg.data_parallel if grouped else 1
        slot = self.mesh.index("data") if grouped else 0

        def batches():
            # a trailing partial group repeats a real batch, whose results
            # are not counted
            for group in _grouped(loader, dp):
                yield len(group), self._local((group + [group[0]] * dp)[slot])

        n_real, losses = [], []
        for n, batch in prefetch(batches()):
            n_real.append(n)
            loss, _, out = self.loss_fn(batch)
            with profiling.span("wait", wait=True):
                losses.append(float(loss))
            if slot >= n:
                continue
            targets = self.task.get_targets(batch)
            for m in metrics:
                tgt, mask = targets[m["target"]]
                pred = out[m["prediction"]].reshape(tgt.shape)
                with profiling.span("wait", wait=True):
                    pred, tgt, mask = (pred.float().cpu().numpy(),
                                       tgt.float().cpu().numpy(),
                                       mask.float().cpu().numpy())
                accs[m["name"]].update(pred, tgt, mask)

        def kind_of(m):
            return m.get("kind") or ("mae" if "Absolute" in m["name"]
                                     else "mse")

        sums = [[accs[m["name"]].abs_sum, accs[m["name"]].sq_sum,
                 accs[m["name"]].count] for m in metrics]
        if self.mesh is not None:
            sums = self._reduce(sums).tolist()
        if self.cfg.distributed:
            tot = self._reduce([sum(losses), len(losses)]).tolist()
            val = tot[0] / max(tot[1], 1.0)
            out = {"val_loss": self._stage_ema(phase, val)}
        else:
            if grouped:
                table = torch.zeros(len(losses), dp, dtype=torch.float64)
                table[:, slot] = torch.tensor(losses, dtype=torch.float64)
                table = self._reduce(table).cpu()
                losses = [float(table[g, i]) for g, n in enumerate(n_real)
                          for i in range(n)]
            losses = [self._stage_ema(phase, v) for v in losses]
            out = {"val_loss": float(np.mean(losses)) if losses else math.nan}
        for m, (a_sum, s_sum, cnt) in zip(metrics, sums):
            out[m["name"]] = ((a_sum if kind_of(m) == "mae" else s_sum)
                              / max(cnt, 1.0))
        return out

    # ---- persistence -------------------------------------------------------
    def save_checkpoint(self, optimizer, step: int, tag: str,
                        train_state: Optional[Dict] = None) -> None:
        from gotennet_tpu_torch.train.checkpoint import save_checkpoint
        from gotennet_tpu_torch.utils.logging import is_main_process
        # every rank holds the same parameters: rank 0 writes them, and the
        # others wait until it has
        if is_main_process():
            extra = {"task": getattr(self.task, "name", None),
                     "label": getattr(self.task, "label_name",
                                      getattr(self.task, "label", None))}
            save_checkpoint(os.path.join(self.cfg.workdir, f"ckpt_{tag}"),
                            self.model, step=step, extra_meta=extra,
                            optimizer=optimizer, train_state=train_state)
        if self.mesh is not None:
            self._reduce([0.0], ("data", "edge"))

    def _log(self, record: Dict[str, Any]) -> None:
        self._logger.log(record)

    def _trace_means(self) -> Dict[str, float]:
        """With the tracer on, the means over the training steps traced
        since the last call (``profiling.summary``); else nothing."""
        if not profiling.active():
            return {}
        new = [r for r in profiling.records()
               if r["seq"] > self._traced and r["kind"] == "step"]
        if not new:
            return {}
        self._traced = new[-1]["seq"]
        return profiling.summary(new)
