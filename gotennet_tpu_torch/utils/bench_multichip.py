"""Weak-scaling measurement of the sharded trainer modes
(``gotennet_tpu/utils/bench_multichip.py``), one process per device.

  dense_dp   dense layout, data parallelism over every rank
  edge_ep    edge layout, a data x edge mesh (edge-partitioned graphs)
  ell_rows   ELL layout, destination rows sharded over the edge axis

Every rank of an initialised process group calls ``multichip_bench``; the
world size is the group's (1 without a group).  For each mode it times the
``Trainer``'s optimizer step on the world's mesh and then, on each rank
alone with no collective, the same per-device workload on one device, and
reports per-device real edges/s and the efficiency
``per_device(n) / per_device(1)``.  Rank 0 returns the records (the JAX
package's fields), the other ranks an empty list.  With one card there is
one rank, so its records are world-size-1 records.
"""

from __future__ import annotations

import tempfile
import time
from typing import Dict, List, Optional, Sequence

import torch

__all__ = ["multichip_bench", "MODES"]

MODES = ("dense_dp", "edge_ep", "ell_rows")
_LAYOUT = {"dense_dp": "dense", "edge_ep": "edge", "ell_rows": "ell"}


def _count_real_edges(ds, n_graphs: int, cutoff: float) -> int:
    """Real edges (cutoff, self-loops included) of the first ``n_graphs``
    molecules, as the edge list counts them."""
    from gotennet_tpu_torch.data.dataset import BatchLoader

    sub = ds.subset(range(n_graphs))
    eb = next(iter(BatchLoader(sub, batch_size=n_graphs, cutoff=cutoff)))
    return int(eb.edge_mask.sum())


def _make_loader(mode: str, ds, cfg, batch_size: int):
    from gotennet_tpu_torch.data.dataset import (BatchLoader, DenseLoader,
                                                 ELLLoader)

    if mode == "dense_dp":
        return DenseLoader(ds, batch_size=batch_size)
    if mode == "ell_rows":
        return ELLLoader(ds, batch_size=batch_size, cutoff=cfg.cutoff)
    return BatchLoader(ds, batch_size=batch_size, cutoff=cfg.cutoff)


def _time_mode(mode: str, cfg, ds, device, *, batch_size: int,
               data_parallel: int, edge_parallel: int, steps: int,
               lr: float = 1e-4) -> float:
    """Seconds per optimizer step at one (mode, mesh) point."""
    from gotennet_tpu_torch.models.model import GotenModel
    from gotennet_tpu_torch.tasks.qm9 import QM9Task
    from gotennet_tpu_torch.train.optim import make_optimizer
    from gotennet_tpu_torch.train.trainer import Trainer, TrainerConfig

    task = QM9Task("U0", dataset_meta={"mean": 0.0, "std": 1.0})
    model = GotenModel(cfg, task.build_head(), _LAYOUT[mode], device=device)
    model.train()
    loader = _make_loader(mode, ds, cfg, batch_size)
    with tempfile.TemporaryDirectory() as wd:
        trainer = Trainer(model, task, TrainerConfig(
            lr=lr, workdir=wd, data_parallel=data_parallel,
            edge_parallel=edge_parallel))
        chunks = next(iter(trainer._train_groups(loader)))
        optimizer = make_optimizer(model.parameters(), lr)
        sync = (torch.cuda.synchronize if trainer.device.type == "cuda"
                else lambda: None)
        # one warm-up step (the kernels' first launches), then ``steps``
        # steps on the same chunks
        trainer._train_step(optimizer, chunks, 1.0, 1.0)
        sync()
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer._train_step(optimizer, chunks, 1.0, 1.0)
        sync()
        return (time.perf_counter() - t0) / steps


def multichip_bench(*, cfg=None, steps: int = 5, batch_size: int = 8,
                    n_mol_min: int = 12, n_mol_max: int = 29,
                    modes: Sequence[str] = MODES, seed: int = 0,
                    device: Optional[str | torch.device] = None
                    ) -> List[Dict]:
    """Per-device edges/s and weak-scaling efficiency for each mode.

    Returns, on rank 0, one record per mode: ``{mode, n_devices, mesh,
    step_ms, per_chip_edges_per_s, per_chip_edges_per_s_1dev,
    efficiency}``; ``device`` None means ``cuda``."""
    import torch.distributed as dist

    from gotennet_tpu_torch.data.dataset import synthetic_molecules
    from gotennet_tpu_torch.models.gotennet import GotenNetConfig

    grouped = dist.is_available() and dist.is_initialized()
    n_devices = dist.get_world_size() if grouped else 1
    rank = dist.get_rank() if grouped else 0
    if cfg is None:
        cfg = GotenNetConfig(n_atom_basis=64, n_interactions=2, lmax=2,
                             n_rbf=16, num_heads=4, attn_dropout=0.0)
    # weak scaling: every device takes ``batch_size`` graphs a step in both
    # the n-device and the one-device run
    ds = synthetic_molecules(batch_size * n_devices, seed=seed,
                             min_atoms=n_mol_min, max_atoms=n_mol_max)
    records = []
    for mode in modes:
        if mode == "dense_dp":
            dp_n, ep_n = n_devices, 1
        else:
            # edge and row sharding ride the inner mesh axis
            ep_n = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
            dp_n = n_devices // ep_n
            if ep_n == 1 and n_devices > 1:
                continue  # an odd world size: no edge axis to measure
        dt_n = _time_mode(mode, cfg, ds, device, batch_size=batch_size,
                          data_parallel=dp_n, edge_parallel=ep_n,
                          steps=steps)
        dt_1 = _time_mode(mode, cfg, ds, device, batch_size=batch_size,
                          data_parallel=1, edge_parallel=1, steps=steps)
        # the n-device step takes the first n * batch_size molecules (the
        # loaders keep dataset order), the one-device step the first
        # batch_size
        edges_n = _count_real_edges(ds, batch_size * n_devices, cfg.cutoff)
        edges_1 = _count_real_edges(ds, batch_size, cfg.cutoff)
        per_chip_n = edges_n / dt_n / n_devices
        per_chip_1 = edges_1 / dt_1
        records.append({
            "mode": mode,
            "n_devices": n_devices,
            "mesh": {"data": dp_n, "edge": ep_n},
            "step_ms": round(dt_n * 1e3, 3),
            "per_chip_edges_per_s": round(per_chip_n, 1),
            "per_chip_edges_per_s_1dev": round(per_chip_1, 1),
            "efficiency": round(per_chip_n / per_chip_1, 4),
        })
    return records if rank == 0 else []
