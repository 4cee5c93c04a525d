"""One rank of a multi-process run of the port, for the parallel tests.

    python tests/torch_port_ranks.py <scenario> <dir> <rank> <world>

Joins a Gloo process group of ``world`` ranks through ``file://<dir>/rdv``
(no port), on one torch thread, reads ``<dir>/inputs.pt`` (written by the
test), runs ``<scenario>`` and writes what it gives to
``<dir>/out_<rank>.pt``.  The test compares that with the JAX package;
this file imports only torch, numpy and the port.  ``spawn_ranks`` starts
the ranks and waits for all of them, with a time limit (``Ranks`` starts
them and lets the caller work while they run).
"""

from __future__ import annotations

import datetime
import os
import pathlib
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


class Ranks:
    """``world`` ranks running ``scenario``, started at once; ``wait()``
    gives each rank's output, in rank order.  Every rank is killed at
    ``timeout`` seconds from the start, and a rank that fails, or runs out
    of time, fails ``wait()`` with every rank's output."""

    def __init__(self, scenario: str, workdir, world: int, inputs: dict,
                 timeout: float = 120.0):
        self.workdir = pathlib.Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        torch.save(inputs, self.workdir / "inputs.pt")
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        self.deadline = time.monotonic() + timeout
        self.procs = [subprocess.Popen(
            [sys.executable, __file__, scenario, str(self.workdir), str(r),
             str(world)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]

    def wait(self) -> list:
        logs, failed = [], False
        for p in self.procs:
            try:
                out, _ = p.communicate(
                    timeout=max(1.0, self.deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                for q in self.procs:
                    q.kill()
                out, _ = p.communicate()
                out += "\n(killed at the time limit)"
                failed = True
            failed |= p.returncode != 0
            logs.append(out)
        if failed:
            raise AssertionError("\n".join(
                f"---- rank {r} (exit {p.returncode}):\n{log[-3000:]}"
                for r, (p, log) in enumerate(zip(self.procs, logs))))
        return [torch.load(self.workdir / f"out_{r}.pt", weights_only=False)
                for r in range(len(self.procs))]


def spawn_ranks(scenario: str, workdir, world: int, inputs: dict,
                timeout: float = 120.0) -> list:
    """Run ``scenario`` on ``world`` ranks and wait for them (``Ranks``)."""
    return Ranks(scenario, workdir, world, inputs, timeout).wait()


# ---- the scenarios ------------------------------------------------------------
def _model(inp, edge_axis=None):
    from gotennet_tpu_torch.models.gotennet import GotenNetConfig
    from gotennet_tpu_torch.models.model import GotenModel, HeadConfig
    cfg = GotenNetConfig(**inp["cfg"], edge_axis=edge_axis)
    model = GotenModel(cfg, HeadConfig(**inp.get("head", {})), inp["layout"],
                       device="cpu")
    if inp.get("state_dict") is not None:
        model.load_state_dict(inp["state_dict"])
    return model


def collectives(inp, rank, world):
    """The mesh's grid and groups, and psum / pmean / pmax with psum's
    backward."""
    from gotennet_tpu_torch.parallel import make_mesh, pmax, pmean, psum
    out = {}
    mesh = make_mesh((-1, 2))
    out["shape"] = mesh.shape
    mesh = make_mesh((2, 2))
    out["devices"] = mesh.devices.tolist()
    out["coords"] = (mesh.index("data"), mesh.index("edge"))
    x = torch.tensor([float(rank), 1.0], requires_grad=True)
    for axis in ("data", "edge", ("data", "edge")):
        key = axis if isinstance(axis, str) else "both"
        y = psum(x * (rank + 1), axis)
        (g,) = torch.autograd.grad(y.sum(), x)
        out[f"psum_{key}"] = y.detach()
        out[f"grad_{key}"] = g
        out[f"pmean_{key}"] = pmean(x.detach(), axis)
        out[f"pmax_{key}"] = pmax(x.detach() * (1 - 2 * (rank % 2)), axis)
    try:
        pmax(x * 2.0, "edge")
    except ValueError as e:
        out["pmax_grad_error"] = str(e)
    return out


def forward(inp, rank, world):
    """The model on ``inp['batch']`` over a ``(1, world)`` mesh whose edge
    axis splits the graph (``inp['serial']``: on one device), with forces
    for a force head; or its output without an axis."""
    from gotennet_tpu_torch.models.model import apply_with_forces
    from gotennet_tpu_torch.parallel import make_mesh, shard_graph_batch
    mesh = make_mesh((1, world))
    model = _model(inp, "edge")
    batch = shard_graph_batch(inp["batch"], mesh, "edge", inp["layout"])
    out = apply_with_forces(model, batch)
    h, X = model.representation(batch)
    return {"property": out["property"].detach(), "h": h.detach(),
            "X": X.detach(),
            "forces": (out["forces"].detach() if "forces" in out else None)}


def step(inp, rank, world):
    """One ``make_parallel_train_step`` step on a ``inp['mesh']`` mesh:
    the data index's batch of ``inp['batches']``."""
    from gotennet_tpu_torch.parallel import (make_mesh,
                                             make_parallel_train_step,
                                             shard_graph_batch)
    from gotennet_tpu_torch.tasks.qm9 import QM9Task
    from gotennet_tpu_torch.train.optim import make_optimizer
    from gotennet_tpu_torch.train.trainer import make_loss_fn
    mesh = make_mesh(inp["mesh"])
    edge_axis = "edge" if mesh.size("edge") > 1 else None
    model = _model(inp, edge_axis)
    task = QM9Task("U0", dataset_meta={"mean": 0.0, "std": 1.0})
    opt = make_optimizer(model.parameters(), inp["lr"], 0.0, None)
    run = make_parallel_train_step(model, opt, make_loss_fn(model, task),
                                   mesh, grad_clip=None)
    batch = inp["batches"][mesh.index("data")]
    loss = run([shard_graph_batch(batch, mesh, edge_axis, inp["layout"])])
    return {"loss": loss, "state": {k: v.detach().clone() for k, v in
                                    model.state_dict().items()}}


def _loader(inp, split):
    from gotennet_tpu_torch.data import dataset
    ds = dataset.MoleculeDataset(z=inp["z"], pos=inp["pos"],
                                 y=np.asarray(inp["y"], np.float32))
    ds = ds.subset(inp[split])
    kw = dict(inp.get("loader", {}))
    if split == "train_idx":
        kw.update(inp.get("train_loader", {}))
    kind = {"edge": "BatchLoader", "dense": "DenseLoader",
            "ell": "ELLLoader"}[inp["layout"]]
    return getattr(dataset, kind)(ds, inp["batch_size"], **kw)


def trainer(inp, rank, world):
    """For each of ``inp['runs']`` (overrides of ``inp``), one after the
    other: ``Trainer.fit`` (or only ``evaluate`` with ``eval_only``) on
    ``world`` ranks with ``trainer``; with ``shard`` each loader is
    ``set_shard`` by the rank's data index, as the command line does under
    ``distributed``.  A ``ValueError`` from ``fit`` is given back as
    ``error``."""
    from gotennet_tpu_torch.tasks.qm9 import QM9Task
    from gotennet_tpu_torch.train.trainer import Trainer, TrainerConfig
    outs = []
    for n, run in enumerate(inp["runs"]):
        run = {**inp, **run}
        model = _model(run)
        task = QM9Task("U0", dataset_meta=run["meta"])
        tcfg = TrainerConfig(**run["trainer"],
                             workdir=os.path.join(run["workdir"], str(n)))
        tr = Trainer(model, task, tcfg)
        train, val = _loader(run, "train_idx"), _loader(run, "val_idx")
        if run.get("shard"):
            d = rank // tcfg.edge_parallel
            train.set_shard(tcfg.data_parallel, d)
            val.set_shard(tcfg.data_parallel, d, pad=True)
        if run.get("eval_only"):
            outs.append({"metrics": tr.evaluate(None, val)})
            continue
        try:
            state, history = tr.fit(model.state_dict(), train, val)
        except ValueError as e:
            outs.append({"error": str(e)})
            continue
        outs.append({"state": state, "history": history,
                     "files": sorted(os.listdir(tcfg.workdir))})
    return outs


SCENARIOS = {f.__name__: f for f in (collectives, forward, step, trainer)}


def main(argv) -> int:
    scenario, workdir, rank, world = argv[0], argv[1], int(argv[2]), \
        int(argv[3])
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'rdv')}",
        world_size=world, rank=rank, timeout=datetime.timedelta(seconds=90))
    try:
        inp = torch.load(os.path.join(workdir, "inputs.pt"),
                         weights_only=False)
        out = SCENARIOS[scenario](inp, rank, world)
        torch.save(out, os.path.join(workdir, f"out_{rank}.pt"))
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
