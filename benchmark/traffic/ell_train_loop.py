"""Training traffic on the ELL layout: one ``train_step`` over ``accum``
consecutive batches of the program's ``ELLLoader`` (shuffled, reshuffled
each epoch by ``set_epoch``, its frames spatially sorted into
``block_rows``-row gather windows, as the configuration's train path
says), fed through ``data.prefetch.prefetch``: the accumulation chunks of
one optimizer step, as the program's ``Trainer`` groups them under
``grad_accum_steps``.

The dense mode's loop (``train_loop.py``) with the ELL batch in its place:
its compared steps, window, reference and controls are reused as they
are.  What differs:
- each attention keep mask the model draws is ``[N, K, H]`` a layer and
  chunk; the reference takes ``[G, M, M, H]`` over each chunk's frames, so
  every real slot is mapped to its pair: the row to (frame, atom) by the
  batch's ``node_graph`` and ``atom`` (the spatial sort permutes rows), the
  slot to the source's atom through ``nbr``.  The self-loop slot is the
  pair (i, i), which the reference's softmax holds too; entries of no real
  slot are kept (the reference masks those pairs out itself);
- the chunk's reference ``M`` is its largest frame rounded up to 8;
- ``padded`` counts the table's ``N K`` slots;
- warm-up is ``warmup_steps`` steps: a loader has one ``(N, K)``, and the
  window raises if it runs a table shape that set-up did not;
- the fault ``half_batch`` leaves the second half of each chunk's frames
  out of the loss and the graph (their graph, rows, slots and types)."""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from harness import port
from harness.registry import load_module

Dense = load_module(Path(__file__).resolve().with_name("train_loop.py")).Loop


def pair_keeps(batch, keeps, n_frames: int, M: int) -> list:
    """The reference's ``[G, M, M, H]`` keep masks of one chunk from the
    program's ``[N, K, H]`` ones (``keeps``, one a layer), through the
    host copy of the chunk's ``ELLBatch``."""
    nbr = batch.nbr.numpy()
    rows, slots = np.nonzero(batch.nbr_mask.numpy())
    g = torch.from_numpy(batch.node_graph.numpy()[rows]).long()
    atom = batch.atom.numpy()
    i = torch.from_numpy(atom[rows]).long()
    j = torch.from_numpy(atom[nbr[rows, slots]]).long()
    rows, slots = torch.from_numpy(rows), torch.from_numpy(slots)
    out = []
    for k in keeps:
        dense = torch.ones((n_frames, M, M, k.shape[-1]), dtype=torch.bool)
        dense[g, i, j] = k.cpu()[rows, slots]
        out.append(dense)
    return out


class Loop(Dense):

    def setup(self) -> None:
        from gotennet_tpu_torch.data.dataset import ELLLoader
        from gotennet_tpu_torch.models.model import GotenModel
        from gotennet_tpu_torch.train.optim import make_optimizer
        from gotennet_tpu_torch.train.trainer import make_loss_fn
        ctx, t, cfg = self.ctx, self.t, self.ctx.config
        p = cfg["paths"]["train"]
        if p["layout"] != "ell" or cfg["task"]["kind"] == "force":
            raise ValueError("ell_train_loop trains energies on the ELL "
                             "layout's ELLLoader batches")
        self.make_pool()
        self.model = GotenModel(port.model_config(cfg, "train"),
                                port.head_config(cfg, self.mean, self.std),
                                "ell", device=self.dev)
        self.model.load_state_dict(self.weights)
        o = cfg["optimizer"]
        self.opt = make_optimizer(self.model.parameters(), o["lr"],
                                  o["weight_decay"], o["grad_clip"], o["eps"])
        self.loss_fn = make_loss_fn(self.model, port.task(cfg))
        self.stage("model")
        self.loader = ELLLoader(
            port.dataset(self.pool, False), t["batch_size"],
            cutoff=self.m["cutoff"],
            max_num_neighbors=self.m["max_num_neighbors"],
            spatial_sort=p["spatial_sort"], block_rows=p["block_rows"],
            shuffle=True, seed=ctx.seed, neighbor_probe=p["neighbor_probe"])
        self.feed = self._feed()
        self.seen = set()
        self.stage("loader")
        self._hosts = []
        self._compared()
        for st in self.compared_steps:
            for ch in st:
                host = self._hosts.pop(0)
                if ch["keeps"] is not None:
                    ch["keeps"] = pair_keeps(host, ch["keeps"],
                                             len(ch["idx"]), ch["M"])
        self._hosts = None
        self.stage("compared")
        for _ in range(t["warmup_steps"]):
            self.iterate()
        ctx.sync()
        self.warm = set(self.seen)
        self.stage("warmup")

    def _next(self):
        with self.spans.span("loader_wait"):
            idx, batch = next(self.feed)
            if self.ctx.fault == "half_batch":
                cut = (len(idx) + 1) // 2
                gone = batch.node_graph >= cut
                batch.graph_mask[cut:] = False
                for field in (batch.node_mask, batch.nbr_mask):
                    field[gone] = False
                batch.z[gone] = 0
            if self._hosts is not None:
                self._hosts.append(batch)
            on_device = batch.to(self.dev)
        return idx, on_device

    def iterate(self):
        from gotennet_tpu_torch.train.trainer import train_step
        chunks, self._last_chunks = [], []
        for _ in range(self.t["accum"]):
            idx, batch = self._next()
            N, K = batch.nbr.shape
            self.seen.add((N, K))
            self.padded += N * K
            chunks.append(batch)
            M = -(-int(self.atoms[idx].max()) // 8) * 8
            self._last_chunks.append((np.asarray(idx), M))
        with self.spans.span("train_step"):
            self.last_loss = train_step(self.model, self.opt, chunks,
                                        self.opt.grad_clip,
                                        loss_fn=self.loss_fn)
        if not math.isfinite(self.last_loss):
            self.nonfinite += 1
        return np.concatenate([c[0] for c in self._last_chunks])

    def measure(self) -> dict:
        out = super().measure()
        new = self.seen - self.warm
        if new:
            raise RuntimeError(f"the window ran table shapes {sorted(new)} "
                               f"that set-up did not ({sorted(self.warm)})")
        return out
