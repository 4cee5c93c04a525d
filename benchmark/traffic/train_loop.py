"""Training traffic: one ``train_step`` over ``accum`` consecutive
batches of the program's ``DenseLoader`` (shuffled, reshuffled each epoch
by ``set_epoch``), fed through ``data.prefetch.prefetch``: the
accumulation chunks of one optimizer step, as the program's ``Trainer``
groups them under ``grad_accum_steps``.

Set-up builds one model and optimizer from the benchmark's weights and
drives them through the first ``compared_steps`` steps of the same feed
and call as the window, keeping what the reference needs (the batches'
molecules, the attention keep masks, the losses, the first gradient as
AdamW holds it after one step, the leaves after the steps); then warm-up
steps until every batch shape of the traffic has run twice.  The window
and the traced stretch go on with the same object."""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from harness import port
from harness.compare import train_numbers
from harness.loop import BaseLoop
from reference import train as ref_train


class Loop(BaseLoop):

    def __init__(self, ctx):
        super().__init__(ctx)
        self.work = ("force_train" if ctx.config["task"]["kind"] == "force"
                     else "train")

    def setup(self) -> None:
        from gotennet_tpu_torch.data.dataset import DenseLoader
        from gotennet_tpu_torch.models.model import GotenModel
        from gotennet_tpu_torch.train.optim import make_optimizer
        from gotennet_tpu_torch.train.trainer import make_loss_fn
        ctx, t, cfg = self.ctx, self.t, self.ctx.config
        self.make_pool()
        forces = cfg["task"]["kind"] == "force"
        if cfg["paths"]["train"]["layout"] != "dense":
            raise ValueError("train_loop feeds the dense layout's "
                             "DenseLoader batches")
        self.model = GotenModel(port.model_config(cfg, "train"),
                                port.head_config(cfg, self.mean, self.std),
                                "dense", device=self.dev)
        self.model.load_state_dict(self.weights)
        o = cfg["optimizer"]
        self.opt = make_optimizer(self.model.parameters(), o["lr"],
                                  o["weight_decay"], o["grad_clip"], o["eps"])
        self.loss_fn = make_loss_fn(self.model, port.task(cfg))
        self.loader = DenseLoader(
            port.dataset(self.pool, forces), batch_size=t["batch_size"],
            shuffle=True, seed=ctx.seed, bucket=t["bucket"],
            bucket_window=t["bucket_window"])
        self.feed = self._feed()
        self.seen = {}
        self.stage("model")
        self._compared()
        self.stage("compared")
        warm = set(t["batch_atoms"])
        for _ in range(t["max_warmup_steps"]):
            if all(self.seen.get(M, 0) >= 2 for M in warm):
                break
            self.iterate()
        else:
            raise RuntimeError(f"warm-up saw shapes {self.seen}, not every "
                               f"one of {sorted(warm)} twice")
        ctx.sync()
        self.stage("warmup")

    def _feed(self):
        from gotennet_tpu_torch.data.prefetch import prefetch
        for epoch in itertools.count():
            self.loader.set_epoch(epoch)
            # lists, not tuples: prefetch takes a 2-tuple whose first item
            # compares equal to "__error__" for its error marker, and an
            # index array cannot be compared so
            yield from prefetch((list(x) for x in self.loader.batches()),
                                self.t["prefetch"])

    def _next(self):
        with self.spans.span("loader_wait"):
            idx, batch = next(self.feed)
            if self.ctx.fault == "half_batch":
                cut = (len(idx) + 1) // 2
                for name in ("mask", "graph_mask"):
                    getattr(batch, name)[cut:] = False
                batch.z[cut:] = 0
            batch = batch.to(self.dev)
        return idx, batch

    def iterate(self):
        from gotennet_tpu_torch.train.trainer import train_step
        chunks, self._last_chunks = [], []
        for _ in range(self.t["accum"]):
            idx, batch = self._next()
            M = batch.max_atoms
            self.seen[M] = self.seen.get(M, 0) + 1
            self.padded += batch.num_graphs * M * M
            chunks.append(batch)
            self._last_chunks.append((np.asarray(idx), M))
        with self.spans.span("train_step"):
            self.last_loss = train_step(self.model, self.opt, chunks,
                                        self.opt.grad_clip,
                                        loss_fn=self.loss_fn)
        if not math.isfinite(self.last_loss):
            self.nonfinite += 1
        return np.concatenate([c[0] for c in self._last_chunks])

    def _compared(self) -> None:
        """The first steps, with the keep masks drawn by the benchmark."""
        from gotennet_tpu_torch.models import gotennet
        n = self.t["compared_steps"]
        gen = torch.Generator(device=self.dev)
        gen.manual_seed((self.ctx.seed * 7919 + 17) % (2 ** 63))
        masks = []

        def keep_mask(shape, rate, generator, device):
            keep = torch.rand(tuple(shape), generator=gen,
                              device=device) < 1.0 - rate
            masks.append(keep)
            return keep

        names = {p: k for k, p in self.model.named_parameters()}
        beta1 = self.opt.defaults["betas"][0]
        saved = gotennet.attention_keep_mask
        gotennet.attention_keep_mask = keep_mask
        step = self.opt.step
        if self.ctx.fault == "unchanged":
            self.opt.step = lambda *a, **k: None
        self.nonfinite = 0
        self.padded = 0
        steps, losses = [], []
        try:
            for s in range(n):
                masks.clear()
                self.iterate()
                losses.append(self.last_loss)
                # each chunk's forward draws one mask a layer, in order
                per = len(masks) // len(self._last_chunks)
                steps.append([{"idx": idx, "M": M, "keeps": [
                    k.cpu() for k in masks[c * per:(c + 1) * per]] or None}
                    for c, (idx, M) in enumerate(self._last_chunks)])
                if s == 0:
                    st = self.opt.state
                    g1 = {names[p]: (st[p]["exp_avg"] / (1 - beta1)).cpu()
                          if p in st else torch.zeros_like(p).cpu()
                          for p in names}
        finally:
            gotennet.attention_keep_mask = saved
            self.opt.step = step
        theta = {k: p.detach().cpu() for p, k in names.items()}
        self.prog = {"losses": losses, "grad1": g1,
                     "change": {k: theta[k] - self.weights[k].cpu()
                                for k in theta}}
        self.compared_steps = steps

    def measure(self) -> dict:
        self.ctx.reset_peak()
        self.nonfinite = 0
        w = self.run_for(self.ctx.seconds)
        w["kind"] = "train"
        return {"attempted": w["iterations"], "failed": self.nonfinite,
                "e2e": {"train_mol_per_s": w["molecules"] / w["seconds"]},
                "data": {"kind": "train", "window": w}}

    def release(self) -> None:
        del self.model, self.opt, self.loss_fn
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, dtype=torch.float32) -> dict:
        cfg = self.ctx.config
        steps = [{"chunks": [{"mols": [self.pool[i] for i in ch["idx"]],
                              "M": ch["M"], "keeps": ch["keeps"]}
                             for ch in st]} for st in self.compared_steps]
        ref = ref_train.train(self.weights, self.m, cfg["task"],
                              cfg["optimizer"], steps, self.dev, dtype,
                              block=self.t["reference_block"])
        self.ref = ref
        self.steps_ref = steps
        return train_numbers(self.prog, ref)

    def control(self, dtype=torch.bfloat16, pair_type=None) -> dict:
        """The reference computed in ``dtype`` (its pairs rounded through
        ``pair_type``, where given), in the program's place, against the
        float32 reference of ``check``; kept as ``self.low``."""
        cfg = self.ctx.config
        self.low = ref_train.train(
            self.weights, self.m, cfg["task"], cfg["optimizer"],
            self.steps_ref, self.dev, dtype,
            block=self.t["reference_block"], pair_type=pair_type)
        return train_numbers(self.low, self.ref)
