"""Request traffic, closed loop with one client: each request is a list of
molecules from the pool, sent to the program's ``Predictor`` (``predict``,
or ``predict_with_forces`` where the traffic asks for forces) when the
previous one has been answered.  Latency is the host's clock from the call
to the answer.

Requests are drawn from the seed: ``in_turn`` takes consecutive slices of
one seeded permutation of the pool (wrapping round), ``no_repeat`` draws
each request without repeats from the whole pool.  Warm-up requests run
until every chunk shape of the traffic has run twice.  Every answer of the
window is kept; once the window has closed, a sample of the window's
requests drawn from the seed is answered again by the reference."""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import port
from harness.compare import answer_numbers
from harness.loop import BaseLoop
from reference import train as ref_train


class _TimedLoader:
    """The loader ``Predictor.loader`` returns, its iteration inside the
    benchmark's ``loader`` span; counts the padded pairs of its chunks."""

    def __init__(self, inner, loop):
        self.inner, self.loop = inner, loop

    def batches(self):
        it = self.inner.batches()
        while True:
            with self.loop.spans.span("loader"):
                item = next(it, None)
            if item is None:
                return
            b = item[1]
            self.loop.padded += b.num_graphs * b.max_atoms ** 2
            self.loop.seen[b.max_atoms] = self.loop.seen.get(b.max_atoms,
                                                             0) + 1
            yield item


class Loop(BaseLoop):

    def __init__(self, ctx):
        super().__init__(ctx)
        self.forces = bool(ctx.traffic["forces"])
        self.work = "force" if self.forces else "forward"

    def setup(self) -> None:
        from gotennet_tpu_torch.serve import Predictor
        ctx, t, cfg = self.ctx, self.t, self.ctx.config
        self.make_pool()
        self.pred = Predictor(port.model_config(cfg, "serve"),
                              port.head_config(cfg, self.mean, self.std),
                              self.weights, chunk=t["chunk"],
                              bucket=t["bucket"], device=self.dev,
                              layout=cfg["paths"]["serve"]["layout"])
        inner = self.pred.loader
        self.pred.loader = lambda ds: _TimedLoader(inner(ds), self)
        self.rng = np.random.default_rng([ctx.seed, 3])
        self.order = self.rng.permutation(len(self.pool))
        self.sent = 0
        self.seen, self.padded = {}, 0
        self.log = None
        self.stage("model")
        warm = set(t["batch_atoms"])
        for _ in range(t["max_warmup_requests"]):
            if all(self.seen.get(M, 0) >= 2 for M in warm):
                break
            self.iterate()
        else:
            raise RuntimeError(f"warm-up saw shapes {self.seen}, not every "
                               f"one of {sorted(warm)} twice")
        ctx.sync()
        self.stage("warmup")

    def _draw(self) -> np.ndarray:
        n, size = len(self.pool), self.t["request_size"]
        if self.t["draw"] == "in_turn":
            start = (self.sent * size) % n
            idx = np.take(self.order, np.arange(start, start + size),
                          mode="wrap")
        else:
            idx = self.rng.choice(n, size, replace=False)
        self.sent += 1
        return idx

    def iterate(self):
        idx = self._draw()
        mols = [{"z": self.pool[i][0], "pos": self.pool[i][1]} for i in idx]
        t0 = time.perf_counter()
        with self.spans.span("request"):
            if self.forces:
                e, f = self.pred.predict_with_forces(mols)
            else:
                e, f = self.pred.predict(mols), None
        lat = time.perf_counter() - t0
        if self.ctx.fault == "answer":
            e = e.copy()
            e[0] = -e[0]
        if self.log is not None:
            self.log.append((idx, e[:, 0].copy(), f, lat))
        return idx

    def measure(self) -> dict:
        self.ctx.reset_peak()
        self.log = []
        w = self.run_for(self.ctx.seconds)
        window_log, self.log = self.log, None
        self.window_log = window_log
        lat = np.asarray([x[3] for x in window_log])
        failed = sum(1 for x in window_log if not np.isfinite(x[1]).all()
                     or (x[2] is not None and not all(
                         np.isfinite(a).all() for a in x[2])))
        e2e = {"infer_mol_per_s": w["molecules"] / w["seconds"],
               "infer_p95_ms": float(np.percentile(lat, 95)) * 1e3}
        return {"attempted": len(window_log), "failed": failed, "e2e": e2e,
                "data": {"kind": "infer", "window": w}}

    def release(self) -> None:
        del self.pred
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> list:
        """The window's requests that the reference answers again."""
        log = self.window_log
        k = min(len(log), self.t["check_requests"])
        pick = np.random.default_rng([self.ctx.seed, 5]).choice(
            len(log), k, replace=False)
        return [log[i] for i in sorted(pick)]

    def check(self, dtype=torch.float32) -> dict:
        reqs = self.sample()
        mols = [self.pool[i] for r in reqs for i in r[0]]
        e_ref, f_ref = ref_train.answers(
            self.weights, self.m, mols, self.dev, self.forces, dtype,
            block=self.t["reference_block"])
        e_prog = np.concatenate([r[1] for r in reqs])
        f_prog = [a for r in reqs for a in r[2]] if self.forces else None
        self.ref_answers = (mols, e_ref, f_ref)
        return answer_numbers(e_prog, e_ref, f_prog, f_ref,
                              [len(m[0]) for m in mols])

    def control(self, dtype=torch.bfloat16, pair_type=None) -> dict:
        """The reference computed in ``dtype`` (its pairs rounded through
        ``pair_type``, where given), in the program's place, against the
        float32 reference of ``check``."""
        mols, e_ref, f_ref = self.ref_answers
        e_low, f_low = ref_train.answers(
            self.weights, self.m, mols, self.dev, self.forces, dtype,
            block=self.t["reference_block"], pair_type=pair_type)
        return answer_numbers(e_low, e_ref, f_low or None, f_ref,
                              [len(m[0]) for m in mols])
