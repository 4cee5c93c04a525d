"""Inference entry point: a ``Predictor`` answers requests of molecules.

Counterpart of the JAX package's forward-only evaluation pipeline
(``bench.py``'s ``BENCH_MODE=eval`` and the CLI's ``test`` entry): a
request is bucketed by size into chunks of ``chunk`` graphs, each chunk
padded to its own largest molecule (M a multiple of 8), and run through
``GotenModel`` in the dense layout.

    pred = Predictor(cfg, head, state_dict)        # on cuda
    energies = pred.predict([{"z": z0, "pos": pos0}, ...])   # [n, n_out]
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from gotennet_tpu_torch.data.dataset import DenseLoader, MoleculeDataset
from gotennet_tpu_torch.models.gotennet import GotenNetConfig
from gotennet_tpu_torch.models.model import GotenModel, HeadConfig

__all__ = ["Predictor"]


class Predictor:
    """One model serving requests; answers come back in request order.

    Args:
        cfg, head: the model's configuration.
        state_dict: weights (for example from
            ``utils.convert.state_dict_from_jax_params``); None keeps the
            seeded init.
        chunk: graphs per forward call.
        seed: seed of the init when no weights are given.
        device: ``None`` means ``cuda``; pass ``"cpu"`` for the plain
            versions on the CPU.
    """

    def __init__(self, cfg: GotenNetConfig, head: HeadConfig,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None, *,
                 chunk: int = 8, seed: int = 0,
                 device: Optional[str | torch.device] = None):
        self.model = GotenModel(cfg, head, seed=seed, device=device)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.device = next(self.model.parameters()).device
        self.chunk = chunk
        self.n_out = head.n_out

    @torch.inference_mode()
    def predict(self, molecules: Sequence[dict]) -> np.ndarray:
        """``molecules``: dicts with ``z`` ``[n_i]`` and ``pos``
        ``[n_i, 3]``.  Returns ``[len(molecules), n_out]`` float32."""
        n = len(molecules)
        if n == 0:
            return np.zeros((0, self.n_out), np.float32)
        ds = MoleculeDataset(
            z=[np.asarray(m["z"], np.int32) for m in molecules],
            pos=[np.asarray(m["pos"], np.float32) for m in molecules])
        # one bucketing window over the whole request
        loader = DenseLoader(ds, batch_size=self.chunk, bucket=True,
                             bucket_window=math.ceil(n / self.chunk))
        out = torch.empty(n, self.n_out, device=self.device)
        for idx, batch in loader.batches():
            prop = self.model(batch.to(self.device))["property"]
            out[torch.as_tensor(idx, device=self.device)] = prop[:len(idx)]
        return out.cpu().numpy()
