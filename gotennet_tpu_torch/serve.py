"""Inference entry point: a ``Predictor`` answers requests of molecules.

Counterpart of the JAX package's forward-only evaluation pipeline
(``bench.py``'s ``BENCH_MODE=eval`` and the CLI's ``test`` entry): a
request is cut into chunks of ``chunk`` graphs and run through
``GotenModel``.  In the dense layout each chunk is bucketed by size so
that it is padded to its own largest molecule (M a multiple of 8), or
unbucketed (``bucket=False``, ``bench.py``'s MD22 mode) with every chunk
padded to the request's largest molecule.  In the ELL layout
(``layout="ell"``, ``bench.py``'s ``BENCH_DATASET=large`` mode) every
chunk is one ``ELLBatch`` with the request's node capacity and neighbour
slots (probed over the whole request), atoms spatially sorted and
``block_rows``-row gather windows.  In the edge-list layout
(``layout="edge"``, ``bench.py``'s default layout) every chunk is one
``GraphBatch`` with the capacities ``BatchLoader`` probes over the request,
as ``bench.py`` cuts them.  ``predict_with_forces`` also returns
``forces = -dE/dpos`` for a head with ``derivative`` (``MD22Task``'s), by
one backward pass through the model with respect to the positions alone.

    pred = Predictor(cfg, head, state_dict)        # on cuda
    energies = pred.predict([{"z": z0, "pos": pos0}, ...])   # [n, n_out]
    energies, forces = pred.predict_with_forces(molecules)   # + [n_i, 3] each
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gotennet_tpu_torch.data.dataset import (BatchLoader, DenseLoader,
                                             ELLLoader, MoleculeDataset)
from gotennet_tpu_torch.models.gotennet import GotenNetConfig
from gotennet_tpu_torch.models.model import (GotenModel, HeadConfig,
                                             apply_with_forces)
from gotennet_tpu_torch.utils import profiling

__all__ = ["Predictor"]


class Predictor:
    """One model serving requests; answers come back in request order.
    The weights ask for no gradient.

    Args:
        cfg, head: the model's configuration.
        state_dict: weights (for example from
            ``utils.convert.state_dict_from_jax_params``); None keeps the
            seeded init.
        chunk: graphs per forward call.
        bucket: (dense) sort each request by size so that every chunk is
            padded only to its own largest molecule; False pads every
            chunk to the request's largest.
        seed: seed of the init when no weights are given.
        device: ``None`` means ``cuda``; pass ``"cpu"`` for the plain
            versions on the CPU.
        layout: "edge", "dense" or "ell".
        spatial_sort, block_rows: (ELL) sort each molecule's atoms by
            spatial cell and measure gather windows over ``block_rows``-row
            blocks (None: no windows).
    """

    def __init__(self, cfg: GotenNetConfig, head: HeadConfig,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None, *,
                 chunk: int = 8, bucket: bool = True, seed: int = 0,
                 device: Optional[str | torch.device] = None,
                 layout: str = "dense", spatial_sort: bool = True,
                 block_rows: Optional[int] = 64):
        self.model = GotenModel(cfg, head, layout, seed=seed, device=device)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.model.requires_grad_(False)
        self.device = next(self.model.parameters()).device
        self.cfg = cfg
        self.chunk = chunk
        self.bucket = bucket
        self.layout = layout
        self.spatial_sort = spatial_sort
        self.block_rows = block_rows
        self.n_out = head.n_out

    def loader(self, ds: MoleculeDataset
               ) -> BatchLoader | DenseLoader | ELLLoader:
        """The loader that cuts one request (``ds``) into chunks."""
        if self.layout == "edge":
            return BatchLoader(ds, batch_size=self.chunk,
                               cutoff=self.cfg.cutoff,
                               max_num_neighbors=self.cfg.max_num_neighbors)
        if self.layout == "ell":
            return ELLLoader(ds, batch_size=self.chunk, cutoff=self.cfg.cutoff,
                             max_num_neighbors=self.cfg.max_num_neighbors,
                             spatial_sort=self.spatial_sort,
                             block_rows=self.block_rows)
        # one bucketing window over the whole request
        return DenseLoader(ds, batch_size=self.chunk, bucket=self.bucket,
                           bucket_window=math.ceil(len(ds) / self.chunk))

    @staticmethod
    def _request(molecules: Sequence[dict]) -> MoleculeDataset:
        return MoleculeDataset(
            z=[np.asarray(m["z"], np.int32) for m in molecules],
            pos=[np.asarray(m["pos"], np.float32) for m in molecules])

    @torch.inference_mode()
    @profiling.traced("request")
    def predict(self, molecules: Sequence[dict]) -> np.ndarray:
        """``molecules``: dicts with ``z`` ``[n_i]`` and ``pos``
        ``[n_i, 3]``.  Returns ``[len(molecules), n_out]`` float32."""
        n = len(molecules)
        if n == 0:
            return np.zeros((0, self.n_out), np.float32)
        out = torch.empty(n, self.n_out, device=self.device)
        for idx, batch in self.loader(self._request(molecules)).batches():
            prop = self.model(batch.to(self.device))["property"]
            out[self._rows(idx)] = prop[:len(idx)]
        with profiling.span("wait", wait=True):
            return out.cpu().numpy()

    def _rows(self, idx: np.ndarray) -> torch.Tensor:
        """A chunk's molecule indices on the device (a copy from host
        memory, which waits for the device)."""
        with profiling.span("wait", wait=True):
            return torch.as_tensor(idx, device=self.device)

    @profiling.traced("request")
    def predict_with_forces(self, molecules: Sequence[dict]
                            ) -> Tuple[np.ndarray, List[np.ndarray]]:
        """Energies and forces: ``([len(molecules), n_out]`` float32, one
        ``[n_i, 3]`` float32 force array per molecule), in the request's
        molecule and atom order.  Needs a head with ``derivative``."""
        if not self.model.head.derivative:
            raise ValueError("predict_with_forces needs a head with "
                             "derivative=True (for example "
                             "MD22Task(...).build_head())")
        n = len(molecules)
        if n == 0:
            return np.zeros((0, self.n_out), np.float32), []
        energies = torch.empty(n, self.n_out, device=self.device)
        chunks = []
        for idx, batch in self.loader(self._request(molecules)).batches():
            with profiling.span("request.forces"):
                out = apply_with_forces(self.model, batch.to(self.device))
            energies[self._rows(idx)] = out["property"][:len(idx)].detach()
            chunks.append((idx, batch, out["forces"].detach()))
        forces = [np.zeros((len(m["z"]), 3), np.float32) for m in molecules]
        for idx, batch, f in chunks:
            with profiling.span("wait", wait=True):
                f = f.cpu().numpy()
            if self.layout == "dense":
                for g, i in enumerate(idx):
                    forces[i] = f[g, :len(forces[i])]
                continue
            graph = batch.node_graph.numpy()
            real = batch.node_mask.numpy()
            for g, i in enumerate(idx):
                rows = real & (graph == g)
                if self.layout == "edge":    # atoms in the request's order
                    forces[i] = f[rows]
                else:
                    forces[i][batch.atom.numpy()[rows]] = f[rows]
        with profiling.span("wait", wait=True):
            return energies.cpu().numpy(), forces
