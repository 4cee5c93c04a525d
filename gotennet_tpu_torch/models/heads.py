"""Output heads (``gotennet_tpu/models/heads.py``): the atomwise head.

Parameter names follow the reference state dict: the per-atom MLP sits
at ``out_net.1.out_net.{i}`` (the reference wraps it as
``Sequential(GetItem, SchnetMLP)``), the standardisation at
``standardize.{mean,stddev}`` and the frozen atomref at
``atomref.weight``.  The Dipole and ESE heads are not ported yet
(ROADMAP.md Queue 1, item 6).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from gotennet_tpu_torch.nn.dense import Dense
from gotennet_tpu_torch.ops.activations import get_activation, shifted_softplus

__all__ = ["SchnetMLP", "Atomwise"]


class SchnetMLP(nn.Module):
    """Pyramidal MLP with halving hidden widths: n_layers=2 gives
    [n_in, n_in // 2, n_out], activation on all but the last layer."""

    def __init__(self, n_in: int, n_out: int, n_hidden=None,
                 n_layers: int = 2, activation: Any = shifted_softplus):
        super().__init__()
        act = get_activation(activation)
        if n_hidden is None:
            dims, c = [], n_in
            for _ in range(n_layers):
                dims.append(c)
                c //= 2
            dims.append(n_out)
        else:
            hidden = ([n_hidden] * (n_layers - 1) if isinstance(n_hidden, int)
                      else list(n_hidden))
            dims = [n_in] + hidden + [n_out]
        n = len(dims) - 1
        self.out_net = nn.ModuleList(
            Dense(dims[i], dims[i + 1], activation=act if i < n - 1 else None)
            for i in range(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.out_net:
            x = layer(x)
        return x


class _ScaleShift(nn.Module):
    def __init__(self, mean: float, stddev: float):
        super().__init__()
        self.register_buffer("mean", torch.tensor([mean], dtype=torch.float32))
        self.register_buffer("stddev",
                             torch.tensor([stddev], dtype=torch.float32))


class Atomwise(nn.Module):
    """Per-atom MLP -> y * stddev + mean per atom -> + atomref[z] ->
    masked per-graph sum."""

    def __init__(self, n_in: int, n_out: int = 1, n_layers: int = 2,
                 n_hidden=None, activation: Any = shifted_softplus,
                 mean: float = 0.0, stddev: float = 1.0,
                 atomref: Optional[np.ndarray] = None,
                 max_z: int = 100):
        super().__init__()
        # index 0 stands for the reference's parameter-free GetItem
        self.out_net = nn.Sequential(
            nn.Identity(),
            SchnetMLP(n_in, n_out, n_hidden, n_layers, activation))
        self.standardize = _ScaleShift(mean, stddev)
        if atomref is not None:
            table = np.asarray(atomref, np.float32)
            if table.ndim == 1:
                table = table[:, None]
            self.atomref = nn.Embedding(*table.shape)
            self.atomref.weight.requires_grad_(False)
            with torch.no_grad():
                self.atomref.weight.copy_(torch.from_numpy(table))
        else:
            self.atomref = None

    def forward(self, z: torch.Tensor, h: torch.Tensor, node_mask: torch.Tensor,
                node_graph: torch.Tensor, num_graphs: int
                ) -> Dict[str, torch.Tensor]:
        """``z``, ``node_mask`` and ``node_graph`` (each node's graph)
        ``[N]``, ``h`` ``[N, D]``; the masked contributions are summed per
        graph into ``[num_graphs, n_out]``."""
        yi = self.out_net(h)
        yi = yi * self.standardize.stddev + self.standardize.mean
        if self.atomref is not None:
            yi = yi + self.atomref(z.long())
        y = yi.new_zeros(num_graphs, yi.shape[-1]).index_add(
            0, node_graph.long(), yi * node_mask[:, None].to(yi.dtype))
        return {"property": y, "contributions": yi}
