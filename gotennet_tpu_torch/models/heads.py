"""Output heads (``gotennet_tpu/models/heads.py``): atomwise properties,
the dipole moment and the electronic spatial extent.

Every head maps ``(z, pos, h, X)`` of the flat node set, with each node's
mask and graph, to a dict of predictions; forces are not computed here
(``models.model.apply_with_forces`` differentiates the whole energy).

Parameter names follow the reference state dict: the Atomwise and ESE
per-atom MLP sits at ``out_net.1.out_net.{i}`` (the reference wraps it as
``Sequential(GetItem, SchnetMLP)``), the Atomwise standardisation at
``standardize.{mean,stddev}``, its frozen atomref at ``atomref.weight`` and
the ESE's mass table at ``atomic_mass``; the Dipole holds two gated
equivariant blocks at ``equivariant_layers.{0,1}``, each a bias-free
``mix_vectors`` and a two-layer ``scalar_net``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from gotennet_tpu_torch.nn.dense import Dense
from gotennet_tpu_torch.ops.activations import get_activation, shifted_softplus

__all__ = ["SchnetMLP", "GatedEquivariantBlock", "Atomwise", "Dipole",
           "ElectronicSpatialExtent", "ATOMIC_MASSES"]

# IUPAC 2021 standard atomic weights, index = atomic number (0 = dummy);
# the JAX package's table (the reference takes ase.data.atomic_masses)
ATOMIC_MASSES = np.asarray([
    1.008, 1.008, 4.002602, 6.94, 9.0121831, 10.81, 12.011, 14.007, 15.999,
    18.998403163, 20.1797, 22.98976928, 24.305, 26.9815385, 28.085,
    30.973761998, 32.06, 35.45, 39.948, 39.0983, 40.078, 44.955908, 47.867,
    50.9415, 51.9961, 54.938044, 55.845, 58.933194, 58.6934, 63.546, 65.38,
    69.723, 72.63, 74.921595, 78.971, 79.904, 83.798, 85.4678, 87.62,
    88.90584, 91.224, 92.90637, 95.95, 97.90721, 101.07, 102.9055, 106.42,
    107.8682, 112.414, 114.818, 118.71, 121.76, 127.6, 126.90447, 131.293,
    132.90545196, 137.327, 138.90547, 140.116, 140.90766, 144.242, 144.91276,
    150.36, 151.964, 157.25, 158.92535, 162.5, 164.93033, 167.259, 168.93422,
    173.054, 174.9668, 178.49, 180.94788, 183.84, 186.207, 190.23, 192.217,
    195.084, 196.966569, 200.592, 204.38, 207.2, 208.9804, 208.98243,
    209.98715, 222.01758, 223.01974, 226.02541, 227.02775, 232.0377,
    231.03588, 238.02891, 237.04817, 244.06421, 243.06138, 247.07035,
    247.07031, 251.07959, 252.083, 257.09511, 258.09843, 259.101, 262.11,
    267.122, 268.126, 271.134, 270.133, 269.1338, 278.156, 281.165, 281.166,
    285.177, 286.182, 289.19, 289.194, 293.204, 293.208, 294.214,
], dtype=np.float32)


def _segment_sum(data: torch.Tensor, node_graph: torch.Tensor,
                 num_graphs: int, node_mask: torch.Tensor) -> torch.Tensor:
    """Sum the real rows of ``data [N, ...]`` per graph; a padded row adds
    nothing, whatever it holds."""
    m = node_mask
    while m.dim() < data.dim():
        m = m[..., None]
    data = torch.where(m, data, torch.zeros_like(data))
    return data.new_zeros(num_graphs, *data.shape[1:]).index_add(
        0, node_graph.long(), data)


def _safe_norm(v: torch.Tensor, dim: int) -> torch.Tensor:
    """L2 norm whose gradient at a zero vector is 0, not NaN: padded slots
    carry exact zeros, and a NaN there times a zero cotangent would poison
    the sum (the double ``where`` keeps sqrt's backward away from 0)."""
    n2 = torch.sum(v * v, dim=dim)
    nonzero = n2 > 0
    return torch.where(nonzero,
                       torch.sqrt(torch.where(nonzero, n2,
                                              torch.ones_like(n2))),
                       torch.zeros_like(n2))


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
    masked per-graph sum; with ``aggregation=None`` the per-atom values
    themselves are the property."""

    def __init__(self, n_in: int, n_out: int = 1, n_layers: int = 2,
                 n_hidden=None, activation: Any = shifted_softplus,
                 aggregation: Optional[str] = "sum",
                 mean: float = 0.0, stddev: float = 1.0,
                 atomref: Optional[np.ndarray] = None):
        super().__init__()
        if aggregation not in ("sum", None):
            raise ValueError(f"aggregation {aggregation!r}: choose 'sum' or "
                             "None")
        self.aggregation = aggregation
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

    def forward(self, z, pos, h, X, node_mask, node_graph, num_graphs
                ) -> Dict[str, torch.Tensor]:
        """``z``, ``node_mask`` and ``node_graph`` (each node's graph)
        ``[N]``, ``h`` ``[N, D]``: ``property`` ``[num_graphs, n_out]`` (or
        ``[N, n_out]`` per atom without aggregation)."""
        yi = self.out_net(h)
        yi = yi * self.standardize.stddev + self.standardize.mean
        if self.atomref is not None:
            yi = yi + self.atomref(z.long())
        if self.aggregation is None:
            return {"property": yi, "contributions": yi}
        return {"property": _segment_sum(yi, node_graph, num_graphs,
                                         node_mask),
                "contributions": yi}


class GatedEquivariantBlock(nn.Module):
    """PaiNN-style gated block: two bias-free maps mix the vector channels
    (V, W); ``[s ; ||V||]`` goes through a scalar net whose second half
    gates W."""

    def __init__(self, n_sin: int, n_vin: int, n_sout: int, n_vout: int,
                 n_hidden: int, activation: Any = "silu",
                 sactivation: Any = None):
        super().__init__()
        act = get_activation(activation)
        self.n_sout, self.n_vout = n_sout, n_vout
        self.mix_vectors = Dense(n_vin, 2 * n_vout, use_bias=False)
        self.scalar_net = nn.ModuleList([
            Dense(n_sin + n_vout, n_hidden, activation=act),
            Dense(n_hidden, n_sout + n_vout)])
        self.sactivation = get_activation(sactivation)

    def forward(self, scalars: torch.Tensor, vectors: torch.Tensor):
        vmix = self.mix_vectors(vectors)                  # [N, 3, 2 vout]
        v_V, v_W = vmix[..., :self.n_vout], vmix[..., self.n_vout:]
        ctx = torch.cat([scalars.to(v_V.dtype), _safe_norm(v_V, dim=-2)],
                        dim=-1)
        x = self.scalar_net[1](self.scalar_net[0](ctx))
        s_out, gate = x[..., :self.n_sout], x[..., self.n_sout:]
        v_out = gate[..., None, :] * v_W
        if self.sactivation is not None:
            s_out = self.sactivation(s_out)
        return s_out, v_out


class Dipole(nn.Module):
    """Dipole moment: two gated equivariant blocks over (h, the l = 1 rows
    of X) give atomic charges and dipoles; ``sum(dipole + pos * charge)``
    per graph, its norm with ``predict_magnitude`` (QM9's 'mu')."""

    def __init__(self, n_in: int, n_hidden: Optional[int] = None,
                 activation: Any = "silu", predict_magnitude: bool = True,
                 mean: Optional[float] = None,
                 stddev: Optional[float] = None):
        super().__init__()
        nh = n_hidden or n_in
        self.predict_magnitude = predict_magnitude
        self.mean, self.stddev = mean, stddev
        self.equivariant_layers = nn.ModuleList([
            GatedEquivariantBlock(n_in, n_in, nh, nh, nh, activation,
                                  sactivation=activation),
            GatedEquivariantBlock(nh, nh, 1, 1, nh, activation)])

    def forward(self, z, pos, h, X, node_mask, node_graph, num_graphs
                ) -> Dict[str, torch.Tensor]:
        l0, l1 = h, X[:, 0:3, :]
        for block in self.equivariant_layers:
            l0, l1 = block(l0, l1)
        if self.stddev is not None:
            l0 = self.stddev * l0 + (self.mean or 0.0)
        y_atom = l1[..., 0] + pos * l0                    # [N, 3]
        y = _segment_sum(y_atom, node_graph, num_graphs, node_mask)
        y_vector = _segment_sum(l1, node_graph, num_graphs, node_mask)
        if self.predict_magnitude:
            y = _safe_norm(y, dim=1)[:, None]
        return {"property": y, "property_vector": y_vector}


class ElectronicSpatialExtent(nn.Module):
    """<R^2>: per atom ``|pos - c|^2 * MLP(h)`` about the graph's centre of
    mass ``c``, summed per graph."""

    def __init__(self, n_in: int, n_layers: int = 2, n_hidden=None,
                 activation: Any = shifted_softplus):
        super().__init__()
        self.out_net = nn.Sequential(
            nn.Identity(),
            SchnetMLP(n_in, 1, n_hidden, n_layers, activation))
        self.register_buffer("atomic_mass", torch.tensor(ATOMIC_MASSES))

    def forward(self, z, pos, h, X, node_mask, node_graph, num_graphs
                ) -> Dict[str, torch.Tensor]:
        x = self.out_net(h)                               # [N, 1]
        mass = self.atomic_mass[z.long()][:, None] * node_mask[:, None]
        mpos = _segment_sum(mass * pos, node_graph, num_graphs, node_mask)
        msum = _segment_sum(mass, node_graph, num_graphs, node_mask)
        c = mpos / torch.clamp(msum, min=1e-12)           # [G, 3]
        rel = pos - c[node_graph.long()]
        yi = torch.sum(rel ** 2, dim=1, keepdim=True) * x
        return {"property": _segment_sum(yi, node_graph, num_graphs,
                                         node_mask),
                "contributions": yi}
