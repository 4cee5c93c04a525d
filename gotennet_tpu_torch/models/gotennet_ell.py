"""GotenNet on the ELL layout: a row of ``K`` neighbour slots per node.

Counterpart of ``gotennet_tpu/models/gotennet_ell.py`` on one device, with
its fused path (``fused=True, fused_htr=True``): every GATA layer runs its
message + aggregation through ``ops.fused_ell.fused_ell`` and its HTR
update through ``ops.fused_htr.fused_htr_ell`` (the CUDA kernels on the
card).  Both are forward only: training on this layout raises
``NotImplementedError`` (ROADMAP.md Queue 1, item 11), and so do the
unfused edge update and node tables above ``fused_table_rows``, which the
JAX package runs through its chunked drivers.

Types follow the JAX layer, not the dense one: the node projections (q,
k, x_g, v, EQ, EK), ``W_ndp`` and ``W_erp`` compute in float32, only EQFF
follows ``node_dtype``.  A batch with gather windows (spatially sorted
atoms, ``block_rows``) rounds the gathered node features of NodeInit and
EdgeInit to ``pair_dtype``, as the JAX package's one-hot window matmuls
do; positions and edge counts gather exactly.  Parameters carry the
dense layout's names, so one state dict serves both layouts.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch
from torch import nn

from gotennet_tpu_torch.graph.ell_batch import ELLBatch
from gotennet_tpu_torch.models.gotennet import (EQFF, GotenNetConfig,
                                               not_ported, parse_edge_updates)
from gotennet_tpu_torch.nn.dense import MLP, Dense
from gotennet_tpu_torch.ops import fused_ell, fused_htr
from gotennet_tpu_torch.ops.activations import get_activation
from gotennet_tpu_torch.ops.cutoffs import cosine_cutoff
from gotennet_tpu_torch.ops.rbf import get_rbf
from gotennet_tpu_torch.ops.spherical import degree_slices, spherical_harmonics

__all__ = ["GotenNetELL", "NodeInitELL", "EdgeInitELL", "GATAELL"]

Gather = Callable[[torch.Tensor], torch.Tensor]


def _gather_fn(nbr: torch.Tensor, rounded: bool,
               pair_dtype: torch.dtype) -> Gather:
    """``gather(x [N, F...]) -> [N, K, F...]`` by the neighbour rows; with
    ``rounded`` (a windowed batch) the values come back rounded to
    ``pair_dtype`` in ``x``'s type."""
    idx = nbr.long()

    def gather(x: torch.Tensor) -> torch.Tensor:
        g = x[idx]
        return g.to(pair_dtype).to(x.dtype) if rounded else g
    return gather


class NodeInitELL(nn.Module):
    """Neighbour embeddings gated by a radial filter under the cosine
    cutoff, summed over the non-loop slots, fused with the centre
    embedding (the dense NodeInit's parameters)."""

    def __init__(self, cfg: GotenNetConfig):
        super().__init__()
        d = cfg.n_atom_basis
        kw = dict(weight_init=cfg.weight_init, bias_init=cfg.bias_init)
        self.cutoff = cfg.cutoff
        self.A_nbr = nn.Embedding(cfg.max_z, d)
        self.W_ndp = MLP([cfg.n_rbf, d], **kw)
        self.W_nrd_nru = MLP([2 * d, d, d],
                             activation=get_activation(cfg.activation),
                             norm="layer", **kw)

    def forward(self, z, h, gather: Gather, dist, phi, nonloop
                ) -> torch.Tensor:
        env = cosine_cutoff(dist, self.cutoff)
        msg = gather(self.A_nbr(z)) * self.W_ndp(phi) * env[..., None]
        m_i = torch.sum(msg * nonloop[..., None], dim=1)
        return self.W_nrd_nru(torch.cat([h, m_i], dim=-1))


class EdgeInitELL(nn.Module):
    """t = (h_r + h_j) * W_erp(phi), float32."""

    def __init__(self, cfg: GotenNetConfig):
        super().__init__()
        self.W_erp = Dense(cfg.n_rbf, cfg.n_atom_basis,
                           weight_init="xavier_uniform", bias_init="zeros")

    def forward(self, phi, h, gather: Gather) -> torch.Tensor:
        return (h[:, None, :] + gather(h)) * self.W_erp(phi)


class GATAELL(nn.Module):
    """One interaction: the fused ELL message + aggregation, then (except in
    the last layer) the fused ELL HTR update."""

    def __init__(self, cfg: GotenNetConfig, last_layer: bool = False):
        super().__init__()
        D, mult = cfg.n_atom_basis, cfg.multiplier
        act = get_activation(cfg.activation)
        kw = dict(weight_init=cfg.weight_init, bias_init=cfg.bias_init)
        self.cfg = cfg
        self.last_layer = last_layer
        self.gamma_s = nn.ModuleList([Dense(D, D, activation=act, **kw),
                                      Dense(D, mult * D, **kw)])
        self.W_q = Dense(D, D, **kw)
        self.W_k = Dense(D, D, **kw)
        self.gamma_v = nn.ModuleList([Dense(D, D, activation=act, **kw),
                                      Dense(D, mult * D, **kw)])
        self.W_re = Dense(D, D, **kw)
        self.W_rs = Dense(D, mult * D, **kw)
        if not last_layer:
            self.gamma_t = MLP([D, D], activation=act, last_activation=act,
                               **kw)
            self.W_vq = Dense(D, D, use_bias=False, **kw)
            if cfg.sep_htr:
                self.W_vk = nn.ModuleList(Dense(D, D, use_bias=False, **kw)
                                          for _ in range(cfg.lmax))
            else:
                self.W_vk = Dense(D, D, use_bias=False, **kw)

    def forward(self, h, X, t_ij, rl_ij, dist, nbr, nbr_mask, n_edges
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        D = cfg.n_atom_basis
        q, k = self.W_q(h), self.W_k(h)
        x_g = self.gamma_s[1](self.gamma_s[0](h))
        v = self.gamma_v[1](self.gamma_v[0](h))
        # the sign of env_signed carries the slot mask
        env_signed = torch.where(nbr_mask, cosine_cutoff(dist, cfg.cutoff),
                                 torch.full_like(dist, -1.0))
        if cfg.scale_edge:
            scale = torch.sqrt(n_edges) / math.sqrt(D)
        else:
            scale = torch.full_like(dist, 1.0 / math.sqrt(D))
        d_h, dX = fused_ell.fused_ell(
            t_ij, q, k, x_g, v, rl_ij, X, env_signed, scale, nbr,
            self.W_re.weight.t().contiguous(), self.W_re.bias,
            self.W_rs.weight.t().contiguous(), self.W_rs.bias, lmax=cfg.lmax,
            num_heads=cfg.num_heads, sep_dir=cfg.sep_dir,
            sep_tensor=cfg.sep_tensor, pair_dtype=cfg.pair_dtype)
        h = h + d_h
        X = X + dX
        if self.last_layer:
            return h, X, t_ij

        EQ = self.W_vq(X)
        if cfg.sep_htr:
            EK = torch.cat([self.W_vk[l](X[:, lo:hi]) for l, (lo, hi)
                            in enumerate(degree_slices(cfg.lmax))], dim=1)
        else:
            EK = self.W_vk(X)
        info = parse_edge_updates(cfg.edge_updates)
        layer = self.gamma_t.dense_layers[0]
        return h, X, fused_htr.fused_htr_ell(
            t_ij, EQ, EK, rl_ij, nbr, layer.weight.t().contiguous(),
            layer.bias, lmax=cfg.lmax, sep_htr=cfg.sep_htr, rej=info["rej"],
            gate=info["gated"] or "", pair_dtype=cfg.pair_dtype)


class GotenNetELL(nn.Module):
    """The ELL-layout representation stack: ``(h [N, D], X [N, L, D])``
    from an ``ELLBatch``."""

    def __init__(self, cfg: GotenNetConfig):
        super().__init__()
        if not cfg.fused_htr or (cfg.evec_dim or cfg.n_atom_basis) != \
                cfg.n_atom_basis:
            raise not_ported("layout='ell' without the fused HTR update "
                             "(fused_htr=False or evec_dim != n_atom_basis)",
                             11)
        D = cfg.n_atom_basis
        self.cfg = cfg
        self.A_na = nn.Embedding(cfg.max_z, D)
        self.rbf = get_rbf(cfg.radial_basis, cfg.n_rbf, cfg.cutoff)
        self.node_init = NodeInitELL(cfg)
        self.edge_init = EdgeInitELL(cfg)
        n = cfg.n_interactions
        self.gata_list = nn.ModuleList(
            GATAELL(cfg, last_layer=(i == n - 1)) for i in range(n))
        self.eqff_list = nn.ModuleList(EQFF(cfg) for _ in range(n))

    def forward(self, batch: ELLBatch) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        N, K = batch.nbr.shape
        if cfg.fused_table_rows and N > cfg.fused_table_rows:
            raise not_ported(f"an ELL node table of {N} rows, above "
                             f"fused_table_rows={cfg.fused_table_rows} (the "
                             "chunked drivers)", 11)
        nbr, nm, pos = batch.nbr, batch.nbr_mask, batch.pos
        idx = nbr.long()
        gather = _gather_fn(nbr, bool(batch.gather_window and batch.block_rows),
                            cfg.pair_dtype)
        # neighbour geometry (source - destination); the self-loop's
        # distance is pinned to 0 and its unit vector to zeros
        vec = pos[idx] - pos[:, None, :]
        self_idx = torch.arange(N, device=idx.device)[:, None]
        nonloop = nm & (idx != self_idx)
        d2 = torch.sum(vec ** 2, dim=-1)
        one = torch.ones_like(d2)
        dist = torch.where(nonloop, torch.sqrt(torch.where(nonloop, d2, one)),
                           torch.zeros_like(d2))
        vec_n = torch.where(nonloop[..., None],
                            vec / torch.where(nonloop, dist, one)[..., None],
                            vec * 0.0)
        rl_ij = spherical_harmonics(vec_n, cfg.lmax).contiguous()

        z = batch.z.long()
        h = self.A_na(z)
        phi = self.rbf(dist)                                  # [N, K, R]
        h = self.node_init(z, h, gather, dist, phi, nonloop)
        t_ij = self.edge_init(phi, h, gather)
        # per-source real-edge counts; integers, so the scatter is exact
        counts = torch.zeros(N, dtype=h.dtype, device=h.device).index_add_(
            0, idx.reshape(-1), nm.reshape(-1).to(h.dtype))
        n_edges = counts[idx]
        X = torch.zeros(N, cfg.sh_dim, cfg.n_atom_basis, dtype=h.dtype,
                        device=h.device)
        for gata, eqff in zip(self.gata_list, self.eqff_list):
            h, X, t_ij = gata(h, X, t_ij, rl_ij, dist, nbr, nm, n_edges)
            h, X = eqff(h, X)
        return h, X
