"""GotenNet in dense-block layout: batched ``[G, M, M]`` pair tensors.

Counterpart of ``gotennet_tpu/models/gotennet_dense.py`` with the fused
message path: every GATA layer runs its message + aggregation through
``ops.fused_gata.fused_gata`` (the CUDA kernels on the card, forward and,
in training, backward through ``FusedGATA``), and the HTR edge update in
its expanded-rejection form,

    sum_m EQr.EKr = S - pq * pk * (2 - |r_l|^2),

through ``ops.fused_htr.fused_htr`` (its CUDA kernels, ``FusedHTR`` in
training) when ``fused_htr`` is set, as plain tensor ops otherwise.

Parameters carry the reference state-dict names
(``gata_list.{i}.W_q.weight`` ...).  ``pair_dtype`` and ``node_dtype``
cast where the JAX package casts; every reduction accumulates in f32.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from gotennet_tpu_torch.graph.dense_batch import DenseBatch
from gotennet_tpu_torch.models.gotennet import (EQFF, GotenNetConfig,
                                               parse_edge_updates)
from gotennet_tpu_torch.nn.dense import MLP, Dense
from gotennet_tpu_torch.ops import fused_gata, fused_htr
from gotennet_tpu_torch.ops.activations import get_activation
from gotennet_tpu_torch.ops.cutoffs import cosine_cutoff
from gotennet_tpu_torch.ops.rbf import get_rbf
from gotennet_tpu_torch.ops.spherical import degree_slices, spherical_harmonics

__all__ = ["GotenNetDense", "PairGeometry", "pair_geometry"]


class PairGeometry(NamedTuple):
    """Pair tensors of a dense batch (i = destination, j = source)."""

    vec: torch.Tensor        # [G, M, M, 3]  pos_j - pos_i
    adj: torch.Tensor        # [G, M, M]     real non-loop pairs (capped)
    pair_mask: torch.Tensor  # [G, M, M]     adj plus real self-loops
    dist: torch.Tensor       # [G, M, M]     0 off adj
    vec_n: torch.Tensor      # [G, M, M, 3]  unit vectors, 0 off adj


def pair_geometry(pos: torch.Tensor, mask: torch.Tensor, cutoff: float,
                  max_num_neighbors: Optional[int]) -> PairGeometry:
    """Adjacency within ``cutoff``, capped to the nearest
    ``max_num_neighbors`` sources per destination (ties broken by source
    index, as the host edge builder's stable argsort).  ``pair_mask``
    counts the same edges as the edge-list layout, self-loops included."""
    M = pos.shape[1]
    vec = pos[:, None, :, :] - pos[:, :, None, :]
    d2 = torch.sum(vec ** 2, dim=-1)
    eye = torch.eye(M, dtype=torch.bool, device=pos.device)[None]
    both = mask[:, :, None] & mask[:, None, :]
    adj = both & ~eye & (d2 < cutoff ** 2)
    cap = max_num_neighbors
    if cap is not None and cap < M - 1:
        d2m = torch.where(adj, d2, torch.full_like(d2, math.inf))
        order = torch.argsort(d2m, dim=-1, stable=True)
        rank = torch.argsort(order, dim=-1, stable=True)
        adj = adj & (rank < cap)
    pair_mask = adj | (eye & both)
    d2_safe = torch.where(adj, d2, torch.ones_like(d2))
    zero = torch.zeros_like(d2)
    dist = torch.where(adj, torch.sqrt(d2_safe), zero)
    inv = torch.where(adj, torch.rsqrt(d2_safe), zero)
    return PairGeometry(vec, adj, pair_mask, dist, vec * inv[..., None])


def _node_dtype(cfg: GotenNetConfig) -> Optional[torch.dtype]:
    return None if cfg.node_dtype == torch.float32 else cfg.node_dtype


class NodeInitDense(nn.Module):
    """Neighbour embeddings gated by a radial filter under the cosine
    cutoff, summed over non-loop pairs, fused with the centre
    embedding."""

    def __init__(self, cfg: GotenNetConfig):
        super().__init__()
        d = cfg.n_atom_basis
        act = get_activation(cfg.activation)
        kw = dict(weight_init=cfg.weight_init, bias_init=cfg.bias_init)
        self.cutoff = cfg.cutoff
        self.pair_dtype = cfg.pair_dtype
        self.A_nbr = nn.Embedding(cfg.max_z, d)
        # the reference's W_ndp is a one-layer MLP
        self.W_ndp = MLP([cfg.n_rbf, d], **kw, dtype=cfg.pair_dtype)
        self.W_nrd_nru = MLP([2 * d, d, d], activation=act, norm="layer",
                             **kw)

    def forward(self, z, h, dist, phi, adj) -> torch.Tensor:
        pd = self.pair_dtype
        h_src = self.A_nbr(z)                                  # [G, M, D]
        env = cosine_cutoff(dist, self.cutoff)
        r_feat = self.W_ndp(phi.to(pd)) * (env * adj)[..., None].to(pd)
        # bf16 factors, f32 accumulation over j
        m_i = torch.einsum("gijd,gjd->gid", r_feat.float(),
                           h_src.to(pd).float())
        return self.W_nrd_nru(torch.cat([h, m_i], dim=-1))


class EdgeInitDense(nn.Module):
    """t_ij = (h_i + h_j) * W_erp(phi_ij), formed in pair_dtype, kept
    f32."""

    def __init__(self, cfg: GotenNetConfig):
        super().__init__()
        self.pair_dtype = cfg.pair_dtype
        self.W_erp = Dense(cfg.n_rbf, cfg.n_atom_basis,
                           weight_init="xavier_uniform", bias_init="zeros",
                           dtype=cfg.pair_dtype)

    def forward(self, phi, h) -> torch.Tensor:
        pd = self.pair_dtype
        w = self.W_erp(phi.to(pd))
        hp = h.to(pd)
        return ((hp[:, :, None, :] + hp[:, None, :, :]) * w).float()


class GATADense(nn.Module):
    """One interaction: fused message + aggregation, then (except in the
    last layer) the HTR edge update."""

    def __init__(self, cfg: GotenNetConfig, last_layer: bool = False):
        super().__init__()
        D, mult = cfg.n_atom_basis, cfg.multiplier
        act = get_activation(cfg.activation)
        nd = _node_dtype(cfg)
        kw = dict(weight_init=cfg.weight_init, bias_init=cfg.bias_init)
        self.cfg = cfg
        self.act = act
        self.last_layer = last_layer
        self.gamma_s = nn.ModuleList([
            Dense(D, D, activation=act, **kw, dtype=nd),
            Dense(D, mult * D, **kw, dtype=nd)])
        self.W_q = Dense(D, D, **kw, dtype=nd)
        self.W_k = Dense(D, D, **kw, dtype=nd)
        self.gamma_v = nn.ModuleList([
            Dense(D, D, activation=act, **kw, dtype=nd),
            Dense(D, mult * D, **kw, dtype=nd)])
        self.W_re = Dense(D, D, **kw)
        self.W_rs = Dense(D, mult * D, **kw)
        if not last_layer:
            E = cfg.evec_dim or D
            self.gamma_t = MLP([D, D], activation=act, last_activation=act,
                               **kw, dtype=cfg.pair_dtype)
            self.W_vq = Dense(D, E, use_bias=False, **kw, dtype=nd)
            if cfg.sep_htr:
                self.W_vk = nn.ModuleList(
                    Dense(D, E, use_bias=False, **kw, dtype=nd)
                    for _ in range(cfg.lmax))
            else:
                self.W_vk = Dense(D, E, use_bias=False, **kw, dtype=nd)

    def _node_projections(self, h):
        """q, k, x_g, v in the node compute type."""
        cfg, D = self.cfg, self.cfg.n_atom_basis
        if not cfg.merge_proj:
            return (self.W_q(h), self.W_k(h),
                    self.gamma_s[1](self.gamma_s[0](h)),
                    self.gamma_v[1](self.gamma_v[0](h)))
        # one product per projection group; same parameters
        cd = cfg.node_dtype
        w1 = torch.cat([self.W_q.weight, self.W_k.weight,
                        self.gamma_s[0].weight, self.gamma_v[0].weight]).to(cd)
        b1 = torch.cat([self.W_q.bias, self.W_k.bias, self.gamma_s[0].bias,
                        self.gamma_v[0].bias]).to(cd)
        y1 = h.to(cd) @ w1.t() + b1
        q, k = y1[..., :D], y1[..., D:2 * D]
        s0 = self.act(y1[..., 2 * D:3 * D])
        v0 = self.act(y1[..., 3 * D:])
        w2 = torch.stack([self.gamma_s[1].weight, self.gamma_v[1].weight]).to(cd)
        b2 = torch.stack([self.gamma_s[1].bias, self.gamma_v[1].bias]).to(cd)
        y2 = torch.stack([s0, v0]).flatten(1, -2) @ w2.transpose(1, 2)
        y2 = y2.reshape(2, *s0.shape[:-1], -1) + b2[:, None, None, :]
        return q, k, y2[0], y2[1]

    def _htr_projections(self, X):
        """EQ, EK [G, M, L, E] in the node compute type."""
        cfg = self.cfg
        W_vk = list(self.W_vk) if cfg.sep_htr else [self.W_vk]
        if not cfg.merge_proj:
            EQ = self.W_vq(X)
            if not cfg.sep_htr:
                return EQ, self.W_vk(X)
            return EQ, torch.cat([W_vk[l](X[..., lo:hi, :]) for l, (lo, hi)
                                  in enumerate(degree_slices(cfg.lmax))],
                                 dim=2)
        E = self.W_vq.weight.shape[0]
        cd = cfg.node_dtype
        wall = torch.cat([self.W_vq.weight] + [w.weight for w in W_vk]).to(cd)
        y = X.to(cd) @ wall.t()                       # [G, M, L, (1+n)E]
        EQ = y[..., :E]
        if not cfg.sep_htr:
            return EQ, y[..., E:2 * E]
        return EQ, torch.cat([y[:, :, lo:hi, (1 + l) * E:(2 + l) * E]
                              for l, (lo, hi)
                              in enumerate(degree_slices(cfg.lmax))], dim=2)

    def forward(self, h, X, t_ij, rl_ij, dist, pair_mask, n_edges
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        D = cfg.n_atom_basis
        pd = cfg.pair_dtype
        if self.training and cfg.attn_dropout > 0.0:
            from gotennet_tpu_torch.models.gotennet import not_ported
            raise not_ported("attention dropout in training", 1)

        q, k, x_g, v = self._node_projections(h)
        # the sign of env_signed carries the pair mask
        env_signed = torch.where(pair_mask, cosine_cutoff(dist, cfg.cutoff),
                                 torch.full_like(dist, -1.0))
        if cfg.scale_edge:
            scale = torch.sqrt(n_edges) / math.sqrt(D)
        else:
            scale = torch.full_like(dist, 1.0 / math.sqrt(D))
        # through FusedGATA (kernel backward) when a gradient is wanted
        d_h, dX = fused_gata.fused_gata(
            t_ij.contiguous(), q.contiguous(), k.contiguous(),
            x_g.contiguous(), v.contiguous(), rl_ij, X, env_signed, scale,
            self.W_re.weight.t().contiguous(), self.W_re.bias,
            self.W_rs.weight.t().contiguous(), self.W_rs.bias,
            lmax=cfg.lmax, num_heads=cfg.num_heads, sep_dir=cfg.sep_dir,
            sep_tensor=cfg.sep_tensor, pair_dtype=pd)
        h = h + d_h
        X = X + dX
        if self.last_layer:
            return h, X, t_ij

        # ---- HTR edge update (expanded rejection), in pair_dtype --------
        EQ, EK = self._htr_projections(X)
        if cfg.fused_htr and (cfg.evec_dim or D) == D:
            # one kernel over the pairs: z, gt, S, pq, pk and w stay on
            # chip (ops/fused_htr.py); gamma_t's single layer in [in, out]
            info = parse_edge_updates(cfg.edge_updates)
            layer = self.gamma_t.dense_layers[0]
            return h, X, fused_htr.fused_htr(
                t_ij, EQ.contiguous(), EK.contiguous(), rl_ij,
                layer.weight.t().contiguous(), layer.bias, lmax=cfg.lmax,
                sep_htr=cfg.sep_htr, rej=info["rej"],
                gate=info["gated"] or "", pair_dtype=pd)

        def pair_terms(lo, hi):
            eq = EQ[..., lo:hi, :].to(pd)
            ek = EK[..., lo:hi, :].to(pd)
            S = pq = pk = 0.0
            for m in range(hi - lo):
                eq_m = eq[:, :, None, m, :]        # [G, i, 1, E]
                ek_m = ek[:, None, :, m, :]        # [G, 1, j, E]
                r_m = rl_ij[..., lo + m:lo + m + 1].to(pd)
                S = S + eq_m * ek_m
                pq = pq + eq_m * r_m
                pk = pk + ek_m * r_m
            r2 = torch.sum(rl_ij[..., lo:hi] ** 2, dim=-1)[..., None].to(pd)
            return S - pq * pk * (2.0 - r2)

        if cfg.sep_htr:
            w_ij = sum(pair_terms(lo, hi) for lo, hi in degree_slices(cfg.lmax))
        else:
            w_ij = pair_terms(0, rl_ij.shape[-1])
        gt = self.gamma_t(t_ij)
        return h, X, t_ij + (gt * w_ij).to(t_ij.dtype)


class GotenNetDense(nn.Module):
    """The dense-layout representation stack: ``(h [G,M,D], X [G,M,L,D])``
    from a ``DenseBatch``."""

    def __init__(self, cfg: GotenNetConfig):
        super().__init__()
        D = cfg.n_atom_basis
        self.cfg = cfg
        self.A_na = nn.Embedding(cfg.max_z, D)
        self.rbf = get_rbf(cfg.radial_basis, cfg.n_rbf, cfg.cutoff)
        self.node_init = NodeInitDense(cfg)
        self.edge_init = EdgeInitDense(cfg)
        n = cfg.n_interactions
        self.gata_list = nn.ModuleList(
            GATADense(cfg, last_layer=(i == n - 1)) for i in range(n))
        self.eqff_list = nn.ModuleList(EQFF(cfg) for _ in range(n))

    def forward(self, batch: DenseBatch
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        G, M = batch.z.shape
        geo = pair_geometry(batch.pos, batch.mask, cfg.cutoff,
                            cfg.max_num_neighbors)
        z = batch.z.long()
        h = self.A_na(z)
        phi = self.rbf(geo.dist)                              # [G, M, M, R]
        h = self.node_init(z, h, geo.dist, phi, geo.adj.to(h.dtype))
        t_ij = self.edge_init(phi, h)
        rl_ij = spherical_harmonics(geo.vec_n, cfg.lmax).contiguous()
        # per-source real-edge counts (src axis = j)
        counts_src = torch.sum(geo.pair_mask.to(h.dtype), dim=1)
        n_edges = counts_src[:, None, :].expand(G, M, M)
        X = torch.zeros(G, M, cfg.sh_dim, cfg.n_atom_basis, dtype=h.dtype,
                        device=h.device)
        sd = cfg.pair_dtype if cfg.edge_state_pair_dtype else None
        if sd is not None:
            t_ij = t_ij.to(sd)
        for gata, eqff in zip(self.gata_list, self.eqff_list):
            h, X, t_ij = gata(h, X, t_ij, rl_ij, geo.dist, geo.pair_mask,
                              n_edges)
            if sd is not None:
                t_ij = t_ij.to(sd)
            h, X = eqff(h, X)
        return h, X
