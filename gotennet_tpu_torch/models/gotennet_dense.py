"""GotenNet in dense-block layout: batched ``[G, M, M]`` pair tensors.

Counterpart of ``gotennet_tpu/models/gotennet_dense.py``.  With ``fused``
every GATA layer runs its message + aggregation through
``ops.fused_gata.fused_gata`` (the CUDA kernels on the card, forward and,
in training, backward through ``FusedGATA``); without it the message runs
as plain tensor ops (``GATADense._unfused_message``: any activation,
``aggr`` add, mean or max), which autograd differentiates to any order, so
training on forces takes this path.  The HTR edge update runs in its
expanded-rejection form,

    sum_m EQr.EKr = S - pq * pk * (2 - |r_l|^2),

through ``ops.fused_htr.fused_htr`` (its CUDA kernels, ``FusedHTR`` in
training) with ``fused`` and ``fused_htr``, as plain tensor ops otherwise
(``htr_terms``): each of S, pq and pk is one batched product over the
spherical components m (S over (g, e), pq over (g, i), pk over (g, j)),
summed in f32 and rounded to ``pair_dtype`` once, so each pair tensor is
written once and nothing once per component.
Attention dropout in training takes each layer's ``[G, M, M, H]`` keep
mask: the fused message folds it into the kernel's per-head scale, the
unfused one drops the attention with it, as flax's ``Dropout`` does;
``remat`` recomputes each layer in the backward pass
(``models.gotennet.run_layer``).  ``scan_layers`` leaves the loop over the
layers as it is (the JAX package scans them and remats the scanned block
whole: the same values); it changes only the parameter tree's form where
it crosses to the JAX package (``utils.convert``, checkpoints).

A packed batch (``seg``, several molecules to a slab) keeps the pairs of
different molecules apart in ``pair_geometry``'s mask; the fused message
sees that mask only through the sign of ``env_signed``, so its kernels run
packed slabs as they are.

Parameters carry the reference state-dict names
(``gata_list.{i}.W_q.weight`` ...), the same for both message paths.
``pair_dtype`` and ``node_dtype`` cast where the JAX package casts; every
reduction accumulates in f32.  ``layernorm`` and ``steerable_norm`` norm h
and X in front of each layer, for either message; an update variant the
fused HTR kernel does not compute (an MLP or linear ``gamma_w`` part,
``edge_ln``, ``evec_dim != n_atom_basis``) takes the plain update, as in the
JAX package, with its tail shared with the other layouts
(``models.gotennet.GATALayer.update_tail``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from gotennet_tpu_torch.graph.dense_batch import DenseBatch
from gotennet_tpu_torch.models.gotennet import (EQFF, GATALayer,
                                               GotenNetConfig, kernel_paths,
                                               keep_masks, masked_softmax,
                                               run_layer)
from gotennet_tpu_torch.nn.dense import MLP, Dense
from gotennet_tpu_torch.ops import fused_gata, fused_htr
from gotennet_tpu_torch.ops.activations import get_activation
from gotennet_tpu_torch.ops.cutoffs import cosine_cutoff
from gotennet_tpu_torch.ops.rbf import RadialBasis
from gotennet_tpu_torch.ops.spherical import degree_slices, spherical_harmonics
from gotennet_tpu_torch.utils import profiling

__all__ = ["GotenNetDense", "PairGeometry", "htr_terms", "pair_geometry"]


class PairGeometry(NamedTuple):
    """Pair tensors of a dense batch (i = destination, j = source)."""

    vec: torch.Tensor        # [G, M, M, 3]  pos_j - pos_i
    adj: torch.Tensor        # [G, M, M]     real non-loop pairs (capped)
    pair_mask: torch.Tensor  # [G, M, M]     adj plus real self-loops
    dist: torch.Tensor       # [G, M, M]     0 off adj
    vec_n: torch.Tensor      # [G, M, M, 3]  unit vectors, 0 off adj


def pair_geometry(pos: torch.Tensor, mask: torch.Tensor, cutoff: float,
                  max_num_neighbors: Optional[int],
                  seg: Optional[torch.Tensor] = None) -> PairGeometry:
    """Adjacency within ``cutoff``, capped to the nearest
    ``max_num_neighbors`` sources per destination (ties broken by source
    index, as the host edge builder's stable argsort).  ``pair_mask``
    counts the same edges as the edge-list layout, self-loops included.
    ``seg`` (a packed batch's molecule of each slot) keeps the pairs of
    different molecules of one slab apart."""
    M = pos.shape[1]
    vec = pos[:, None, :, :] - pos[:, :, None, :]
    d2 = torch.sum(vec ** 2, dim=-1)
    eye = torch.eye(M, dtype=torch.bool, device=pos.device)[None]
    both = mask[:, :, None] & mask[:, None, :]
    if seg is not None:
        both = both & (seg[:, :, None] == seg[:, None, :])
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


def htr_terms(EQ: torch.Tensor, EK: torch.Tensor, rl_ij: torch.Tensor,
              lmax: int, sep_htr: bool, rej: bool,
              pair_dtype: torch.dtype) -> torch.Tensor:
    """The plain HTR update's ``w_ij [G, M, M, E]``:
    ``sum_l [S_l - pq_l * pk_l * (2 - |r_l|^2)]`` over the degree blocks l
    (one block of every component without ``sep_htr``; S alone without
    ``rej``), from ``EQ``, ``EK [G, M, L, E]`` and ``rl_ij [G, M, M, L]``.

    Each term is a product over the components m of one block, batched:
    ``S[g,i,j,e] = sum_m EQ[g,i,m,e] EK[g,j,m,e]`` over (g, e), once for
    all blocks (the sum of the blocks' S_l); ``pq[g,i,j,e] = sum_m
    r[g,i,j,m] EQ[g,i,m,e]`` over (g, i); ``pk`` over (g, j), laid out
    [G, j, i, E] and read transposed.  The factors are rounded to
    ``pair_dtype``, each product sums in f32 and is rounded once.
    ``(2 - |r_l|^2)``, negated, scales pq's factor r, so the blocks combine
    as ``S + pq' * pk`` with one multiply-add each, laid out as pq is.
    """
    eq, ek = EQ.to(pair_dtype), EK.to(pair_dtype)
    # S, laid out [G, E, i, j]; w holds the only reference, so S is freed
    # once the first block has read it
    w = torch.matmul(eq.permute(0, 3, 1, 2),
                     ek.permute(0, 3, 2, 1)).permute(0, 2, 3, 1)
    if not rej:
        return w
    blocks = degree_slices(lmax) if sep_htr else [(0, rl_ij.shape[-1])]
    for n, (lo, hi) in enumerate(blocks):
        r = rl_ij[..., lo:hi]
        rq = (r * (torch.sum(r * r, dim=-1, keepdim=True) - 2.0)
              ).to(pair_dtype)
        pq = torch.matmul(rq, eq[:, :, lo:hi])             # [G, i, j, E]
        pk = torch.matmul(r.to(pair_dtype).transpose(1, 2),
                          ek[:, :, lo:hi]).transpose(1, 2)
        # the first operand decides the layout: pq's, never S's
        w = pq * pk + w if n == 0 else torch.addcmul(w, pq, pk)
    return w


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


class GATADense(GATALayer):
    """One interaction: the message + aggregation (fused or plain), then
    (except in the last layer) the HTR update (fused or plain)."""

    def __init__(self, cfg: GotenNetConfig, last_layer: bool = False):
        # the plain message computes W_re and W_rs in the pair type
        super().__init__(cfg, last_layer, node_dtype=_node_dtype(cfg),
                         pair_dtype=cfg.pair_dtype)

    def _node_projections(self, h):
        """q, k, x_g, v in the node compute type."""
        cfg, D = self.cfg, self.cfg.n_atom_basis
        if not cfg.merge_proj:
            return self.node_projections(h)
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
        if not cfg.merge_proj:
            return self.htr_tables(X)
        W_vk = list(self.W_vk) if cfg.sep_htr else [self.W_vk]
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

    def _fused_message(self, t_ij, q, k, x_g, v, rl_ij, X, dist, pair_mask,
                       n_edges, keep):
        cfg = self.cfg
        env_signed, scale = self.fused_inputs(dist, pair_mask, n_edges, keep)
        # through FusedGATA (kernel backward) when a gradient is wanted
        return fused_gata.fused_gata(
            t_ij.contiguous(), q.contiguous(), k.contiguous(),
            x_g.contiguous(), v.contiguous(), rl_ij, X, env_signed, scale,
            self.W_re.weight.t().contiguous(), self.W_re.bias,
            self.W_rs.weight.t().contiguous(), self.W_rs.bias,
            lmax=cfg.lmax, num_heads=cfg.num_heads, sep_dir=cfg.sep_dir,
            sep_tensor=cfg.sep_tensor, pair_dtype=cfg.pair_dtype,
            pos_grads=cfg.pos_grads is not False)

    def _unfused_message(self, t_ij, q, k, x_g, v, rl_ij, X, dist,
                         pair_mask, n_edges, keep):
        """The message as plain tensor ops (JAX gotennet_dense.py:395-489),
        the pair tensors in ``pair_dtype`` and every sum over j in f32.
        Returns ``(d_h [G, M, D], dX [G, M, L, D])``."""
        cfg = self.cfg
        D, H = cfg.n_atom_basis, cfg.num_heads
        C = cfg.multiplier * D
        pd = cfg.pair_dtype
        G, M = q.shape[:2]
        t_attn = self.W_re(t_ij)                          # [G, M, M, D]
        if self.act is not None:
            t_attn = self.act(t_attn)
        t_filter = self.W_rs(t_ij)                        # [G, M, M, C]
        # attention: SDDMM logits (a head's channels summed in f32), masked
        # softmax over the sources j
        p_qk = (t_attn * q.to(pd)[:, :, None, :]) * k.to(pd)[:, None, :, :]
        logit = torch.sum(p_qk.float().reshape(G, M, M, H, D // H), dim=-1)
        real = pair_mask[..., None]
        attn = self.scale_attention(masked_softmax(logit, real, 2), n_edges,
                                    keep)
        # o[g, i, j] = spatial + sea; channel c takes head c // (C / H)
        env = (cosine_cutoff(dist, cfg.cutoff) * pair_mask).to(pd)
        attn_full = attn.to(pd).repeat_interleave(C // H, dim=-1)
        o = (t_filter * x_g.to(pd)[:, None, :, :] * env[..., None]
             + attn_full * v.to(pd)[:, None, :, :])
        counts = torch.sum(pair_mask.float(), dim=2)[..., None]   # [G, i, 1]

        def aggr_j(contrib):
            """``[G, i, j, D]`` pair contributions -> ``[G, i, D]``: max
            over the real pairs (a row without one gives zeros; amax shares
            the gradient among equal maxima, as jnp.max does), else the sum
            (over the count for mean)."""
            if cfg.aggr == "max":
                masked = torch.where(real, contrib.float(),
                                     torch.full_like(contrib, -3e38,
                                                     dtype=torch.float32))
                out = torch.amax(masked, dim=2)
                return torch.where(counts > 0, out, torch.zeros_like(out))
            s = torch.sum(contrib.float(), dim=2)
            return s / torch.clamp(counts, min=1.0) if cfg.aggr == "mean" \
                else s

        d_h = aggr_j(o[..., :D])
        # per SH component m: the direction and tensor terms, summed apart
        # for add and mean (linear), jointly for max, as the reference's
        # scatter-max over whole messages
        rl_p, X_p = rl_ij.to(pd), X.to(pd)
        linear = cfg.aggr in ("add", "mean")
        off_d = D
        off_t = off_d + (cfg.lmax if cfg.sep_dir else 1) * D
        cols = []
        for l, (lo, hi) in enumerate(degree_slices(cfg.lmax)):
            a = off_d + (l * D if cfg.sep_dir else 0)
            b = off_t + (l * D if cfg.sep_tensor else 0)
            o_d, o_t = o[..., a:a + D], o[..., b:b + D]
            for m in range(lo, hi):
                dir_c = rl_p[..., m:m + 1] * o_d
                ten_c = X_p[:, None, :, m, :] * o_t
                cols.append(aggr_j(dir_c) + aggr_j(ten_c) if linear
                            else aggr_j(dir_c + ten_c))
        return d_h, torch.stack(cols, dim=2)

    def forward(self, h, X, t_ij, rl_ij, dist, pair_mask, n_edges,
                keep: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``keep``: the layer's ``[G, M, M, H]`` attention keep mask, or
        None (no dropout)."""
        cfg = self.cfg
        pd = cfg.pair_dtype
        fused_message, fused_update = kernel_paths(cfg, "dense")
        h, X = self.pre_norm(h, X)
        q, k, x_g, v = self._node_projections(h)
        if fused_message:
            d_h, dX = self._fused_message(t_ij, q, k, x_g, v, rl_ij, X, dist,
                                          pair_mask, n_edges, keep)
        else:
            d_h, dX = self._unfused_message(t_ij, q, k, x_g, v, rl_ij, X,
                                            dist, pair_mask, n_edges, keep)
        h = h + d_h
        X = X + dX
        if not self.updates:
            return h, X, t_ij

        # ---- HTR edge update (expanded rejection), in pair_dtype --------
        EQ, EK = self._htr_projections(X)
        info = self.info
        if fused_update:
            # one kernel over the pairs: z, gt, S, pq, pk and w stay on
            # chip (ops/fused_htr.py); gamma_t's single layer in [in, out]
            layer = self.gamma_t.dense_layers[0]
            return h, X, fused_htr.fused_htr(
                t_ij, EQ.contiguous(), EK.contiguous(), rl_ij,
                layer.weight.t().contiguous(), layer.bias, lmax=cfg.lmax,
                sep_htr=cfg.sep_htr, rej=info["rej"],
                gate=info["gated"] or "", pair_dtype=pd)

        G, M = rl_ij.shape[:2]
        profiling.count("pairs.htr_plain", G * M * M)
        w_ij = htr_terms(EQ, EK, rl_ij, cfg.lmax, cfg.sep_htr, info["rej"],
                         pd)
        return h, X, self.update_tail(t_ij, w_ij)


class GotenNetDense(nn.Module):
    """The dense-layout representation stack: ``(h [G,M,D], X [G,M,L,D])``
    from a ``DenseBatch``."""

    def __init__(self, cfg: GotenNetConfig):
        super().__init__()
        D = cfg.n_atom_basis
        self.cfg = cfg
        self.A_na = nn.Embedding(cfg.max_z, D)
        self.radial_basis = RadialBasis(cfg.radial_basis, cfg.n_rbf,
                                        cfg.cutoff, cfg.trainable_rbf)
        self.node_init = NodeInitDense(cfg)
        self.edge_init = EdgeInitDense(cfg)
        n = cfg.n_interactions
        self.gata_list = nn.ModuleList(
            GATADense(cfg, last_layer=(i == n - 1)) for i in range(n))
        self.eqff_list = nn.ModuleList(EQFF(cfg) for _ in range(n))

    def forward(self, batch: DenseBatch,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``generator`` draws the attention keep masks (training with
        ``attn_dropout > 0``)."""
        cfg = self.cfg
        G, M = batch.z.shape
        with profiling.span("model.embed"):
            geo = pair_geometry(batch.pos, batch.mask, cfg.cutoff,
                                cfg.max_num_neighbors, batch.seg)
            z = batch.z.long()
            h = self.A_na(z)
            phi = self.radial_basis(geo.dist)                 # [G, M, M, R]
            h = self.node_init(z, h, geo.dist, phi, geo.adj.to(h.dtype))
            t_ij = self.edge_init(phi, h)
            rl_ij = spherical_harmonics(geo.vec_n, cfg.lmax).contiguous()
            # per-source real-edge counts (src axis = j)
            counts_src = torch.sum(geo.pair_mask.to(h.dtype), dim=1)
            n_edges = counts_src[:, None, :].expand(G, M, M)
            X = torch.zeros(G, M, cfg.sh_dim, cfg.n_atom_basis,
                            dtype=h.dtype, device=h.device)
            sd = cfg.pair_dtype if cfg.edge_state_pair_dtype else None
            if sd is not None:
                t_ij = t_ij.to(sd)
            masks = keep_masks(cfg, self.training, (G, M, M, cfg.num_heads),
                               generator, h.device)
        for gata, eqff, keep in zip(self.gata_list, self.eqff_list, masks):
            with profiling.span("model.layer"):
                h, X, t_ij = run_layer(cfg, self.training, gata, h, X, t_ij,
                                       rl_ij, geo.dist, geo.pair_mask,
                                       n_edges, keep)
                if sd is not None:
                    t_ij = t_ij.to(sd)
                h, X = eqff(h, X)
        return h, X
