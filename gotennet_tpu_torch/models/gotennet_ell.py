"""GotenNet on the ELL layout: a row of ``K`` neighbour slots per node.

Counterpart of ``gotennet_tpu/models/gotennet_ell.py``.  Each GATA layer
takes the path the JAX package takes for the same configuration and batch
(``models.gotennet.kernel_paths``):
- with ``fused`` the message + aggregation runs through
  ``ops.fused_ell.fused_ell`` and, with ``fused_htr`` too, the HTR update
  through ``ops.fused_htr.fused_htr_ell`` (the CUDA kernels on the card,
  forward and backward);
- otherwise each runs as plain tensor ops (``_unfused_message``,
  ``_unfused_update``): any activation, ``aggr`` add, mean or max, the
  update's every variant (``rej``, the gates, an MLP or linear ``gamma_w``
  part, ``edge_ln``, any ``evec_dim``), its tail shared with the other
  layouts (``models.gotennet.GATALayer.update_tail``).
A node table above ``fused_table_rows`` is where the JAX package runs its
fused kernels chunked over halo windows, to fit the TPU's on-chip memory.
Where it finds such a chunking (``ops.fused_ell.pick_chunking``) the port
runs its kernels on the whole table, which they read from device memory by
index; where it finds none (no ``gather_halo``, or a halo too wide) both
take the unfused paths, as they do there.  The transposed slot list both
backward kernels sum table gradients by is built once per forward and
shared by every fused layer.  Attention dropout in training takes each
layer's ``[N, K, H]`` keep mask: the fused message folds it into its
per-head scale, the unfused one drops the attention with it, as the JAX
package's ``attn_dropout`` does; ``remat`` recomputes each layer in the
backward pass.  ``layernorm`` and ``steerable_norm`` norm h and X in front
of each layer, for either message.

Row sharding (``cfg.edge_axis`` set, one process per device, as JAX's
inside ``shard_map``): the batch is whole on every rank of the axis and
each rank owns a contiguous block of ``NR = N / ranks`` destination rows.
Pair tensors, the edge state and the kernels' destination inputs hold only
those rows; the node projections run on them too, and the source tables
(k, x_g, v, EK) and every per-row aggregate are rebuilt whole by zero
padding and an all-reduce (``RowShard``).  The fused kernels take the
``NR``-row block over the ``N``-row tables.

Types follow the JAX layer, not the dense one: the node projections (q,
k, x_g, v, EQ, EK), ``W_ndp`` and ``W_erp`` compute in float32, only EQFF
follows ``node_dtype``.  A batch with gather windows (spatially sorted
atoms, ``block_rows``) rounds every gathered node feature (NodeInit,
EdgeInit and the unfused paths' k, x_g, v, X, EK) to ``pair_dtype``, as the
JAX package's one-hot window matmuls do; positions and edge counts gather
exactly.  Parameters carry the dense layout's names, so one state dict
serves both layouts and every path.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from gotennet_tpu_torch.graph.ell_batch import ELLBatch
from gotennet_tpu_torch.graph.segment import segment_sum
from gotennet_tpu_torch.models.gotennet import (_NEG, EQFF, GATALayer,
                                               GotenNetConfig, htr_pair_sum,
                                               keep_masks, kernel_paths,
                                               masked_softmax, run_layer)
from gotennet_tpu_torch.nn.dense import MLP, Dense
from gotennet_tpu_torch.ops import fused_ell, fused_htr
from gotennet_tpu_torch.ops.activations import get_activation
from gotennet_tpu_torch.ops.cutoffs import cosine_cutoff
from gotennet_tpu_torch.ops.rbf import RadialBasis
from gotennet_tpu_torch.ops.spherical import spherical_harmonics
from gotennet_tpu_torch.utils import profiling

__all__ = ["GotenNetELL", "NodeInitELL", "EdgeInitELL", "GATAELL",
           "RowShard"]

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


class RowShard:
    """This rank's block of destination rows of an ``n_total``-row batch
    along mesh ``axis`` (JAX gotennet_ell.py's ``_shard_rows``): ``rows(x)``
    is the block of a whole ``[n_total, ...]`` tensor, ``unshard(x)`` the
    whole tensor again from every rank's block (zero padding, then an
    all-reduce over the axis: the blocks are disjoint, so the sum is their
    concatenation).  With ``axis=None`` both are the identity."""

    def __init__(self, axis: Optional[str], n_total: int):
        self.axis = axis
        self.n_total = n_total
        self.start, self.n_rows = 0, n_total
        if axis is not None:
            from gotennet_tpu_torch.parallel.collectives import (axis_index,
                                                                 axis_size)
            n = axis_size(axis)
            if n_total % n:
                raise ValueError(f"node capacity {n_total} not divisible by "
                                 f"the '{axis}'-axis size {n}")
            self.n_rows = n_total // n
            self.start = axis_index(axis) * self.n_rows

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        if self.axis is None:
            return x
        return x[self.start:self.start + self.n_rows]

    def unshard(self, x: torch.Tensor) -> torch.Tensor:
        if self.axis is None:
            return x
        from gotennet_tpu_torch.parallel.collectives import psum
        rest = tuple(x.shape[1:])
        after = self.n_total - self.start - self.n_rows
        full = torch.cat([x.new_zeros((self.start,) + rest), x,
                          x.new_zeros((after,) + rest)])
        return psum(full, self.axis)


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

    def forward(self, phi, h, gather: Gather,
                h_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``h_rows``: the destination rows of ``h`` (all of it on one
        device); ``h`` is the table the neighbours are gathered from."""
        h_rows = h if h_rows is None else h_rows
        return (h_rows[:, None, :] + gather(h)) * self.W_erp(phi)


def _aggr_k(aggr: str, data: torch.Tensor, mask: torch.Tensor
            ) -> torch.Tensor:
    """Masked reduction of ``data [N, K, ...]`` over the K slots: add, mean
    or max, with the reference's convention for a row without real slots
    (zeros)."""
    m = mask.to(data.dtype)
    while m.dim() < data.dim():
        m = m[..., None]
    if aggr == "add":
        return torch.sum(data * m, dim=1)
    if aggr == "mean":
        cnt = torch.sum(m, dim=1)
        return torch.sum(data * m, dim=1) / torch.clamp(cnt, min=1.0)
    if aggr == "max":
        # amax shares the gradient among equal maxima, as jnp.max does
        out = torch.amax(torch.where(m > 0, data, torch.full_like(data, _NEG)),
                         dim=1)
        any_real = torch.sum(m, dim=1) > 0
        return torch.where(any_real, out, torch.zeros_like(out))
    raise ValueError(f"Unknown aggr {aggr!r}")


class GATAELL(GATALayer):
    """One interaction: the message + aggregation, then (except in the last
    layer) the HTR update, each fused or unfused as ``kernel_paths``
    chose."""

    def __init__(self, cfg: GotenNetConfig, last_layer: bool = False):
        super().__init__(cfg, last_layer)

    def forward(self, h, X, t_ij, rl_ij, dist, nbr, nbr_mask, n_edges,
                gather: Gather, paths: Tuple[bool, bool],
                slots: Optional[fused_ell.Slots],
                keep: Optional[torch.Tensor] = None,
                shard: Optional[RowShard] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``h``, ``X``: the whole node state; the pair inputs hold the
        destination rows of ``shard`` (every row on one device).  ``keep``:
        the layer's ``[NR, K, H]`` attention keep mask, or None (no
        dropout)."""
        cfg = self.cfg
        shard = shard or RowShard(None, h.shape[0])
        rows, unshard = shard.rows, shard.unshard
        h, X = self.pre_norm(h, X)
        # the node projections run on this rank's rows; the source tables
        # are rebuilt whole for the gathers
        q, k, x_g, v = self.node_projections(rows(h))
        k, x_g, v = unshard(k), unshard(x_g), unshard(v)
        if paths[0]:
            d_h, dX = self._fused_message(t_ij, q, k, x_g, v, rl_ij, X, dist,
                                          nbr, nbr_mask, n_edges, slots, keep)
        else:
            d_h, dX = self._unfused_message(t_ij, q, k, x_g, v, rl_ij, X,
                                            dist, nbr_mask, n_edges, gather,
                                            keep)
        h = h + unshard(d_h)
        X = X + unshard(dX)
        if not self.updates:
            return h, X, t_ij

        EQ, EK = self.htr_tables(rows(X))
        EK = unshard(EK)
        info = self.info
        if not paths[1]:
            # the plain update (JAX gotennet_ell.py:523-574)
            w_ij = htr_pair_sum(EQ[:, None], gather(EK), rl_ij, cfg.lmax,
                                cfg.sep_htr, info["rej"])
            return h, X, self.update_tail(t_ij, w_ij)
        layer = self.gamma_t.dense_layers[0]
        return h, X, fused_htr.fused_htr_ell(
            t_ij, EQ, EK, rl_ij, nbr, layer.weight.t().contiguous(),
            layer.bias, lmax=cfg.lmax, sep_htr=cfg.sep_htr, rej=info["rej"],
            gate=info["gated"] or "", pair_dtype=cfg.pair_dtype, slots=slots)

    def _fused_message(self, t_ij, q, k, x_g, v, rl_ij, X, dist, nbr,
                       nbr_mask, n_edges, slots, keep):
        cfg = self.cfg
        env_signed, scale = self.fused_inputs(dist, nbr_mask, n_edges, keep)
        return fused_ell.fused_ell(
            t_ij, q, k, x_g, v, rl_ij, X, env_signed, scale, nbr,
            self.W_re.weight.t().contiguous(), self.W_re.bias,
            self.W_rs.weight.t().contiguous(), self.W_rs.bias, lmax=cfg.lmax,
            num_heads=cfg.num_heads, sep_dir=cfg.sep_dir,
            sep_tensor=cfg.sep_tensor, pair_dtype=cfg.pair_dtype, slots=slots)

    def _unfused_message(self, t_ij, q, k, x_g, v, rl_ij, X, dist, nbr_mask,
                         n_edges, gather: Gather, keep):
        """The message as plain tensor ops (JAX gotennet_ell.py:375-434):
        any activation and aggregation.  Returns ``(d_h, dX)``."""
        cfg = self.cfg
        D, H = cfg.n_atom_basis, cfg.num_heads
        N, K = nbr_mask.shape
        Dh, C = D // H, cfg.multiplier * D
        t_attn = self.W_re(t_ij)
        if self.act is not None:
            t_attn = self.act(t_attn)
        t_filter = self.W_rs(t_ij)                            # [N, K, C]
        # attention: SDDMM logits, masked softmax over the K slots
        logit = torch.sum(q.reshape(N, 1, H, Dh)
                          * gather(k).reshape(N, K, H, Dh)
                          * t_attn.reshape(N, K, H, Dh), dim=-1)
        attn = self.scale_attention(
            masked_softmax(logit, nbr_mask[..., None], 1), n_edges, keep)
        sea = (attn[..., None] * gather(v).reshape(N, K, H, C // H)
               ).reshape(N, K, C)
        spatial = (t_filter * gather(x_g)
                   * cosine_cutoff(dist, cfg.cutoff)[..., None])
        o_s, dX = self.split_message(spatial + sea, rl_ij, gather(X))
        return _aggr_k(cfg.aggr, o_s, nbr_mask), _aggr_k(cfg.aggr, dX,
                                                          nbr_mask)


class GotenNetELL(nn.Module):
    """The ELL-layout representation stack: ``(h [N, D], X [N, L, D])``
    from an ``ELLBatch``."""

    def __init__(self, cfg: GotenNetConfig):
        super().__init__()
        D = cfg.n_atom_basis
        self.cfg = cfg
        self.A_na = nn.Embedding(cfg.max_z, D)
        self.radial_basis = RadialBasis(cfg.radial_basis, cfg.n_rbf,
                                        cfg.cutoff, cfg.trainable_rbf)
        self.node_init = NodeInitELL(cfg)
        self.edge_init = EdgeInitELL(cfg)
        n = cfg.n_interactions
        self.gata_list = nn.ModuleList(
            GATAELL(cfg, last_layer=(i == n - 1)) for i in range(n))
        self.eqff_list = nn.ModuleList(EQFF(cfg) for _ in range(n))

    def forward(self, batch: ELLBatch,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``generator`` draws the attention keep masks (training with
        ``attn_dropout > 0``)."""
        cfg = self.cfg
        N, K = batch.nbr.shape
        with profiling.span("model.embed"):
            # under row sharding each rank owns NR = N / ranks destination
            # rows
            shard = RowShard(cfg.edge_axis, N)
            rows, NR = shard.rows, shard.n_rows
            paths = kernel_paths(cfg, "ell", N, NR, batch.gather_halo)
            nbr, nm, pos = rows(batch.nbr), rows(batch.nbr_mask), batch.pos
            idx = nbr.long()
            gather = _gather_fn(
                nbr, bool(batch.gather_window and batch.block_rows),
                cfg.pair_dtype)
            # neighbour geometry (source - destination); the self-loop's
            # distance is pinned to 0 and its unit vector to zeros
            vec = pos[idx] - rows(pos)[:, None, :]
            self_idx = (torch.arange(NR, device=idx.device)[:, None]
                        + shard.start)
            nonloop = nm & (idx != self_idx)
            d2 = torch.sum(vec ** 2, dim=-1)
            one = torch.ones_like(d2)
            dist = torch.where(nonloop,
                               torch.sqrt(torch.where(nonloop, d2, one)),
                               torch.zeros_like(d2))
            vec_n = torch.where(
                nonloop[..., None],
                vec / torch.where(nonloop, dist, one)[..., None], vec * 0.0)
            rl_ij = spherical_harmonics(vec_n, cfg.lmax).contiguous()

            z = batch.z.long()
            h = self.A_na(z)
            phi = self.radial_basis(dist)                     # [NR, K, R]
            h = shard.unshard(self.node_init(z, rows(h), gather, dist, phi,
                                             nonloop))
            t_ij = self.edge_init(phi, h, gather, h_rows=rows(h))
            # per-source real-edge counts; integers, so the scatter is exact
            counts = segment_sum(nm.reshape(-1).to(h.dtype),
                                 idx.reshape(-1), N, psum_axis=cfg.edge_axis)
            n_edges = counts[idx]
            X = torch.zeros(N, cfg.sh_dim, cfg.n_atom_basis, dtype=h.dtype,
                            device=h.device)
            # what the backward kernels sum table gradients by, once a batch
            slots = (fused_ell.source_slots(nbr, N)
                     if paths[0] and torch.is_grad_enabled() else None)
            masks = keep_masks(cfg, self.training, (NR, K, cfg.num_heads),
                               generator, h.device)
        for gata, eqff, keep in zip(self.gata_list, self.eqff_list, masks):
            with profiling.span("model.layer"):
                h, X, t_ij = run_layer(cfg, self.training, gata, h, X, t_ij,
                                       rl_ij, dist, nbr, nm, n_edges, gather,
                                       paths, slots, keep, shard)
                # EQFF is row-wise: this rank's rows, then the whole state
                h_r, X_r = eqff(rows(h), rows(X))
                h, X = shard.unshard(h_r), shard.unshard(X_r)
        return h, X
