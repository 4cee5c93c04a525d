"""GotenNet on the edge-list layout, the configuration, and what the three
layouts' layers share.

Counterpart of ``gotennet_tpu/models/gotennet.py``.  ``GotenNetConfig``
keeps the JAX package's field names and defaults, with ``pair_dtype`` and
``node_dtype`` as ``torch.dtype``s.  ``scan_layers`` changes the form of
the dense layout's parameter tree where it meets the JAX package's
(``utils.params``): the layers stay one module each here.

``GotenNet`` (with ``NodeInit``, ``EdgeInit`` and ``GATA``) runs over a
``GraphBatch``'s flat edge list: gathers by ``edge_src`` / ``edge_dst`` and
masked segment reductions (``graph/segment.py``), as the JAX package does
with XLA gathers and ``jax.ops.segment_*``; it reaches no kernel, and
ignores ``fused``, ``fused_htr`` and ``pair_dtype`` as the JAX edge layer
does.  With ``cfg.edge_axis`` (edge partitioning) each rank of that mesh
axis holds a block of the edge list and the whole node state, and every
segment reduction ends in one all-reduce over the axis.  ``GATALayer`` is
what the edge, dense and ELL interaction layers share: their parameters
under the reference state-dict names, the optional pre-norms
(``layernorm``, ``steerable_norm``), the message arithmetic the layouts
have in common (the unmerged node projections, the fused kernels'
``env_signed`` and scale, the post-softmax scale and dropout, the split of
the message ``o`` into its scalar and steerable parts; ``masked_softmax``
over a dense axis) and the tail of the plain HTR update (``gamma_t``, the
``gamma_w`` chain, the gates; ``update_tail``).  ``kernel_paths`` decides,
for every layout, which kernels a layer runs.

Attention dropout (``attn_dropout > 0``, in training only) draws one
Bernoulli keep mask per interaction layer from an explicit
``torch.Generator`` (``keep_masks``, through ``attention_keep_mask``, which
a test may replace to hand in a mask of its own).  The fused layers fold it
into the post-softmax scale, ``scale * keep / (1 - p)``, the plain ones
drop the attention with it, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from gotennet_tpu_torch.graph.batch import GraphBatch
from gotennet_tpu_torch.graph.segment import (_SOFTMAX_EPS, segment_max,
                                              segment_mean, segment_softmax,
                                              segment_sum)
from gotennet_tpu_torch.nn.dense import MLP, Dense
from gotennet_tpu_torch.nn.norms import TensorLayerNorm
from gotennet_tpu_torch.ops.activations import get_activation, is_silu_like
from gotennet_tpu_torch.ops.cutoffs import cosine_cutoff
from gotennet_tpu_torch.ops.fused_ell import pick_chunking
from gotennet_tpu_torch.ops.rbf import RadialBasis
from gotennet_tpu_torch.ops.spherical import (degree_slices, num_sh_components,
                                              spherical_harmonics)

__all__ = ["GotenNetConfig", "EQFF", "parse_edge_updates", "kernel_paths",
           "attention_keep_mask", "keep_masks", "run_layer", "GATALayer",
           "htr_pair_sum", "degree_index", "masked_softmax", "NodeInit",
           "EdgeInit", "GATA", "GotenNet"]

_NEG = -1e30          # masked logit; exp(_NEG - max) is exactly 0 in f32


def parse_edge_updates(edge_updates: Union[bool, str]) -> dict:
    """Parse the reference's ``edge_updates`` feature string into an
    update-info dict (same result as the JAX package's parser)."""
    info = {"gated": False, "rej": True, "mlp": False, "mlpa": False,
            "lin_w": 0, "lin_ln": 0}
    parts = edge_updates.split("_") if isinstance(edge_updates, str) else []
    allowed = {"gated", "gatedt", "norej", "norm", "mlp", "mlpa", "act",
               "linw", "linwa", "ln", "postln"}
    bad = [p for p in parts if p not in allowed]
    if bad:
        raise ValueError(
            f"Invalid edge update parts {bad}; allowed {sorted(allowed)}")
    for p, key, val in (("gated", "gated", "gated"),
                        ("gatedt", "gated", "gatedt"),
                        ("act", "gated", "act"), ("norej", "rej", False),
                        ("mlp", "mlp", True), ("mlpa", "mlpa", True),
                        ("linw", "lin_w", 1), ("linwa", "lin_w", 2),
                        ("ln", "lin_ln", 1), ("postln", "lin_ln", 2)):
        if p in parts:
            info[key] = val
    return info


@dataclasses.dataclass(frozen=True)
class GotenNetConfig:
    """Hyper-parameters; defaults follow the shipped reference config.

    ``fused`` defaults to True here (False in the JAX package), the path
    this package serves and trains energies on; the dense and ELL layouts
    take either, training on forces takes ``fused=False``, and the edge
    layout ignores it."""

    n_atom_basis: int = 256
    n_interactions: int = 4
    lmax: int = 2
    num_heads: int = 8
    n_rbf: int = 32
    cutoff: float = 5.0
    radial_basis: str = "expnorm"
    trainable_rbf: bool = False
    activation: str = "swish"
    max_z: int = 100
    epsilon: float = 1e-8
    weight_init: str = "xavier_uniform"
    bias_init: str = "zeros"
    layernorm: str = ""
    steerable_norm: str = ""
    attn_dropout: float = 0.0
    edge_updates: Union[bool, str] = True
    scale_edge: bool = False
    aggr: str = "add"
    evec_dim: Optional[int] = None
    emlp_dim: Optional[int] = None
    sep_htr: bool = True
    sep_dir: bool = True
    sep_tensor: bool = True
    edge_ln: str = ""
    max_num_neighbors: int = 32
    # mesh axis (parallel.mesh) whose ranks split the graph: the edge list
    # on the edge layout, the destination rows on the ELL one; None: one
    # device.  See graph/segment.py's psum_axis.
    edge_axis: Optional[str] = None
    # storage type of the large per-pair tensors; reductions stay f32
    pair_dtype: torch.dtype = torch.float32
    # compute type of the per-layer node projections
    node_dtype: torch.dtype = torch.float32
    fused: bool = True
    # keep the inter-layer edge state t_ij in pair_dtype
    edge_state_pair_dtype: bool = False
    fused_htr: bool = False
    # recompute each interaction layer in the backward pass
    # (torch.utils.checkpoint) instead of keeping its activations
    remat: bool = True
    # ELL layout: the most node-table rows the JAX package's fused kernels
    # take in one call (it cuts larger tables into halo windows); the
    # port's kernels read the whole table at any size
    fused_table_rows: int = 2048
    merge_proj: bool = True
    # the dense layout's n-1 homogeneous layers as one layer-stacked tree
    # where parameters cross to the JAX package (utils.params); the edge and
    # ELL layouts ignore it, as the JAX package's do
    scan_layers: bool = False
    # position gradients through the fused message; None follows the
    # head (GotenModel resolves it from ``derivative``), False refuses them
    pos_grads: Optional[bool] = None

    def __post_init__(self):
        if self.n_atom_basis % self.num_heads:
            raise ValueError(
                f"n_atom_basis={self.n_atom_basis} must be divisible by "
                f"num_heads={self.num_heads}")
        if self.lmax < 1:
            raise ValueError("lmax must be >= 1")
        if (self.n_atom_basis * self.multiplier) % self.num_heads:
            raise ValueError(
                "multiplier * n_atom_basis must be divisible by num_heads")
        if self.aggr not in ("add", "mean", "max"):
            raise ValueError(f"unknown aggr {self.aggr!r}")
        parse_edge_updates(self.edge_updates)   # validates the string
        for name in ("pair_dtype", "node_dtype"):
            if getattr(self, name) not in (torch.float32, torch.bfloat16):
                raise ValueError(f"{name} must be torch.float32 or "
                                 f"torch.bfloat16, got {getattr(self, name)}")
        if self.fused:
            if not is_silu_like(self.activation):
                raise ValueError(
                    "fused=True hardcodes silu in the message kernel; got "
                    f"activation={self.activation!r} (fused=False takes "
                    "any activation)")
            if self.aggr != "add":
                raise ValueError("fused=True supports aggr='add' only")

    @property
    def sh_dim(self) -> int:
        return num_sh_components(self.lmax)

    @property
    def multiplier(self) -> int:
        m = 3
        if self.sep_dir:
            m += self.lmax - 1
        if self.sep_tensor:
            m += self.lmax - 1
        return m


def kernel_paths(cfg: GotenNetConfig, layout: str, N: Optional[int] = None,
                 NR: Optional[int] = None, halo: Optional[int] = None
                 ) -> Tuple[bool, bool]:
    """Whether a layer of ``layout`` runs its message and its HTR update
    through the fused kernels, ``(message, update)``, as the JAX package
    chooses.  The edge layout runs no kernel.  The dense message is fused
    with ``fused``.  The ELL message (JAX gotennet_ell.py:306-321,
    :448-487) of an ``N``-row node table with ``NR`` destination rows is
    fused with ``fused`` unless the table is above ``fused_table_rows`` (0:
    no limit) and no halo-windowed chunking exists for it (no ``halo``, or
    ``pick_chunking`` finds no geometry); where the JAX package chunks, the
    port's kernels take the whole table.  The update is fused with the
    fused message and ``fused_htr``, for the grammar the kernel computes
    (rejection on or off, the gates; no MLP or linear ``gamma_w`` part, no
    ``edge_ln``, ``evec_dim`` at ``n_atom_basis``; JAX
    gotennet_dense.py:318-321); the ELL layer asks besides for an
    activation spelt "silu" or "swish" (gotennet_ell.py:512-516), where the
    dense one takes any the config normalises to silu."""
    if layout == "edge":
        return False, False
    info = parse_edge_updates(cfg.edge_updates)
    update = (cfg.fused_htr and not info["mlp"] and not info["mlpa"]
              and info["lin_w"] == 0 and info["lin_ln"] == 0
              and cfg.edge_ln == ""
              and (cfg.evec_dim or cfg.n_atom_basis) == cfg.n_atom_basis)
    if layout == "dense":
        return cfg.fused, cfg.fused and update
    fits = (not cfg.fused_table_rows or N <= cfg.fused_table_rows
            or (halo is not None and pick_chunking(
                NR, N, halo, cfg.fused_table_rows) is not None))
    message = cfg.fused and fits
    return message, (message and update
                     and cfg.activation in ("swish", "silu"))


def attention_keep_mask(shape: Sequence[int], rate: float,
                        generator: torch.Generator,
                        device: torch.device) -> torch.Tensor:
    """A boolean Bernoulli(1 - rate) keep mask of ``shape``, drawn from
    ``generator`` on ``device``."""
    return torch.rand(tuple(shape), generator=generator,
                      device=device) < 1.0 - rate


def keep_masks(cfg: GotenNetConfig, training: bool, shape: Sequence[int],
               generator: Optional[torch.Generator],
               device: torch.device) -> List[Optional[torch.Tensor]]:
    """One attention keep mask ``shape`` (``[..., H]``) per interaction
    layer, in layer order, when ``training`` with ``attn_dropout > 0``;
    Nones otherwise (no draw)."""
    if not (training and cfg.attn_dropout > 0.0):
        return [None] * cfg.n_interactions
    if generator is None:
        raise ValueError("attention dropout in training draws from an "
                         "explicit torch.Generator; none was given")
    return [attention_keep_mask(shape, cfg.attn_dropout, generator, device)
            for _ in range(cfg.n_interactions)]


def run_layer(cfg: GotenNetConfig, training: bool, layer: nn.Module,
              *args):
    """``layer(*args)``, recomputed in the backward pass under
    ``torch.utils.checkpoint`` when ``cfg.remat`` in training with autograd
    on (the same values either way)."""
    if cfg.remat and training and torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint
        return checkpoint(layer, *args, use_reentrant=False)
    return layer(*args)


class EQFF(nn.Module):
    """Equivariant feed-forward: context = [h ; ||X W_vu||], two-layer
    MLP, residual scalar and gated steerable updates."""

    def __init__(self, cfg: GotenNetConfig):
        super().__init__()
        act = get_activation(cfg.activation)
        D = cfg.n_atom_basis
        nd = None if cfg.node_dtype == torch.float32 else cfg.node_dtype
        kw = dict(weight_init=cfg.weight_init, bias_init=cfg.bias_init,
                  dtype=nd)
        self.epsilon = cfg.epsilon
        self.gamma_m = nn.ModuleList([
            Dense(2 * D, D, activation=act, **kw),
            Dense(D, 2 * D, **kw)])
        self.W_vu = Dense(D, D, use_bias=False, **kw)

    def forward(self, h: torch.Tensor, X: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        D = h.shape[-1]
        X_p = self.W_vu(X)
        # the norm reduction accumulates f32; X_p stays in node_dtype
        X_pn = torch.sqrt(torch.sum(X_p.float() ** 2, dim=-2) + self.epsilon)
        m = self.gamma_m[1](self.gamma_m[0](torch.cat([h, X_pn], dim=-1)))
        m1, m2 = m[..., :D], m[..., D:]
        return h + m1, X + m2[..., None, :].to(X.dtype) * X_p


# ---- what the three layouts' interaction layers share ----------------------
def degree_index(lmax: int, device) -> torch.Tensor:
    """The degree block (l - 1) of each spherical-harmonic component."""
    return torch.tensor([l - 1 for l in range(1, lmax + 1)
                         for _ in range(2 * l + 1)], device=device)


def masked_softmax(logit: torch.Tensor, real: torch.Tensor, dim: int
                   ) -> torch.Tensor:
    """Softmax of ``logit`` over its axis ``dim`` (the sources of a dense
    pair tensor, the slots of an ELL row) among the ``real`` entries:
    masked entries come out exactly zero, the maximum shift is detached and
    the sum guarded as the reference's."""
    logit = torch.where(real, logit, torch.full_like(logit, _NEG))
    top = torch.amax(logit, dim=dim, keepdim=True).detach()
    expd = torch.exp(logit - top) * real
    return expd / (torch.sum(expd, dim=dim, keepdim=True) + _SOFTMAX_EPS)


def htr_pair_sum(EQ_i: torch.Tensor, EK_j: torch.Tensor, rl: torch.Tensor,
                 lmax: int, sep_htr: bool, rej: bool) -> torch.Tensor:
    """The HTR update's per-pair inner products ``w_ij``, the m axis being
    the second last of ``EQ_i`` / ``EK_j`` (which broadcast) and the last of
    ``rl``: with ``rej`` each side's projection on ``r_l`` (``-r_l``) is
    rejected first; with ``sep_htr`` per degree block, summed, else over all
    components at once (JAX gotennet.py:457-476)."""
    def reject(rep, r):
        proj = torch.sum(rep * r[..., None], dim=-2, keepdim=True)
        return rep - proj * r[..., None]

    if sep_htr:
        # the degree sums add up in float32, as JAX's float32 zeros do
        w_ij = 0.0
        for lo, hi in degree_slices(lmax):
            eq_l, ek_l = EQ_i[..., lo:hi, :], EK_j[..., lo:hi, :]
            if rej:
                r_l = rl[..., lo:hi]
                eq_l, ek_l = reject(eq_l, r_l), reject(ek_l, -r_l)
            w_ij = w_ij + torch.sum(eq_l * ek_l, dim=-2).float()
        return w_ij
    if not rej:
        return torch.sum(EQ_i * EK_j, dim=-2)
    return torch.sum(reject(EQ_i.expand_as(EK_j), rl) * reject(EK_j, -rl),
                     dim=-2)


class GATALayer(nn.Module):
    """The parameters of one interaction layer under the reference
    state-dict names (``gamma_s``, ``W_q``, ``W_k``, ``gamma_v``, ``W_re``,
    ``W_rs``, ``layernorm``; except in the last layer and with
    ``edge_updates``, ``gamma_t``, ``W_vq``, ``W_vk``, ``gamma_w`` and
    ``W_edp``), the optional pre-norms, and the tail of the plain HTR
    update, which the edge, dense and ELL layers share, and the message
    arithmetic they have in common.

    ``node_dtype`` is the compute type of the node projections (q, k, x_g,
    v, EQ, EK) and ``pair_dtype`` that of ``W_re``, ``W_rs``, ``gamma_t``
    and ``W_edp``, as each layout's JAX layer casts them (None: float32).
    ``W_re`` carries no activation: the fused kernels apply silu to its
    product themselves, the plain messages ``act``."""

    def __init__(self, cfg: GotenNetConfig, last_layer: bool,
                 node_dtype: Optional[torch.dtype] = None,
                 pair_dtype: Optional[torch.dtype] = None):
        super().__init__()
        D, mult = cfg.n_atom_basis, cfg.multiplier
        act = get_activation(cfg.activation)
        kw = dict(weight_init=cfg.weight_init, bias_init=cfg.bias_init)
        nd, pd = node_dtype, pair_dtype
        self.cfg = cfg
        self.act = act
        self.last_layer = last_layer
        self.info = parse_edge_updates(cfg.edge_updates)
        self.gamma_s = nn.ModuleList([
            Dense(D, D, activation=act, **kw, dtype=nd),
            Dense(D, mult * D, **kw, dtype=nd)])
        self.W_q = Dense(D, D, **kw, dtype=nd)
        self.W_k = Dense(D, D, **kw, dtype=nd)
        self.gamma_v = nn.ModuleList([
            Dense(D, D, activation=act, **kw, dtype=nd),
            Dense(D, mult * D, **kw, dtype=nd)])
        self.W_re = Dense(D, D, **kw, dtype=pd)
        self.W_rs = Dense(D, mult * D, **kw, dtype=pd)
        self.updates = bool(cfg.edge_updates) and not last_layer
        if self.updates:
            info = self.info
            E = cfg.evec_dim or D
            if info["mlp"] or info["mlpa"]:
                self.gamma_t = MLP(
                    [D, cfg.emlp_dim or D, D], activation=act,
                    last_activation=None if info["mlp"] else act,
                    norm=cfg.edge_ln, **kw, dtype=pd)
            else:
                self.gamma_t = MLP([D, D], activation=act, last_activation=act,
                                   norm=cfg.edge_ln, **kw, dtype=pd)
            self.W_vq = Dense(D, E, use_bias=False, **kw, dtype=nd)
            if cfg.sep_htr:
                self.W_vk = nn.ModuleList(
                    Dense(D, E, use_bias=False, **kw, dtype=nd)
                    for _ in range(cfg.lmax))
            else:
                self.W_vk = Dense(D, E, use_bias=False, **kw, dtype=nd)
            if info["lin_w"]:
                # the reference's gamma_w Sequential: its LayerNorm at 0
                if info["lin_ln"] == 1:
                    self.gamma_w = nn.ModuleList([nn.LayerNorm(E, eps=1e-5)])
                self.W_edp = Dense(E, D, norm="layer" if info["lin_ln"] == 2
                                   else "", **kw, dtype=pd)
        self.layernorm = (nn.LayerNorm(D, eps=1e-5) if cfg.layernorm
                          else None)
        self.tensor_layernorm = (TensorLayerNorm(D, cfg.lmax)
                                 if cfg.steerable_norm else None)

    def pre_norm(self, h: torch.Tensor, X: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``layernorm`` on h and ``steerable_norm`` on X, each when set;
        the residual updates of the layer add to the normed values."""
        if self.layernorm is not None:
            h = self.layernorm(h)
        if self.tensor_layernorm is not None:
            X = self.tensor_layernorm(X)
        return h, X

    def node_projections(self, h: torch.Tensor
                         ) -> Tuple[torch.Tensor, ...]:
        """q, k, x_g, v from ``h`` through the unmerged projections."""
        return (self.W_q(h), self.W_k(h),
                self.gamma_s[1](self.gamma_s[0](h)),
                self.gamma_v[1](self.gamma_v[0](h)))

    def fused_inputs(self, dist: torch.Tensor, mask: torch.Tensor,
                     n_edges: torch.Tensor, keep: Optional[torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The fused message kernels' ``env_signed`` (the cutoff on the
        ``mask``ed pairs, -1 elsewhere: its sign carries the mask) and
        post-softmax ``scale`` (``sqrt(n_edges)`` with ``scale_edge``, over
        sqrt(D)), with dropout's ``keep`` folded in per head."""
        cfg = self.cfg
        D = cfg.n_atom_basis
        env_signed = torch.where(mask, cosine_cutoff(dist, cfg.cutoff),
                                 torch.full_like(dist, -1.0))
        if cfg.scale_edge:
            scale = torch.sqrt(n_edges) / math.sqrt(D)
        else:
            scale = torch.full_like(dist, 1.0 / math.sqrt(D))
        if keep is not None:
            scale = (scale[..., None] * keep.to(scale.dtype)
                     / (1.0 - cfg.attn_dropout))
        return env_signed, scale

    def scale_attention(self, attn: torch.Tensor, n_edges: torch.Tensor,
                        keep: Optional[torch.Tensor]) -> torch.Tensor:
        """The plain messages' post-softmax scale of ``attn [..., H]``
        (``n_edges`` over its leading axes; ``sqrt(n_edges)`` with
        ``scale_edge``, over sqrt(D)), then flax's Dropout with ``keep``:
        kept entries divided by the keep rate."""
        cfg = self.cfg
        D = cfg.n_atom_basis
        if cfg.scale_edge:
            attn = attn * (torch.sqrt(n_edges)[..., None] / math.sqrt(D))
        else:
            attn = attn / math.sqrt(D)
        if keep is not None:
            attn = torch.where(keep, attn / (1.0 - cfg.attn_dropout),
                               torch.zeros_like(attn))
        return attn

    def split_message(self, o: torch.Tensor, rl_ij: torch.Tensor,
                      X_j: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(o_s, dX_R + dX_X)`` of a plain message ``o [..., C]``: its
        scalar block, and the direction blocks times ``rl_ij [..., L]``
        plus the tensor blocks times the sources' ``X_j [..., L, D]``, one
        block per degree with ``sep_dir`` / ``sep_tensor``, else one
        shared."""
        cfg, lmax = self.cfg, self.cfg.lmax
        chunks = list(torch.split(o, cfg.n_atom_basis, dim=-1))
        o_s, rest = chunks[0], chunks[1:]
        deg = degree_index(lmax, o.device)
        if cfg.sep_dir:
            o_d, rest = torch.stack(rest[:lmax], dim=-2), rest[lmax:]
            dX_R = rl_ij[..., None] * o_d[..., deg, :]
        else:
            o_d, rest = rest[0], rest[1:]
            dX_R = rl_ij[..., None] * o_d[..., None, :]
        if cfg.sep_tensor:
            dX_X = X_j * torch.stack(rest[:lmax], dim=-2)[..., deg, :]
        else:
            dX_X = X_j * rest[0][..., None, :]
        return o_s, dX_R + dX_X

    def htr_tables(self, X: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """EQ = X W_vq and EK (X W_vk_l per degree block with ``sep_htr``),
        ``[..., L, evec_dim]`` in the node compute type."""
        if not self.cfg.sep_htr:
            return self.W_vq(X), self.W_vk(X)
        return self.W_vq(X), torch.cat(
            [self.W_vk[l](X[..., lo:hi, :])
             for l, (lo, hi) in enumerate(degree_slices(self.cfg.lmax))],
            dim=-2)

    def update_tail(self, t_ij: torch.Tensor, w_ij: torch.Tensor
                    ) -> torch.Tensor:
        """``t_ij + gamma_t(t_ij) * gate(gamma_w(w_ij))`` (JAX
        gotennet.py:478-509): ``gamma_t`` one layer, or two with ``mlp`` /
        ``mlpa`` (``edge_ln`` normalising the hidden one); with ``linw`` /
        ``linwa`` the inner products in float32 through ``ln``'s LayerNorm,
        ``act`` (``linwa``) and ``W_edp`` (normed with ``postln``); then the
        ``gated`` / ``gatedt`` / ``act`` gate.  The product is added in
        ``t_ij``'s type."""
        info = self.info
        gt = self.gamma_t(t_ij)
        gw = w_ij
        if info["lin_w"]:
            gw = gw.float()
            if info["lin_ln"] == 1:
                gw = self.gamma_w[0](gw)
            if info["lin_w"] == 2:
                gw = self.act(gw)
            gw = self.W_edp(gw)
        gate = {"gatedt": torch.tanh, "gated": torch.sigmoid,
                "act": torch.nn.functional.silu}.get(info["gated"])
        if gate is not None:
            gw = gate(gw)
        return t_ij + (gt * gw).to(t_ij.dtype)


# ---- the edge-list layout ---------------------------------------------------
def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The rows of ``x`` at ``idx`` (int64): an ``index_select``, whose
    backward is an ``index_add_`` (the scatter-add JAX's gather transposes
    to); advanced indexing's backward sorts the indices instead, some 20x
    slower at the flagship width on the card."""
    return x.index_select(0, idx)


def _segment_aggregate(aggr: str, data: torch.Tensor, seg: torch.Tensor,
                       n: int, mask: torch.Tensor,
                       psum_axis: Optional[str] = None) -> torch.Tensor:
    """Masked segment reduction; a segment without a real row gives zeros,
    also under ``max``."""
    if aggr == "add":
        return segment_sum(data, seg, n, mask, psum_axis)
    if aggr == "mean":
        return segment_mean(data, seg, n, mask, psum_axis)
    if aggr == "max":
        out = segment_max(data, seg, n, mask, psum_axis)
        c = segment_sum(mask.to(torch.int32), seg, n, psum_axis=psum_axis)
        while c.dim() < out.dim():
            c = c[..., None]
        return torch.where(c > 0, out, torch.zeros_like(out))
    raise ValueError(f"Unknown aggr {aggr!r}")


class NodeInit(nn.Module):
    """Neighbour atom-type embeddings gated by a radial filter under the
    cosine cutoff, summed over the non-loop edges, fused with the centre
    embedding (JAX gotennet.py:287-318)."""

    def __init__(self, cfg: GotenNetConfig):
        super().__init__()
        d = cfg.n_atom_basis
        kw = dict(weight_init=cfg.weight_init, bias_init=cfg.bias_init)
        self.cfg = cfg
        self.A_nbr = nn.Embedding(cfg.max_z, d)
        # the reference's W_ndp is a one-layer MLP
        self.W_ndp = MLP([cfg.n_rbf, d], **kw)
        self.W_nrd_nru = MLP([2 * d, d, d],
                             activation=get_activation(cfg.activation),
                             norm="layer", **kw)

    def forward(self, z, h, edge_src, edge_dst, edge_dist, phi, edge_mask
                ) -> torch.Tensor:
        r_feat = self.W_ndp(phi) * cosine_cutoff(edge_dist,
                                                 self.cfg.cutoff)[:, None]
        # self-loops add nothing
        msg_mask = edge_mask & (edge_src != edge_dst)
        msg = take(self.A_nbr(z), edge_src.long()) * r_feat
        m_i = segment_sum(msg, edge_dst, h.shape[0], msg_mask,
                          self.cfg.edge_axis)
        return self.W_nrd_nru(torch.cat([h, m_i], dim=-1))


class EdgeInit(nn.Module):
    """t_ij = (h_i + h_j) * W_erp(phi_ij)."""

    def __init__(self, cfg: GotenNetConfig):
        super().__init__()
        self.W_erp = Dense(cfg.n_rbf, cfg.n_atom_basis,
                           weight_init="xavier_uniform", bias_init="zeros")

    def forward(self, phi, h, edge_src, edge_dst) -> torch.Tensor:
        return ((take(h, edge_dst.long()) + take(h, edge_src.long()))
                * self.W_erp(phi))


class GATA(GATALayer):
    """One interaction over the edge list (JAX gotennet.py:335-511): the
    SDDMM attention logits, a softmax per destination over its real edges,
    the spatial filter path, the steerable message, segment aggregation,
    then (except in the last layer) the HTR update.  The node projections
    compute in ``node_dtype``; everything else in float32."""

    def __init__(self, cfg: GotenNetConfig, last_layer: bool = False):
        nd = None if cfg.node_dtype == torch.float32 else cfg.node_dtype
        super().__init__(cfg, last_layer, node_dtype=nd)

    def forward(self, h, X, t_ij, rl_ij, edge_dist, edge_src, edge_dst,
                edge_mask, n_edges, keep: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``keep``: the layer's ``[E, H]`` attention keep mask, or None (no
        dropout)."""
        cfg = self.cfg
        D, H = cfg.n_atom_basis, cfg.num_heads
        Dh, C = D // H, cfg.multiplier * D
        N, E = h.shape[0], edge_src.shape[0]
        src, dst = edge_src.long(), edge_dst.long()
        h, X = self.pre_norm(h, X)
        q, k, x_g, v = self.node_projections(h)
        t_attn = self.W_re(t_ij)
        if self.act is not None:
            t_attn = self.act(t_attn)
        t_filter = self.W_rs(t_ij)

        logit = torch.sum(take(q.reshape(N, H, Dh), dst)
                          * take(k.reshape(N, H, Dh), src)
                          * t_attn.reshape(E, H, Dh), dim=-1)      # [E, H]
        attn = self.scale_attention(
            segment_softmax(logit, edge_dst, N, edge_mask, cfg.edge_axis),
            n_edges, keep)
        sea = (attn[..., None] * take(v, src).reshape(E, H, C // H)
               ).reshape(E, C)
        spatial = t_filter * take(x_g, src) * cosine_cutoff(
            edge_dist, cfg.cutoff)[:, None]
        o_s, dX = self.split_message(spatial + sea, rl_ij, take(X, src))
        h = h + _segment_aggregate(cfg.aggr, o_s, edge_dst, N, edge_mask,
                                   cfg.edge_axis)
        X = X + _segment_aggregate(cfg.aggr, dX, edge_dst, N, edge_mask,
                                   cfg.edge_axis)
        if not self.updates:
            return h, X, t_ij
        EQ, EK = self.htr_tables(X)
        w_ij = htr_pair_sum(take(EQ, dst), take(EK, src), rl_ij, cfg.lmax,
                            cfg.sep_htr, self.info["rej"])
        return h, X, self.update_tail(t_ij, w_ij)


def edge_geometry(pos: torch.Tensor, edge_src: torch.Tensor,
                  edge_dst: torch.Tensor, edge_mask: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(vec [E, 3], dist [E], nonloop [E])`` of an edge list, ``vec`` =
    pos_src - pos_dst.  A self-loop's or padded edge's distance is 0, under
    a double ``where`` so that second derivatives there stay finite."""
    vec = take(pos, edge_src.long()) - take(pos, edge_dst.long())
    nonloop = edge_mask & (edge_src != edge_dst)
    sq = torch.sum(vec ** 2, dim=-1)
    dist = torch.where(nonloop, torch.sqrt(torch.where(
        nonloop, sq, torch.ones_like(sq))), torch.zeros_like(sq))
    return vec, dist, nonloop


class GotenNet(nn.Module):
    """The edge-list representation stack (JAX gotennet.py:543-611):
    ``(h [N, D], X [N, L, D])`` from a ``GraphBatch``, edge geometry
    computed from the positions (differentiable: force heads)."""

    def __init__(self, cfg: GotenNetConfig):
        super().__init__()
        D = cfg.n_atom_basis
        self.cfg = cfg
        self.A_na = nn.Embedding(cfg.max_z, D)
        self.radial_basis = RadialBasis(cfg.radial_basis, cfg.n_rbf,
                                        cfg.cutoff, cfg.trainable_rbf)
        self.node_init = NodeInit(cfg)
        self.edge_init = EdgeInit(cfg)
        n = cfg.n_interactions
        self.gata_list = nn.ModuleList(
            GATA(cfg, last_layer=(i == n - 1)) for i in range(n))
        self.eqff_list = nn.ModuleList(EQFF(cfg) for _ in range(n))

    def forward(self, batch: GraphBatch,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``generator`` draws the attention keep masks (training with
        ``attn_dropout > 0``)."""
        cfg = self.cfg
        src, dst, em = batch.edge_src, batch.edge_dst, batch.edge_mask
        N, E = batch.num_nodes, batch.num_edges
        vec, dist, nonloop = edge_geometry(batch.pos, src, dst, em)
        z = batch.z.long()
        h = self.A_na(z)
        phi = self.radial_basis(dist)                             # [E, R]
        h = self.node_init(z, h, src, dst, dist, phi, em)
        t_ij = self.edge_init(phi, h, src, dst)
        # unit vectors on real non-loop edges; the rest keep theirs (zero)
        safe_d = torch.where(nonloop, dist, torch.ones_like(dist))
        vec_n = torch.where(nonloop[:, None], vec / safe_d[:, None], vec)
        rl_ij = spherical_harmonics(vec_n, cfg.lmax)              # [E, L]
        # per-source real-edge counts
        n_edges = take(segment_sum(em.to(h.dtype), src, N,
                                   psum_axis=cfg.edge_axis), src.long())
        X = torch.zeros(N, cfg.sh_dim, cfg.n_atom_basis, dtype=h.dtype,
                        device=h.device)
        masks = keep_masks(cfg, self.training, (E, cfg.num_heads), generator,
                           h.device)
        for gata, eqff, keep in zip(self.gata_list, self.eqff_list, masks):
            h, X, t_ij = run_layer(cfg, self.training, gata, h, X, t_ij,
                                   rl_ij, dist, src, dst, em, n_edges, keep)
            h, X = eqff(h, X)
        return h, X
