"""GotenNet (ICLR 2025) in plain PyTorch, on dense ``[G, M, M]`` pair
blocks, as a function of a dict of named tensors.

The names are the reference implementation's state-dict names, so the
same dict loads into the program with ``load_state_dict``.  It covers the
published model as the benchmark's configurations state it: expnorm radial
basis, cosine cutoff, the neighbour cap (nearest first, ties by index,
self-loops counted as an edge list counts them), the node and edge
initialisation, GATA with multi-head attention over a destination's real
pairs (``sep_dir`` and ``sep_tensor``), the HTR edge update with rejection
(``sep_htr``, no gate), EQFF, and the Atomwise head.  Departures from the
edge-list form, none of which changes the mathematics: every pair sum runs
over a dense j axis with the pairs that are not edges masked to zero, and
the HTR inner product with rejection is expanded as
``S - pq * pk * (2 - |r|^2)``.

The model computes in the type of its weights: the positions and the
geometry (distances, unit vectors) keep the positions' type and are cast
where they enter the model.  With bfloat16 weights this is the benchmark's
lower-precision control, the whole model one step below the float32 that
the configurations state.  ``pair_type`` rounds the pair tensors (the edge
state, the pair projections, the node tensors where they meet a pair, and
each pair's message), and their cotangents on the way back, to a storage
type at the points where a program storing its pairs in that type rounds
them; ``(type, False)`` rounds the forward values alone.  In float32 with
float8 (e4m3) pair values this is the other control, one step below the
bfloat16 pairs that the configurations state; with bfloat16 pairs it is a
witness of the program's own precision.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
R = "representation"
HEAD = "output_modules.0"


def multiplier(m: dict) -> int:
    """Channel blocks of a message: scalar, direction and tensor parts."""
    extra = m["lmax"] - 1
    return 3 + (extra if m["sep_dir"] else 0) + (extra if m["sep_tensor"]
                                                  else 0)


def sh_dim(m: dict) -> int:
    return (m["lmax"] + 1) ** 2 - 1


def degree_slices(lmax: int) -> List[Tuple[int, int]]:
    return [(l * l - 1, (l + 1) ** 2 - 1) for l in range(1, lmax + 1)]


def param_spec(m: dict) -> List[Tuple[str, tuple, str]]:
    """``(name, shape, init)`` of every tensor of the model ``m`` (a
    configuration's ``model`` group): ``xavier`` (uniform, weights
    ``[out, in]``), ``zeros``, ``ones``, ``normal`` (embeddings),
    ``normal_pad0`` (the centre embedding, row 0 zero), ``mean`` and
    ``stddev`` (the head's standardisation)."""
    D, Rb, n = m["n_atom_basis"], m["n_rbf"], m["n_interactions"]
    C, hid = multiplier(m) * D, m["head_hidden"]
    spec: List[Tuple[str, tuple, str]] = []

    def dense(name, i, o, bias=True, norm=False):
        spec.append((f"{name}.weight", (o, i), "xavier"))
        if bias:
            spec.append((f"{name}.bias", (o,), "zeros"))
        if norm:
            spec.append((f"{name}.norm.weight", (o,), "ones"))
            spec.append((f"{name}.norm.bias", (o,), "zeros"))

    spec.append((f"{R}.A_na.weight", (m["max_z"], D), "normal_pad0"))
    spec.append((f"{R}.node_init.A_nbr.weight", (m["max_z"], D), "normal"))
    dense(f"{R}.node_init.W_ndp.dense_layers.0", Rb, D)
    dense(f"{R}.node_init.W_nrd_nru.dense_layers.0", 2 * D, D, norm=True)
    dense(f"{R}.node_init.W_nrd_nru.dense_layers.1", D, D)
    dense(f"{R}.edge_init.W_erp", Rb, D)
    for i in range(n):
        g = f"{R}.gata_list.{i}"
        dense(f"{g}.gamma_s.0", D, D)
        dense(f"{g}.gamma_s.1", D, C)
        dense(f"{g}.W_q", D, D)
        dense(f"{g}.W_k", D, D)
        dense(f"{g}.gamma_v.0", D, D)
        dense(f"{g}.gamma_v.1", D, C)
        dense(f"{g}.W_re", D, D)
        dense(f"{g}.W_rs", D, C)
        if i < n - 1:
            dense(f"{g}.gamma_t.dense_layers.0", D, D)
            dense(f"{g}.W_vq", D, D, bias=False)
            for l in range(m["lmax"]):
                dense(f"{g}.W_vk.{l}", D, D, bias=False)
    for i in range(n):
        e = f"{R}.eqff_list.{i}"
        dense(f"{e}.gamma_m.0", 2 * D, D)
        dense(f"{e}.gamma_m.1", D, 2 * D)
        dense(f"{e}.W_vu", D, D, bias=False)
    dense(f"{HEAD}.out_net.1.out_net.0", D, hid)
    dense(f"{HEAD}.out_net.1.out_net.1", hid, 1)
    spec.append((f"{HEAD}.standardize.mean", (1,), "mean"))
    spec.append((f"{HEAD}.standardize.stddev", (1,), "stddev"))
    return spec


def trainable(name: str) -> bool:
    """The head's standardisation is a constant, not a parameter."""
    return not name.startswith(f"{HEAD}.standardize.")


def _lin(P: Params, name: str, x: torch.Tensor, act=False) -> torch.Tensor:
    y = x @ P[f"{name}.weight"].t()
    if f"{name}.bias" in P:
        y = y + P[f"{name}.bias"]
    if f"{name}.norm.weight" in P:
        y = F.layer_norm(y, y.shape[-1:], P[f"{name}.norm.weight"],
                         P[f"{name}.norm.bias"], eps=1e-5)
    return F.silu(y) if act else y


def cosine_cutoff(r: torch.Tensor, rc: float) -> torch.Tensor:
    return 0.5 * (torch.cos(r * (math.pi / rc)) + 1.0) * (r < rc).to(r.dtype)


def expnorm(r: torch.Tensor, n_rbf: int, rc: float) -> torch.Tensor:
    """cutoff(r) exp(-beta (exp(-alpha r) - mu_k)^2), alpha = 5 / rc, the
    means evenly from exp(-rc) to 1 (float32 constants, as published)."""
    start = math.exp(-rc)
    mu = torch.linspace(start, 1.0, n_rbf, dtype=torch.float32,
                        device=r.device).to(r.dtype)
    beta = (2.0 / n_rbf * (1.0 - start)) ** -2
    arg = torch.exp(-(5.0 / rc) * r)[..., None] - mu
    return cosine_cutoff(r, rc)[..., None] * torch.exp(-beta * arg ** 2)


def spherical_harmonics_l2(v: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics of degrees 1 and 2 of unit vectors (y the
    zenith axis, m = -l..l), norm-normalised: ``[..., 8]``; zero for a zero
    vector."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    s3 = math.sqrt(3.0)
    return torch.stack([
        x, y, z,
        s3 * x * z, s3 * x * y, y * y - 0.5 * (x * x + z * z), s3 * y * z,
        0.5 * s3 * (z * z - x * x)], dim=-1)


def pair_geometry(pos: torch.Tensor, mask: torch.Tensor, rc: float,
                  cap: int):
    """(vec, adj, pair_mask, dist, unit) of ``[G, M]`` atoms; i the
    destination (axis 1), j the source (axis 2), vec = pos_j - pos_i; adj the
    real pairs within ``rc`` without self-loops, capped to the ``cap``
    nearest sources (ties by index); pair_mask adj plus real self-loops."""
    G, M = mask.shape
    vec = pos[:, None, :, :] - pos[:, :, None, :]
    d2 = (vec ** 2).sum(-1)
    eye = torch.eye(M, dtype=torch.bool, device=pos.device)[None]
    both = mask[:, :, None] & mask[:, None, :]
    adj = both & ~eye & (d2 < rc * rc)
    if cap < M - 1:
        key = torch.where(adj, d2.detach().float(),
                          torch.full_like(d2, math.inf, dtype=torch.float32))
        order = torch.argsort(key, dim=-1, stable=True)
        rank = torch.argsort(order, dim=-1, stable=True)
        adj = adj & (rank < cap)
    pair_mask = adj | (eye & both)
    safe = torch.where(adj, d2, torch.ones_like(d2))
    dist = torch.where(adj, torch.sqrt(safe), torch.zeros_like(d2))
    unit = torch.where(adj[..., None], vec / torch.sqrt(safe)[..., None],
                       torch.zeros_like(vec))
    return adj, pair_mask, dist, unit


def _cast(x: torch.Tensor, pair_type: torch.dtype) -> torch.Tensor:
    top = float(torch.finfo(pair_type).max)
    return x.detach().clamp(-top, top).to(pair_type).to(x.dtype)


class _Round(torch.autograd.Function):
    """A value stored in ``pair_type``: rounded on the way forward, its
    cotangent rounded on the way back (differentiable again, for the force
    loss's second derivative)."""

    @staticmethod
    def forward(ctx, x, pair_type):
        ctx.pair_type = pair_type
        return _cast(x, pair_type)

    @staticmethod
    def backward(ctx, g):
        return _Round.apply(g, ctx.pair_type), None


def rounder(pair_type):
    """Rounding through ``pair_type`` (saturating at its largest finite
    value), or the identity; ``(type, False)``: the value rounded, its
    cotangent passed on as it is."""
    if pair_type is None:
        return lambda x: x
    kind, back = ((pair_type, True) if isinstance(pair_type, torch.dtype)
                  else pair_type)
    if back:
        return lambda x: _Round.apply(x, kind)
    return lambda x: x + (_cast(x, kind) - x.detach())


def energy(P: Params, m: dict, z: torch.Tensor, pos: torch.Tensor,
           mask: torch.Tensor,
           keeps: Optional[Sequence[torch.Tensor]] = None,
           pair_type: Optional[torch.dtype] = None) -> torch.Tensor:
    """``[G]`` energies of a dense batch (``z [G, M]`` int, ``pos [G, M,
    3]``, ``mask [G, M]`` bool).  ``keeps``: one ``[G, M, M, H]`` attention
    keep mask per interaction layer (training with attention dropout);
    ``pair_type``: see the module's note."""
    rnd = rounder(pair_type)
    D, H, lmax, rc = m["n_atom_basis"], m["num_heads"], m["lmax"], m["cutoff"]
    n = m["n_interactions"]
    C = multiplier(m) * D
    G, M = z.shape
    dt = P[f"{R}.A_na.weight"].dtype
    adj, pm, dist, unit = pair_geometry(pos, mask, rc, m["max_num_neighbors"])
    adjf, pmf = adj.to(dt), pm.to(dt)
    zl = z.long()
    rl = spherical_harmonics_l2(unit).to(dt)                    # [G,M,M,8]
    phi = expnorm(dist, m["n_rbf"], rc).to(dt)                  # [G,M,M,R]
    env = cosine_cutoff(dist, rc).to(dt)

    # node init: neighbour embeddings gated by a radial filter (non-loop)
    h = P[f"{R}.A_na.weight"][zl]
    r_feat = _lin(P, f"{R}.node_init.W_ndp.dense_layers.0", phi) \
        * (env * adjf)[..., None]
    m_i = torch.einsum("gijd,gjd->gid", r_feat,
                       P[f"{R}.node_init.A_nbr.weight"][zl])
    x = _lin(P, f"{R}.node_init.W_nrd_nru.dense_layers.0",
             torch.cat([h, m_i], -1), act=True)
    h = _lin(P, f"{R}.node_init.W_nrd_nru.dense_layers.1", x)
    # edge init
    t = rnd((h[:, :, None, :] + h[:, None, :, :]) * _lin(
        P, f"{R}.edge_init.W_erp", phi))
    X = torch.zeros(G, M, sh_dim(m), D, dtype=dt, device=pos.device)
    blocks = degree_slices(lmax)
    p = m["attn_dropout"]
    for li in range(n):
        g = f"{R}.gata_list.{li}"
        q = rnd(_lin(P, f"{g}.W_q", h))
        k = rnd(_lin(P, f"{g}.W_k", h))
        x_g = rnd(_lin(P, f"{g}.gamma_s.1",
                       _lin(P, f"{g}.gamma_s.0", h, True)))
        v = rnd(_lin(P, f"{g}.gamma_v.1",
                     _lin(P, f"{g}.gamma_v.0", h, True)))
        t = rnd(t)
        ta = rnd(_lin(P, f"{g}.W_re", t, act=True))
        tf = rnd(_lin(P, f"{g}.W_rs", t))
        logit = (q[:, :, None, :] * k[:, None, :, :] * ta).reshape(
            G, M, M, H, D // H).sum(-1)
        logit = torch.where(pm[..., None], logit,
                            torch.full_like(logit, -1e30))
        top = logit.amax(dim=2, keepdim=True).detach()
        ex = torch.exp(logit - top) * pmf[..., None]
        attn = ex / (ex.sum(dim=2, keepdim=True) + 1e-16) / math.sqrt(D)
        if keeps is not None:
            attn = torch.where(keeps[li], attn / (1.0 - p),
                               torch.zeros_like(attn))
        sea = attn.repeat_interleave(C // H, dim=-1) * v[:, None, :, :]
        o = rnd(tf * x_g[:, None, :, :] * env[..., None] + sea) \
            * pmf[..., None]
        parts = torch.split(o, D, dim=-1)
        h = h + parts[0].sum(2)
        n_dir = lmax if m["sep_dir"] else 1
        d_parts = parts[1:1 + n_dir] * (lmax // n_dir)
        t_parts = parts[1 + n_dir:] * (lmax // len(parts[1 + n_dir:]))
        dX = torch.cat([
            torch.einsum("gijm,gijd->gimd", rl[..., lo:hi], d_parts[l])
            + torch.einsum("gjmd,gijd->gimd", X[:, :, lo:hi], t_parts[l])
            for l, (lo, hi) in enumerate(blocks)], dim=2)
        X = X + dX
        if li < n - 1:
            EQ = X @ P[f"{g}.W_vq.weight"].t()
            EK = torch.cat([X[:, :, lo:hi] @ P[f"{g}.W_vk.{l}.weight"].t()
                            for l, (lo, hi) in enumerate(blocks)], dim=2)
            w = 0.0
            for lo, hi in blocks:
                r = rl[..., lo:hi]
                S = torch.einsum("gimd,gjmd->gijd", EQ[:, :, lo:hi],
                                 EK[:, :, lo:hi])
                pq = torch.einsum("gimd,gijm->gijd", EQ[:, :, lo:hi], r)
                pk = torch.einsum("gjmd,gijm->gijd", EK[:, :, lo:hi], r)
                r2 = (r * r).sum(-1, keepdim=True)
                w = w + S - pq * pk * (2.0 - r2)
            t = t + _lin(P, f"{g}.gamma_t.dense_layers.0", t, act=True) * w
        e = f"{R}.eqff_list.{li}"
        Xp = X @ P[f"{e}.W_vu.weight"].t()
        Xn = torch.sqrt((Xp ** 2).sum(-2) + 1e-8)
        mm = _lin(P, f"{e}.gamma_m.1",
                  _lin(P, f"{e}.gamma_m.0", torch.cat([h, Xn], -1), True))
        h = h + mm[..., :D]
        X = X + mm[..., None, D:] * Xp
    y = _lin(P, f"{HEAD}.out_net.1.out_net.1",
             _lin(P, f"{HEAD}.out_net.1.out_net.0", h, act=True))[..., 0]
    y = y * P[f"{HEAD}.standardize.stddev"] + P[f"{HEAD}.standardize.mean"]
    return (y * mask.to(dt)).sum(1)


def energy_forces(P: Params, m: dict, z, pos, mask, keeps=None,
                  create_graph: bool = False, pair_type=None):
    """Energies ``[G]`` and forces ``-dE/dpos`` ``[G, M, 3]`` (zero on
    padded atoms)."""
    pos = pos.detach().requires_grad_(True)
    with torch.enable_grad():
        e = energy(P, m, z, pos, mask, keeps, pair_type)
        g, = torch.autograd.grad(e.sum(), pos, create_graph=create_graph)
    return e, -g * mask[..., None].to(g.dtype)
