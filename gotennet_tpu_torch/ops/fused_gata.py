"""Fused dense-GATA message + aggregation, forward and backward.

Replaces the TPU kernels ``_kernel`` and ``_bwd_kernel`` in
``gotennet_tpu/ops/pallas/fused_gata.py`` (launched by
``_pallas_forward`` and ``_pallas_backward``, wired by
``make_fused_gata``).  For each graph g, destination i and neighbour
j < M:

    ta     = silu(t @ W_re + b_re)
    logits = sum_{d in head h} q_i * k_j * ta          (per head)
    sm     = masked softmax_j(logits),  valid = env_signed >= 0
    attn   = sm * scale                 (scale [G,M,M] or per head [G,M,M,H])
    o      = (t @ W_rs + b_rs) * x_g[j] * max(env, 0) + attn[head(c)] * v[j]
    d_h[i]   = sum_j o_scalar
    dX[i, m] = sum_j rl[i,j,m] * o_dir,l(m) + sum_j X[j,m] * o_ten,l(m)

Channel blocks of ``o`` (each D wide): ``[scalar | dir l=1..lmax (one
shared block unless sep_dir) | tensor l=1..lmax (likewise sep_tensor)]``.

Cast points follow the TPU kernel: ``t`` and the node tensors are
rounded to ``pair_dtype`` before use, both projections accumulate in
float32, ``ta`` is computed in float32 and rounded for the products,
``o`` is formed from ``pair_dtype`` factors (each product rounded) and
every j-sum accumulates in float32.

``fused_gata_forward`` runs the hand-written CUDA kernel
(``csrc/fused_gata_fwd.cu``) on CUDA tensors and the plain version
``fused_gata_forward_reference`` on CPU tensors; ``fused_gata_backward``
likewise runs ``csrc/fused_gata_bwd.cu`` or
``fused_gata_backward_reference``.  Nothing falls back.  ``FusedGATA``
wires the two through autograd, and ``fused_gata`` picks it only when a
gradient is wanted.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from gotennet_tpu_torch.ops._build import aligned, call_entry, launch
from gotennet_tpu_torch.utils import profiling

__all__ = ["fused_gata", "FusedGATA", "fused_gata_forward",
           "fused_gata_forward_reference", "fused_gata_backward",
           "fused_gata_backward_reference", "MAX_PAIRS_PER_BLOCK"]

Out = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]
# names of the 13 inputs, in argument order
ARG_NAMES = ("t", "q", "k", "x_g", "v", "rl", "X", "env_signed", "scale",
             "W_re", "b_re", "W_rs", "b_rs")

# pair rows one thread block holds (TI destination rows x all M neighbours)
MAX_PAIRS_PER_BLOCK = 128


def _block_layout(sep_dir: bool, sep_tensor: bool, lmax: int):
    """(kind, m_lo, m_hi) for each D-wide channel block of ``o``."""
    L = (lmax + 1) ** 2 - 1
    deg = [(l * l - 1, (l + 1) ** 2 - 1) for l in range(1, lmax + 1)]
    blocks = [("scalar", 0, 0)]
    blocks += [("dir", lo, hi) for lo, hi in deg] if sep_dir \
        else [("dir", 0, L)]
    blocks += [("ten", lo, hi) for lo, hi in deg] if sep_tensor \
        else [("ten", 0, L)]
    return blocks


def fused_gata_forward_reference(t, q, k, x_g, v, rl, X, env_signed, scale,
                                 W_re, b_re, W_rs, b_rs, *, lmax: int,
                                 num_heads: int, sep_dir: bool,
                                 sep_tensor: bool,
                                 pair_dtype: torch.dtype = torch.float32,
                                 with_attn: bool = False) -> Out:
    """Plain PyTorch version of the kernel (same inputs, same outputs).

    Returns ``(d_h [G,M,D], dX [G,M,L,D], sm)`` in float32, where ``sm``
    is the PRE-scale softmax ``[G,M,M,H]`` when ``with_attn`` else None.
    """
    f32, pd = torch.float32, pair_dtype
    G, M, _, D = t.shape
    H = num_heads
    C = W_rs.shape[1]
    e_per = C // H
    tp = t.to(pd).to(f32)
    ta = tp @ W_re.to(pd).to(f32) + b_re
    ta = ta * torch.sigmoid(ta)
    p = ta.to(pd) * q.to(pd)[:, :, None, :] * k.to(pd)[:, None, :, :]
    logits = p.to(f32).reshape(G, M, M, H, D // H).sum(-1)
    valid = (env_signed >= 0)[..., None]
    logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    mx = logits.amax(dim=2, keepdim=True)
    ex = torch.exp(logits - mx) * valid
    sm = ex / (ex.sum(dim=2, keepdim=True) + 1e-16)
    attn = sm * (scale if scale.dim() == 4 else scale[..., None])
    attn_c = attn.to(pd).repeat_interleave(e_per, dim=-1)      # [G,M,M,C]
    envp = env_signed.clamp(min=0.0).to(pd)[..., None]
    tf = tp @ W_rs.to(pd).to(f32) + b_rs
    o = (tf.to(pd) * x_g.to(pd)[:, None] * envp
         + attn_c * v.to(pd)[:, None])
    rl_p = rl.to(pd).to(f32)
    X_p = X.to(pd)
    d_h = None
    dX = torch.zeros(G, M, rl.shape[-1], D, dtype=f32, device=t.device)
    for b, (kind, lo, hi) in enumerate(_block_layout(sep_dir, sep_tensor,
                                                     lmax)):
        o_b = o[..., b * D:(b + 1) * D]
        if kind == "scalar":
            d_h = o_b.to(f32).sum(dim=2)
        elif kind == "dir":
            dX[:, :, lo:hi] += torch.einsum("gijm,gijd->gimd",
                                            rl_p[..., lo:hi], o_b.to(f32))
        else:
            prod = o_b[:, :, :, None, :] * X_p[:, None, :, lo:hi, :]
            dX[:, :, lo:hi] += prod.to(f32).sum(dim=2)
    return d_h, dX, (sm if with_attn else None)


def fused_gata_backward_reference(t, q, k, x_g, v, rl, X, env_signed, scale,
                                  W_re, b_re, W_rs, b_rs, sm, g_dh, g_dX, *,
                                  lmax: int, num_heads: int, sep_dir: bool,
                                  sep_tensor: bool,
                                  pair_dtype: torch.dtype = torch.float32,
                                  pos_grads: bool = False
                                  ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the backward kernel: the analytic VJP of
    the forward, from its pre-scale softmax ``sm`` ``[G,M,M,H]`` and the
    float32 cotangents ``g_dh`` ``[G,M,D]`` and ``g_dX`` ``[G,M,L,D]``.

    Cast points follow the TPU kernel ``_bwd_kernel``: every pair-sized
    product is formed from factors rounded to ``pair_dtype`` and is
    rounded itself (``r`` below), every sum accumulates in float32, and
    the softmax backward and the silu chain stay in float32.  Returns the
    13 cotangents in input order, all float32.  Those of ``rl`` and
    ``env_signed`` (the position gradients) are computed only with
    ``pos_grads``, and are zeros otherwise, as the JAX package returns them:
    ``g_rl[i,j,m] = sum_d o[i,j,d] g_dX[i,m,d]`` over the direction block
    of m's degree (products of rounded factors, unrounded, as the TPU
    kernel's float32-accumulating matmul forms them), and ``g_env`` the
    sum over every channel of ``g_o tf x_g[j]``, zero on invalid pairs.
    """
    f32 = torch.float32

    def r(a):
        return a.to(pair_dtype).to(f32)

    G, M, _, D = t.shape
    H = num_heads
    C = W_rs.shape[1]
    e_per = C // H
    scale_h = scale if scale.dim() == 4 else scale[..., None]
    tp = r(t.to(f32))                                        # [G,i,j,D]
    envp = r(env_signed.clamp(min=0.0))[..., None]           # [G,i,j,1]
    attn_c = r(sm * scale_h).repeat_interleave(e_per, dim=-1)  # [G,i,j,C]
    xg = r(x_g.to(f32))[:, None]                             # [G,1,j,C]
    vj = r(v.to(f32))[:, None]
    gdx = r(g_dX)
    tf = r(tp @ r(W_rs) + b_rs)                              # [G,i,j,C]

    # the cotangent of o, block by block; g_X from the tensor blocks
    g_o = torch.empty_like(tf)
    g_X = torch.zeros(X.shape, dtype=f32, device=X.device)
    g_rl = torch.zeros(rl.shape, dtype=f32, device=rl.device)
    for b, (kind, lo, hi) in enumerate(_block_layout(sep_dir, sep_tensor,
                                                     lmax)):
        cols = slice(b * D, (b + 1) * D)
        if kind == "ten" or (kind == "dir" and pos_grads):
            # the forward's o on this block, in the pair type
            o_c = r(r(r(tf[..., cols] * xg[..., cols]) * envp)
                    + r(attn_c[..., cols] * vj[..., cols]))
        if kind == "scalar":
            g_o[..., cols] = r(g_dh)[:, :, None, :]
        elif kind == "dir":
            g_o[..., cols] = r(torch.einsum("gijm,gimd->gijd",
                                            r(rl[..., lo:hi]),
                                            gdx[:, :, lo:hi]))
            if pos_grads:
                g_rl[..., lo:hi] = torch.einsum("gijd,gimd->gijm", o_c,
                                                gdx[:, :, lo:hi])
        else:
            acc = torch.zeros_like(tp)
            for m in range(lo, hi):
                acc = r(acc + r(r(X[:, None, :, m, :])
                                * gdx[:, :, None, m, :]))
            g_o[..., cols] = acc
            for m in range(lo, hi):
                g_X[:, :, m] = r(o_c * gdx[:, :, None, m, :]).sum(dim=1)
    g_env = torch.zeros(env_signed.shape, dtype=f32, device=t.device)
    if pos_grads:
        g_env = torch.where(env_signed >= 0, r(r(g_o * tf) * xg).sum(dim=-1),
                            g_env)

    g_tf = r(r(g_o * xg) * envp)
    g_xg = r(r(g_o * tf) * envp).sum(dim=1)
    g_v = r(attn_c * g_o).sum(dim=1)
    g_attn = r(g_o * vj).reshape(G, M, M, H, e_per).sum(dim=-1)
    g_t = g_tf @ r(W_rs).t()
    g_Wrs = torch.einsum("gijd,gijc->dc", tp, g_tf)
    g_brs = g_tf.sum(dim=(0, 1, 2))

    # softmax backward and the attention filter, float32
    g_scale = sm * g_attn
    if scale.dim() == 3:
        g_scale = g_scale.sum(dim=-1)
    g_sm = g_attn * scale_h
    g_logits = sm * (g_sm - (sm * g_sm).sum(dim=2, keepdim=True))
    g_p = r(g_logits).repeat_interleave(D // H, dim=-1)      # [G,i,j,D]
    zre = tp @ r(W_re) + b_re
    sig = torch.sigmoid(zre)
    ta = r(zre * sig)
    qi = r(q.to(f32))[:, :, None]
    kj = r(k.to(f32))[:, None]
    g_q = r(r(g_p * ta) * kj).sum(dim=2)
    g_k = r(r(g_p * ta) * qi).sum(dim=1)
    g_zre = r(r(g_p * qi) * kj) * (sig + zre * sig * (1.0 - sig))
    g_t = g_t + r(g_zre) @ r(W_re).t()
    g_Wre = torch.einsum("gijd,gije->de", tp, r(g_zre))
    g_bre = g_zre.sum(dim=(0, 1, 2))
    return (g_t, g_q, g_k, g_xg, g_v, g_rl, g_X, g_env, g_scale, g_Wre, g_bre,
            g_Wrs, g_brs)


def _check(cond: bool, msg: str, who: str = "fused_gata_forward") -> None:
    if not cond:
        raise ValueError(f"{who}: {msg}")


def _check_common(who, args, *, lmax, num_heads, sep_dir, sep_tensor,
                  pair_dtype) -> Tuple[int, int, int, int]:
    """What the message kernels of both layouts ask of their inputs (a dict
    by name, D the last axis of ``t``): one device, contiguity, the types,
    channel blocks that fit D and the heads, a scalar or per-head scale;
    returns (D, H, L, C)."""
    f32, bf16 = torch.float32, torch.bfloat16
    t, q = args["t"], args["q"]
    D, H = t.shape[-1], num_heads
    L = (lmax + 1) ** 2 - 1
    C = args["W_rs"].shape[-1]
    n_blocks = len(_block_layout(sep_dir, sep_tensor, lmax))
    for name, a in args.items():
        _check(a.device == t.device, f"{name} is on {a.device}, t on "
               f"{t.device}", who)
        _check(a.is_contiguous(), f"{name} is not contiguous", who)
    _check(t.dtype in (f32, bf16), f"t has dtype {t.dtype}", who)
    _check(q.dtype in (f32, bf16), f"q has dtype {q.dtype}", who)
    for name in ("k", "x_g", "v"):
        _check(args[name].dtype == q.dtype, f"{name} is {args[name].dtype}, "
               f"q is {q.dtype}", who)
    for name in ("rl", "X", "env_signed", "scale", "W_re", "b_re", "W_rs",
                 "b_rs"):
        _check(args[name].dtype == f32, f"{name} must be float32", who)
    _check(pair_dtype in (f32, bf16), f"pair_dtype {pair_dtype}", who)
    _check(D % 32 == 0 and D % H == 0, f"D={D} must be a multiple of 32 "
           f"and of num_heads={H}", who)
    _check(C == n_blocks * D, f"W_rs width {C} does not match the channel "
           f"blocks (expected {n_blocks} x D)", who)
    _check(C % H == 0, f"mult*D={C} must be divisible by num_heads={H}", who)
    pairs = tuple(t.shape[:-1])
    _check(tuple(args["scale"].shape) in (pairs, pairs + (H,)),
           f"scale has shape {tuple(args['scale'].shape)}", who)
    return D, H, L, C


def _check_shapes(who, args, shapes) -> None:
    for name, shp in shapes.items():
        _check(tuple(args[name].shape) == shp,
               f"{name} has shape {tuple(args[name].shape)}, expected {shp}",
               who)


def _check_inputs(who, args, **kw) -> Tuple[int, ...]:
    """Device, type, shape and contiguity of the 13 inputs (a dict by
    name), as both kernels take them; returns (G, M, D, H, L, C)."""
    D, H, L, C = _check_common(who, args, **kw)
    G, M, M2, _ = args["t"].shape
    _check(M2 == M, "t must be [G, M, M, D]", who)
    _check(M <= MAX_PAIRS_PER_BLOCK, f"M={M} > {MAX_PAIRS_PER_BLOCK}", who)
    _check_shapes(who, args, dict(
        q=(G, M, D), k=(G, M, D), x_g=(G, M, C), v=(G, M, C),
        rl=(G, M, M, L), X=(G, M, L, D), env_signed=(G, M, M), W_re=(D, D),
        b_re=(D,), W_rs=(D, C), b_rs=(C,)))
    return G, M, D, H, L, C


def fused_gata_forward(t, q, k, x_g, v, rl, X, env_signed, scale,
                       W_re, b_re, W_rs, b_rs, *, lmax: int, num_heads: int,
                       sep_dir: bool, sep_tensor: bool,
                       pair_dtype: torch.dtype = torch.float32,
                       with_attn: bool = False) -> Out:
    """Fused GATA forward; the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors.

    Args (JAX package layout):
        t: ``[G, M, M, D]`` edge state, float32 or bfloat16.
        q, k: ``[G, M, D]``; x_g, v: ``[G, M, mult*D]``; all four of one
            type, float32 or bfloat16.
        rl: ``[G, M, M, L]``, X: ``[G, M, L, D]``, env_signed: ``[G, M, M]``
            (cutoff for valid pairs, -1 for invalid), scale: ``[G, M, M]``
            or ``[G, M, M, H]``; all float32.
        W_re ``[D, D]``, b_re ``[D]``, W_rs ``[D, mult*D]``,
            b_rs ``[mult*D]``: float32, ``[in, out]`` layout.

    Returns ``(d_h, dX, sm)`` as ``fused_gata_forward_reference``.
    ``fused_gata_forward.launches`` counts kernel launches.
    """
    kw = dict(lmax=lmax, num_heads=num_heads, sep_dir=sep_dir,
              sep_tensor=sep_tensor, pair_dtype=pair_dtype,
              with_attn=with_attn)
    args = (t, q, k, x_g, v, rl, X, env_signed, scale, W_re, b_re, W_rs,
            b_rs)
    if t.device.type == "cpu":
        return fused_gata_forward_reference(*args, **kw)
    if t.device.type != "cuda":
        raise ValueError(f"fused_gata_forward: no kernel for {t.device}")
    return _launch(*args, **kw)


def fused_gata_backward(t, q, k, x_g, v, rl, X, env_signed, scale,
                        W_re, b_re, W_rs, b_rs, sm, g_dh, g_dX, *,
                        lmax: int, num_heads: int, sep_dir: bool,
                        sep_tensor: bool,
                        pair_dtype: torch.dtype = torch.float32,
                        pos_grads: bool = False
                        ) -> Tuple[torch.Tensor, ...]:
    """Fused GATA backward; the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors.  Inputs as ``fused_gata_forward``'s, plus the
    forward's pre-scale softmax ``sm`` and the float32 cotangents
    ``g_dh``, ``g_dX``.  Returns the 13 cotangents as
    ``fused_gata_backward_reference`` (those of ``rl`` and ``env_signed``
    only with ``pos_grads``, zeros otherwise).
    ``fused_gata_backward.launches`` counts kernel launches."""
    kw = dict(lmax=lmax, num_heads=num_heads, sep_dir=sep_dir,
              sep_tensor=sep_tensor, pair_dtype=pair_dtype,
              pos_grads=pos_grads)
    args = (t, q, k, x_g, v, rl, X, env_signed, scale, W_re, b_re, W_rs,
            b_rs, sm, g_dh, g_dX)
    if t.device.type == "cpu":
        return fused_gata_backward_reference(*args, **kw)
    if t.device.type != "cuda":
        raise ValueError(f"fused_gata_backward: no kernel for {t.device}")
    return _launch_backward(*args, **kw)


fused_gata_forward.launches = 0
fused_gata_backward.launches = 0
# the counters stay on the public wrappers even while a caller patches the
# module's names (as chip_smoke.py does to capture the kernels' inputs)
_counted = fused_gata_forward
_counted_bwd = fused_gata_backward


class FusedGATA(torch.autograd.Function):
    """The fused step through autograd, as ``make_fused_gata`` wires it in
    the JAX package: the forward saves the inputs and the pre-scale
    softmax, the backward hands them to ``fused_gata_backward``, with
    ``pos_grads`` exactly when autograd asks for the cotangent of ``rl`` or
    ``env_signed`` (forces), and counts its G M^2 pairs under
    ``pairs.gata_bwd``.  Cotangents come back in their inputs' types.
    Built with ``pos_grads=False``, a position gradient raises
    ``ValueError`` (the JAX package returns zeros for it)."""

    @staticmethod
    def forward(ctx, t, q, k, x_g, v, rl, X, env_signed, scale, W_re, b_re,
                W_rs, b_rs, lmax, num_heads, sep_dir, sep_tensor,
                pair_dtype, pos_grads=True):
        ctx.pos_grads = pos_grads
        ctx.kw = dict(lmax=lmax, num_heads=num_heads, sep_dir=sep_dir,
                      sep_tensor=sep_tensor, pair_dtype=pair_dtype)
        inputs = (t, q, k, x_g, v, rl, X, env_signed, scale, W_re, b_re,
                  W_rs, b_rs)
        d_h, dX, sm = fused_gata_forward(*inputs, **ctx.kw, with_attn=True)
        ctx.save_for_backward(*inputs, sm)
        return d_h, dX

    @staticmethod
    @once_differentiable
    def backward(ctx, g_dh, g_dX):
        need = ctx.needs_input_grad[:len(ARG_NAMES)]
        pos = need[5] or need[7]
        if pos and not ctx.pos_grads:
            raise ValueError(
                "a position gradient through the fused message, built with "
                "pos_grads=False: build the model with pos_grads=True (or "
                "None with a derivative head)")
        *inputs, sm = ctx.saved_tensors
        G, M = inputs[0].shape[:2]
        profiling.count("pairs.gata_bwd", G * M * M)
        grads = fused_gata_backward(*inputs, sm, g_dh.float().contiguous(),
                                    g_dX.float().contiguous(), **ctx.kw,
                                    pos_grads=pos)
        out = tuple(g.to(a.dtype) if n else None
                    for g, a, n in zip(grads, inputs, need))
        return out + (None,) * 6


def fused_gata(t, q, k, x_g, v, rl, X, env_signed, scale, W_re, b_re, W_rs,
               b_rs, *, lmax: int, num_heads: int, sep_dir: bool,
               sep_tensor: bool, pair_dtype: torch.dtype = torch.float32,
               pos_grads: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(d_h, dX)`` of the fused step.  Through ``FusedGATA`` when
    autograd records and an input needs a gradient; otherwise the forward
    alone, which keeps no softmax.  ``pos_grads=False`` refuses position
    gradients (``FusedGATA``)."""
    args = (t, q, k, x_g, v, rl, X, env_signed, scale, W_re, b_re, W_rs,
            b_rs)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return FusedGATA.apply(*args, lmax, num_heads, sep_dir, sep_tensor,
                               pair_dtype, pos_grads)
    d_h, dX, _ = fused_gata_forward(
        *args, lmax=lmax, num_heads=num_heads, sep_dir=sep_dir,
        sep_tensor=sep_tensor, pair_dtype=pair_dtype)
    return d_h, dX


def _launch(t, q, k, x_g, v, rl, X, env_signed, scale, W_re, b_re, W_rs,
            b_rs, *, lmax, num_heads, sep_dir, sep_tensor, pair_dtype,
            with_attn) -> Out:
    f32 = torch.float32
    args = dict(zip(ARG_NAMES, (t, q, k, x_g, v, rl, X, env_signed, scale,
                                W_re, b_re, W_rs, b_rs)))
    G, M, D, H, L, C = _check_inputs(
        "fused_gata_forward", args, lmax=lmax, num_heads=num_heads,
        sep_dir=sep_dir, sep_tensor=sep_tensor, pair_dtype=pair_dtype)
    d_h = torch.empty(G, M, D, dtype=f32, device=t.device)
    dX = torch.empty(G, M, L, D, dtype=f32, device=t.device)
    sm = (torch.empty(G, M, M, H, dtype=f32, device=t.device) if with_attn
          else None)
    launch("fused_gata_fwd.cu", _call_kernel, t, q, k, x_g, v, rl, X,
           env_signed, scale, W_re, b_re, W_rs, b_rs, d_h, dX, sm, lmax=lmax,
           num_heads=H, sep_dir=sep_dir, sep_tensor=sep_tensor,
           pair_dtype=pair_dtype)
    _counted.launches += 1
    return d_h, dX, sm


def _call_kernel(lib, stream, t, q, k, x_g, v, rl, X, env_signed, scale,
                 W_re, b_re, W_rs, b_rs, d_h, dX, sm, *, lmax, num_heads,
                 sep_dir, sep_tensor, pair_dtype) -> None:
    """One forward through the C interface on ``stream`` (``call_entry``;
    the workspace holds the bf16 weights).  Arguments are validated by the
    caller."""
    bf16 = torch.bfloat16
    G, M, _, D = t.shape
    t, q, k, x_g, v, X, b_re, b_rs = (aligned(a) for a in (
        t, q, k, x_g, v, X, b_re, b_rs))
    sizes = (G, M, D, num_heads, lmax, int(sep_dir), int(sep_tensor))
    call_entry(lib, "fused_gata_fwd", stream, sizes,
               (t, q, k, x_g, v, rl, X, env_signed, scale, W_re, b_re, W_rs,
                b_rs, d_h, dX, sm),
               sizes + (int(scale.dim() == 4), int(pair_dtype == bf16),
                        int(t.dtype == bf16), int(q.dtype == bf16)))


def _launch_backward(t, q, k, x_g, v, rl, X, env_signed, scale, W_re, b_re,
                     W_rs, b_rs, sm, g_dh, g_dX, *, lmax, num_heads, sep_dir,
                     sep_tensor, pair_dtype, pos_grads
                     ) -> Tuple[torch.Tensor, ...]:
    who = "fused_gata_backward"
    inputs = (t, q, k, x_g, v, rl, X, env_signed, scale, W_re, b_re, W_rs,
              b_rs)
    G, M, D, H, L, C = _check_inputs(
        who, dict(zip(ARG_NAMES, inputs)), lmax=lmax, num_heads=num_heads,
        sep_dir=sep_dir, sep_tensor=sep_tensor, pair_dtype=pair_dtype)
    for name, a, shp in (("sm", sm, (G, M, M, H)), ("g_dh", g_dh, (G, M, D)),
                         ("g_dX", g_dX, (G, M, L, D))):
        _check(a.device == t.device and a.dtype == torch.float32
               and a.is_contiguous() and tuple(a.shape) == shp,
               f"{name} must be a contiguous float32 tensor of shape {shp} "
               f"on {t.device}", who)
    outs = backward_outputs(t, scale, C, L, pos_grads)
    launch("fused_gata_bwd.cu", _call_backward, *inputs, sm, g_dh, g_dX,
           outs, lmax=lmax, num_heads=H, sep_dir=sep_dir,
           sep_tensor=sep_tensor, pair_dtype=pair_dtype)
    _counted_bwd.launches += 1
    if not pos_grads:
        outs[5], outs[7] = torch.zeros_like(rl), torch.zeros_like(env_signed)
    return tuple(outs)


def backward_outputs(t, scale, C: int, L: int, pos_grads: bool = False):
    """Empty float32 outputs of the backward kernel, on ``t``'s device, in
    input order: g_t, g_q, g_k, g_xg, g_v, g_rl, g_X, g_env, g_scale, g_Wre,
    g_bre, g_Wrs, g_brs; g_rl and g_env are None without ``pos_grads``."""
    G, M, _, D = t.shape

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=t.device)

    return [new(G, M, M, D), new(G, M, D), new(G, M, D), new(G, M, C),
            new(G, M, C), new(G, M, M, L) if pos_grads else None,
            new(G, M, L, D), new(G, M, M) if pos_grads else None,
            new(*scale.shape), new(D, D), new(D), new(D, C), new(C)]


def _call_backward(lib, stream, t, q, k, x_g, v, rl, X, env_signed, scale,
                   W_re, b_re, W_rs, b_rs, sm, g_dh, g_dX, outs, *, lmax,
                   num_heads, sep_dir, sep_tensor, pair_dtype) -> None:
    """One backward through the C interface on ``stream`` into ``outs``
    (as ``backward_outputs`` makes them; a None output, g_rl or g_env, is
    not computed; ``call_entry``).  Arguments are validated by the
    caller."""
    bf16 = torch.bfloat16
    G, M, _, D = t.shape
    sizes = (G, M, D, num_heads, lmax, int(sep_dir), int(sep_tensor))
    call_entry(lib, "fused_gata_bwd", stream, sizes,
               (t, q, k, x_g, v, rl, X, env_signed, scale, W_re, b_re, W_rs,
                b_rs, sm, g_dh, g_dX, *outs),
               sizes + (int(scale.dim() == 4), int(pair_dtype == bf16),
                        int(t.dtype == bf16), int(q.dtype == bf16)))
