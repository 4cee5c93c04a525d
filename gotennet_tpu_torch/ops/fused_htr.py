"""Fused dense HTR edge update, forward and backward.

Replaces the TPU kernels ``_kernel`` and ``_bwd_kernel`` in
``gotennet_tpu/ops/pallas/fused_htr.py`` (wired by ``make_fused_htr``).
For each graph g and pair (i, j) of its padded ``[M, M]`` slab, every
pair included (the TPU kernel masks none):

    z    = t @ W_g + b_g                       (gamma_t, one layer)
    gt   = silu(z)
    w    = sum_l [ S_l - pq_l * pk_l * (2 - r2_l) ]   (S_l alone if not rej)
    S_l  = sum_{m in l} EQ[i,m] * EK[j,m]
    pq_l = sum_{m in l} EQ[i,m] * rl[ij,m]     (pk_l likewise with EK[j])
    r2_l = sum_{m in l} rl[ij,m]^2
    out  = t + gt * gate(w)                    (gate: '' | sigmoid | tanh | silu)

The degree blocks l are 1..lmax with ``sep_htr``, else one block over
all L components.

Cast points follow the TPU kernel: ``t`` and ``W_g`` are rounded to
``pair_dtype`` and their product accumulates in float32; ``gt`` is
float32; ``S``, ``pq`` and ``pk`` accumulate in ``pair_dtype``, one
rounding per product and per sum, in m order; ``w`` accumulates in
float32 from the rounded ``pq * pk`` and the float32 ``r2``; ``out`` is
float32.

``fused_htr_forward`` runs the hand-written CUDA kernel
(``csrc/fused_htr_fwd.cu``) on CUDA tensors and the plain version
``fused_htr_forward_reference`` on CPU tensors; ``fused_htr_backward``
likewise runs ``csrc/fused_htr_bwd.cu`` or ``fused_htr_backward_reference``.
Nothing falls back.  ``FusedHTR`` wires the two through autograd, and
``fused_htr`` picks it only when a gradient is wanted.

The ELL layout's update (TPU kernel ``_ell_htr_kernel``, wired by
``make_fused_htr_ell``) is the same update with ``i`` the destination row
r of ``t [NR, K, D]`` and ``j = nbr[r, s]`` a row of the source table
``EK [N, L, D]``: ``fused_htr_ell_forward`` runs ``csrc/fused_htr_ell_fwd.cu``
or ``fused_htr_ell_forward_reference``, ``fused_htr_ell_backward``
``csrc/fused_htr_ell_bwd.cu`` or ``fused_htr_ell_backward_reference``;
``FusedHTRELL`` wires them through autograd and ``fused_htr_ell`` picks it
when a gradient is wanted.  The backward kernel sums g_EK per table row in
the order of ``fused_ell.source_slots``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from gotennet_tpu_torch.ops.fused_ell import Slots, _checked_slots
from gotennet_tpu_torch.ops.fused_gata import (_check, _check_shapes, _raise_on,
                                              aligned)
from gotennet_tpu_torch.ops.spherical import degree_slices

__all__ = ["fused_htr", "FusedHTR", "fused_htr_forward",
           "fused_htr_forward_reference", "fused_htr_backward",
           "fused_htr_backward_reference", "fused_htr_ell", "FusedHTRELL",
           "fused_htr_ell_forward", "fused_htr_ell_forward_reference",
           "fused_htr_ell_backward", "fused_htr_ell_backward_reference"]

# gate names, in the order of the kernels' gate codes
GATES = ("", "gated", "gatedt", "act")
# the kernels keep one degree block's components in registers
MAX_LMAX = 4

Grads = Tuple[torch.Tensor, ...]


def _blocks(lmax: int, sep_htr: bool) -> List[Tuple[int, int]]:
    """[lo, hi) of each degree block of the SH axis."""
    return (degree_slices(lmax) if sep_htr
            else [(0, (lmax + 1) ** 2 - 1)])


def _gate(w: torch.Tensor, gate: str) -> torch.Tensor:
    if gate == "gated":
        return torch.sigmoid(w)
    if gate == "gatedt":
        return torch.tanh(w)
    if gate == "act":
        return w * torch.sigmoid(w)
    return w


def _gate_grad(w: torch.Tensor, gw: torch.Tensor, gate: str) -> torch.Tensor:
    """d gate(w) / d w, given w and gw = gate(w)."""
    if gate == "gated":
        return gw * (1.0 - gw)
    if gate == "gatedt":
        return 1.0 - gw * gw
    if gate == "act":
        sig = torch.sigmoid(w)
        return sig + w * sig * (1.0 - sig)
    return torch.ones_like(w)


def _block_terms(EQ, EK, rl, lo, hi, rej, pd):
    """``S, pq, pk`` of one degree block, ``[G, M, M, D]`` in ``pd`` (each
    product and each partial sum rounded, in m order); ``pq, pk`` are None
    when not ``rej``."""
    S = pq = pk = None
    for m in range(lo, hi):
        eqm = EQ[:, :, None, m, :].to(pd)          # [G, i, 1, D]
        ekm = EK[:, None, :, m, :].to(pd)          # [G, 1, j, D]
        s = eqm * ekm
        S = s if S is None else S + s
        if rej:
            rlm = rl[..., m:m + 1].to(pd)          # [G, i, j, 1]
            a, b = eqm * rlm, ekm * rlm
            pq = a if pq is None else pq + a
            pk = b if pk is None else pk + b
    return S, pq, pk


def _recompute(t, EQ, EK, rl, W_g, b_g, *, lmax, sep_htr, rej, pd):
    """z, w and, per degree block, ``(pq, pk, 2 - r2)`` (None if not
    rej), all as the kernel forms them."""
    f32 = torch.float32
    z = t.to(pd).to(f32) @ W_g.to(pd).to(f32) + b_g
    w = torch.zeros(z.shape, dtype=f32, device=z.device)
    saved = []
    for lo, hi in _blocks(lmax, sep_htr):
        S, pq, pk = _block_terms(EQ, EK, rl, lo, hi, rej, pd)
        if rej:
            a = 2.0 - torch.sum(rl[..., lo:hi] ** 2, dim=-1, keepdim=True)
            w = w + S.to(f32) - (pq * pk).to(f32) * a
            saved.append((pq, pk, a))
        else:
            w = w + S.to(f32)
            saved.append(None)
    return z, w, saved


def fused_htr_forward_reference(t, EQ, EK, rl, W_g, b_g, *, lmax: int,
                                sep_htr: bool, rej: bool, gate: str,
                                pair_dtype: torch.dtype = torch.float32
                                ) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: ``out [G, M, M, D]``
    float32."""
    z, w, _ = _recompute(t, EQ, EK, rl, W_g, b_g, lmax=lmax,
                         sep_htr=sep_htr, rej=rej, pd=pair_dtype)
    gt = z * torch.sigmoid(z)
    return t.to(torch.float32) + gt * _gate(w, gate)


def fused_htr_backward_reference(t, EQ, EK, rl, W_g, b_g, g, *, lmax: int,
                                 sep_htr: bool, rej: bool, gate: str,
                                 pair_dtype: torch.dtype = torch.float32
                                 ) -> Grads:
    """Plain PyTorch version of the backward kernel: the analytic VJP of
    the forward for the float32 cotangent ``g`` of ``out``.  Returns
    ``(g_t, g_EQ, g_EK, g_rl, g_W_g, g_b_g)``, all float32.

    Cast points follow ``_bwd_kernel``: the factors of the three products
    (``t W_g`` recomputed, ``g_z W_g^T``, ``t^T g_z``) are rounded to
    ``pair_dtype`` and summed in float32; ``g_w`` and ``g_pq``, ``g_pk``
    are rounded once before the pair-type products of the EQ/EK
    cotangents, whose sums over j (``g_EQ``) and over i (``g_EK``) are
    float32; ``g_rl`` is float32 throughout."""
    f32, pd = torch.float32, pair_dtype
    G, M, _, D = t.shape
    z, w, saved = _recompute(t, EQ, EK, rl, W_g, b_g, lmax=lmax,
                             sep_htr=sep_htr, rej=rej, pd=pd)
    sig = torch.sigmoid(z)
    gt = z * sig
    gw = _gate(w, gate)
    g_w = g * gt * _gate_grad(w, gw, gate)
    g_z = g * gw * (sig + z * sig * (1.0 - sig))
    g_zp = g_z.to(pd).to(f32)
    W_p = W_g.to(pd).to(f32)
    g_t = g + g_zp @ W_p.t()
    tp = t.to(pd).to(f32)
    g_W = tp.reshape(-1, D).t() @ g_zp.reshape(-1, D)
    g_b = g_z.reshape(-1, D).sum(dim=0)

    g_w_p = g_w.to(pd)
    L = rl.shape[-1]
    g_EQ = torch.zeros(EQ.shape, dtype=f32, device=t.device)
    g_EK = torch.zeros(EK.shape, dtype=f32, device=t.device)
    g_rl = torch.zeros(rl.shape, dtype=f32, device=t.device)
    for (lo, hi), sv in zip(_blocks(lmax, sep_htr), saved):
        if rej:
            pq, pk, a = sv
            g_pq = -(g_w * pk.to(f32)) * a
            g_pk = -(g_w * pq.to(f32)) * a
            g_r2 = torch.sum(g_w * (pq * pk).to(f32), dim=-1)
            g_pq_p, g_pk_p = g_pq.to(pd), g_pk.to(pd)
        for m in range(lo, hi):
            eqm = EQ[:, :, None, m, :].to(pd)
            ekm = EK[:, None, :, m, :].to(pd)
            ge = g_w_p * ekm
            gk = g_w_p * eqm
            if rej:
                rlm = rl[..., m:m + 1].to(pd)
                ge = ge + g_pq_p * rlm
                gk = gk + g_pk_p * rlm
                g_rl[..., m] = (torch.sum(g_pq * eqm.to(f32)
                                          + g_pk * ekm.to(f32), dim=-1)
                                + 2.0 * rl[..., m] * g_r2)
            g_EQ[:, :, m] = ge.to(f32).sum(dim=2)      # over j
            g_EK[:, :, m] = gk.to(f32).sum(dim=1)      # over i
    return g_t, g_EQ, g_EK, g_rl, g_W, g_b


def _check_common(who, named, *, lmax, gate, pair_dtype) -> Tuple[int, int]:
    """What the dense and the ELL kernels ask of their inputs (a dict by
    name, D the last axis of ``t``): one device, contiguity, the types, the
    gate and lmax; returns (D, L)."""
    f32, bf16 = torch.float32, torch.bfloat16
    t, EQ, EK = named["t"], named["EQ"], named["EK"]
    D = t.shape[-1]
    for name, a in named.items():
        _check(a.device == t.device, f"{name} is on {a.device}, t on "
               f"{t.device}", who)
        _check(a.is_contiguous(), f"{name} is not contiguous", who)
    _check(t.dtype in (f32, bf16), f"t has dtype {t.dtype}", who)
    _check(EQ.dtype in (f32, bf16) and EK.dtype == EQ.dtype,
           f"EQ, EK have dtypes {EQ.dtype}, {EK.dtype}", who)
    for name in ("rl", "W_g", "b_g"):
        _check(named[name].dtype == f32, f"{name} must be float32", who)
    _check(pair_dtype in (f32, bf16), f"pair_dtype {pair_dtype}", who)
    _check(gate in GATES, f"unsupported gate {gate!r}", who)
    _check(1 <= lmax <= MAX_LMAX, f"lmax={lmax} outside 1..{MAX_LMAX}", who)
    _check(D % 32 == 0, f"D={D} must be a multiple of 32", who)
    return D, (lmax + 1) ** 2 - 1


def _check_inputs(who, t, EQ, EK, rl, W_g, b_g, *, lmax, gate,
                  pair_dtype) -> Tuple[int, int, int, int]:
    """Device, type, shape and contiguity of the six inputs, as both dense
    kernels take them; returns (G, M, D, L)."""
    named = dict(t=t, EQ=EQ, EK=EK, rl=rl, W_g=W_g, b_g=b_g)
    D, L = _check_common(who, named, lmax=lmax, gate=gate,
                         pair_dtype=pair_dtype)
    G, M, M2, _ = t.shape
    _check(M2 == M, "t must be [G, M, M, D]", who)
    _check_shapes(who, named, dict(EQ=(G, M, L, D), EK=(G, M, L, D),
                                   rl=(G, M, M, L), W_g=(D, D), b_g=(D,)))
    return G, M, D, L


def fused_htr_forward(t, EQ, EK, rl, W_g, b_g, *, lmax: int, sep_htr: bool,
                      rej: bool, gate: str,
                      pair_dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    """Fused HTR forward; the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors.

    Args (JAX package layout):
        t: ``[G, M, M, D]`` edge state, float32 or bfloat16.
        EQ, EK: ``[G, M, L, D]``, one type, float32 or bfloat16.
        rl: ``[G, M, M, L]`` float32.
        W_g ``[D, D]`` (``[in, out]``), b_g ``[D]``: float32.

    Returns ``out [G, M, M, D]`` float32.  ``fused_htr_forward.launches``
    counts kernel launches.
    """
    kw = dict(lmax=lmax, sep_htr=sep_htr, rej=rej, gate=gate,
              pair_dtype=pair_dtype)
    args = (t, EQ, EK, rl, W_g, b_g)
    if t.device.type == "cpu":
        return fused_htr_forward_reference(*args, **kw)
    if t.device.type != "cuda":
        raise ValueError(f"fused_htr_forward: no kernel for {t.device}")
    return _launch(*args, **kw)


def fused_htr_backward(t, EQ, EK, rl, W_g, b_g, g, *, lmax: int,
                       sep_htr: bool, rej: bool, gate: str,
                       pair_dtype: torch.dtype = torch.float32) -> Grads:
    """Fused HTR backward; the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors.  Inputs as ``fused_htr_forward``'s, plus the
    float32 cotangent ``g`` of ``out``.  Returns the six cotangents as
    ``fused_htr_backward_reference``.  ``fused_htr_backward.launches``
    counts kernel launches."""
    kw = dict(lmax=lmax, sep_htr=sep_htr, rej=rej, gate=gate,
              pair_dtype=pair_dtype)
    args = (t, EQ, EK, rl, W_g, b_g, g)
    if t.device.type == "cpu":
        return fused_htr_backward_reference(*args, **kw)
    if t.device.type != "cuda":
        raise ValueError(f"fused_htr_backward: no kernel for {t.device}")
    return _launch_backward(*args, **kw)


fused_htr_forward.launches = 0
fused_htr_backward.launches = 0
# the counters stay on the public wrappers even while a caller patches the
# module's names (as chip_smoke.py does to capture the kernels' inputs)
_counted = fused_htr_forward
_counted_bwd = fused_htr_backward


class FusedHTR(torch.autograd.Function):
    """The fused update through autograd, as ``make_fused_htr`` wires it
    with ``jax.custom_vjp``: the forward saves its inputs, the backward
    hands them to ``fused_htr_backward``.  Cotangents come back in their
    inputs' types."""

    @staticmethod
    def forward(ctx, t, EQ, EK, rl, W_g, b_g, lmax, sep_htr, rej, gate,
                pair_dtype):
        ctx.kw = dict(lmax=lmax, sep_htr=sep_htr, rej=rej, gate=gate,
                      pair_dtype=pair_dtype)
        ctx.save_for_backward(t, EQ, EK, rl, W_g, b_g)
        return fused_htr_forward(t, EQ, EK, rl, W_g, b_g, **ctx.kw)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        inputs = ctx.saved_tensors
        grads = fused_htr_backward(*inputs, g.float().contiguous(), **ctx.kw)
        out = tuple(gr.to(a.dtype) if n else None for gr, a, n in
                    zip(grads, inputs, ctx.needs_input_grad[:6]))
        return out + (None,) * 5


def fused_htr(t, EQ, EK, rl, W_g, b_g, *, lmax: int, sep_htr: bool,
              rej: bool, gate: str,
              pair_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``out`` of the fused update.  Through ``FusedHTR`` when autograd
    records and an input needs a gradient; otherwise the forward alone."""
    args = (t, EQ, EK, rl, W_g, b_g)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return FusedHTR.apply(*args, lmax, sep_htr, rej, gate, pair_dtype)
    return fused_htr_forward(*args, lmax=lmax, sep_htr=sep_htr, rej=rej,
                             gate=gate, pair_dtype=pair_dtype)


def _flags(t, EQ, *, lmax, sep_htr, rej, gate, pair_dtype) -> Tuple[int, ...]:
    """The integer arguments both C entry points end with: G, M, D, lmax,
    sep_htr, rej, gate code, pair/t/node bf16 flags."""
    bf16 = torch.bfloat16
    G, M, _, D = t.shape
    return (G, M, D, lmax, int(sep_htr), int(rej), GATES.index(gate),
            int(pair_dtype == bf16), int(t.dtype == bf16),
            int(EQ.dtype == bf16))


def _launch(t, EQ, EK, rl, W_g, b_g, *, lmax, sep_htr, rej, gate,
            pair_dtype) -> torch.Tensor:
    from gotennet_tpu_torch.ops._build import load_library

    _check_inputs("fused_htr_forward", t, EQ, EK, rl, W_g, b_g, lmax=lmax,
                  gate=gate, pair_dtype=pair_dtype)
    out = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    with torch.cuda.device(t.device):
        _call_kernel(load_library("fused_htr_fwd.cu"),
                     torch.cuda.current_stream(t.device).cuda_stream,
                     t, EQ, EK, rl, W_g, b_g, out, lmax=lmax,
                     sep_htr=sep_htr, rej=rej, gate=gate,
                     pair_dtype=pair_dtype)
    _counted.launches += 1
    return out


def _call_kernel(lib, stream, t, EQ, EK, rl, W_g, b_g, out, **kw) -> None:
    """One forward through the C interface on ``stream`` into ``out``;
    raises on the launch's CUDA error.  Arguments are validated by the
    caller."""
    err = lib.gotennet_fused_htr_fwd(
        *(a.data_ptr() for a in (t, EQ, EK, rl, W_g, b_g, out)),
        *_flags(t, EQ, **kw), stream)
    _raise_on(lib, err, "fused_htr_fwd")


def backward_outputs(t, L: int) -> List[torch.Tensor]:
    """Empty float32 outputs of the backward kernel, on ``t``'s device:
    g_t, g_EQ, g_EK, g_rl, g_W_g, g_b_g."""
    G, M, _, D = t.shape

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=t.device)

    return [new(G, M, M, D), new(G, M, L, D), new(G, M, L, D),
            new(G, M, M, L), new(D, D), new(D)]


def _launch_backward(t, EQ, EK, rl, W_g, b_g, g, *, lmax, sep_htr, rej,
                     gate, pair_dtype) -> Grads:
    from gotennet_tpu_torch.ops._build import load_library

    who = "fused_htr_backward"
    G, M, D, L = _check_inputs(who, t, EQ, EK, rl, W_g, b_g, lmax=lmax,
                               gate=gate, pair_dtype=pair_dtype)
    _check(g.device == t.device and g.dtype == torch.float32
           and g.is_contiguous() and g.shape == t.shape,
           f"g must be a contiguous float32 tensor of shape "
           f"{tuple(t.shape)} on {t.device}", who)
    outs = backward_outputs(t, L)
    with torch.cuda.device(t.device):
        _call_backward(load_library("fused_htr_bwd.cu"),
                       torch.cuda.current_stream(t.device).cuda_stream,
                       t, EQ, EK, rl, W_g, b_g, g, outs, lmax=lmax,
                       sep_htr=sep_htr, rej=rej, gate=gate,
                       pair_dtype=pair_dtype)
    _counted_bwd.launches += 1
    return tuple(outs)


def _call_backward(lib, stream, t, EQ, EK, rl, W_g, b_g, g, outs,
                   **kw) -> None:
    """One backward through the C interface on ``stream`` into ``outs``
    (as ``backward_outputs`` makes them), with a workspace of the size the
    library asks for; raises on a CUDA error.  Arguments are validated by
    the caller."""
    G, M, _, D = t.shape
    t, EQ, EK, b_g, g = (aligned(a) for a in (t, EQ, EK, b_g, g))
    n_bytes = lib.gotennet_fused_htr_bwd_workspace(G, M, D)
    work = torch.empty((n_bytes + 3) // 4, dtype=torch.float32,
                       device=t.device)
    err = lib.gotennet_fused_htr_bwd(
        *(a.data_ptr() for a in (t, EQ, EK, rl, W_g, b_g, g, *outs, work)),
        *_flags(t, EQ, **kw), stream)
    _raise_on(lib, err, "fused_htr_bwd")


# ---- the ELL layout ----------------------------------------------------------

def fused_htr_ell_forward_reference(t, EQ, EK, rl, nbr, W_g, b_g, *,
                                    lmax: int, sep_htr: bool, rej: bool,
                                    gate: str,
                                    pair_dtype: torch.dtype = torch.float32
                                    ) -> torch.Tensor:
    """Plain PyTorch version of the ELL kernel: ``out [NR, K, D]`` float32.
    Row r is a one-row graph whose K partners are the gathered
    ``EK[nbr[r]]``, so the dense update gives it with the same cast
    points."""
    out = fused_htr_forward_reference(
        t[:, None], EQ[:, None], EK[nbr.long()], rl[:, None], W_g, b_g,
        lmax=lmax, sep_htr=sep_htr, rej=rej, gate=gate,
        pair_dtype=pair_dtype)
    return out[:, 0]


def fused_htr_ell_backward_reference(t, EQ, EK, rl, nbr, W_g, b_g, g, *,
                                     lmax: int, sep_htr: bool, rej: bool,
                                     gate: str,
                                     pair_dtype: torch.dtype = torch.float32,
                                     slots: Optional[Slots] = None) -> Grads:
    """Plain PyTorch version of the ELL backward kernel: the dense backward
    on NR one-row graphs whose K partners are the gathered ``EK[nbr[r]]``,
    so the cast points are ``_ell_htr_bwd_kernel``'s; each slot's EK term
    (rounded to ``pair_dtype``, as the transposed one-hot matmul takes it)
    is then summed per table row in float32.  (``slots`` is the kernel's;
    the table sum here is ``index_add_``.)  Returns ``(g_t, g_EQ, g_EK,
    g_rl, g_W_g, g_b_g)``, all float32."""
    idx = nbr.long().reshape(-1)
    g_t, g_EQ, g_EKs, g_rl, g_W, g_b = fused_htr_backward_reference(
        t[:, None], EQ[:, None], EK[idx].reshape(nbr.shape + EK.shape[1:]),
        rl[:, None], W_g, b_g, g[:, None], lmax=lmax, sep_htr=sep_htr,
        rej=rej, gate=gate, pair_dtype=pair_dtype)
    g_EK = torch.zeros(EK.shape, dtype=torch.float32, device=t.device)
    g_EK.index_add_(0, idx, g_EKs.reshape((-1,) + EK.shape[1:]))
    return g_t[:, 0], g_EQ[:, 0], g_EK, g_rl[:, 0], g_W, g_b


def _check_ell_inputs(who, t, EQ, EK, rl, nbr, W_g, b_g, *, lmax, gate,
                      pair_dtype) -> None:
    """Device, type, shape and contiguity of the ELL kernel's inputs."""
    named = dict(t=t, EQ=EQ, EK=EK, rl=rl, nbr=nbr, W_g=W_g, b_g=b_g)
    D, L = _check_common(who, named, lmax=lmax, gate=gate,
                         pair_dtype=pair_dtype)
    NR, K, _ = t.shape
    N = EK.shape[0]
    _check(nbr.dtype == torch.int32, "nbr must be int32", who)
    _check(NR <= N, f"{NR} destination rows > {N} table rows", who)
    _check_shapes(who, named, dict(EQ=(NR, L, D), EK=(N, L, D),
                                   rl=(NR, K, L), nbr=(NR, K), W_g=(D, D),
                                   b_g=(D,)))


def fused_htr_ell_forward(t, EQ, EK, rl, nbr, W_g, b_g, *, lmax: int,
                          sep_htr: bool, rej: bool, gate: str,
                          pair_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """Fused ELL HTR forward; the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors.

    Args (JAX package layout):
        t: ``[NR, K, D]`` edge state, float32 or bfloat16.
        EQ: ``[NR, L, D]`` destination rows, EK: ``[N, L, D]`` source
            table (N >= NR), one type, float32 or bfloat16.
        rl: ``[NR, K, L]`` float32; nbr: ``[NR, K]`` int32 rows of EK.
        W_g ``[D, D]`` (``[in, out]``), b_g ``[D]``: float32.

    Returns ``out [NR, K, D]`` float32, every slot updated (padded ones
    too, as the TPU kernel does).  ``fused_htr_ell_forward.launches``
    counts kernel launches.
    """
    kw = dict(lmax=lmax, sep_htr=sep_htr, rej=rej, gate=gate,
              pair_dtype=pair_dtype)
    args = (t, EQ, EK, rl, nbr, W_g, b_g)
    if t.device.type == "cpu":
        return fused_htr_ell_forward_reference(*args, **kw)
    if t.device.type != "cuda":
        raise ValueError(f"fused_htr_ell_forward: no kernel for {t.device}")
    return _launch_ell(*args, **kw)


def fused_htr_ell_backward(t, EQ, EK, rl, nbr, W_g, b_g, g, *, lmax: int,
                           sep_htr: bool, rej: bool, gate: str,
                           pair_dtype: torch.dtype = torch.float32,
                           slots: Optional[Slots] = None) -> Grads:
    """Fused ELL HTR backward; the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors.  Inputs as ``fused_htr_ell_forward``'s, plus the
    float32 cotangent ``g`` of ``out``; ``slots`` is
    ``fused_ell.source_slots(nbr, N)`` (built here when None).  Returns the
    six cotangents as ``fused_htr_ell_backward_reference``.
    ``fused_htr_ell_backward.launches`` counts kernel launches."""
    kw = dict(lmax=lmax, sep_htr=sep_htr, rej=rej, gate=gate,
              pair_dtype=pair_dtype, slots=slots)
    args = (t, EQ, EK, rl, nbr, W_g, b_g, g)
    if t.device.type == "cpu":
        return fused_htr_ell_backward_reference(*args, **kw)
    if t.device.type != "cuda":
        raise ValueError(f"fused_htr_ell_backward: no kernel for {t.device}")
    return _launch_ell_backward(*args, **kw)


fused_htr_ell_forward.launches = 0
fused_htr_ell_backward.launches = 0
_counted_ell = fused_htr_ell_forward
_counted_ell_bwd = fused_htr_ell_backward


class FusedHTRELL(torch.autograd.Function):
    """The ELL update through autograd, as ``make_fused_htr_ell`` wires it
    with ``jax.custom_vjp``: the forward saves its inputs, the backward hands
    them to ``fused_htr_ell_backward``.  Cotangents come back in their
    inputs' types; ``nbr`` gets none."""

    @staticmethod
    def forward(ctx, t, EQ, EK, rl, nbr, W_g, b_g, lmax, sep_htr, rej, gate,
                pair_dtype, slots):
        ctx.kw = dict(lmax=lmax, sep_htr=sep_htr, rej=rej, gate=gate,
                      pair_dtype=pair_dtype)
        ctx.slots = slots
        ctx.save_for_backward(t, EQ, EK, rl, nbr, W_g, b_g)
        return fused_htr_ell_forward(t, EQ, EK, rl, nbr, W_g, b_g, **ctx.kw)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        inputs = ctx.saved_tensors
        grads = list(fused_htr_ell_backward(*inputs, g.float().contiguous(),
                                            **ctx.kw, slots=ctx.slots))
        grads.insert(4, None)                       # nbr
        out = tuple(gr.to(a.dtype) if n else None
                    for gr, a, n in zip(grads, inputs, ctx.needs_input_grad))
        return out + (None,) * 6


def fused_htr_ell(t, EQ, EK, rl, nbr, W_g, b_g, *, lmax: int, sep_htr: bool,
                  rej: bool, gate: str,
                  pair_dtype: torch.dtype = torch.float32,
                  slots: Optional[Slots] = None) -> torch.Tensor:
    """``out`` of the ELL update.  Through ``FusedHTRELL`` when autograd
    records and an input needs a gradient (``slots``, the transposed slot
    list, goes to the backward); otherwise the forward alone."""
    args = (t, EQ, EK, rl, nbr, W_g, b_g)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return FusedHTRELL.apply(*args, lmax, sep_htr, rej, gate, pair_dtype,
                                 slots)
    return fused_htr_ell_forward(*args, lmax=lmax, sep_htr=sep_htr, rej=rej,
                                 gate=gate, pair_dtype=pair_dtype)


def _launch_ell(t, EQ, EK, rl, nbr, W_g, b_g, *, lmax, sep_htr, rej, gate,
                pair_dtype) -> torch.Tensor:
    from gotennet_tpu_torch.ops._build import load_library

    _check_ell_inputs("fused_htr_ell_forward", t, EQ, EK, rl, nbr, W_g, b_g,
                      lmax=lmax, gate=gate, pair_dtype=pair_dtype)
    out = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    with torch.cuda.device(t.device):
        _call_ell_kernel(load_library("fused_htr_ell_fwd.cu"),
                         torch.cuda.current_stream(t.device).cuda_stream,
                         t, EQ, EK, rl, nbr, W_g, b_g, out, lmax=lmax,
                         sep_htr=sep_htr, rej=rej, gate=gate,
                         pair_dtype=pair_dtype)
    _counted_ell.launches += 1
    return out


def _call_ell_kernel(lib, stream, t, EQ, EK, rl, nbr, W_g, b_g, out, *,
                     lmax, sep_htr, rej, gate, pair_dtype) -> None:
    """One ELL forward through the C interface on ``stream`` into ``out``;
    raises on the launch's CUDA error.  Arguments are validated by the
    caller."""
    bf16 = torch.bfloat16
    NR, K, D = t.shape
    err = lib.gotennet_fused_htr_ell_fwd(
        *(a.data_ptr() for a in (t, EQ, EK, rl, nbr, W_g, b_g, out)),
        NR, EK.shape[0], K, D, lmax, int(sep_htr), int(rej),
        GATES.index(gate), int(pair_dtype == bf16), int(t.dtype == bf16),
        int(EQ.dtype == bf16), stream)
    _raise_on(lib, err, "fused_htr_ell_fwd")


def _launch_ell_backward(t, EQ, EK, rl, nbr, W_g, b_g, g, *, lmax, sep_htr,
                         rej, gate, pair_dtype, slots) -> Grads:
    from gotennet_tpu_torch.ops._build import load_library

    who = "fused_htr_ell_backward"
    _check_ell_inputs(who, t, EQ, EK, rl, nbr, W_g, b_g, lmax=lmax,
                      gate=gate, pair_dtype=pair_dtype)
    _check(g.device == t.device and g.dtype == torch.float32
           and g.is_contiguous() and g.shape == t.shape,
           f"g must be a contiguous float32 tensor of shape "
           f"{tuple(t.shape)} on {t.device}", who)
    slots = _checked_slots(who, slots, nbr, EK.shape[0])
    outs = ell_backward_outputs(t, EK)
    with torch.cuda.device(t.device):
        _call_ell_backward(load_library("fused_htr_ell_bwd.cu"),
                           torch.cuda.current_stream(t.device).cuda_stream,
                           t, EQ, EK, rl, nbr, W_g, b_g, g, slots, outs,
                           lmax=lmax, sep_htr=sep_htr, rej=rej, gate=gate,
                           pair_dtype=pair_dtype)
    _counted_ell_bwd.launches += 1
    return tuple(outs)


def ell_backward_outputs(t, EK) -> List[torch.Tensor]:
    """Empty float32 outputs of the ELL backward kernel, on ``t``'s device:
    g_t, g_EQ, g_EK, g_rl, g_W_g, g_b_g."""
    NR, K, D = t.shape
    N, L, _ = EK.shape

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=t.device)

    return [new(NR, K, D), new(NR, L, D), new(N, L, D), new(NR, K, L),
            new(D, D), new(D)]


def _call_ell_backward(lib, stream, t, EQ, EK, rl, nbr, W_g, b_g, g, slots,
                       outs, *, lmax, sep_htr, rej, gate, pair_dtype) -> None:
    """One ELL backward through the C interface on ``stream`` into ``outs``
    (as ``ell_backward_outputs`` makes them), with a workspace of the size
    the library asks for; raises on a CUDA error.  Arguments are validated
    by the caller."""
    bf16 = torch.bfloat16
    NR, K, D = t.shape
    n_bytes = lib.gotennet_fused_htr_ell_bwd_workspace(NR, K, D)
    work = torch.empty((n_bytes + 3) // 4, dtype=torch.float32,
                       device=t.device)
    err = lib.gotennet_fused_htr_ell_bwd(
        *(a.data_ptr() for a in (t, EQ, EK, rl, nbr, W_g, b_g, g, *slots,
                                 *outs, work)),
        NR, EK.shape[0], K, D, lmax, int(sep_htr), int(rej),
        GATES.index(gate), int(pair_dtype == bf16), int(t.dtype == bf16),
        int(EQ.dtype == bf16), stream)
    _raise_on(lib, err, "fused_htr_ell_bwd")
