"""Row 8, the ELL HTR update's backward; the bound copied from
``chip_smoke.py`` ``htr_ell_bwd_bound_ms``."""

from harness.roofline import bound_ms as _bound, n_bytes

MODULE = "gotennet_tpu_torch.ops.fused_htr"
WRAPPER = "fused_htr_ell_backward"
VALID_ARG = None


def bound_ms(args, kwargs, valid=None) -> tuple:
    """The ELL HTR backward: t, EQ, EK (as a table), rl, nbr, W_g, b_g, the
    cotangent of out and the transposed slot list read once, the six
    cotangents written once (float32); three projections (t W_g recomputed,
    g_z W_g^T, t^T g_z), 6 D^2 FLOP per slot, over every slot."""
    t, EQ, EK, rl, W_g = args[0], args[1], args[2], args[3], args[5]
    pairs = t.numel() // t.shape[-1]
    n_out = 4 * (t.numel() + EQ.numel() + EK.numel() + rl.numel()
                 + W_g.numel() + W_g.shape[0])
    n_in = n_bytes(args) + n_bytes(kwargs.get("slots") or ())
    return _bound(n_in + n_out, 6.0 * W_g.numel() * pairs,
                  kwargs["pair_dtype"])
