"""Row 4, the dense HTR update's backward; the bound copied from
``chip_smoke.py`` ``htr_bwd_bound_ms``."""

from harness.roofline import bound_ms as _bound, n_bytes

MODULE = "gotennet_tpu_torch.ops.fused_htr"
WRAPPER = "fused_htr_backward"
VALID_ARG = None


def bound_ms(args, kwargs, valid=None) -> tuple:
    """The HTR backward: the six inputs and the cotangent of out read once,
    the six cotangents written once (float32); three projections (t W_g
    recomputed, g_z W_g^T, t^T g_z), 6 D^2 FLOP per pair, over every
    pair."""
    t, W_g = args[0], args[4]
    pairs = t.numel() // t.shape[-1]
    n_out = 4 * sum(a.numel() for a in args[:6])
    return _bound(n_bytes(args) + n_out, 6.0 * W_g.numel() * pairs,
                  kwargs["pair_dtype"])
