"""Row 3, the dense HTR update; the bound copied from ``chip_smoke.py``
``htr_fwd_bound_ms``."""

from harness.roofline import bound_ms as _bound, n_bytes

MODULE = "gotennet_tpu_torch.ops.fused_htr"
WRAPPER = "fused_htr_forward"
VALID_ARG = None


def bound_ms(args, kwargs, valid=None) -> tuple:
    """The HTR forward: t, EQ, EK, rl, W_g, b_g read once, out (float32)
    written once; the projection t W_g, 2 D^2 FLOP per pair, over every pair
    (the update masks none)."""
    t, W_g = args[0], args[4]
    pairs = t.numel() // t.shape[-1]
    return _bound(n_bytes(args) + 4 * t.numel(),
                  2.0 * W_g.numel() * pairs, kwargs["pair_dtype"])
