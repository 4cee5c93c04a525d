"""Row 7, the ELL HTR update; the bound copied from ``chip_smoke.py``
``htr_ell_fwd_bound_ms``."""

from harness.roofline import bound_ms as _bound, n_bytes

MODULE = "gotennet_tpu_torch.ops.fused_htr"
WRAPPER = "fused_htr_ell_forward"
VALID_ARG = None


def bound_ms(args, kwargs, valid=None) -> tuple:
    """The ELL HTR update: t, EQ, EK (as a table), rl, nbr, W_g, b_g read
    once, out (float32) written once; the projection t W_g, 2 D^2 FLOP per
    slot, over every slot (the update masks none)."""
    t, W_g = args[0], args[5]
    pairs = t.numel() // t.shape[-1]
    return _bound(n_bytes(args) + 4 * t.numel(),
                  2.0 * W_g.numel() * pairs, kwargs["pair_dtype"])
