"""Row 1, the dense GATA forward; the bound copied from ``chip_smoke.py``
``fwd_bound_ms`` (the valid pairs passed in, not counted here)."""

from harness.roofline import bound_ms as _bound, count_valid, n_bytes

MODULE = "gotennet_tpu_torch.ops.fused_gata"
WRAPPER = "fused_gata_forward"
VALID_ARG = 7


def bound_ms(args, kwargs, valid=None) -> tuple:
    """The GATA forward: each input read once, d_h and dX written once; the
    two projections t W_re and t W_rs, 2 D (D + mult D) FLOP per valid pair
    (invalid pairs add exact zeros)."""
    t, W_re, W_rs = args[0], args[9], args[11]
    Dd, C = W_re.shape[0], W_rs.shape[1]
    Gg, M = t.shape[:2]
    L = args[5].shape[-1]
    n_out = (Gg * M * Dd + Gg * M * L * Dd) * 4
    valid = count_valid(args, 7, valid)
    return _bound(n_bytes(args) + n_out, 2.0 * Dd * (Dd + C) * valid,
                  kwargs["pair_dtype"])
