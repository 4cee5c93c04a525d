"""Row 5, the ELL message; the bound copied from ``chip_smoke.py``
``ell_fwd_bound_ms`` (the valid slots passed in, not counted here)."""

from harness.roofline import bound_ms as _bound, count_valid, n_bytes

MODULE = "gotennet_tpu_torch.ops.fused_ell"
WRAPPER = "fused_ell_forward"
VALID_ARG = 7


def bound_ms(args, kwargs, valid=None) -> tuple:
    """The ELL message: each input read once (the node tables as tables),
    d_h and dX written once; the two projections t W_re and t W_rs,
    2 D (D + mult D) FLOP per valid slot (padded ones add exact zeros)."""
    t, W_re, W_rs = args[0], args[10], args[12]
    Dd, C = W_re.shape[0], W_rs.shape[1]
    NR, L = t.shape[0], args[5].shape[-1]
    n_out = (NR * Dd + NR * L * Dd) * 4
    valid = count_valid(args, 7, valid)
    return _bound(n_bytes(args) + n_out, 2.0 * Dd * (Dd + C) * valid,
                  kwargs["pair_dtype"])
