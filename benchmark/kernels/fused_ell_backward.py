"""Row 6, the ELL message's backward; the bound copied from
``chip_smoke.py`` ``ell_bwd_bound_ms`` (the valid slots passed in, not
counted here)."""

from harness.roofline import bound_ms as _bound, count_valid, n_bytes

MODULE = "gotennet_tpu_torch.ops.fused_ell"
WRAPPER = "fused_ell_backward"
VALID_ARG = 7


def bound_ms(args, kwargs, valid=None) -> tuple:
    """The ELL message backward: each input read once (the node tables and
    the transposed slot list as tables), the 13 cotangents written once
    (float32); six projections (t W_rs and t W_re recomputed, g_tf W_rs^T,
    g_zre W_re^T, t^T g_tf, t^T g_zre), 6 D (mult D + D) FLOP per valid
    slot (padded ones add exact zeros)."""
    t, k, scale, W_re, W_rs = args[0], args[2], args[8], args[10], args[12]
    Dd, C = W_re.shape[0], W_rs.shape[1]
    NR, K = t.shape[:2]
    N, L = k.shape[0], args[5].shape[-1]
    n_out = 4 * (NR * K * Dd + NR * Dd + N * Dd + 2 * N * C + NR * K * L
                 + N * L * Dd + NR * K + scale.numel() + Dd * Dd + Dd
                 + Dd * C + C)
    n_in = n_bytes(args) + n_bytes(kwargs.get("slots") or ())
    valid = count_valid(args, 7, valid)
    return _bound(n_in + n_out, 6.0 * Dd * (C + Dd) * valid,
                  kwargs["pair_dtype"])
