"""Row 2, the dense GATA backward; the bound copied from ``chip_smoke.py``
``bwd_bound_ms`` (the valid pairs passed in, not counted here)."""

from harness.roofline import bound_ms as _bound, count_valid, n_bytes

MODULE = "gotennet_tpu_torch.ops.fused_gata"
WRAPPER = "fused_gata_backward"
VALID_ARG = 7


def bound_ms(args, kwargs, valid=None) -> tuple:
    """The GATA backward: each input read once, the 11 cotangents it
    computes written once (float32; 13 with ``pos_grads``: g_rl and g_env
    too); six projections (t W_rs and t W_re recomputed, g_tf W_rs^T, g_zre
    W_re^T, t^T g_tf, t^T g_zre), 6 D (mult D + D) FLOP per valid pair (the
    position sums add ~2 mult D per pair, left out)."""
    t, scale, W_re, W_rs = args[0], args[8], args[9], args[11]
    Dd, C = W_re.shape[0], W_rs.shape[1]
    Gg, M = t.shape[:2]
    L = args[5].shape[-1]
    n_out = 4 * (Gg * M * M * Dd + 2 * Gg * M * Dd + 2 * Gg * M * C
                 + Gg * M * L * Dd + scale.numel() + Dd * Dd + Dd + Dd * C
                 + C)
    if kwargs.get("pos_grads"):
        n_out += 4 * (Gg * M * M * L + Gg * M * M)
    valid = count_valid(args, 7, valid)
    return _bound(n_bytes(args) + n_out, 6.0 * Dd * (C + Dd) * valid,
                  kwargs["pair_dtype"])
