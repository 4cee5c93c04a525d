#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check what it gives.

    python3 chip_smoke.py        # from the repository root, one GPU

Phases, in order; any failure exits non-zero before the result line:
  1. device: the card's name and power limit; build the CUDA kernels
     from ``gotennet_tpu_torch/csrc`` (one nvcc per source, all started
     together) and print the ``-Xptxas -v`` summary;
  2. kernel vs plain: the fused-GATA forward kernel against its plain
     PyTorch version at the flagship shapes (G=8, D=256, H=8, lmax 2,
     mult 5), M in {16, 24, 32}, float32 and bf16 pair types, padded
     atoms, scalar and per-head scale;
  3. serving: the flagship QM9 model (256 channels, 4 interactions, lmax
     2, 64 RBFs, 8 heads, bf16 pair/node types, merge_proj, Atomwise U0
     head) from a seeded init answers three requests of 1, 37 and 256
     synthetic QM9-sized molecules through ``Predictor``; the kernel's
     launch counter must equal chunks x 4 layers; each answer is held
     against the same model run through the plain version on the card;
  4. timing: the 256-molecule request (CUDA events, after warm-up), real
     edges per second, the device's busy share of that request (one more
     request under ``torch.profiler``), and the kernel's time per launch on
     the inputs the request gave it, held against the plain version and
     timed beside it and beside its bound.
The last three lines are the kernels' JSON record, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from unittest import mock

import torch

G, D, H, LMAX, N_LAYERS, CHUNK = 8, 256, 8, 2, 4, 8
REQUESTS = (1, 37, 256)
# float32: the same arithmetic, sums in another order (and the card's
# expf) -> 1e-4 of each output's scale.  bf16 pair type: both versions
# round at the same points, but the kernel's tensor-core sums are taken in
# another order (and with the tensor cores' own adder), which can round a
# pair term to the neighbouring bf16 value (2^-8 relative) -> 1e-2 of the
# scale.  The served answers carry such flips through four layers -> 2e-2
# of the scale.
TOL_F32, TOL_BF16, TOL_SERVE = 1e-4, 1e-2, 2e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def rel_err(got, want) -> tuple:
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


def kernel_inputs(M, pair_dtype, head_scale, seed):
    """Flagship-shape inputs on the card; graph 0 has 3 padded atoms."""
    gen = torch.Generator().manual_seed(seed)
    L = (LMAX + 1) ** 2 - 1
    C = (1 + 2 * LMAX) * D

    def rand(*s):
        return torch.randn(s, generator=gen) * 0.3

    valid = torch.rand(G, M, M, generator=gen) > 0.3
    valid[0, M - 3:, :] = False
    valid[0, :, M - 3:] = False
    env = torch.where(valid, torch.rand(G, M, M, generator=gen),
                      torch.tensor(-1.0))
    scale = (torch.rand(G, M, M, H, generator=gen) if head_scale
             else torch.full((G, M, M), 1.0 / math.sqrt(D)))
    nd = torch.bfloat16 if pair_dtype == torch.bfloat16 else torch.float32
    args = [rand(G, M, M, D), rand(G, M, D).to(nd), rand(G, M, D).to(nd),
            rand(G, M, C).to(nd), rand(G, M, C).to(nd), rand(G, M, M, L),
            rand(G, M, L, D), env, scale, rand(D, D), rand(D), rand(D, C),
            rand(C)]
    return [a.cuda() for a in args]


def bound_ms(args, pair_dtype) -> tuple:
    """Least time an H100 SXM could take for one launch: the larger of
    bytes / 3.35 TB/s (each input read once, each output written once)
    and the projections' FLOP / the pair type's peak (989 TFLOP/s bf16,
    67 TFLOP/s float32), counting the valid pairs only, since invalid
    pairs add exact zeros."""
    t, env, W_re, W_rs = args[0], args[7], args[9], args[11]
    Dd, C = W_re.shape[0], W_rs.shape[1]
    Gg, M = t.shape[:2]
    L = args[5].shape[-1]
    n_in = sum(a.numel() * a.element_size() for a in args)
    n_out = (Gg * M * Dd + Gg * M * L * Dd) * 4
    flops = 2.0 * int((env >= 0).sum()) * Dd * (Dd + C)
    peak = 989e12 if pair_dtype == torch.bfloat16 else 67e12
    t_bytes, t_ops = (n_in + n_out) / 3.35e12 * 1e3, flops / peak * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_calls(fn, calls, reps) -> float:
    """Mean ms per call over ``reps`` passes through ``calls``."""
    for c in calls[:2]:
        fn(c)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for c in calls:
            fn(c)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(calls))


def profile_request(pred, request, req_ms, card) -> None:
    """One request under ``torch.profiler``: the device time of its kernels
    and copies, as a share of the request's time without the profiler, and
    the device ops that took the most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pred.predict(request)
        torch.cuda.synchronize()
    # device-side events only: an aten op's row repeats its kernels' time
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in ops) / 1e3
    if busy_ms == 0.0:
        log("[profile] device time not measured: the profiler saw no device "
            "events")
        return
    log(f"[profile] {len(request)}-molecule request: device busy "
        f"{busy_ms:.3f} ms in {sum(e.count for e in ops)} device ops, "
        f"{100 * busy_ms / req_ms:.1f} % of the {req_ms:.3f} ms request "
        f"(idle {100 * (1 - busy_ms / req_ms):.1f} %) | {card}")
    for e in ops[:6]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:5d} x  {e.key[:80]}")


@torch.inference_mode()
def kernel_record(pred, request, kernel, plain, card) -> dict:
    """Capture the kernel's inputs while ``pred`` answers ``request``,
    hold the kernel against the plain version on each of them, and time
    both per launch, grouped by M, beside the bound.  (The captured
    weights are inference tensors, so the replay runs in inference mode
    too.)"""
    from gotennet_tpu_torch.ops import fused_gata
    captured = []

    def record(*args, **kwargs):
        captured.append((args, kwargs))
        return kernel(*args, **kwargs)

    with mock.patch.object(fused_gata, "fused_gata_forward", record):
        pred.predict(request)
    torch.cuda.synchronize()
    max_abs = 0.0
    for args, kwargs in captured:
        got = kernel(*args, **kwargs)
        want = plain(*args, **kwargs)
        for g_, w_ in zip(got[:2], want[:2]):
            err, rel = rel_err(g_, w_)
            max_abs = max(max_abs, err)
            if rel > TOL_BF16:
                raise AssertionError("kernel disagrees on the request's "
                                     f"inputs (rel err {rel:.3e})")
    by_m = {}
    for c in captured:
        by_m.setdefault(c[0][0].shape[1], []).append(c)
    total_k = total_p = total_b = 0.0
    bound_kind = "operations"
    for M in sorted(by_m):
        calls = by_m[M]
        k_ms = time_calls(lambda c: kernel(*c[0], **c[1]), calls, 3)
        p_ms = time_calls(lambda c: plain(*c[0], **c[1]), calls, 1)
        bounds = [bound_ms(c[0], c[1]["pair_dtype"]) for c in calls]
        b_ms = sum(b for b, _ in bounds) / len(bounds)
        bound_kind = bounds[0][1]
        total_k += k_ms * len(calls)
        total_p += p_ms * len(calls)
        total_b += b_ms * len(calls)
        log(f"[time] fused_gata_fwd M={M}: {len(calls)} launches, kernel "
            f"{k_ms:.4f} ms/launch, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({bound_kind}) | {card}")
    n = len(captured)
    return {"name": "fused_gata_fwd", "route": "cuda",
            "source": "gotennet_tpu_torch/csrc/fused_gata_fwd.cu",
            "replaces": "gotennet_tpu/ops/pallas/fused_gata.py:108",
            "launches": None, "max_abs_err": max_abs,
            "ms": total_k / n, "plain_ms": total_p / n,
            "bound_ms": total_b / n, "bound_by": bound_kind,
            "library_ms": None}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from gotennet_tpu_torch.data.dataset import DenseLoader, MoleculeDataset
    from gotennet_tpu_torch.data.dataset import synthetic_molecules
    from gotennet_tpu_torch.models.gotennet import GotenNetConfig
    from gotennet_tpu_torch.models.gotennet_dense import pair_geometry
    from gotennet_tpu_torch.ops import _build, fused_gata
    from gotennet_tpu_torch.serve import Predictor
    from gotennet_tpu_torch.tasks.qm9 import QM9Task

    bf16, f32 = torch.bfloat16, torch.float32
    kernel, plain = (fused_gata.fused_gata_forward,
                     fused_gata.fused_gata_forward_reference)

    # ---- 1. device and build -------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind} | nvidia-smi: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.time()
    _build.build_all()
    log(f"[build] {len(_build.SOURCES)} source(s) in "
        f"{time.time() - t0:.1f} s")
    for src in _build.SOURCES:
        for line in _build.build_log(src).splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[ptxas] {src}: {line.strip()}")

    # ---- 2. kernel vs plain at flagship shapes ---------------------------
    kw = dict(lmax=LMAX, num_heads=H, sep_dir=True, sep_tensor=True)
    for M in (16, 24, 32):
        for pd in (f32, bf16):
            for head_scale in (False, True):
                args = kernel_inputs(M, pd, head_scale, seed=M)
                got = kernel(*args, **kw, pair_dtype=pd, with_attn=True)
                torch.cuda.synchronize()
                want = plain(*args, **kw, pair_dtype=pd, with_attn=True)
                tol = TOL_BF16 if pd == bf16 else TOL_F32
                errs = [rel_err(g, w) for g, w in zip(got, want)]
                log(f"[kernel-vs-plain] M={M} pair={str(pd)[6:]} "
                    f"head_scale={head_scale}: max abs / rel err "
                    + ", ".join(f"{n} {a:.3e}/{r:.3e}" for n, (a, r)
                                in zip(("d_h", "dX", "sm"), errs))
                    + f" (tol {tol:g} rel)")
                if not all(r <= tol for _, r in errs):
                    raise AssertionError(f"kernel disagrees at M={M} {pd}")
                sm = got[2]
                if not (torch.all(sm[0, M - 3:] == 0)
                        and torch.all(got[0][0, M - 3:] == 0)):
                    raise AssertionError("padded atoms got weight")

    # ---- 3. serving path at full width -----------------------------------
    cfg = GotenNetConfig(n_atom_basis=D, n_interactions=N_LAYERS, lmax=LMAX,
                         n_rbf=64, num_heads=H, pair_dtype=bf16,
                         node_dtype=bf16, merge_proj=True)
    head = QM9Task("U0", dataset_meta={"mean": 0.0, "std": 1.0}).build_head()
    pred = Predictor(cfg, head, seed=0, chunk=CHUNK)
    ds = synthetic_molecules(sum(REQUESTS), seed=0, min_atoms=12,
                             max_atoms=29)
    mols = ds.graph_dicts(range(len(ds)))
    requests, off = [], 0
    for n in REQUESTS:
        requests.append(mols[off:off + n])
        off += n
    kernel.launches = 0
    answers = [pred.predict(r) for r in requests]
    torch.cuda.synchronize()
    launches = kernel.launches
    expected = sum(math.ceil(n / CHUNK) for n in REQUESTS) * N_LAYERS
    log(f"[serve] answered {len(requests)} requests of {REQUESTS} molecules;"
        f" kernel launches {launches} (chunks x layers = {expected})")
    if launches != expected:
        raise AssertionError(f"{launches} kernel launches, expected "
                             f"{expected}")
    with mock.patch.object(fused_gata, "fused_gata_forward", plain):
        plain_answers = [pred.predict(r) for r in requests]
    for n, got, want in zip(REQUESTS, answers, plain_answers):
        got_t, want_t = torch.from_numpy(got), torch.from_numpy(want)
        err, rel = rel_err(got_t, want_t)
        log(f"[serve] request of {n}: shape {tuple(got.shape)}, max abs err "
            f"vs plain path {err:.4e} (rel {rel:.3e}, tol {TOL_SERVE:g})")
        if (got.shape != (n, 1) or not torch.isfinite(got_t).all()
                or rel > TOL_SERVE):
            raise AssertionError(f"request of {n} disagrees with the plain "
                                 "path")

    # ---- 4. timing ---------------------------------------------------------
    big = requests[-1]
    ds_big = MoleculeDataset(z=[m["z"] for m in big],
                             pos=[m["pos"] for m in big])
    real_edges = padded_pairs = 0
    for b in DenseLoader(ds_big, batch_size=CHUNK, bucket=True,
                         bucket_window=math.ceil(len(big) / CHUNK)):
        b = b.to("cuda")
        real_edges += int(pair_geometry(b.pos, b.mask, cfg.cutoff,
                                        cfg.max_num_neighbors).pair_mask.sum())
        padded_pairs += b.num_graphs * b.max_atoms ** 2
    for _ in range(2):
        pred.predict(big)
    reps = 5
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        pred.predict(big)
    end.record()
    torch.cuda.synchronize()
    req_ms = start.elapsed_time(end) / reps
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    log(f"[time] 256-molecule request: {req_ms:.3f} ms (CUDA events), "
        f"{host_ms:.3f} ms (host clock); real edges {real_edges} "
        f"(self-loops included), padded pairs {padded_pairs}; "
        f"{real_edges / (req_ms / 1e3):.1f} real edges/s | {card}")

    profile_request(pred, big, req_ms, card)
    # the kernel on the inputs the 256-molecule request gave it
    record = kernel_record(pred, big, kernel, plain, card)
    record["launches"] = launches
    log(json.dumps({"kernels": [record]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
