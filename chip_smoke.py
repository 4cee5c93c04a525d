#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check what it gives.

    python3 chip_smoke.py        # from the repository root, one GPU

(``--rank ...`` is how phase 37 starts its ranks.)

Phases, in order; any failure exits non-zero before the result line:
  1. device: the card's name and power limit; build the CUDA kernels
     from ``gotennet_tpu_torch/csrc`` (one nvcc per source, all started
     together, and the host neighbour list with g++ beside them) and print
     the ``-Xptxas -v`` summary;
  2. kernel vs plain: the fused-GATA forward kernel against its plain
     PyTorch version at the flagship shapes (G=8, D=256, H=8, lmax 2,
     mult 5), M in {16, 24, 32}, float32 and bf16 pair types, padded
     atoms, scalar and per-head scale, the same bits from a second run;
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
     timed beside it and beside its bound;
  5. backward kernel vs plain: the fused-GATA backward kernel against its
     plain PyTorch version at the training shapes (G=16, D=256, H=8, lmax
     2, mult 5), M in {16, 24, 32}, float32 and bf16 pair types, scalar and
     per-head scale, padded atoms (whose cotangents must be exact zeros),
     the same bits from a second run;
  6. training: ``train_steps`` takes one step of the flagship model on 256
     synthetic QM9-sized molecules in 16-graph accumulation chunks; both
     kernels' launch counters must equal chunks x 4 layers.  The first
     step's gradients are held against the same step with the backward's
     plain version; three steps are timed after two warm-up steps (CUDA
     events), with real edges per second, the device's busy share of a step
     (``torch.profiler``) and the backward kernel's time per launch on the
     inputs a step gave it, beside its plain version and its bound;
  7. HTR forward kernel vs plain: the fused-HTR forward against its plain
     PyTorch version at G=4, D=256, lmax 2, sep_htr, M in {16, 32, 112,
     120}, float32 and bf16 pair types, bf16 EQ/EK (and float32 ones at
     M = 120 with a bf16 pair type), the flagship grammar and the
     sigmoid-gated variant (every pair compared, padded ones included), the
     same bits from a second run;
  8. HTR backward kernel vs plain: the same grid, all six cotangents, with
     exact zeros where the cotangent of out is zero (padded atoms), the
     same bits from a second run;
  9. GATA kernels at M = 112 and 120: forward and backward against their
     plain versions at the MD22 chunk's shapes (G=4), each run twice (the
     same bits);
 10. MD22 serving: the flagship model with ``fused_htr=True`` answers 32
     synthetic MD22-sized frames (110-120 atoms at condensed-phase density)
     through ``Predictor`` in unbucketed 4-frame chunks (M = 120); the launch
     counters must read 8 chunks x 4 layers of GATA and x 3 of HTR; the
     answers are held against the same model run through both forward plain
     versions; the request is timed (CUDA events) and profiled, and the HTR
     forward kernel timed on the inputs the request gave it and split per
     launch (``[passes]``: the bf16 W_g, then the update);
 11. MD22 training: ``train_steps`` takes one step on the same 32 frames
     (4-frame chunks, unbucketed): 32 GATA and 24 HTR launches each way; the
     first step's gradients are held against the same step through both
     backward plain versions; three steps are timed after two warm-up steps,
     profiled, and the HTR backward kernel timed on a step's inputs and
     split per pass (``[passes]``);
 12. ELL message kernel vs plain: the fused ELL forward against its plain
     PyTorch version at N = 704 rows, K = 36 slots, D = 256, H = 8, lmax 2,
     float32 and bf16 pair types, scalar and per-head scale, a third of the
     slots and the last 8 rows padded, and a case with fewer rows than
     table rows; the same bits from a second run;
 13. ELL HTR kernel vs plain: the same shapes, the flagship grammar and the
     sigmoid-gated variant, float32 and bf16 pair types, float32 node tables
     (and bf16 ones with a bf16 pair type), every slot compared, the same
     bits from a second run;
 14. ELL serving: the flagship model with ``fused_htr=True`` answers 8
     synthetic frames of 600-700 atoms at condensed-phase density
     (``bench.py``'s ``BENCH_DATASET=large``) through
     ``Predictor(layout="ell")``, one frame per chunk, atoms spatially sorted,
     64-row gather windows; the launch counters must read 8 chunks x 4
     layers of the message and x 3 of the HTR update; the answers are held
     against the same model run through both plain versions; the loader's
     host time is logged with the chunks; the request is timed (CUDA
     events) and profiled, and both kernels rerun to the same bits, timed on
     the inputs the request gave them and split per launch (``[passes]``:
     the bf16 weights and tables, then the message kernel or the update);
 15. ELL message backward kernel vs plain: at phase 12's shapes and cases,
     all 13 cotangents, exact zeros for g_t, g_rl, g_env and g_scale at
     padded slots, and the same bits from a second run;
 16. ELL HTR backward kernel vs plain: phase 13's shapes and variants, all
     six cotangents, the same bits from a second run;
 17. ELL training: ``train_steps(layout="ell")`` takes one step on phase 14's
     8 frames, one per chunk: 32 ELL message and 24 ELL HTR launches each
     way; the first step's gradients are held against the same step through
     both backward plain versions; three steps are timed after two warm-up
     steps (CUDA events), with real edges per second, the device's busy share
     of a step (``torch.profiler``) and both backward kernels timed on the
     inputs a step gave them (rerun to the same bits), beside their plain
     versions and bounds, and both split per pass (``[passes]``);
 18. GATA backward with position cotangents vs plain: ``pos_grads=True``
     (g_rl and g_env, the half forces need) at M 16/24/32 (G=16) and
     112/120 (G=4), float32 and bf16, scalar and per-head scale: all 13
     cotangents, exact zeros at padded atoms and invalid pairs, the same
     bits from a second run;
 19. MD22 forces: the flagship model with ``fused_htr=True`` and MD22Task's
     force head answers phase 10's 32 frames with energies and forces
     through ``Predictor.predict_with_forces`` (unbucketed 4-frame chunks):
     32 GATA forward and backward launches and 24 HTR forward and backward
     launches; energies and forces held against the same model through all
     four plain versions; a finite-difference check of the forces on one
     frame with float32 pair and node types; the request timed (CUDA events)
     and profiled, and the GATA backward timed on the request's own inputs
     beside its bound and plain version; both backwards split per pass;
 20. ELL forces: phase 14's 8 frames of 600-700 atoms, one per chunk,
     through ``predict_with_forces(layout="ell")``: 32 ELL message and 24
     ELL HTR launches each way, energies and forces held against the plain
     path, timed and profiled, the ELL HTR backward split per pass;
 21. the backward kernels' product alone: ``PRODUCT_SOURCE`` (the product
     and column sums of ``csrc/bwd_sums.cuh`` behind a plain C interface)
     at the MD22 chunk's 57,600 pairs and the ELL chunk's 25,344 slots, the
     six products of a message backward held against torch.matmul of the
     same bf16-rounded factors (and the column sums against a float64 sum),
     twice (the same bits), then timed beside torch.matmul of the same six
     bf16 products (a yardstick only: the port never calls it); and the
     yardsticks of every kernel's products: torch.matmul from bf16 factors
     of the message forwards' t W_re and t W_rs (57,600 pairs, each QM9
     request launch's pairs, 25,344 ELL slots), the HTR backwards' t W_g,
     g_z W_g^T and t^T g_z and the HTR forwards' t W_g (57,600 pairs and
     25,344 slots), each logged beside the kernel's own ms a launch;
 22. the native neighbour list (``csrc/neighborlist.cpp``, built with g++
     in phase 1 beside the kernels): on the xl frames its edges equal
     ``build_edges_np``'s, arrays in the same order, both timed;
 23. xl serving: ``bench.py``'s ``BENCH_DATASET=xl``, 2 synthetic frames of
     4,000-4,200 atoms, as phase 14 (the flagship with ``fused_htr=True``,
     ``Predictor(layout="ell")``, one frame per chunk): N = 4,224 rows is
     above ``fused_table_rows`` = 2048, where the JAX package chunks its
     kernels over halo windows (the geometry ``pick_chunking`` gives is
     logged) and the port runs them on the whole table; 2 x 4 message and
     2 x 3 HTR launches; answers against both plain versions; loader host
     time, wall, busy, real edges/s; both kernels on the request's inputs
     beside their bounds and plain versions, rerun to the same bits;
 24. xl training: one step through ``train_steps(layout="ell", chunk=1)``
     on the same 2 frames, as phase 17: 8 message and 6 HTR launches each
     way, the first step's gradients against both backward plain versions,
     three steps timed after two warm-up steps and profiled, both backward
     kernels on a step's inputs beside their bounds, rerun to the same bits;
 25. the ``large_molecule`` experiment's model (``fused=True,
     fused_htr=False``: the fused message, the unfused HTR update) on phase
     14's 8 frames: one request (32 message launches, no HTR launch)
     against the plain message path, and one training step (32 message
     launches each way) with its gradients against the plain message
     backward, each timed and profiled;
 26. QM9 through the command line: ``cli.main(["train",
     "experiment=qm9_u0_tpu", ...])`` on 1,280 synthetic 12-29-atom
     molecules (1,024 / 128 / 128), 2 epochs: the flagship width, bf16
     pairs, fused, bucketed, ``grad_accum_steps`` 8 and attention dropout
     0.1 (32 batches and 4 optimizer steps an epoch).  Both GATA kernels'
     launches must equal batches x 4 layers, every training launch must
     take a per-head scale (dropout) and every evaluation launch a scalar
     one; every logged loss finite; the checkpoints, splits, JSONL log and
     test results written.  ``resume=true`` on a copy of the run, to 3
     epochs, must give a fresh 3-epoch run's epoch-2 record within 1e-3
     (the head's ``index_add`` atomics make it inexact); ``cli test`` of
     ``ckpt_best`` must give the run's test results within 1e-5, and
     within ``TOL_SERVE`` through the forward's plain version.  Epoch,
     optimizer steps/s, training molecules/s, evaluation and checkpoint
     times are printed, and both kernels held against their plain
     versions and timed on the run's own inputs;
 27. ``large_molecule`` through the command line, 1 epoch on its 32
     synthetic 600-700-atom frames: 6 batches of 4 frames, 2 optimizer
     steps (``grad_accum_steps`` 4, the second from a partial group), the
     ELL message with dropout's per-head scale, no HTR launch; launches,
     losses, files, ``cli test`` against the run and the plain path, the
     same timings and records;
 28. the QM9 'mu' and 'r2' heads through the command line: ``cli train
     experiment=qm9_u0_tpu label=mu`` (the Dipole head) and ``label=r2``
     (the electronic spatial extent), each one epoch on 640 of phase 26's
     synthetic molecules (512 / 64 / 64) at the flagship width, fused, bf16
     pairs, dropout 0.1: both GATA kernels' launches equal batches x 4
     layers, dropout's per-head scale on every training launch, finite
     losses, the checkpoint's head kind, ``cli test`` against the run
     within 1e-5 and through the forward's plain version within
     ``TOL_SERVE``, the same timings and records as phase 26;
 29. the unfused dense message at MD22 size: phase 10's 32 frames through
     ``Predictor`` with ``fused=False`` (the plain-tensor message and HTR
     update: no kernel launch) against ``fused=True`` (both GATA and both
     HTR kernels) at one state dict, energies (``predict``) and energies
     and forces (``predict_with_forces``) within ``TOL_SERVE``; both paths'
     requests timed (CUDA events) and profiled, the unfused force request's
     peak memory;
 30. training on forces: ``cli train experiment=md22_atat`` as its yaml
     sets it (dense, ``fused=False``, 256 channels, 4 layers, 64 RBFs, bf16
     pairs, batch 8 at M = 120, MSE energy 0.05 / force 0.95, dropout 0.1,
     remat) for one epoch on an sGDML ``md22_AT-AT-CG-CG.npz`` the script
     writes under ``build/`` (96 synthetic frames of one 118-atom topology
     at condensed-phase density, pair-potential energies and forces): no
     kernel launch, every loss finite, the first step's gradients on the
     card against the same step on the CPU (the same weights, batch and
     dropout masks) within ``TOL_TRAIN``, then ``cli test`` against the run
     within 1e-5; epoch seconds, optimizer steps/s, frames/s, a step's time,
     busy share and peak memory, evaluation and checkpoint times;
 31. the edge-list layout (no kernel): the flagship model in float32
     answers phase 4's 256 molecules through ``Predictor(layout="edge")``
     in 8-graph chunks, held against the dense layout's plain float32 model
     at one state dict within ``TOL_EDGE`` and against the CPU within
     ``TOL_F32``; one step of ``train_steps(layout="edge")`` on 256
     molecules in 16-graph chunks; the request and a step timed, profiled
     and their peak memory;
 32. ``cli train`` / ``cli test`` of ``experiment=qm9_u0`` as the yaml sets
     it (edge layout, batch 32, MSE, warm-up and plateau) on phase 26's
     synthetic molecules for one epoch, and of ``experiment=smoke`` as it
     is: no kernel launch, finite losses, ``cli test`` against the run
     within 1e-5, epoch seconds, optimizer steps/s, molecules/s and
     evaluation seconds;
 33. ``cli train`` / ``cli test`` of ``experiment=md17_aspirin`` as the
     yaml sets it (edge layout, batch 16, MSE energy 0.05 / force 0.95,
     standardised) on an rMD17 NPZ of 1,100 synthetic 21-atom frames the
     script writes under ``build/`` (950 / 50 / 100), one epoch: the first
     force step on the card against the CPU within ``TOL_TRAIN``, a step's
     time, busy share and peak memory;
 34. every remaining option (``layernorm``, ``steerable_norm``,
     ``trainable_rbf``, ``edge_updates="gated_mlpa_linwa_postln"``,
     ``edge_ln="layer"``, ``evec_dim=128``) on phase 10's 32 frames on the
     edge, dense and ELL layouts at one state dict: the dense (the fused
     message: row 1) and ELL (row 5) energies within ``TOL_OPTIONS`` of the
     edge layout's, 32 launches each and nothing else, each request timed
     and profiled, rows 1 and 5 held against their plain versions and
     timed on these inputs;
 35. packed dense batches: phase 4's 256 molecules through
     ``DenseLoader(pack=True)`` (32 a batch, several to a slab of the
     largest molecule's M, the pairs between molecules masked) on phase 4's
     model and weights: GATA forward launches = batches x layers, energies
     within ``TOL_SERVE`` of phase 4's bucketed request; one step on phase
     6's 256 molecules packed 16 a batch (launches = batches x layers each
     way, gradients against the plain backward within ``TOL_TRAIN``); rows 1
     and 2 on the packed slabs against their plain versions, rerun to the
     same bits; both timed, profiled, and their pairs a slab logged beside
     bucketing's;
 36. Molecule3D through the command line: ``cli train
     experiment=molecule3d`` as its yaml sets it (dense, unfused: no kernel
     launch) for one epoch, then ``cli test`` within 1e-5 of the run, on an
     NPZ shard root (four shards by the port's ``save_shards``) and on an
     SDF root with ``properties.csv``, both of 320 synthetic 12-40-atom
     molecules the script writes under ``build/``;
 37. two ranks on the one card over Gloo (``python3 chip_smoke.py --rank
     ...``, started after the build, each failure printed): (a)
     ``data_parallel=2`` on phase 3's model, one step, rank d on batch d:
     4 + 4 GATA launches a rank, gradients and parameters within
     ``TOL_TRAIN`` of one process's 2-batch accumulation, parameters equal
     on both ranks; (b)
     ``edge_parallel=2`` on the ELL layout, one 600-700-atom frame (N = 704,
     NR = 352 rows a rank): a request and a step, rows 5-8 launched on each
     rank at NR = 352, energy and gradients within ``TOL_TRAIN`` of one
     process's, the four kernels on rank 0's inputs against their plain
     versions, rerun to the same bits and timed; (c) ``edge_parallel=2`` on
     the edge layout, one step of 16 molecules, gradients within
     ``TOL_EDGE`` of one process's; (d) ``cli train experiment=molecule3d
     trainer.distributed=true trainer.data_parallel=2`` on phase 36's
     shards: each rank reads its two shards, only rank 0 writes
     checkpoints, the final parameters are the same bits on both ranks;
     then NCCL at world size 1 (NCCL refuses two ranks on one card): an
     all-reduce and a ``distributed=True`` ``Trainer`` step whose gradients
     are within ``TOL_TRAIN`` of the step's with no group.  (After AdamW's
     first step a parameter whose gradient is near zero moves by about lr
     either way, so the other steps hold gradients, and log parameters.)  Gloo copies CUDA tensors
     through the host: no time here is a multi-GPU number;
 38. ``scan_layers``: phase 3's QM9 model and phase 10's MD22 model with
     ``scan_layers=True``, their weights from the stacked tree (the JAX
     package's form: the n-1 homogeneous layers under ``layers`` with a
     leading axis 3) of the unrolled model's seeded init; the stacked ->
     unrolled -> stacked round trip and the state dict from the tree exact.
     The scanned QM9 model serves phase 4's 256 molecules (row 1: 32 chunks
     x 4 launches) and takes one step on phase 6's molecules (64 + 64); the
     scanned MD22 model serves and takes a step on phase 10's frames (32
     GATA and 24 HTR launches each way); energies within ``TOL_SERVE`` of the
     unrolled model's, h and X its bits, first-step gradients in the stacked
     form within ``TOL_TRAIN``; the scanned requests and steps timed (CUDA
     events) and profiled; rows 1-4 on the scanned paths held against their
     plain versions and timed;
 39. the command line's last paths, all under a temporary directory:
     ``cli train experiment=qm9_u0_tpu model.representation.scan_layers=true``
     for one epoch at phase 26's sizes (launches = batches x 4), its NPZ
     holding ``representation/layers/gata/...`` with leading axis 3, ``cli
     test`` of it within 1e-5 of the run; a reference-form Lightning ``.ckpt``
     of the seeded flagship edge-layout model through ``cli test`` within
     1e-5 of the same weights' NPZ checkpoint, ``cli parity`` over two such
     files (two rows in ``out``), and ``cli test checkpoint=QM9_small_U0``
     resolved from a ``CHECKPOINT_PATH`` cache within 1e-5;
 40. the tools, under the same temporary directory: ``cli sweep
     experiment=smoke`` as a 2-trial grid and ``sampler=adaptive
     n_trials=3`` (``sweep.jsonl`` ends with ``best_overrides``, no trial
     failed); ``profile_fn`` of phase 4's request, its device total within
     10 % of phase 4's busy ms; ``multichip_bench()`` at world size 1 (three
     records, one per mode); ``radius_graph`` on the card against the same
     call on the CPU, the same arrays.
The last three lines are the kernels' JSON record, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import pathlib
import shutil
import subprocess
import sys
import threading
import time
from unittest import mock

import torch

G, D, H, LMAX, N_LAYERS, CHUNK = 8, 256, 8, 2, 4, 8
REQUESTS = (1, 37, 256)
TRAIN_MOLS, TRAIN_CHUNK, LR = 256, 16, 1e-4
# float32: the same arithmetic, sums in another order (and the card's
# expf) -> 1e-4 of each output's scale.  bf16 pair type: both versions
# round at the same points, but the kernel's tensor-core sums are taken in
# another order (and with the tensor cores' own adder), which can round a
# pair term to the neighbouring bf16 value (2^-8 relative) -> 1e-2 of the
# scale.  The served answers carry such flips through four layers -> 2e-2
# of the scale.
TOL_F32, TOL_BF16, TOL_SERVE = 1e-4, 1e-2, 2e-2
# A training step's gradients, backward kernel against its plain version:
# the same rounding points, float32 sums in another order; a bf16 value that
# lands on its neighbour in one layer's cotangents is carried back through
# the layers below it -> 2e-2 of each parameter's gradient scale.
TOL_TRAIN = 2e-2
# MD22-sized frames as bench.py's BENCH_DATASET=md22 makes them, in
# unbucketed 4-frame chunks (every chunk padded to M = 120)
MD22_FRAMES, MD22_CHUNK = 32, 4
MD22_SIZES = dict(min_atoms=110, max_atoms=120, box=6.3)
# 600-700-atom frames as bench.py's BENCH_DATASET=large makes them: one
# frame per chunk on the ELL layout (N = 704 rows, K = 36 slots)
LARGE_FRAMES, ELL_N, ELL_K = 8, 704, 36
LARGE_SIZES = dict(min_atoms=600, max_atoms=700, box=6.3)
# bench.py's BENCH_DATASET=xl: 4,000-4,200-atom frames, one per chunk on the
# ELL layout (N = 4,224 rows, K = 36 slots, above fused_table_rows = 2048)
XL_FRAMES = 2
XL_SIZES = dict(min_atoms=4000, max_atoms=4200, box=6.3)
# phases 26-27: the command line's train and test runs, under build/
CLI_DIR = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_cli"
CLI_QM9 = ["experiment=qm9_u0_tpu", "datamodule.dataset=synthetic",
           "datamodule.n_molecules=1280", "datamodule.min_atoms=12",
           "datamodule.max_atoms=29", "datamodule.train_size=1024",
           "datamodule.val_size=128", "datamodule.test_size=128",
           "trainer.max_epochs=2", "trainer.log_every=1"]
CLI_LARGE = ["experiment=large_molecule", "trainer.max_epochs=1"]
# phase 28: the QM9 'mu' and 'r2' heads through the command line, phase 26's
# molecules (512 / 64 / 64), one epoch each
CLI_QM9_LABELS = ["experiment=qm9_u0_tpu", "datamodule.dataset=synthetic",
                  "datamodule.n_molecules=640", "datamodule.min_atoms=12",
                  "datamodule.max_atoms=29", "datamodule.train_size=512",
                  "datamodule.val_size=64", "datamodule.test_size=64",
                  "trainer.max_epochs=1", "trainer.log_every=1"]
# phase 30: md22_atat as its yaml sets it, on an sGDML file of 96 synthetic
# frames of one 118-atom topology (77 / 10 / 9 frames), one epoch
MD22_CLI_FRAMES, MD22_CLI_ATOMS = 96, 118
# resume against a fresh run: the same steps, the Atomwise head's
# index_add atomics on the card -> 1e-3; cli test of the same checkpoint
# on the same data -> 1e-5
TOL_RESUME, TOL_CLI_TEST = 1e-3, 1e-5
# ms a launch of the kernels that phase 21's yardsticks are logged beside,
# by "kernel, path" (filled by the phases that time them)
KERNEL_MS = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


# The backward kernels' product and column sums (csrc/bwd_sums.cuh) alone,
# behind a plain C interface, so phase 21 and the host tests can hold them
# against torch.matmul; a measuring aid, not part of the port.
PRODUCT_SOURCE = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {
constexpr int kThreads = 256;
}  // namespace

#include "bwd_sums.cuh"

namespace {
template <typename K, typename A>
cudaError_t run(K kern, dim3 grid, size_t smem, const A& args,
                cudaStream_t stream) {
  kern<<<grid, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}
}  // namespace

extern "C" long long gotennet_product_part_floats(long long depth, int rows,
                                                  int cols) {
  const long long w = (long long)pair_splits(depth, rows, cols) * rows * cols;
  const long long b = (long long)col_strips(depth, cols) * cols;
  return w > b ? w : b;
}

// out [rows, cols] (row stride cols) = A B (+ bias), A(m, k) = a[m * a_sm +
// k * a_sk], B(k, n) = b[k * b_sk + n * b_sn] (float or bf16 storage; a bf16
// pair type takes bf16 factors); over_pairs: split over the depth into
// `part`, as the weight gradients are formed
extern "C" int gotennet_product(const void* a, long long a_sm, long long a_sk,
                                int a_bf16, const void* b, long long b_sk,
                                long long b_sn, int b_bf16, float* out,
                                const float* bias, int rows, int cols,
                                int depth, int accumulate, int round_out,
                                int over_pairs, int pair_bf16, float* part,
                                void* stream) {
  Product g{};
  g.a = a; g.a_sm = a_sm; g.a_sk = a_sk; g.a_bf16 = a_bf16;
  g.b = b; g.b_sk = b_sk; g.b_sn = b_sn; g.b_bf16 = b_bf16;
  g.out = out; g.o_sm = cols; g.bias = bias;
  g.rows = rows; g.cols = cols; g.depth = depth;
  g.accumulate = accumulate; g.round_out = round_out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (over_pairs) {
    return (int)(pair_bf16 ? product_over_pairs<true>(g, part, s)
                           : product_over_pairs<false>(g, part, s));
  }
  return (int)(pair_bf16 ? product<true>(g, s) : product<false>(g, s));
}

extern "C" int gotennet_column_sums(const float* x, int rows, int cols,
                                    float* part, float* out, void* stream) {
  return (int)column_sums(x, rows, cols, part, out,
                          static_cast<cudaStream_t>(stream));
}

extern "C" const char* gotennet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
"""
# the one kernel-launch line of PRODUCT_SOURCE (a host build replaces it)
PRODUCT_LAUNCH = "kern<<<grid, kThreads, smem, stream>>>(args);"


def declare_products(lib):
    """Argument and result types of PRODUCT_SOURCE's C interface."""
    import ctypes
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gotennet_product_part_floats.argtypes = [i64, i32, i32]
    lib.gotennet_product_part_floats.restype = i64
    lib.gotennet_product.argtypes = ([ptr, i64, i64, i32, ptr, i64, i64, i32,
                                      ptr, ptr] + [i32] * 7 + [ptr, ptr])
    lib.gotennet_product.restype = i32
    lib.gotennet_column_sums.argtypes = [ptr, i32, i32, ptr, ptr, ptr]
    lib.gotennet_column_sums.restype = i32
    lib.gotennet_cuda_error_string.argtypes = [i32]
    lib.gotennet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build_products():
    """PRODUCT_SOURCE built with nvcc beside the kernels (``build/``), as
    the kernels are built; the loaded library."""
    import ctypes
    from gotennet_tpu_torch.ops import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "product_check.cu"
    src.write_text(PRODUCT_SOURCE)
    lib = _build.BUILD_DIR / "libproduct_check.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}",
                    "-o", str(lib), str(src)], check=True,
                   capture_output=True, timeout=600)
    return declare_products(ctypes.CDLL(str(lib)))


def _raise_on(lib, err, what) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({lib.gotennet_cuda_error_string(err).decode()})")


def run_product(lib, A, B, out, *, bias=None, accumulate=False,
                round_out=False, over_pairs=False, bf16=True, stream=None):
    """out [rows, cols] (=, or += with ``accumulate``) = A B (+ bias) through
    PRODUCT_SOURCE: A a [rows, depth] view, B a [depth, cols] view, each
    row-major or column-major (a transposed view reads its tensor across the
    leading axis); with ``bf16`` both factors are rounded to bf16 first (as
    the backward kernels keep bf16 copies of their factors), with their
    layouts kept."""
    bf = torch.bfloat16
    if bf16:
        A, B = (x if x.dtype == bf else (x.to(bf) if x.is_contiguous()
                                         else x.t().to(bf).t())
                for x in (A, B))
    rows, depth = A.shape
    cols = B.shape[1]
    part = torch.empty(max(1, lib.gotennet_product_part_floats(depth, rows,
                                                               cols)),
                       dtype=torch.float32, device=out.device)
    err = lib.gotennet_product(
        A.data_ptr(), A.stride(0), A.stride(1), int(A.dtype == bf),
        B.data_ptr(), B.stride(0), B.stride(1), int(B.dtype == bf),
        out.data_ptr(),
        bias.data_ptr() if bias is not None else None, rows, cols, depth,
        int(accumulate), int(round_out), int(over_pairs), int(bf16),
        part.data_ptr(), stream)
    _raise_on(lib, err, "product")


def run_column_sums(lib, x, out, stream=None):
    """out [cols] = the sum over the rows of x [rows, cols] through
    PRODUCT_SOURCE's column sums."""
    rows, cols = x.shape
    part = torch.empty(max(1, lib.gotennet_product_part_floats(rows, 1,
                                                               cols)),
                       dtype=torch.float32, device=x.device)
    _raise_on(lib, lib.gotennet_column_sums(x.data_ptr(), rows, cols,
                                            part.data_ptr(), out.data_ptr(),
                                            stream), "column sums")


def backward_products(P, seed, device="cuda"):
    """The six pair products of a message backward at P pairs (flagship D
    and C = 5 D) on seeded factors: a list of (name, steps) where each step
    (A, B, bias, round_out, accumulate, over_pairs) adds into one output,
    as fused_gata_bwd.cu and fused_ell_bwd.cu chain them; and the bias
    gradients' column-sum inputs."""
    gen = torch.Generator().manual_seed(seed)
    C = (1 + 2 * LMAX) * D

    def rand(*s):
        return (torch.randn(s, generator=gen) * 0.3).to(device)

    t, g_tf, g_z = rand(P, D), rand(P, C), rand(P, D)
    W_rs, W_re, b_rs, b_re = rand(D, C), rand(D, D), rand(C), rand(D)
    prods = [("t W_rs + b_rs", [(t, W_rs, b_rs, True, False, False)]),
             ("t W_re + b_re", [(t, W_re, b_re, False, False, False)]),
             ("g_tf W_rs^T + g_zre W_re^T",
              [(g_tf, W_rs.t(), None, False, False, False),
               (g_z, W_re.t(), None, False, True, False)]),
             ("t^T g_tf", [(t.t(), g_tf, None, False, False, True)]),
             ("t^T g_zre", [(t.t(), g_z, None, False, False, True)])]
    return prods, (g_tf, g_z)


def hold_products(lib, P, seed) -> list:
    """The product and the column sums of PRODUCT_SOURCE against
    torch.matmul (float32, no TF32) of the same bf16-rounded factors at P
    pairs, each run twice (the same bits); returns (name, max abs err, rel
    err) of each.  Exact products, float32 sums in another order -> 1e-5 of
    the scale; a rounded output may land on the neighbouring bf16 value ->
    one ulp of it more."""
    stream = torch.cuda.current_stream().cuda_stream
    prods, sums = backward_products(P, seed)
    rows = []
    for name, steps in prods:
        runs, want = [], None
        for _ in range(2):
            out = torch.empty(steps[0][0].shape[0], steps[0][1].shape[1],
                              device="cuda")
            for A, B, bias, round_out, accumulate, over_pairs in steps:
                run_product(lib, A, B, out, bias=bias, round_out=round_out,
                            accumulate=accumulate, over_pairs=over_pairs,
                            stream=stream)
            runs.append(out)
        slack = 0.0
        for A, B, bias, round_out, _, _ in steps:
            w = (A.to(torch.bfloat16).float() @ B.to(torch.bfloat16).float())
            if bias is not None:
                w = w + bias
            if round_out:
                w = w.to(torch.bfloat16).float()
                slack = torch.ldexp(torch.ones_like(w),
                                    torch.frexp(w).exponent - 8)
            want = w if want is None else want + w
        torch.cuda.synchronize()
        err = (runs[0] - want).abs()
        scale = float(want.abs().max())
        if not bool((err <= 1e-5 * scale + slack).all()):
            raise AssertionError(f"product {name} at P={P} disagrees with "
                                 f"torch.matmul (max abs err "
                                 f"{float(err.max()):.3e})")
        if not same_bits(runs[0:1], runs[1:2]):
            raise AssertionError(f"product {name} differs between runs")
        rows.append((name, float(err.max()), float(err.max()) / scale))
    for name, x in zip(("column sums of g_tf", "column sums of g_zre"), sums):
        got = [torch.empty(x.shape[1], device="cuda") for _ in range(2)]
        for out in got:
            run_column_sums(lib, x, out, stream)
        want = x.double().sum(dim=0)
        err = float((got[0].double() - want).abs().max())
        rel = err / float(want.abs().max())
        if rel > 1e-5 or not same_bits(got[0:1], got[1:2]):
            raise AssertionError(f"{name} at P={P}: rel err {rel:.3e} or "
                                 "not the same bits twice")
        rows.append((name, err, rel))
    return rows


def products_phase(card) -> None:
    """Phase 21: the backward kernels' product alone (PRODUCT_SOURCE) at
    the MD22 chunk's pairs (P = 4 x 120 x 120) and the ELL chunk's slots
    (P = 704 x 36), held against torch.matmul; then the time of each of the six
    products through PRODUCT_SOURCE (from bf16 factors, as the backward
    kernels keep them) and of torch.matmul of the same six bf16 products (a
    yardstick for the products only: the port never calls it), each the
    mean of 10 runs between CUDA events after a warm-up."""
    lib = build_products()
    stream = torch.cuda.current_stream().cuda_stream
    bf = torch.bfloat16
    for what, P in (("M=120", MD22_CHUNK * 120 * 120), ("ELL", ELL_N * ELL_K)):
        for name, err, rel in hold_products(lib, P, seed=900):
            log(f"[products] {what} P={P} {name}: max abs err {err:.3e} "
                f"(rel {rel:.3e}; tol 1e-5 rel + one bf16 ulp where rounded)")
        prods, _ = backward_products(P, seed=901)
        total = total_lib = flops = 0.0
        for name, steps in prods:
            steps = [(A.to(bf) if A.is_contiguous() else A.t().to(bf).t(),
                      B.to(bf) if B.is_contiguous() else B.t().to(bf).t(),
                      *rest) for A, B, *rest in steps]
            out = torch.empty(steps[0][0].shape[0], steps[0][1].shape[1],
                              device="cuda")

            def ours():
                for A, B, bias, ro, acc, op in steps:
                    run_product(lib, A, B, out, bias=bias, round_out=ro,
                                accumulate=acc, over_pairs=op, stream=stream)

            def library():
                for A, B, *_ in steps:
                    torch.matmul(A, B)

            f = sum(2.0 * A.shape[0] * A.shape[1] * B.shape[1]
                    for A, B, *_ in steps)
            ms, lib_ms = (time_calls(lambda _, fn=fn: fn(), [None], 10)
                          for fn in (ours, library))
            total, total_lib, flops = total + ms, total_lib + lib_ms, flops + f
            log(f"[products] {what} {name}: {ms:.4f} ms "
                f"({f / ms / 1e9:.1f} TFLOP/s); torch.matmul {lib_ms:.4f} ms "
                f"({f / lib_ms / 1e9:.1f} TFLOP/s) | {card}")
        log(f"[products] {what} P={P}: the six products {total:.4f} ms "
            f"({flops / total / 1e9:.1f} TFLOP/s, mma.sync bf16, partial sums "
            f"and bias included); torch.matmul of the same six bf16 products "
            f"(yardstick, not on the port's path) {total_lib:.4f} ms "
            f"({flops / total_lib / 1e9:.1f} TFLOP/s) | {card}")


def matmul_ms(shapes) -> float:
    """ms of torch.matmul of seeded bf16 factors, one call per (rows,
    depth, cols) in ``shapes`` (a transposed first factor as (depth, rows)
    with a negative rows), the mean of 10 passes between CUDA events."""
    gen = torch.Generator().manual_seed(902)
    pairs = []
    for rows, depth, cols in shapes:
        if rows < 0:   # the weight gradient's t^T: a [P, D] tensor read across P
            a = torch.randn(depth, -rows, generator=gen).t()
        else:
            a = torch.randn(rows, depth, generator=gen)
        pairs.append((a.to("cuda", torch.bfloat16), torch.randn(
            depth, cols, generator=gen).to("cuda", torch.bfloat16)))
    return time_calls(lambda _: [torch.matmul(a, b) for a, b in pairs],
                      [None], 10)


def yardsticks(card, qm9_shapes) -> None:
    """Phase 21, second half: torch.matmul of each kernel's products from
    bf16 factors, logged beside the kernel's own ms a launch (yardsticks
    only: the port never calls them).  The message forwards' two
    projections t W_re and t W_rs (row 1 at the MD22 chunk's 57,600 pairs
    and at the pairs of each launch of the 256-molecule QM9 request,
    ``qm9_shapes``, the shapes of t; row 5 at the ELL chunk's 25,344
    slots); the HTR backwards' three products t W_g, g_z W_g^T and t^T g_z
    (row 4 at 57,600 pairs, row 8 at 25,344 slots); the HTR forwards' t W_g
    (row 3 at 57,600 pairs, row 7 at 25,344 slots)."""
    C = (1 + 2 * LMAX) * D
    P = MD22_CHUNK * 120 * 120
    S = ELL_N * ELL_K
    rows = [("fused_gata_fwd, MD22 request", f"t W_re + t W_rs at P={P}",
             matmul_ms([(P, D, D), (P, D, C)]))]
    by_pairs = {}
    for shape in qm9_shapes:
        n = shape[0] * shape[1] * shape[2]
        by_pairs[n] = by_pairs.get(n, 0) + 1
    total = sum(matmul_ms([(n, D, D), (n, D, C)]) * k
                for n, k in by_pairs.items())
    rows.append(("fused_gata_fwd, QM9 request",
                 f"t W_re + t W_rs, mean over the {len(qm9_shapes)} launches "
                 f"(P {sorted(by_pairs)})", total / max(len(qm9_shapes), 1)))
    rows.append(("fused_ell_fwd, ELL request", f"t W_re + t W_rs at P={S}",
                 matmul_ms([(S, D, D), (S, D, C)])))
    for kernel, n in (("fused_htr_bwd, MD22 step", P),
                      ("fused_htr_ell_bwd, ELL step", S)):
        rows.append((kernel, f"t W_g + g_z W_g^T + t^T g_z at P={n}",
                     matmul_ms([(n, D, D), (n, D, D), (-D, n, D)])))
    for kernel, n in (("fused_htr_fwd, MD22 request", P),
                      ("fused_htr_ell_fwd, ELL request", S)):
        rows.append((kernel, f"t W_g at P={n}", matmul_ms([(n, D, D)])))
    for kernel, what, ms in rows:
        own = KERNEL_MS.get(kernel)
        log(f"[yardstick] {kernel}: torch.matmul of {what} from bf16 factors "
            f"{ms:.4f} ms (not on the port's path); the kernel "
            + (f"{own:.4f} ms a launch" if own is not None else "not timed")
            + f" | {card}")


def rel_err(got, want) -> tuple:
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


def kernel_inputs(M, pair_dtype, head_scale, seed, G=G):
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


def bound_ms(n_bytes, flops, pair_dtype) -> tuple:
    """Least time an H100 SXM could take for one launch: the larger of
    ``n_bytes`` / 3.35 TB/s and ``flops`` / the pair type's peak (989
    TFLOP/s bf16, 67 TFLOP/s float32)."""
    peak = 989e12 if pair_dtype == torch.bfloat16 else 67e12
    t_bytes, t_ops = n_bytes / 3.35e12 * 1e3, flops / peak * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def n_bytes(tensors) -> int:
    return sum(a.numel() * a.element_size() for a in tensors)


def fwd_bound_ms(args, kwargs) -> tuple:
    """The GATA forward: each input read once, d_h and dX written once; the
    two projections t W_re and t W_rs, 2 D (D + mult D) FLOP per valid pair
    (invalid pairs add exact zeros)."""
    t, W_re, W_rs = args[0], args[9], args[11]
    Dd, C = W_re.shape[0], W_rs.shape[1]
    Gg, M = t.shape[:2]
    L = args[5].shape[-1]
    n_out = (Gg * M * Dd + Gg * M * L * Dd) * 4
    valid = int((args[7] >= 0).sum())
    return bound_ms(n_bytes(args) + n_out, 2.0 * Dd * (Dd + C) * valid,
                    kwargs["pair_dtype"])


def bwd_bound_ms(args, kwargs) -> tuple:
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
    valid = int((args[7] >= 0).sum())
    return bound_ms(n_bytes(args) + n_out, 6.0 * Dd * (C + Dd) * valid,
                    kwargs["pair_dtype"])


def htr_fwd_bound_ms(args, kwargs) -> tuple:
    """The HTR forward: t, EQ, EK, rl, W_g, b_g read once, out (float32)
    written once; the projection t W_g, 2 D^2 FLOP per pair, over every pair
    (the update masks none)."""
    t, W_g = args[0], args[4]
    pairs = t.numel() // t.shape[-1]
    return bound_ms(n_bytes(args) + 4 * t.numel(),
                    2.0 * W_g.numel() * pairs, kwargs["pair_dtype"])


def htr_bwd_bound_ms(args, kwargs) -> tuple:
    """The HTR backward: the six inputs and the cotangent of out read once,
    the six cotangents written once (float32); three projections (t W_g
    recomputed, g_z W_g^T, t^T g_z), 6 D^2 FLOP per pair, over every
    pair."""
    t, W_g = args[0], args[4]
    pairs = t.numel() // t.shape[-1]
    n_out = 4 * sum(a.numel() for a in args[:6])
    return bound_ms(n_bytes(args) + n_out, 6.0 * W_g.numel() * pairs,
                    kwargs["pair_dtype"])


def ell_fwd_bound_ms(args, kwargs) -> tuple:
    """The ELL message: each input read once (the node tables as tables),
    d_h and dX written once; the two projections t W_re and t W_rs,
    2 D (D + mult D) FLOP per valid slot (padded ones add exact zeros)."""
    t, W_re, W_rs = args[0], args[10], args[12]
    Dd, C = W_re.shape[0], W_rs.shape[1]
    NR, L = t.shape[0], args[5].shape[-1]
    n_out = (NR * Dd + NR * L * Dd) * 4
    valid = int((args[7] >= 0).sum())
    return bound_ms(n_bytes(args) + n_out, 2.0 * Dd * (Dd + C) * valid,
                    kwargs["pair_dtype"])


def htr_ell_fwd_bound_ms(args, kwargs) -> tuple:
    """The ELL HTR update: t, EQ, EK (as a table), rl, nbr, W_g, b_g read
    once, out (float32) written once; the projection t W_g, 2 D^2 FLOP per
    slot, over every slot (the update masks none)."""
    t, W_g = args[0], args[5]
    pairs = t.numel() // t.shape[-1]
    return bound_ms(n_bytes(args) + 4 * t.numel(),
                    2.0 * W_g.numel() * pairs, kwargs["pair_dtype"])


def ell_bwd_bound_ms(args, kwargs) -> tuple:
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
    valid = int((args[7] >= 0).sum())
    return bound_ms(n_in + n_out, 6.0 * Dd * (C + Dd) * valid,
                    kwargs["pair_dtype"])


def htr_ell_bwd_bound_ms(args, kwargs) -> tuple:
    """The ELL HTR backward: t, EQ, EK (as a table), rl, nbr, W_g, b_g, the
    cotangent of out and the transposed slot list read once, the six
    cotangents written once (float32); three projections (t W_g recomputed,
    g_z W_g^T, t^T g_z), 6 D^2 FLOP per slot, over every slot."""
    t, EQ, EK, rl, W_g = args[0], args[1], args[2], args[3], args[5]
    pairs = t.numel() // t.shape[-1]
    n_out = 4 * (t.numel() + EQ.numel() + EK.numel() + rl.numel()
                 + W_g.numel() + W_g.shape[0])
    n_in = n_bytes(args) + n_bytes(kwargs.get("slots") or ())
    return bound_ms(n_in + n_out, 6.0 * W_g.numel() * pairs,
                    kwargs["pair_dtype"])


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


def time_run(run, warmup, reps) -> tuple:
    """``run()`` ``warmup`` times, then ``reps`` times between CUDA events:
    (device ms per run, host ms per run, every run's result)."""
    results = [run() for _ in range(warmup)]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    results += [run() for _ in range(reps)]
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    return start.elapsed_time(end) / reps, host_ms, results


def count_pairs(chunks, cfg) -> tuple:
    """(real edges, self-loops included, as the edge list counts them;
    padded pairs, a packed slab's pairs between molecules among them) of
    dense chunks on the card."""
    from gotennet_tpu_torch.models.gotennet_dense import pair_geometry
    real = sum(int(pair_geometry(b.pos, b.mask, cfg.cutoff,
                                 cfg.max_num_neighbors, b.seg)
                   .pair_mask.sum()) for b in chunks)
    return real, sum(b.num_graphs * b.max_atoms ** 2 for b in chunks)


def device_ops(run) -> list:
    """The device-side events of one ``run()`` under ``torch.profiler``
    (kernels and copies: an aten op's row would repeat its kernels' time,
    and a ``record_function`` range's device-side row spans the kernels
    launched inside it), the most device time first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiler
    torch.cuda.synchronize()
    with profiler(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda e: e.self_device_time_total, reverse=True)


def profile(run, wall_ms, what, card):
    """``run()`` once under ``torch.profiler``: the device time of its
    kernels and copies, as a share of ``wall_ms`` (its time without the
    profiler), and the device ops that took the most of it.  Returns the
    busy ms (None when the profiler saw no device event)."""
    ops = device_ops(run)
    busy_ms = sum(e.self_device_time_total for e in ops) / 1e3
    if busy_ms == 0.0:
        log("[profile] device time not measured: the profiler saw no device "
            "events")
        return None
    log(f"[profile] {what}: device busy {busy_ms:.3f} ms in "
        f"{sum(e.count for e in ops)} device ops, "
        f"{100 * busy_ms / wall_ms:.1f} % of the {wall_ms:.3f} ms "
        f"(idle {100 * (1 - busy_ms / wall_ms):.1f} %) | {card}")
    for e in ops[:10]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:5d} x  {e.key[:80]}")
    return busy_ms


@torch.inference_mode()
def pass_split(kernel, captured, what, card) -> None:
    """The kernel's launches on a path's captured inputs once under
    ``torch.profiler``: device ms per launch of each of its passes (the CUDA
    kernels one launch runs), largest first."""
    for args, kwargs in captured[:2]:
        kernel(*args, **kwargs)
    ops = device_ops(lambda: [kernel(*a, **kw) for a, kw in captured])
    n = len(captured)
    total = sum(e.self_device_time_total for e in ops) / 1e3 / n
    log(f"[passes] {what}: {total:.4f} ms of device time a launch, over {n} "
        f"launches | {card}")
    for e in ops[:14]:
        name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
        log(f"[passes]   {e.self_device_time_total / 1e3 / n:8.4f} ms "
            f"{e.count / n:5.1f} x  {name[:90]}")


def capture(module, name, run) -> list:
    """The arguments of every call of ``module.<name>`` while ``run()``
    runs (the calls still go to the kernel)."""
    kernel = getattr(module, name)
    captured = []

    def record(*args, **kwargs):
        captured.append((args, kwargs))
        return kernel(*args, **kwargs)

    with mock.patch.object(module, name, record):
        run()
    torch.cuda.synchronize()
    return captured


@torch.inference_mode()
def kernel_record(meta, captured, kernel, plain, bound, card) -> dict:
    """Hold the kernel against the plain version on each captured call, and
    time both per launch, grouped by the shape of t, beside
    ``bound(args, kwargs)``.
    (Weights captured while serving are inference tensors, so the replay
    runs in inference mode.)"""
    max_abs = 0.0
    for args, kwargs in captured:
        got = kernel(*args, **kwargs)
        want = plain(*args, **kwargs)
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        for g_, w_ in zip(got, want):
            if g_ is None:
                continue
            err, rel = rel_err(g_, w_)
            max_abs = max(max_abs, err)
            if rel > TOL_BF16:
                raise AssertionError(f"{meta['name']} disagrees on the main "
                                     f"path's inputs (rel err {rel:.3e})")
    by_shape = {}
    for c in captured:
        by_shape.setdefault(tuple(c[0][0].shape), []).append(c)
    total_k = total_p = total_b = 0.0
    bound_kind = "operations"
    for shape in sorted(by_shape):
        calls = by_shape[shape]
        k_ms = time_calls(lambda c: kernel(*c[0], **c[1]), calls, 3)
        p_ms = time_calls(lambda c: plain(*c[0], **c[1]), calls, 1)
        bounds = [bound(*c) for c in calls]
        b_ms = sum(b for b, _ in bounds) / len(bounds)
        bound_kind = bounds[0][1]
        total_k += k_ms * len(calls)
        total_p += p_ms * len(calls)
        total_b += b_ms * len(calls)
        log(f"[time] {meta['name']} t{list(shape)}: {len(calls)} launches, "
            f"kernel {k_ms:.4f} ms/launch, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({bound_kind}) | {card}")
    n = len(captured)
    return {**meta, "launches": None, "max_abs_err": max_abs,
            "ms": total_k / n, "plain_ms": total_p / n,
            "bound_ms": total_b / n, "bound_by": bound_kind,
            "library_ms": None}


def check_gata_forward(M, pd, head_scale, G) -> None:
    """The GATA forward kernel against its plain version on one input;
    padded atoms must get exact zeros."""
    from gotennet_tpu_torch.ops import fused_gata
    kw = dict(lmax=LMAX, num_heads=H, sep_dir=True, sep_tensor=True,
              pair_dtype=pd, with_attn=True)
    args = kernel_inputs(M, pd, head_scale, seed=M, G=G)
    got = fused_gata.fused_gata_forward(*args, **kw)
    torch.cuda.synchronize()
    want = fused_gata.fused_gata_forward_reference(*args, **kw)
    tol = TOL_BF16 if pd == torch.bfloat16 else TOL_F32
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    log(f"[kernel-vs-plain] G={G} M={M} pair={str(pd)[6:]} "
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
    if not same_bits(got, fused_gata.fused_gata_forward(*args, **kw)):
        raise AssertionError("GATA forward differs between runs")


def check_gata_backward(M, pd, head_scale, G, pos_grads=False) -> None:
    """The GATA backward kernel against its plain version on one input;
    padded atoms' cotangents must be exact zeros, and a second run must give
    the same bits.  With ``pos_grads`` the position cotangents g_rl and
    g_env are compared too (exact zeros at padded atoms and invalid
    pairs)."""
    from gotennet_tpu_torch.ops import fused_gata
    kw = dict(lmax=LMAX, num_heads=H, sep_dir=True, sep_tensor=True,
              pair_dtype=pd)
    names = ("g_t", "g_q", "g_k", "g_xg", "g_v", "g_rl", "g_X", "g_env",
             "g_scale", "g_Wre", "g_bre", "g_Wrs", "g_brs")
    L = (LMAX + 1) ** 2 - 1
    args = kernel_inputs(M, pd, head_scale, seed=100 + M, G=G)
    _, _, sm = fused_gata.fused_gata_forward(*args, **kw, with_attn=True)
    gen = torch.Generator().manual_seed(M)
    g_dh = torch.randn(G, M, D, generator=gen).cuda()
    g_dX = torch.randn(G, M, L, D, generator=gen).cuda()
    kw["pos_grads"] = pos_grads
    got = fused_gata.fused_gata_backward(*args, sm, g_dh, g_dX, **kw)
    torch.cuda.synchronize()
    want = fused_gata.fused_gata_backward_reference(*args, sm, g_dh, g_dX,
                                                    **kw)
    tol = TOL_BF16 if pd == torch.bfloat16 else TOL_F32
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    worst = max(range(len(errs)), key=lambda i: errs[i][1])
    log(f"[{'pos-' if pos_grads else ''}bwd-vs-plain] G={G} M={M} "
        f"pair={str(pd)[6:]} head_scale={head_scale}: max rel err "
        + ", ".join(f"{n} {r:.1e}" for n, (_, r) in zip(names, errs)
                    if pos_grads or n not in ("g_rl", "g_env"))
        + f" (worst {names[worst]}, abs {errs[worst][0]:.3e}; "
        f"tol {tol:g} rel)")
    if errs[worst][1] > tol:
        raise AssertionError(f"backward kernel disagrees at M={M} {pd} on "
                             f"{names[worst]}")
    # padded atoms (graph 0's last 3): exact zeros
    g_t, g_q, g_k, g_xg, g_v, _, g_X, _, g_scale = got[:9]
    pad = [a[0, M - 3:] for a in (g_t, g_q, g_k, g_xg, g_v, g_X, g_scale)]
    pad += [a[0, :, M - 3:] for a in (g_t, g_scale)]
    if pos_grads:
        pad += [got[5][0, M - 3:], got[5][0, :, M - 3:], got[7][args[7] < 0]]
    if not all(bool(torch.all(a == 0)) for a in pad):
        raise AssertionError("padded atoms got a cotangent")
    if not same_bits(
            got, fused_gata.fused_gata_backward(*args, sm, g_dh, g_dX, **kw)):
        raise AssertionError("GATA backward differs between runs")


HTR_NAMES = ("g_t", "g_EQ", "g_EK", "g_rl", "g_W_g", "g_b_g")


def htr_inputs(M, seed, G=MD22_CHUNK):
    """HTR inputs at the MD22 path's types (t, rl, W_g, b_g float32; EQ, EK
    bf16) and a cotangent of out that is zero on the rows and columns of
    graph 0's last 3 atoms, as the message's backward leaves padded
    atoms."""
    gen = torch.Generator().manual_seed(seed)
    L = (LMAX + 1) ** 2 - 1

    def rand(*s):
        return torch.randn(s, generator=gen) * 0.4

    args = [rand(G, M, M, D), rand(G, M, L, D).to(torch.bfloat16),
            rand(G, M, L, D).to(torch.bfloat16), rand(G, M, M, L),
            rand(D, D) / 8.0, rand(D)]
    g = torch.randn(G, M, M, D, generator=gen)
    g[0, M - 3:] = 0.0
    g[0, :, M - 3:] = 0.0
    return [a.cuda() for a in args], g.cuda()


def htr_cases():
    """(M, pair type, gate) of phases 7 and 8."""
    for M in (16, 32, 112, 120):
        for pd in (torch.float32, torch.bfloat16):
            for gate in ("", "gated"):
                yield M, pd, gate


def check_htr_forward() -> None:
    """Phase 7: the HTR forward kernel against its plain version, with the
    path's bf16 node tables and, at M = 120 with a bf16 pair type, float32
    ones (the kernel rounds those once a launch); a rerun gives the same
    bits."""
    from gotennet_tpu_torch.ops import fused_htr
    cases = [(M, pd, gate, torch.bfloat16) for M, pd, gate in htr_cases()]
    cases += [(120, torch.bfloat16, gate, torch.float32)
              for gate in ("", "gated")]
    for M, pd, gate, nd in cases:
        args, _ = htr_inputs(M, seed=300 + M)
        args[1], args[2] = args[1].to(nd), args[2].to(nd)
        kw = dict(lmax=LMAX, sep_htr=True, rej=True, gate=gate,
                  pair_dtype=pd)
        got = fused_htr.fused_htr_forward(*args, **kw)
        torch.cuda.synchronize()
        want = fused_htr.fused_htr_forward_reference(*args, **kw)
        tol = TOL_BF16 if pd == torch.bfloat16 else TOL_F32
        err, rel = rel_err(got, want)
        pad = torch.cat([(got - want)[0, M - 3:].flatten(),
                         (got - want)[0, :, M - 3:].flatten()])
        log(f"[htr-fwd-vs-plain] M={M} pair={str(pd)[6:]} tables="
            f"{str(nd)[6:]} gate={gate!r}: out max abs {err:.3e} rel "
            f"{rel:.3e}, on padded pairs max abs "
            f"{pad.abs().max().item():.3e} (tol {tol:g} rel)")
        if rel > tol or not torch.isfinite(got).all():
            raise AssertionError(f"HTR forward disagrees at M={M} {pd}")
        if not torch.equal(got, fused_htr.fused_htr_forward(*args, **kw)):
            raise AssertionError("HTR forward differs between runs")


def check_htr_backward() -> None:
    """Phase 8: the HTR backward kernel against its plain version; where
    the cotangent of out is zero, every cotangent it feeds is exactly
    zero."""
    from gotennet_tpu_torch.ops import fused_htr
    for M, pd, gate in htr_cases():
        args, g = htr_inputs(M, seed=400 + M)
        kw = dict(lmax=LMAX, sep_htr=True, rej=True, gate=gate,
                  pair_dtype=pd)
        got = fused_htr.fused_htr_backward(*args, g, **kw)
        torch.cuda.synchronize()
        want = fused_htr.fused_htr_backward_reference(*args, g, **kw)
        tol = TOL_BF16 if pd == torch.bfloat16 else TOL_F32
        errs = [rel_err(a, w) for a, w in zip(got, want)]
        worst = max(range(len(errs)), key=lambda i: errs[i][1])
        log(f"[htr-bwd-vs-plain] M={M} pair={str(pd)[6:]} gate={gate!r}: "
            "max rel err " + ", ".join(f"{n} {r:.1e}" for n, (_, r)
                                       in zip(HTR_NAMES, errs))
            + f" (worst {HTR_NAMES[worst]}, abs {errs[worst][0]:.3e}; "
            f"tol {tol:g} rel)")
        if errs[worst][1] > tol:
            raise AssertionError(f"HTR backward disagrees at M={M} {pd} on "
                                 f"{HTR_NAMES[worst]}")
        g_t, g_EQ, g_EK, g_rl = got[:4]
        pad = [a[0, M - 3:] for a in (g_t, g_rl, g_EQ, g_EK)]
        pad += [a[0, :, M - 3:] for a in (g_t, g_rl)]
        if not all(bool(torch.all(a == 0)) for a in pad):
            raise AssertionError("a zero cotangent gave a non-zero one")
        if not same_bits(got, fused_htr.fused_htr_backward(*args, g, **kw)):
            raise AssertionError("HTR backward differs between runs")


def train_phase(cfg, head, card) -> dict:
    """Phase 6: the training step at full width; returns the backward
    kernel's record."""
    from gotennet_tpu_torch.data.dataset import synthetic_molecules
    from gotennet_tpu_torch.models.model import GotenModel
    from gotennet_tpu_torch.ops import fused_gata
    from gotennet_tpu_torch.tasks.base import Task
    from gotennet_tpu_torch.train.optim import make_optimizer
    from gotennet_tpu_torch.train.trainer import (accum_grads, make_chunks,
                                                  make_loss_fn, train_step,
                                                  train_steps)

    fwd, bwd = fused_gata.fused_gata_forward, fused_gata.fused_gata_backward
    ds = synthetic_molecules(TRAIN_MOLS, seed=1, min_atoms=12, max_atoms=29)
    mols = ds.graph_dicts(range(TRAIN_MOLS))
    expected = math.ceil(TRAIN_MOLS / TRAIN_CHUNK) * N_LAYERS

    # the main path: one step through the entry point
    fwd.launches = bwd.launches = 0
    losses = train_steps(cfg, head, mols, 1, chunk=TRAIN_CHUNK, lr=LR,
                         seed=0)
    torch.cuda.synchronize()
    n_fwd, n_bwd = fwd.launches, bwd.launches
    log(f"[train] one step on {TRAIN_MOLS} molecules in {TRAIN_CHUNK}-graph "
        f"chunks: loss {losses[0]:.6f}; launches forward {n_fwd}, backward "
        f"{n_bwd} (chunks x layers = {expected})")
    if n_fwd != expected or n_bwd != expected:
        raise AssertionError(f"launches {n_fwd}/{n_bwd}, expected {expected}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("training loss is not finite")

    # the first step's gradients against the backward's plain version
    model = GotenModel(cfg, head, seed=0)
    chunks = make_chunks(mols, TRAIN_CHUNK, "cuda")
    loss_fn = make_loss_fn(model, Task(None))
    model.train()
    accum_grads(model, loss_fn, chunks)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    with mock.patch.object(fused_gata, "fused_gata_backward",
                           fused_gata.fused_gata_backward_reference):
        accum_grads(model, loss_fn, chunks)
    errs = {n: rel_err(grads[n], p.grad) for n, p in model.named_parameters()}
    worst = max(errs, key=lambda n: errs[n][1])
    log(f"[train] first-step gradients, kernel vs plain backward: "
        f"{len(errs)} tensors, worst {worst} abs {errs[worst][0]:.3e} rel "
        f"{errs[worst][1]:.3e} (tol {TOL_TRAIN:g} rel)")
    if errs[worst][1] > TOL_TRAIN or not all(
            torch.isfinite(g).all() for g in grads.values()):
        raise AssertionError("training gradients disagree with the plain "
                             "backward")

    # timing: three steps after two warm-up steps
    opt = make_optimizer(model.parameters(), LR)

    def step():
        return train_step(model, opt, chunks, opt.grad_clip, loss_fn=loss_fn)

    step_ms, host_ms, step_losses = time_run(step, 2, 3)
    if not all(math.isfinite(x) for x in step_losses):
        raise AssertionError("training loss is not finite")
    real_edges, padded = count_pairs(chunks, cfg)
    log(f"[train] step: {step_ms:.3f} ms (CUDA events), {host_ms:.3f} ms "
        f"(host clock); real edges {real_edges} (self-loops included), "
        f"padded pairs {padded}; {real_edges / (step_ms / 1e3):.1f} real "
        f"edges/s; losses {[round(x, 6) for x in step_losses]} | {card}")
    profile(step, step_ms, "training step", card)

    captured = capture(fused_gata, "fused_gata_backward",
                       lambda: accum_grads(model, loss_fn, chunks))
    record = kernel_record(
        {"name": "fused_gata_bwd", "route": "cuda",
         "source": "gotennet_tpu_torch/csrc/fused_gata_bwd.cu",
         "replaces": "gotennet_tpu/ops/pallas/fused_gata.py:350"},
        captured, bwd, fused_gata.fused_gata_backward_reference,
        bwd_bound_ms, card)
    record["launches"] = n_bwd
    return record


def md22_frames() -> list:
    """bench.py's MD22 batch: 32 synthetic frames of 110-120 atoms at
    condensed-phase density, with a synthetic energy."""
    from gotennet_tpu_torch.data.dataset import synthetic_molecules
    return synthetic_molecules(MD22_FRAMES, seed=0,
                               **MD22_SIZES).graph_dicts(range(MD22_FRAMES))


def md22_chunks(mols) -> list:
    """The request's or the step's unbucketed chunks, on the card."""
    from gotennet_tpu_torch.train.trainer import make_chunks
    return make_chunks(mols, MD22_CHUNK, "cuda", bucket=False)


def md22_serve_phase(cfg, head, card) -> dict:
    """Phase 10: MD22-sized serving through both forward kernels; returns
    the HTR forward kernel's record."""
    from gotennet_tpu_torch.ops import fused_gata, fused_htr
    from gotennet_tpu_torch.serve import Predictor

    gata, htr = fused_gata.fused_gata_forward, fused_htr.fused_htr_forward
    mols = md22_frames()
    pred = Predictor(cfg, head, seed=0, chunk=MD22_CHUNK, bucket=False)
    n_chunks = math.ceil(MD22_FRAMES / MD22_CHUNK)
    expected = (n_chunks * N_LAYERS, n_chunks * (N_LAYERS - 1))

    # the main path: one request through the entry point
    gata.launches = htr.launches = 0
    got = pred.predict(mols)
    torch.cuda.synchronize()
    launches = (gata.launches, htr.launches)
    log(f"[md22-serve] answered {MD22_FRAMES} frames in {MD22_CHUNK}-frame "
        f"chunks: launches GATA {launches[0]}, HTR {launches[1]} (chunks x "
        f"layers = {expected[0]}, chunks x (layers - 1) = {expected[1]})")
    if launches != expected:
        raise AssertionError(f"launches {launches}, expected {expected}")
    with mock.patch.object(fused_gata, "fused_gata_forward",
                           fused_gata.fused_gata_forward_reference), \
            mock.patch.object(fused_htr, "fused_htr_forward",
                              fused_htr.fused_htr_forward_reference):
        want = pred.predict(mols)
    got_t = torch.from_numpy(got)
    err, rel = rel_err(got_t, torch.from_numpy(want))
    log(f"[md22-serve] answers: shape {tuple(got.shape)}, max abs err vs the "
        f"plain path {err:.4e} (rel {rel:.3e}, tol {TOL_SERVE:g})")
    if (got.shape != (MD22_FRAMES, 1) or not torch.isfinite(got_t).all()
            or rel > TOL_SERVE):
        raise AssertionError("MD22 answers disagree with the plain path")

    real_edges, padded = count_pairs(md22_chunks(mols), cfg)
    req_ms, host_ms, _ = time_run(lambda: pred.predict(mols), 2, 5)
    log(f"[time] {MD22_FRAMES}-frame MD22 request: {req_ms:.3f} ms (CUDA "
        f"events), {host_ms:.3f} ms (host clock); real edges {real_edges} "
        f"(self-loops included), padded pairs {padded}; "
        f"{real_edges / (req_ms / 1e3):.1f} real edges/s | {card}")
    profile(lambda: pred.predict(mols), req_ms,
            f"{MD22_FRAMES}-frame MD22 request", card)
    # the GATA forward at M = 120, logged only: its JSON record is the QM9
    # request's (phase 4)
    KERNEL_MS["fused_gata_fwd, MD22 request"] = kernel_record(
        {"name": "fused_gata_fwd"},
        capture(fused_gata, "fused_gata_forward", lambda: pred.predict(mols)),
        gata, fused_gata.fused_gata_forward_reference, fwd_bound_ms,
        card)["ms"]
    captured = capture(fused_htr, "fused_htr_forward",
                       lambda: pred.predict(mols))
    record = kernel_record(
        {"name": "fused_htr_fwd", "route": "cuda",
         "source": "gotennet_tpu_torch/csrc/fused_htr_fwd.cu",
         "replaces": "gotennet_tpu/ops/pallas/fused_htr.py:79"},
        captured, htr, fused_htr.fused_htr_forward_reference,
        htr_fwd_bound_ms, card)
    record["launches"] = launches[1]
    KERNEL_MS["fused_htr_fwd, MD22 request"] = record["ms"]
    pass_split(htr, captured, "fused_htr_fwd (MD22 request)", card)
    return record


def md22_train_phase(cfg, head, card) -> dict:
    """Phase 11: one MD22-sized training step through all four kernels;
    returns the HTR backward kernel's record."""
    from gotennet_tpu_torch.models.model import GotenModel
    from gotennet_tpu_torch.ops import fused_gata, fused_htr
    from gotennet_tpu_torch.tasks.base import Task
    from gotennet_tpu_torch.train.optim import make_optimizer
    from gotennet_tpu_torch.train.trainer import (accum_grads, make_loss_fn,
                                                  train_step, train_steps)

    counters = (fused_gata.fused_gata_forward, fused_gata.fused_gata_backward,
                fused_htr.fused_htr_forward, fused_htr.fused_htr_backward)
    mols = md22_frames()
    n_chunks = math.ceil(MD22_FRAMES / MD22_CHUNK)
    expected = ((n_chunks * N_LAYERS,) * 2
                + (n_chunks * (N_LAYERS - 1),) * 2)

    # the main path: one step through the entry point
    for c in counters:
        c.launches = 0
    losses = train_steps(cfg, head, mols, 1, chunk=MD22_CHUNK, lr=LR,
                         seed=0, bucket=False)
    torch.cuda.synchronize()
    launches = tuple(c.launches for c in counters)
    log(f"[md22-train] one step on {MD22_FRAMES} frames in {MD22_CHUNK}-frame"
        f" chunks: loss {losses[0]:.6f}; launches GATA forward/backward "
        f"{launches[0]}/{launches[1]}, HTR forward/backward "
        f"{launches[2]}/{launches[3]} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"launches {launches}, expected {expected}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("training loss is not finite")

    # the first step's gradients against both backward plain versions
    model = GotenModel(cfg, head, seed=0)
    chunks = md22_chunks(mols)
    loss_fn = make_loss_fn(model, Task(None))
    model.train()
    accum_grads(model, loss_fn, chunks)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    with mock.patch.object(fused_gata, "fused_gata_backward",
                           fused_gata.fused_gata_backward_reference), \
            mock.patch.object(fused_htr, "fused_htr_backward",
                              fused_htr.fused_htr_backward_reference):
        accum_grads(model, loss_fn, chunks)
    errs = {n: rel_err(grads[n], p.grad) for n, p in model.named_parameters()}
    worst = max(errs, key=lambda n: errs[n][1])
    log(f"[md22-train] first-step gradients, kernels vs plain backwards: "
        f"{len(errs)} tensors, worst {worst} abs {errs[worst][0]:.3e} rel "
        f"{errs[worst][1]:.3e} (tol {TOL_TRAIN:g} rel)")
    if errs[worst][1] > TOL_TRAIN or not all(
            torch.isfinite(g).all() for g in grads.values()):
        raise AssertionError("MD22 gradients disagree with the plain "
                             "backwards")

    # timing: three steps after two warm-up steps
    opt = make_optimizer(model.parameters(), LR)

    def step():
        return train_step(model, opt, chunks, opt.grad_clip, loss_fn=loss_fn)

    step_ms, host_ms, step_losses = time_run(step, 2, 3)
    if not all(math.isfinite(x) for x in step_losses):
        raise AssertionError("training loss is not finite")
    real_edges, padded = count_pairs(chunks, cfg)
    log(f"[md22-train] step: {step_ms:.3f} ms (CUDA events), {host_ms:.3f} ms"
        f" (host clock); real edges {real_edges} (self-loops included), "
        f"padded pairs {padded}; {real_edges / (step_ms / 1e3):.1f} real "
        f"edges/s; losses {[round(x, 6) for x in step_losses]} | {card}")
    profile(step, step_ms, "MD22 training step", card)

    # both backward kernels on a step's inputs; the GATA one logged only (its
    # JSON record is the QM9 step's, phase 6)
    captured = capture(fused_gata, "fused_gata_backward",
                       lambda: accum_grads(model, loss_fn, chunks))
    kernel_record({"name": "fused_gata_bwd"}, captured,
                  fused_gata.fused_gata_backward,
                  fused_gata.fused_gata_backward_reference, bwd_bound_ms, card)
    pass_split(fused_gata.fused_gata_backward, captured,
               "fused_gata_bwd at M = 120 (MD22 step)", card)
    captured = capture(fused_htr, "fused_htr_backward",
                       lambda: accum_grads(model, loss_fn, chunks))
    record = kernel_record(
        {"name": "fused_htr_bwd", "route": "cuda",
         "source": "gotennet_tpu_torch/csrc/fused_htr_bwd.cu",
         "replaces": "gotennet_tpu/ops/pallas/fused_htr.py:115"},
        captured, fused_htr.fused_htr_backward,
        fused_htr.fused_htr_backward_reference, htr_bwd_bound_ms, card)
    record["launches"] = launches[3]
    KERNEL_MS["fused_htr_bwd, MD22 step"] = record["ms"]
    pass_split(fused_htr.fused_htr_backward, captured,
               "fused_htr_bwd at M = 120 (MD22 step)", card)
    return record


def ell_message_inputs(NR, N, head_scale, seed) -> list:
    """ELL message inputs on the card at the large request's shapes (float32
    node tables, as the ELL layer gives them): a third of the slots padded
    (env -1, pointing at their own row) and the last 8 rows wholly
    padded."""
    gen = torch.Generator().manual_seed(seed)
    L, C = (LMAX + 1) ** 2 - 1, (1 + 2 * LMAX) * D

    def rand(*s):
        return torch.randn(s, generator=gen) * 0.3

    valid = torch.rand(NR, ELL_K, generator=gen) > 0.3
    valid[-8:] = False
    nbr = torch.where(valid, torch.randint(0, N, (NR, ELL_K), generator=gen),
                      torch.arange(NR)[:, None]).to(torch.int32)
    env = torch.where(valid, torch.rand(NR, ELL_K, generator=gen),
                      torch.tensor(-1.0))
    scale = (torch.rand(NR, ELL_K, H, generator=gen) if head_scale
             else torch.full((NR, ELL_K), 1.0 / math.sqrt(D)))
    args = [rand(NR, ELL_K, D), rand(NR, D), rand(N, D), rand(N, C),
            rand(N, C), rand(NR, ELL_K, L), rand(N, L, D), env, scale, nbr,
            rand(D, D), rand(D), rand(D, C), rand(C)]
    return [a.cuda() for a in args]


def check_ell_message() -> None:
    """Phase 12: the ELL message kernel against its plain version; padded
    rows get exact zeros, and a rerun gives the same bits."""
    from gotennet_tpu_torch.ops import fused_ell
    cases = [(ELL_N, ELL_N, pd, hs) for pd in (torch.float32, torch.bfloat16)
             for hs in (False, True)]
    cases.append((ELL_N - 64, ELL_N, torch.bfloat16, False))
    for NR, N, pd, head_scale in cases:
        args = ell_message_inputs(NR, N, head_scale, seed=500 + NR)
        kw = dict(lmax=LMAX, num_heads=H, sep_dir=True, sep_tensor=True,
                  pair_dtype=pd, with_attn=True)
        got = fused_ell.fused_ell_forward(*args, **kw)
        again = fused_ell.fused_ell_forward(*args, **kw)
        torch.cuda.synchronize()
        if not same_bits(got, again):
            raise AssertionError("ELL message differs between runs")
        want = fused_ell.fused_ell_forward_reference(*args, **kw)
        tol = TOL_BF16 if pd == torch.bfloat16 else TOL_F32
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        log(f"[ell-vs-plain] NR={NR} N={N} K={ELL_K} pair={str(pd)[6:]} "
            f"head_scale={head_scale}: max abs / rel err "
            + ", ".join(f"{n} {a:.3e}/{r:.3e}" for n, (a, r)
                        in zip(("d_h", "dX", "sm"), errs))
            + f" (tol {tol:g} rel)")
        if not all(r <= tol for _, r in errs):
            raise AssertionError(f"ELL message disagrees at NR={NR} {pd}")
        if not (torch.all(got[2][-8:] == 0) and torch.all(got[0][-8:] == 0)
                and torch.all(got[1][-8:] == 0)):
            raise AssertionError("padded rows got weight")


def check_htr_ell() -> None:
    """Phase 13: the ELL HTR kernel against its plain version, with the
    path's float32 node tables and, with a bf16 pair type, bf16 ones (read
    as they are); a rerun gives the same bits."""
    from gotennet_tpu_torch.ops import fused_htr
    L = (LMAX + 1) ** 2 - 1
    gen = torch.Generator().manual_seed(600)

    def rand(*s):
        return (torch.randn(s, generator=gen) * 0.4).cuda()

    msg = ell_message_inputs(ELL_N, ELL_N, False, seed=601)
    args = [msg[0], rand(ELL_N, L, D), rand(ELL_N, L, D), msg[5], msg[9],
            rand(D, D) / 8.0, rand(D)]
    cases = [(pd, gate, torch.float32) for pd in (torch.float32,
                                                   torch.bfloat16)
             for gate in ("", "gated")]
    cases += [(torch.bfloat16, gate, torch.bfloat16) for gate in ("", "gated")]
    for pd, gate, nd in cases:
        a = list(args)
        a[1], a[2] = a[1].to(nd), a[2].to(nd)
        kw = dict(lmax=LMAX, sep_htr=True, rej=True, gate=gate,
                  pair_dtype=pd)
        got = fused_htr.fused_htr_ell_forward(*a, **kw)
        torch.cuda.synchronize()
        want = fused_htr.fused_htr_ell_forward_reference(*a, **kw)
        tol = TOL_BF16 if pd == torch.bfloat16 else TOL_F32
        err, rel = rel_err(got, want)
        log(f"[htr-ell-vs-plain] N={ELL_N} K={ELL_K} pair={str(pd)[6:]} "
            f"tables={str(nd)[6:]} gate={gate!r}: out max abs {err:.3e} rel "
            f"{rel:.3e} (tol {tol:g} rel)")
        if rel > tol or not torch.isfinite(got).all():
            raise AssertionError(f"ELL HTR disagrees at {pd} {gate!r}")
        if not torch.equal(got, fused_htr.fused_htr_ell_forward(*a, **kw)):
            raise AssertionError("ELL HTR forward differs between runs")


def large_frames() -> list:
    """bench.py's large batch: 8 synthetic frames of 600-700 atoms at
    condensed-phase density, with a synthetic energy."""
    from gotennet_tpu_torch.data.dataset import synthetic_molecules
    return synthetic_molecules(LARGE_FRAMES, seed=0, **LARGE_SIZES
                               ).graph_dicts(range(LARGE_FRAMES))


def xl_frames() -> list:
    """bench.py's xl batch: 2 synthetic frames of 4,000-4,200 atoms at
    condensed-phase density, with a synthetic energy."""
    from gotennet_tpu_torch.data.dataset import synthetic_molecules
    return synthetic_molecules(XL_FRAMES, seed=0, **XL_SIZES
                               ).graph_dicts(range(XL_FRAMES))


def rerun_bits(kernel, captured, what) -> None:
    """The kernel on the first captured call twice: the same bits."""
    args, kwargs = captured[0]
    with torch.inference_mode():
        a, b = kernel(*args, **kwargs), kernel(*args, **kwargs)
    torch.cuda.synchronize()
    a, b = ((a,), (b,)) if isinstance(a, torch.Tensor) else (a, b)
    if not all(torch.equal(x, y) for x, y in zip(a, b) if x is not None):
        raise AssertionError(f"{what} differs between runs")
    log(f"[rerun] {what}: the same bits from a second run on the path's "
        f"inputs (t {list(args[0].shape)})")


def ell_chunks(cfg, loader, what, card) -> list:
    """The request's chunks as ``loader`` cuts them, its host time, and the
    path each chunk takes: where the JAX package would cut a table above
    ``fused_table_rows`` into halo windows (``pick_chunking``'s geometry)
    the port's kernels take the whole table."""
    from gotennet_tpu_torch.models.gotennet import kernel_paths
    from gotennet_tpu_torch.ops.fused_ell import pick_chunking
    t0 = time.perf_counter()
    chunks = [b for _, b in loader.batches()]
    loader_ms = (time.perf_counter() - t0) * 1e3
    limit = cfg.fused_table_rows
    geometry = [None if not limit or b.num_nodes <= limit else
                pick_chunking(b.num_nodes, b.num_nodes, b.gather_halo, limit)
                for b in chunks]
    paths = {kernel_paths(cfg, "ell", b.num_nodes, b.num_nodes,
                          b.gather_halo) for b in chunks}
    log(f"[{what}] chunks: N = {[b.num_nodes for b in chunks]}, K = "
        f"{[b.max_neighbors for b in chunks]}, gather windows "
        f"{[b.gather_window for b in chunks]}, halos "
        f"{[b.gather_halo for b in chunks]}, real slots "
        f"{[int(b.nbr_mask.sum()) for b in chunks]}; the JAX package's "
        f"chunking (rows a chunk, window, chunks) at fused_table_rows="
        f"{limit}: {geometry} (None: the whole table), replaced by whole-table"
        f" calls; fused (message, update): {sorted(paths)}; loader "
        f"{loader_ms:.3f} ms (host) | {card}")
    return chunks


def native_phase(card) -> None:
    """Phase 22: the native neighbour list on this machine gives the xl
    frames' edges as the numpy version does, arrays in the same order."""
    from gotennet_tpu_torch.graph.native import build_edges
    from gotennet_tpu_torch.graph.neighborlist import build_edges_np
    for i, m in enumerate(xl_frames()):
        t0 = time.perf_counter()
        got = build_edges(m["pos"], 5.0, True, 32)
        t1 = time.perf_counter()
        want = build_edges_np(m["pos"], 5.0, True, 32)
        t2 = time.perf_counter()
        same = all(g.dtype == w.dtype and g.shape == w.shape
                   and bool((g == w).all()) for g, w in zip(got, want))
        log(f"[native] xl frame {i} ({len(m['z'])} atoms): {len(got[0])} "
            f"edges; build_edges {1e3 * (t1 - t0):.3f} ms, build_edges_np "
            f"{1e3 * (t2 - t1):.3f} ms (host); arrays equal in order: "
            f"{same} | {card}")
        if not same:
            raise AssertionError("the native neighbour list differs from "
                                 "build_edges_np")


def ell_serve_phase(cfg, head, card, mols, what, kernels=True) -> list:
    """Phases 14, 24 and 25: a request of ``mols`` (one frame per chunk) on
    the ELL layout through the ELL forward kernels (the HTR one with
    ``fused_htr``); with ``kernels``, returns both kernels' records."""
    from gotennet_tpu_torch.data.dataset import MoleculeDataset
    from gotennet_tpu_torch.ops import fused_ell, fused_htr
    from gotennet_tpu_torch.serve import Predictor

    msg, htr = fused_ell.fused_ell_forward, fused_htr.fused_htr_ell_forward
    n = len(mols)
    pred = Predictor(cfg, head, seed=0, chunk=1, layout="ell",
                     spatial_sort=True, block_rows=64)
    expected = (n * N_LAYERS, n * (N_LAYERS - 1) * cfg.fused_htr)

    # the main path: one request through the entry point
    msg.launches = htr.launches = 0
    got = pred.predict(mols)
    torch.cuda.synchronize()
    launches = (msg.launches, htr.launches)
    log(f"[{what}] answered {n} frames, one per chunk: launches ELL message "
        f"{launches[0]}, ELL HTR {launches[1]} (chunks x layers = "
        f"{expected[0]}, chunks x (layers - 1) = {expected[1]})")
    if launches != expected:
        raise AssertionError(f"launches {launches}, expected {expected}")
    with mock.patch.object(fused_ell, "fused_ell_forward",
                           fused_ell.fused_ell_forward_reference), \
            mock.patch.object(fused_htr, "fused_htr_ell_forward",
                              fused_htr.fused_htr_ell_forward_reference):
        want = pred.predict(mols)
    got_t = torch.from_numpy(got)
    err, rel = rel_err(got_t, torch.from_numpy(want))
    log(f"[{what}] answers: shape {tuple(got.shape)}, max abs err vs the "
        f"plain path {err:.4e} (rel {rel:.3e}, tol {TOL_SERVE:g})")
    if (got.shape != (n, 1) or not torch.isfinite(got_t).all()
            or rel > TOL_SERVE):
        raise AssertionError(f"{what}: answers disagree with the plain path")

    # the request's chunks as the loader cuts them; its host time is that
    # of the neighbour probe over the request and of every collation
    ds = MoleculeDataset(z=[m["z"] for m in mols],
                         pos=[m["pos"] for m in mols])
    chunks = ell_chunks(cfg, pred.loader(ds), what, card)
    real_edges = sum(int(b.nbr_mask.sum()) for b in chunks)
    padded = sum(b.num_nodes * b.max_neighbors for b in chunks)
    req_ms, host_ms, _ = time_run(lambda: pred.predict(mols), 2, 5)
    log(f"[time] {n}-frame {what}: {req_ms:.3f} ms (CUDA events), "
        f"{host_ms:.3f} ms (host clock); real edges {real_edges} "
        f"(self-loops included), padded slots {padded}; "
        f"{real_edges / (req_ms / 1e3):.1f} real edges/s | {card}")
    profile(lambda: pred.predict(mols), req_ms, f"{n}-frame {what}", card)
    if not kernels:
        return []
    records = []
    for name, module, fn_name, kernel, plain, bound, replaces in (
            ("fused_ell_fwd", fused_ell, "fused_ell_forward", msg,
             fused_ell.fused_ell_forward_reference, ell_fwd_bound_ms,
             "gotennet_tpu/ops/pallas/fused_ell.py:77"),
            ("fused_htr_ell_fwd", fused_htr, "fused_htr_ell_forward", htr,
             fused_htr.fused_htr_ell_forward_reference, htr_ell_fwd_bound_ms,
             "gotennet_tpu/ops/pallas/fused_htr.py:339")):
        captured = capture(module, fn_name, lambda: pred.predict(mols))
        rerun_bits(kernel, captured, f"{name} ({what})")
        record = kernel_record(
            {"name": name, "route": "cuda",
             "source": f"gotennet_tpu_torch/csrc/{name}.cu",
             "replaces": replaces}, captured, kernel, plain, bound, card)
        record["launches"] = launches[len(records)]
        KERNEL_MS[f"{name}, {what}"] = record["ms"]
        records.append(record)
        pass_split(kernel, captured, f"{name} ({what})", card)
    return records


ELL_MSG_NAMES = ("g_t", "g_q", "g_k", "g_xg", "g_v", "g_rl", "g_X", "g_env",
                 "g_scale", "g_Wre", "g_bre", "g_Wrs", "g_brs")


def same_bits(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def check_ell_message_backward() -> None:
    """Phase 15: the ELL message backward kernel against its plain version;
    padded slots get exact zeros, and a rerun gives the same bits."""
    from gotennet_tpu_torch.ops import fused_ell
    L = (LMAX + 1) ** 2 - 1
    cases = [(ELL_N, ELL_N, pd, hs) for pd in (torch.float32, torch.bfloat16)
             for hs in (False, True)]
    cases.append((ELL_N - 64, ELL_N, torch.bfloat16, False))
    for NR, N, pd, head_scale in cases:
        args = ell_message_inputs(NR, N, head_scale, seed=700 + NR)
        kw = dict(lmax=LMAX, num_heads=H, sep_dir=True, sep_tensor=True,
                  pair_dtype=pd)
        _, _, sm = fused_ell.fused_ell_forward(*args, **kw, with_attn=True)
        gen = torch.Generator().manual_seed(NR)
        g_dh = torch.randn(NR, D, generator=gen).cuda()
        g_dX = torch.randn(NR, L, D, generator=gen).cuda()
        slots = fused_ell.source_slots(args[9], N)
        got = fused_ell.fused_ell_backward(*args, sm, g_dh, g_dX, **kw,
                                           slots=slots)
        again = fused_ell.fused_ell_backward(*args, sm, g_dh, g_dX, **kw,
                                             slots=slots)
        torch.cuda.synchronize()
        want = fused_ell.fused_ell_backward_reference(*args, sm, g_dh, g_dX,
                                                      **kw)
        tol = TOL_BF16 if pd == torch.bfloat16 else TOL_F32
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        worst = max(range(len(errs)), key=lambda i: errs[i][1])
        log(f"[ell-bwd-vs-plain] NR={NR} N={N} K={ELL_K} pair={str(pd)[6:]} "
            f"head_scale={head_scale}: max rel err "
            + ", ".join(f"{n} {r:.1e}" for n, (_, r)
                        in zip(ELL_MSG_NAMES, errs))
            + f" (worst {ELL_MSG_NAMES[worst]}, abs {errs[worst][0]:.3e}; "
            f"tol {tol:g} rel)")
        if errs[worst][1] > tol:
            raise AssertionError(f"ELL message backward disagrees at NR={NR} "
                                 f"{pd} on {ELL_MSG_NAMES[worst]}")
        pad = args[7] < 0
        if not all(bool(torch.all(got[i][pad] == 0)) for i in (0, 5, 7, 8)):
            raise AssertionError("a padded slot got a cotangent")
        if not same_bits(got, again):
            raise AssertionError("ELL message backward differs between runs")


def check_htr_ell_backward() -> None:
    """Phase 16: the ELL HTR backward kernel against its plain version; a
    rerun gives the same bits."""
    from gotennet_tpu_torch.ops import fused_ell, fused_htr
    L = (LMAX + 1) ** 2 - 1
    gen = torch.Generator().manual_seed(800)

    def rand(*s):
        return (torch.randn(s, generator=gen) * 0.4).cuda()

    msg = ell_message_inputs(ELL_N, ELL_N, False, seed=801)
    args = [msg[0], rand(ELL_N, L, D), rand(ELL_N, L, D), msg[5], msg[9],
            rand(D, D) / 8.0, rand(D)]
    g = torch.randn(ELL_N, ELL_K, D, generator=gen).cuda()
    slots = fused_ell.source_slots(msg[9], ELL_N)
    for pd in (torch.float32, torch.bfloat16):
        for gate in ("", "gated"):
            kw = dict(lmax=LMAX, sep_htr=True, rej=True, gate=gate,
                      pair_dtype=pd)
            got = fused_htr.fused_htr_ell_backward(*args, g, **kw,
                                                   slots=slots)
            again = fused_htr.fused_htr_ell_backward(*args, g, **kw,
                                                     slots=slots)
            torch.cuda.synchronize()
            want = fused_htr.fused_htr_ell_backward_reference(*args, g, **kw)
            tol = TOL_BF16 if pd == torch.bfloat16 else TOL_F32
            errs = [rel_err(a, w) for a, w in zip(got, want)]
            worst = max(range(len(errs)), key=lambda i: errs[i][1])
            log(f"[htr-ell-bwd-vs-plain] N={ELL_N} K={ELL_K} "
                f"pair={str(pd)[6:]} gate={gate!r}: max rel err "
                + ", ".join(f"{n} {r:.1e}" for n, (_, r)
                            in zip(HTR_NAMES, errs))
                + f" (worst {HTR_NAMES[worst]}, abs {errs[worst][0]:.3e}; "
                f"tol {tol:g} rel)")
            if errs[worst][1] > tol:
                raise AssertionError(f"ELL HTR backward disagrees at {pd} "
                                     f"{gate!r} on {HTR_NAMES[worst]}")
            if not same_bits(got, again):
                raise AssertionError("ELL HTR backward differs between runs")


def ell_train_phase(cfg, head, card, mols, what, kernels=True) -> list:
    """Phases 17, 24 and 25: one ELL training step on ``mols`` (one frame
    per chunk) through the ELL kernels (the HTR ones with ``fused_htr``);
    with ``kernels``, returns both backward kernels' records."""
    from gotennet_tpu_torch.models.model import GotenModel
    from gotennet_tpu_torch.ops import fused_ell, fused_htr
    from gotennet_tpu_torch.tasks.base import Task
    from gotennet_tpu_torch.train.optim import make_optimizer
    from gotennet_tpu_torch.train.trainer import (accum_grads, make_chunks,
                                                  make_loss_fn, train_step,
                                                  train_steps)

    counters = (fused_ell.fused_ell_forward, fused_ell.fused_ell_backward,
                fused_htr.fused_htr_ell_forward,
                fused_htr.fused_htr_ell_backward)
    n = len(mols)
    expected = ((n * N_LAYERS,) * 2
                + (n * (N_LAYERS - 1) * cfg.fused_htr,) * 2)

    # the main path: one step through the entry point
    for c in counters:
        c.launches = 0
    losses = train_steps(cfg, head, mols, 1, chunk=1, lr=LR, seed=0,
                         layout="ell")
    torch.cuda.synchronize()
    launches = tuple(c.launches for c in counters)
    log(f"[{what}] one step on {n} frames, one per chunk: loss "
        f"{losses[0]:.6f}; launches ELL message forward/"
        f"backward {launches[0]}/{launches[1]}, ELL HTR forward/backward "
        f"{launches[2]}/{launches[3]} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"launches {launches}, expected {expected}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("training loss is not finite")

    # the first step's gradients against both backward plain versions
    model = GotenModel(cfg, head, "ell", seed=0)
    chunks = make_chunks(mols, 1, "cuda", layout="ell", cutoff=cfg.cutoff,
                         max_num_neighbors=cfg.max_num_neighbors)
    loss_fn = make_loss_fn(model, Task(None))
    model.train()
    accum_grads(model, loss_fn, chunks)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    with mock.patch.object(fused_ell, "fused_ell_backward",
                           fused_ell.fused_ell_backward_reference), \
            mock.patch.object(fused_htr, "fused_htr_ell_backward",
                              fused_htr.fused_htr_ell_backward_reference):
        accum_grads(model, loss_fn, chunks)
    errs = {n: rel_err(grads[n], p.grad) for n, p in model.named_parameters()}
    worst = max(errs, key=lambda n: errs[n][1])
    log(f"[{what}] first-step gradients, kernels vs plain backwards: "
        f"{len(errs)} tensors, worst {worst} abs {errs[worst][0]:.3e} rel "
        f"{errs[worst][1]:.3e} (tol {TOL_TRAIN:g} rel)")
    if errs[worst][1] > TOL_TRAIN or not all(
            torch.isfinite(g).all() for g in grads.values()):
        raise AssertionError(f"{what}: gradients disagree with the plain "
                             "backwards")

    # timing: three steps after two warm-up steps
    opt = make_optimizer(model.parameters(), LR)

    def step():
        return train_step(model, opt, chunks, opt.grad_clip, loss_fn=loss_fn)

    step_ms, host_ms, step_losses = time_run(step, 2, 3)
    if not all(math.isfinite(x) for x in step_losses):
        raise AssertionError("training loss is not finite")
    real_edges = sum(int(b.nbr_mask.sum()) for b in chunks)
    padded = sum(b.num_nodes * b.max_neighbors for b in chunks)
    log(f"[{what}] step: {step_ms:.3f} ms (CUDA events), {host_ms:.3f} ms "
        f"(host clock); real edges {real_edges} (self-loops included), padded"
        f" slots {padded}; {real_edges / (step_ms / 1e3):.1f} real edges/s; "
        f"losses {[round(x, 6) for x in step_losses]} | {card}")
    profile(step, step_ms, what, card)
    if not kernels:
        return []

    # both backward kernels on a step's inputs
    records = []
    for name, module, kernel, n_launches, plain, bound, replaces in (
            ("fused_ell_bwd", fused_ell, counters[1], launches[1],
             fused_ell.fused_ell_backward_reference, ell_bwd_bound_ms,
             "gotennet_tpu/ops/pallas/fused_ell.py:256"),
            ("fused_htr_ell_bwd", fused_htr, counters[3], launches[3],
             fused_htr.fused_htr_ell_backward_reference, htr_ell_bwd_bound_ms,
             "gotennet_tpu/ops/pallas/fused_htr.py:383")):
        captured = capture(module, kernel.__name__,
                           lambda: accum_grads(model, loss_fn, chunks))
        rerun_bits(kernel, captured, f"{name} ({what})")
        record = kernel_record(
            {"name": name, "route": "cuda",
             "source": f"gotennet_tpu_torch/csrc/{name}.cu",
             "replaces": replaces}, captured, kernel, plain, bound, card)
        record["launches"] = n_launches
        KERNEL_MS[f"{name}, {what}"] = record["ms"]
        records.append(record)
        pass_split(kernel, captured, f"{name} ({what})", card)
    return records


def force_head():
    """MD22Task's head: Atomwise energies with forces (derivative=True)."""
    from gotennet_tpu_torch.tasks.force_task import MD22Task
    return MD22Task("energy", dataset_meta={"mean": 0.0,
                                            "std": 1.0}).build_head()


def hold_forces(what, got, want) -> None:
    """Energies and forces of a request (as ``predict_with_forces`` gives
    them) against the plain path's, each within TOL_SERVE of its scale."""
    (e, f), (we, wf) = got, want
    e_err, e_rel = rel_err(torch.from_numpy(e), torch.from_numpy(we))
    f_err = max(float(abs(a - b).max()) for a, b in zip(f, wf))
    f_rel = f_err / max(float(abs(b).max()) for b in wf)
    log(f"[{what}] energies {tuple(e.shape)}, max abs err vs the plain path "
        f"{e_err:.4e} (rel {e_rel:.3e}); forces of {len(f)} frames "
        f"{[x.shape[0] for x in f][:4]}..., max abs err {f_err:.4e} (rel "
        f"{f_rel:.3e}); tol {TOL_SERVE:g} rel")
    finite = all(bool(torch.isfinite(torch.from_numpy(x)).all()) for x in f)
    if not finite or max(e_rel, f_rel) > TOL_SERVE or not \
            torch.isfinite(torch.from_numpy(e)).all():
        raise AssertionError(f"{what}: energies or forces disagree with the "
                             "plain path")


def force_request_run(what, pred, mols, counters, expected, plains, card
                      ) -> tuple:
    """One force request through the entry point with every counter at 0
    (the launches must read ``expected``), the same request through the
    plain versions (``plains``: (module, name, plain) to patch), then the
    request timed and profiled; returns (launches, the kernels' answer,
    request ms)."""
    for c in counters:
        c.launches = 0
    got = pred.predict_with_forces(mols)
    torch.cuda.synchronize()
    launches = tuple(c.launches for c in counters)
    log(f"[{what}] answered {len(mols)} frames with forces: launches "
        f"{launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"launches {launches}, expected {expected}")
    with contextlib.ExitStack() as stack:
        for module, name, plain in plains:
            stack.enter_context(mock.patch.object(module, name, plain))
        want = pred.predict_with_forces(mols)
    hold_forces(what, got, want)
    req_ms, host_ms, _ = time_run(lambda: pred.predict_with_forces(mols), 2,
                                  3)
    log(f"[time] {len(mols)}-frame {what} request: {req_ms:.3f} ms (CUDA "
        f"events), {host_ms:.3f} ms (host clock) | {card}")
    profile(lambda: pred.predict_with_forces(mols), req_ms,
            f"{len(mols)}-frame {what} request", card)
    return launches, got, req_ms


def finite_difference_check(cfg, frame) -> None:
    """Forces against the central difference of the energy on one frame,
    float32 pair and node types: three atoms whose distances all stay at
    least 3 eps off the cutoff (a pair crossing it changes the energy by a
    step) each move by eps = 1e-2 A along a random unit vector u; -F_a.u
    must match within 2e-2 of |F_a|."""
    from gotennet_tpu_torch.serve import Predictor
    f32 = torch.float32
    pred = Predictor(dataclasses.replace(cfg, pair_dtype=f32, node_dtype=f32),
                     force_head(), seed=0, chunk=1, bucket=False)
    _, (forces,) = pred.predict_with_forces([frame])
    pos = torch.from_numpy(frame["pos"]).double()
    eps = 1e-2
    far = ((torch.cdist(pos, pos) - cfg.cutoff).abs() > 3 * eps).all(dim=1)
    rows = torch.nonzero(far)[:3, 0].tolist()
    gen = torch.Generator().manual_seed(7)

    def energy(row, step):
        moved = frame["pos"].copy()
        moved[row] += step
        return float(pred.predict([{"z": frame["z"], "pos": moved}])[0, 0])

    worst = 0.0
    for row in rows:
        u = torch.randn(3, generator=gen, dtype=torch.float64)
        u = (u / u.norm()).numpy()
        num = (energy(row, eps * u) - energy(row, -eps * u)) / (2 * eps)
        ana = -float(forces[row].astype("float64") @ u)
        rel = abs(num - ana) / float((forces[row] ** 2).sum() ** 0.5)
        worst = max(worst, rel)
        log(f"[fd] atom {row}: -F.u {ana:.6f}, central difference {num:.6f} "
            f"(eps {eps} A), err {rel:.3e} of |F| (tol 2e-2)")
    if len(rows) < 3 or worst > 2e-2:
        raise AssertionError("forces disagree with the energy's finite "
                             "differences")


def md22_force_phase(cfg, card) -> dict:
    """Phase 19: the MD22 force request through both GATA and both HTR
    kernels; returns the record of the GATA backward with position
    cotangents."""
    from gotennet_tpu_torch.ops import fused_gata, fused_htr
    from gotennet_tpu_torch.serve import Predictor

    counters = (fused_gata.fused_gata_forward, fused_gata.fused_gata_backward,
                fused_htr.fused_htr_forward, fused_htr.fused_htr_backward)
    mols = md22_frames()
    n_chunks = math.ceil(MD22_FRAMES / MD22_CHUNK)
    expected = ((n_chunks * N_LAYERS,) * 2
                + (n_chunks * (N_LAYERS - 1),) * 2)
    pred = Predictor(cfg, force_head(), seed=0, chunk=MD22_CHUNK,
                     bucket=False)
    plains = [(fused_gata, n, getattr(fused_gata, f"{n}_reference"))
              for n in ("fused_gata_forward", "fused_gata_backward")]
    plains += [(fused_htr, n, getattr(fused_htr, f"{n}_reference"))
               for n in ("fused_htr_forward", "fused_htr_backward")]
    launches, _, req_ms = force_request_run(
        "md22-forces", pred, mols, counters, expected, plains, card)
    real_edges, padded = count_pairs(md22_chunks(mols), cfg)
    log(f"[md22-forces] real edges {real_edges} (self-loops included), "
        f"padded pairs {padded}; {real_edges / (req_ms / 1e3):.1f} real "
        f"edges/s | {card}")
    finite_difference_check(cfg, mols[0])
    captured = capture(fused_gata, "fused_gata_backward",
                       lambda: pred.predict_with_forces(mols))
    record = kernel_record(
        {"name": "fused_gata_bwd_pos_grads", "route": "cuda",
         "source": "gotennet_tpu_torch/csrc/fused_gata_bwd.cu",
         "replaces": "gotennet_tpu/ops/pallas/fused_gata.py:350"},
        captured, counters[1], fused_gata.fused_gata_backward_reference,
        bwd_bound_ms, card)
    record["launches"] = launches[1]
    pass_split(counters[1], captured,
               "fused_gata_bwd with pos_grads (MD22 force request)", card)
    pass_split(counters[3],
               capture(fused_htr, "fused_htr_backward",
                       lambda: pred.predict_with_forces(mols)),
               "fused_htr_bwd at M = 120 (MD22 force request)", card)
    return record


def ell_force_phase(cfg, card) -> None:
    """Phase 20: the ELL force request through all four ELL kernels."""
    from gotennet_tpu_torch.data.dataset import MoleculeDataset
    from gotennet_tpu_torch.ops import fused_ell, fused_htr
    from gotennet_tpu_torch.serve import Predictor

    counters = (fused_ell.fused_ell_forward, fused_ell.fused_ell_backward,
                fused_htr.fused_htr_ell_forward,
                fused_htr.fused_htr_ell_backward)
    expected = ((LARGE_FRAMES * N_LAYERS,) * 2
                + (LARGE_FRAMES * (N_LAYERS - 1),) * 2)
    pred = Predictor(cfg, force_head(), seed=0, chunk=1, layout="ell",
                     spatial_sort=True, block_rows=64)
    plains = [(fused_ell, n, getattr(fused_ell, f"{n}_reference"))
              for n in ("fused_ell_forward", "fused_ell_backward")]
    plains += [(fused_htr, n, getattr(fused_htr, f"{n}_reference"))
               for n in ("fused_htr_ell_forward", "fused_htr_ell_backward")]
    mols = large_frames()
    _, _, req_ms = force_request_run("ell-forces", pred, mols, counters,
                                     expected, plains, card)
    ds = MoleculeDataset(z=[m["z"] for m in mols],
                         pos=[m["pos"] for m in mols])
    real_edges = sum(int(b.nbr_mask.sum())
                     for _, b in pred.loader(ds).batches())
    log(f"[ell-forces] real edges {real_edges} (self-loops included); "
        f"{real_edges / (req_ms / 1e3):.1f} real edges/s | {card}")
    pass_split(counters[3],
               capture(fused_htr, "fused_htr_ell_backward",
                       lambda: pred.predict_with_forces(mols)),
               "fused_htr_ell_bwd (ELL force request)", card)


@contextlib.contextmanager
def spy(module, name, keep, backward=False):
    """Record every call of ``module.<name>`` while the block runs: whether
    it trains (a backward, or a forward ``with_attn``, which keeps the
    softmax for the backward) and the number of dimensions of its scale
    (argument 8), and keep the arguments of the first ``keep`` training
    calls (the calls still go to the kernel)."""
    kernel = getattr(module, name)
    calls, kept = [], []

    def record(*args, **kwargs):
        training = backward or kwargs.get("with_attn", False)
        calls.append((training, args[8].dim()))
        if training and len(kept) < keep:
            kept.append((args, kwargs))
        return kernel(*args, **kwargs)

    with mock.patch.object(module, name, record):
        yield calls, kept


@contextlib.contextmanager
def trainer_timings():
    """Wall seconds of every ``Trainer.evaluate`` (by phase) and
    ``Trainer.save_checkpoint`` while the block runs."""
    from gotennet_tpu_torch.train.trainer import Trainer
    times = {"evaluate": [], "save": []}
    evaluate, save = Trainer.evaluate, Trainer.save_checkpoint

    def timed_evaluate(self, state_dict, loader, phase="test"):
        t0 = time.perf_counter()
        out = evaluate(self, state_dict, loader, phase)
        times["evaluate"].append((phase, time.perf_counter() - t0))
        return out

    def timed_save(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(self, *args, **kwargs)
        times["save"].append(time.perf_counter() - t0)

    with mock.patch.object(Trainer, "evaluate", timed_evaluate), \
            mock.patch.object(Trainer, "save_checkpoint", timed_save):
        yield times


def read_jsonl(path) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def epoch_record(workdir, epoch) -> dict:
    recs = [r for r in read_jsonl(workdir / "metrics.jsonl")
            if r["phase"] == "val_epoch" and r["epoch"] == epoch]
    if len(recs) != 1:
        raise AssertionError(f"{workdir}: {len(recs)} records of epoch "
                             f"{epoch}")
    return recs[0]


def hold_results(what, got, want, tol) -> None:
    for key in want:
        rel = abs(got[key] - want[key]) / max(abs(want[key]), 1e-30)
        log(f"[{what}] {key}: {got[key]!r} vs {want[key]!r} (rel "
            f"{rel:.3e}, tol {tol:g})")
        if not math.isfinite(got[key]) or rel > tol:
            raise AssertionError(f"{what}: {key} disagrees")


def cli_phase(card, what, overrides, kernels, plain_forward, expected,
              idle, n_train, steps_per_epoch, resume=False) -> list:
    """Phases 26-27: ``cli train`` with ``overrides`` through the kernels of
    ``kernels`` (forward, backward: ``(name, module, fn, plain, bound,
    replaces)``), launches checked against ``expected`` and none of the
    wrappers in ``idle``; the files, losses and timings of the run; with
    ``resume``, resume against a fresh run; ``cli test`` against the run
    and, through ``plain_forward`` (module, name, plain), against the plain
    path.  Returns both kernels' records."""
    from gotennet_tpu_torch import cli

    root = CLI_DIR / what.replace(" ", "_")
    shutil.rmtree(root, ignore_errors=True)
    run = root / "run"
    counters = [getattr(k[1], k[2]) for k in kernels]
    for c in counters + idle:
        c.launches = 0
    with spy(kernels[0][1], kernels[0][2], 8) as (fwd_calls, fwd_kept), \
            spy(kernels[1][1], kernels[1][2], 8, backward=True) as (
                bwd_calls, bwd_kept), \
            trainer_timings() as times:
        t0 = time.perf_counter()
        cli.main(["train", *overrides, f"workdir={run}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = tuple(c.launches for c in counters)
    log(f"[{what}] cli train: {wall:.2f} s on the wall; launches forward/"
        f"backward {launches} (expected {expected}), idle wrappers "
        f"{[c.launches for c in idle]}")
    if launches != expected or any(c.launches for c in idle):
        raise AssertionError(f"{what}: launches {launches}, expected "
                             f"{expected}")
    train_dims = {d for t, d in fwd_calls if t} | {d for _, d in bwd_calls}
    eval_dims = {d for t, d in fwd_calls if not t}
    log(f"[{what}] scale dimensions: training launches {sorted(train_dims)}"
        f" (per head: 4 dense, 3 ELL), evaluation launches "
        f"{sorted(eval_dims)}")
    per_head = 4 if kernels[0][0].startswith("fused_gata") else 3
    if train_dims != {per_head} or eval_dims != {per_head - 1}:
        raise AssertionError(f"{what}: the training launches did not all "
                             "take the dropout's per-head scale")
    for name in ("ckpt_best", "ckpt_last", "splits.npz", "metrics.jsonl",
                 "test_results.json"):
        if not (run / name).exists():
            raise AssertionError(f"{what}: {name} was not written")
    recs = read_jsonl(run / "metrics.jsonl")
    losses = [r["loss"] for r in recs if r["phase"] == "train"]
    epochs = [r for r in recs if r["phase"] == "val_epoch"]
    numbers = losses + [r[k] for r in epochs for k in
                        ("val_loss", "train_loss", "MeanAbsoluteError")]
    log(f"[{what}] {len(losses)} optimizer steps, losses "
        f"{[round(x, 6) for x in losses]}")
    if not losses or not all(math.isfinite(x) for x in numbers):
        raise AssertionError(f"{what}: a loss is not finite")
    vals = [s for p, s in times["evaluate"] if p == "validation"]
    for rec, val_s in zip(epochs, vals):
        train_s = rec["epoch_time_s"] - val_s
        log(f"[time] {what} epoch {rec['epoch']}: {rec['epoch_time_s']:.3f}"
            f" s, of which training {train_s:.3f} s ("
            f"{steps_per_epoch / train_s:.3f} optimizer steps/s, "
            f"{n_train / train_s:.1f} training molecules/s) and validation "
            f"{val_s:.3f} s | {card}")
    test_s = [s for p, s in times["evaluate"] if p == "test"]
    log(f"[time] {what}: test evaluation pass {test_s[0]:.3f} s, checkpoint "
        f"writes {[round(s, 3) for s in times['save']]} s | {card}")
    results = json.loads((run / "test_results.json").read_text())

    if resume:
        more = [*overrides, "trainer.max_epochs=3"]
        shutil.copytree(run, root / "resumed")
        cli.main(["train", *more, "trainer.resume=true",
                  f"workdir={root / 'resumed'}"])
        cli.main(["train", *more, f"workdir={root / 'fresh'}"])
        keys = ("val_loss", "MeanSquaredError", "MeanAbsoluteError",
                "train_loss", "lr_scale", "step")
        got, want = (epoch_record(root / d, 2) for d in ("resumed", "fresh"))
        hold_results(f"{what} resume", {k: got[k] for k in keys},
                     {k: want[k] for k in keys}, TOL_RESUME)

    ckpt = f"checkpoint={run / 'ckpt_best'}"
    with trainer_timings() as times:
        cli.main(["test", ckpt, *overrides, f"workdir={root / 'test'}"])
    log(f"[time] {what}: cli test evaluation pass "
        f"{times['evaluate'][0][1]:.3f} s | {card}")
    hold_results(f"{what} cli test",
                 json.loads((root / "test" / "test_results.json").read_text()),
                 results, TOL_CLI_TEST)
    with mock.patch.object(*plain_forward):
        cli.main(["test", ckpt, *overrides, f"workdir={root / 'plain'}"])
    hold_results(f"{what} cli test, plain path",
                 json.loads((root / "plain" / "test_results.json").read_text()),
                 results, TOL_SERVE)

    records = []
    for (name, module, fn, plain, bound, replaces), kept, n in zip(
            kernels, (fwd_kept, bwd_kept), launches):
        record = kernel_record(
            {"name": name, "route": "cuda",
             "source": f"gotennet_tpu_torch/csrc/{name}.cu",
             "replaces": replaces}, kept, getattr(module, fn), plain, bound,
            card)
        record["launches"] = n
        records.append(record)
    return records


def label_cli_phases(card, phase_done) -> list:
    """Phase 28: ``cli train`` / ``cli test`` of ``qm9_u0_tpu`` with
    ``label=mu`` (the Dipole head) and ``label=r2`` (the electronic spatial
    extent) through both GATA kernels; returns the four kernel records."""
    from gotennet_tpu_torch.ops import fused_gata, fused_htr
    records = []
    for label in ("mu", "r2"):
        records += cli_phase(
            card, f"QM9 {label} cli", [*CLI_QM9_LABELS, f"label={label}"],
            [("fused_gata_fwd", fused_gata, "fused_gata_forward",
              fused_gata.fused_gata_forward_reference, fwd_bound_ms,
              "gotennet_tpu/ops/pallas/fused_gata.py:108"),
             ("fused_gata_bwd", fused_gata, "fused_gata_backward",
              fused_gata.fused_gata_backward_reference, bwd_bound_ms,
              "gotennet_tpu/ops/pallas/fused_gata.py:350")],
            (fused_gata, "fused_gata_forward",
             fused_gata.fused_gata_forward_reference),
            # 16 training batches of 32, one validation and one test batch
            ((16 + 1 + 1) * N_LAYERS, 16 * N_LAYERS),
            [fused_htr.fused_htr_forward, fused_htr.fused_htr_backward],
            n_train=512, steps_per_epoch=2)
        meta = json.loads((CLI_DIR / f"QM9_{label}_cli" / "run" / "ckpt_best"
                           / "meta.json").read_text())
        log(f"[QM9 {label} cli] head {meta['head']['kind']}, label "
            f"{meta['label']}")
        want = {"mu": "dipole", "r2": "electronic_spatial_extent"}[label]
        if meta["head"]["kind"] != want:
            raise AssertionError(f"label={label} built a {meta['head']['kind']}"
                                 f" head, not {want}")
    phase_done("28 (QM9 mu and r2 through the command line)")
    return records


def kernel_counters() -> list:
    """Every kernel wrapper of the port (their ``launches`` counters)."""
    from gotennet_tpu_torch.ops import fused_ell, fused_gata, fused_htr
    return [fused_gata.fused_gata_forward, fused_gata.fused_gata_backward,
            fused_htr.fused_htr_forward, fused_htr.fused_htr_backward,
            fused_ell.fused_ell_forward, fused_ell.fused_ell_backward,
            fused_htr.fused_htr_ell_forward, fused_htr.fused_htr_ell_backward]


def md22_unfused_phase(cfg, card) -> None:
    """Phase 29: phase 10's 32 frames through ``Predictor`` with
    ``fused=False`` (the plain-tensor message and HTR update, no kernel)
    against ``fused=True`` (both GATA and both HTR kernels) at one state
    dict: energies (``predict``) and energies and forces
    (``predict_with_forces``) within TOL_SERVE; both paths timed and
    profiled, the unfused force request's peak memory."""
    from gotennet_tpu_torch.serve import Predictor

    mols = md22_frames()
    head = force_head()
    fused = Predictor(cfg, head, seed=0, chunk=MD22_CHUNK, bucket=False)
    plain = Predictor(dataclasses.replace(cfg, fused=False), head,
                      fused.model.state_dict(), chunk=MD22_CHUNK,
                      bucket=False)
    counters = kernel_counters()
    n_chunks = math.ceil(MD22_FRAMES / MD22_CHUNK)
    gata, htr = n_chunks * N_LAYERS, n_chunks * (N_LAYERS - 1)
    # predict launches the forwards, predict_with_forces both ways
    expected = {"fused": [2 * gata, gata, 2 * htr, htr, 0, 0, 0, 0],
                "unfused": [0] * 8}
    answers = {}
    for what, pred in (("fused", fused), ("unfused", plain)):
        for c in counters:
            c.launches = 0
        answers[what] = (pred.predict(mols), pred.predict_with_forces(mols))
        torch.cuda.synchronize()
        got = [c.launches for c in counters]
        log(f"[md22-unfused] {what}: launches {got} (expected "
            f"{expected[what]})")
        if got != expected[what]:
            raise AssertionError(f"{what}: launches {got}, expected "
                                 f"{expected[what]}")
    energies, want = answers["unfused"][0], answers["fused"][0]
    err, rel = rel_err(torch.from_numpy(energies), torch.from_numpy(want))
    log(f"[md22-unfused] request energies, unfused vs fused: max abs err "
        f"{err:.4e} (rel {rel:.3e}, tol {TOL_SERVE:g})")
    if rel > TOL_SERVE or not torch.isfinite(torch.from_numpy(energies)).all():
        raise AssertionError("unfused energies disagree with the fused "
                             "kernels'")
    hold_forces("md22-unfused force request, unfused vs fused",
                answers["unfused"][1], answers["fused"][1])
    for what, pred in (("fused", fused), ("unfused", plain)):
        for kind, run in (("request", lambda: pred.predict(mols)),
                          ("force request",
                           lambda: pred.predict_with_forces(mols))):
            if what == "unfused" and kind == "force request":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                run()
                torch.cuda.synchronize()
                log(f"[md22-unfused] unfused force request: peak memory "
                    f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
                    f"(torch.cuda.max_memory_allocated) | {card}")
            ms, host_ms, _ = time_run(run, 2, 3)
            log(f"[time] {MD22_FRAMES}-frame MD22 {kind}, {what} message: "
                f"{ms:.3f} ms (CUDA events), {host_ms:.3f} ms (host clock) "
                f"| {card}")
            profile(run, ms, f"{MD22_FRAMES}-frame MD22 {kind}, {what} "
                    "message", card)


def write_md22_npz(root) -> pathlib.Path:
    """An sGDML-format ``md22_AT-AT-CG-CG.npz`` of MD22_CLI_FRAMES frames
    of one MD22_CLI_ATOMS-atom topology at condensed-phase density, with the
    synthetic pair-potential energies and forces."""
    import numpy as np
    from gotennet_tpu_torch.data.dataset import synthetic_trajectory
    t = synthetic_trajectory(MD22_CLI_FRAMES, MD22_CLI_ATOMS, seed=0)
    root.mkdir(parents=True, exist_ok=True)
    path = root / "md22_AT-AT-CG-CG.npz"
    np.savez(path, z=t.z[0], R=np.stack(t.pos), E=t.y, F=np.stack(t.dy))
    return path


def md22_cli_phase(card) -> None:
    """Phase 30: ``cli train experiment=md22_atat`` at the yaml's width
    (dense, fused=False, bf16 pairs, batch 8 at M = 120, MSE energy 0.05 /
    force 0.95, standardised, attention dropout 0.1, remat) for one epoch,
    then ``cli test``.  No kernel launches; every loss finite; the first
    optimizer step's gradients on the card against the same step on the CPU
    (the same weights, batch and dropout masks) within TOL_TRAIN; ``cli
    test`` against the run within TOL_CLI_TEST; epoch, steps/s, frames/s,
    a step's busy share and peak memory, checkpoint and evaluation times."""
    from gotennet_tpu_torch import cli
    from gotennet_tpu_torch.models import gotennet
    from gotennet_tpu_torch.train.optim import make_optimizer
    from gotennet_tpu_torch.train.trainer import (accum_grads, make_loss_fn,
                                                  train_step)
    from gotennet_tpu_torch.utils.config import load_config

    root = CLI_DIR / "md22_atat"
    shutil.rmtree(root, ignore_errors=True)
    path = write_md22_npz(root / "data")
    overrides = ["experiment=md22_atat",
                 f"datamodule.dataset_root={path.parent}",
                 "trainer.max_epochs=1", "trainer.log_every=1"]
    run = root / "run"
    counters = kernel_counters()
    for c in counters:
        c.launches = 0
    with trainer_timings() as times:
        t0 = time.perf_counter()
        cli.main(["train", *overrides, f"workdir={run}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = [c.launches for c in counters]
    log(f"[md22 cli] cli train: {wall:.2f} s on the wall; kernel launches "
        f"{launches} (none expected: the unfused paths)")
    if any(launches):
        raise AssertionError("md22_atat launched a fused kernel")
    recs = read_jsonl(run / "metrics.jsonl")
    steps = [r for r in recs if r["phase"] == "train"]
    (epoch,) = [r for r in recs if r["phase"] == "val_epoch"]
    numbers = [r[k] for r in steps for k in ("loss", "energy_MSELoss",
                                             "force_MSELoss", "grad_norm")]
    numbers += [epoch[k] for k in ("val_loss", "train_loss",
                                   "MeanAbsoluteError_energy",
                                   "MeanAbsoluteError_force")]
    log(f"[md22 cli] {len(steps)} optimizer steps, losses "
        f"{[round(r['loss'], 6) for r in steps]}, force losses "
        f"{[round(r['force_MSELoss'], 6) for r in steps]}")
    if not steps or not all(math.isfinite(x) for x in numbers):
        raise AssertionError("md22_atat: a loss is not finite")
    cfg = load_config(cli.CONFIG_DIR, "train.yaml",
                      [*overrides, f"workdir={root / 'grads'}"])
    train_loader, _, _, meta = cli._build_data(cfg, cfg["label"])
    n_train = len(train_loader.ds)
    (val_s,) = [s for p, s in times["evaluate"] if p == "validation"]
    train_s = epoch["epoch_time_s"] - val_s
    test_s = [s for p, s in times["evaluate"] if p == "test"]
    log(f"[time] md22 cli epoch: {epoch['epoch_time_s']:.3f} s, of which "
        f"training {train_s:.3f} s ({len(steps) / train_s:.3f} optimizer "
        f"steps/s, {n_train / train_s:.2f} training frames/s) and "
        f"validation {val_s:.3f} s; test evaluation pass {test_s[0]:.3f} s; "
        f"checkpoint writes {[round(x, 3) for x in times['save']]} s | "
        f"{card}")

    # the first step on the card against the same step on the CPU
    train_loader.set_epoch(0)
    batch = next(iter(train_loader))
    grads, models = [], []
    keep = torch.Generator()
    real_mask = gotennet.attention_keep_mask

    def same_masks(shape, rate, generator, device):
        return real_mask(shape, rate, keep, torch.device("cpu")).to(device)

    for device in ("cuda", "cpu"):
        model, task, _ = cli._build_model_and_trainer(cfg, meta,
                                                      torch.device(device))
        model.train()
        keep.manual_seed(0)
        t0 = time.perf_counter()
        with mock.patch.object(gotennet, "attention_keep_mask", same_masks):
            loss = accum_grads(model, make_loss_fn(model, task),
                               [batch.to(device)])
        grads.append({n: p.grad.float().cpu()
                      for n, p in model.named_parameters()})
        log(f"[md22 cli] first step on {device}: loss {float(loss):.6f}, "
            f"{time.perf_counter() - t0:.1f} s")
        models.append((model, task))
    errs = {n: rel_err(grads[0][n], g) for n, g in grads[1].items()}
    worst = max(errs, key=lambda n: errs[n][1])
    log(f"[md22 cli] first-step gradients, card vs CPU: {len(errs)} tensors, "
        f"worst {worst} abs {errs[worst][0]:.3e} rel {errs[worst][1]:.3e} "
        f"(tol {TOL_TRAIN:g} rel)")
    if errs[worst][1] > TOL_TRAIN or not all(
            torch.isfinite(g).all() for g in grads[0].values()):
        raise AssertionError("md22_atat gradients on the card disagree with "
                             "the CPU's")

    # one optimizer step on the card: its time, busy share and peak memory
    model, task = models[0]
    chunks = [batch.to("cuda")]
    opt = make_optimizer(model.parameters(), cfg["model"]["lr"])
    loss_fn = make_loss_fn(model, task)

    def step():
        return train_step(model, opt, chunks, opt.grad_clip, loss_fn=loss_fn)

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms, host_ms, _ = time_run(step, 1, 3)
    log(f"[time] md22 force-training step ({batch.num_graphs} frames, M = "
        f"{batch.max_atoms}, double backward): {step_ms:.3f} ms (CUDA "
        f"events), {host_ms:.3f} ms (host clock); peak memory {peak:.3f} GiB"
        f" (torch.cuda.max_memory_allocated) | {card}")
    profile(step, step_ms, "md22 force-training step", card)

    results = json.loads((run / "test_results.json").read_text())
    with trainer_timings() as times:
        cli.main(["test", f"checkpoint={run / 'ckpt_best'}", *overrides,
                  f"workdir={root / 'test'}"])
    log(f"[time] md22 cli test evaluation pass {times['evaluate'][0][1]:.3f}"
        f" s | {card}")
    hold_results("md22 cli test",
                 json.loads((root / "test" / "test_results.json").read_text()),
                 results, TOL_CLI_TEST)


def new_phases(card, phase_done, md22_cfg) -> list:
    """Phases 28-30; returns phase 28's kernel records."""
    records = label_cli_phases(card, phase_done)
    md22_unfused_phase(md22_cfg, card)
    phase_done("29 (the unfused dense message at MD22 size)")
    md22_cli_phase(card)
    phase_done("30 (md22_atat through the command line: training on "
               "forces)")
    return records


# ---- phases 31-34: the edge-list layout and the remaining model options ----
# phase 33: md17_aspirin as its yaml sets it, on an rMD17 NPZ of 1,100
# synthetic frames of one 21-atom topology (950 / 50 / 100), one epoch
MD17_CLI_FRAMES, MD17_CLI_ATOMS = 1100, 21
# phase 31: the edge layout against the dense layout's plain float32 model
# at one state dict: the same nearest-32 graph, f32 sums in another order
# (and segment sums by atomics on the card) -> 1e-4 of the scale
TOL_EDGE = 1e-4
# phase 34: every remaining option on three layouts at one state dict; the
# dense and ELL runs round their pair tensors to bf16, the edge one does not
TOL_OPTIONS = 1e-2


def peak_gib(run) -> float:
    """Peak device memory (GiB, torch.cuda.max_memory_allocated) of one
    ``run()``, counted from what the process held before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**30


def no_launches(what) -> None:
    """Fail unless every kernel counter reads 0 (the edge layout and the
    plain paths launch no kernel)."""
    got = [c.launches for c in kernel_counters()]
    log(f"[{what}] kernel launches {got} (none expected)")
    if any(got):
        raise AssertionError(f"{what} launched a kernel: {got}")


def reset_counters() -> None:
    for c in kernel_counters():
        c.launches = 0


def edge_flagship():
    """Phase 31's model: the flagship width in float32, the edge layout
    (which has no pair type), and the QM9 U0 head."""
    from gotennet_tpu_torch.models.gotennet import GotenNetConfig
    from gotennet_tpu_torch.tasks.qm9 import QM9Task
    cfg = GotenNetConfig(n_atom_basis=D, n_interactions=N_LAYERS, lmax=LMAX,
                         n_rbf=64, num_heads=H, remat=False)
    return cfg, QM9Task("U0", dataset_meta={"mean": 0.0,
                                            "std": 1.0}).build_head()


def edge_serve_phase(card) -> None:
    """Phase 31, serving: phase 4's 256 molecules through
    ``Predictor(layout="edge")`` in 8-graph chunks (no kernel launch);
    against the dense layout's plain float32 model at one state dict within
    TOL_EDGE, and against the CPU within TOL_F32; latency, busy share, real
    edges/s, device ops a request and peak memory."""
    from gotennet_tpu_torch.data.dataset import (MoleculeDataset,
                                                 synthetic_molecules)
    from gotennet_tpu_torch.serve import Predictor

    cfg, head = edge_flagship()
    ds = synthetic_molecules(sum(REQUESTS), seed=0, min_atoms=12,
                             max_atoms=29)
    mols = ds.graph_dicts(range(len(ds)))[-REQUESTS[-1]:]
    pred = Predictor(cfg, head, seed=0, chunk=CHUNK, layout="edge")
    reset_counters()
    got = pred.predict(mols)
    torch.cuda.synchronize()
    no_launches("edge request")
    state = pred.model.state_dict()
    dense = Predictor(dataclasses.replace(cfg, fused=False), head, state,
                      chunk=CHUNK)
    for what, want in (("dense plain float32 model",
                        dense.predict(mols)),
                       ("CPU", Predictor(cfg, head, state, chunk=CHUNK,
                                         layout="edge",
                                         device="cpu").predict(mols))):
        tol = TOL_EDGE if what.startswith("dense") else TOL_F32
        err, rel = rel_err(torch.from_numpy(got), torch.from_numpy(want))
        log(f"[edge request] {len(mols)} energies vs the {what}: max abs err "
            f"{err:.4e} (rel {rel:.3e}, tol {tol:g})")
        if (got.shape != (len(mols), 1) or rel > tol
                or not torch.isfinite(torch.from_numpy(got)).all()):
            raise AssertionError(f"edge energies disagree with the {what}")
    chunks = [b for _, b in pred.loader(MoleculeDataset(
        z=[m["z"] for m in mols], pos=[m["pos"] for m in mols])).batches()]
    real = sum(int(b.edge_mask.sum()) for b in chunks)
    slots = sum(b.num_edges for b in chunks)
    req_ms, host_ms, _ = time_run(lambda: pred.predict(mols), 2, 5)
    log(f"[time] 256-molecule edge request: {req_ms:.3f} ms (CUDA events), "
        f"{host_ms:.3f} ms (host clock); real edges {real} (self-loops "
        f"included) in {slots} edge slots; {real / (req_ms / 1e3):.1f} real "
        f"edges/s | {card}")
    profile(lambda: pred.predict(mols), req_ms, "256-molecule edge request",
            card)
    log(f"[edge request] peak memory {peak_gib(lambda: pred.predict(mols)):.3f}"
        f" GiB (torch.cuda.max_memory_allocated) | {card}")


def edge_train_phase(card) -> None:
    """Phase 31, training: one step of ``train_steps(layout="edge")`` on 256
    molecules in 16-graph chunks (no kernel launch), then a step timed,
    profiled and its peak memory."""
    from gotennet_tpu_torch.data.dataset import synthetic_molecules
    from gotennet_tpu_torch.models.model import GotenModel
    from gotennet_tpu_torch.tasks.base import Task
    from gotennet_tpu_torch.train.optim import make_optimizer
    from gotennet_tpu_torch.train.trainer import (make_chunks, make_loss_fn,
                                                  train_step, train_steps)

    cfg, head = edge_flagship()
    mols = synthetic_molecules(TRAIN_MOLS, seed=1, min_atoms=12,
                               max_atoms=29).graph_dicts(range(TRAIN_MOLS))
    reset_counters()
    losses = train_steps(cfg, head, mols, 1, chunk=TRAIN_CHUNK, lr=LR, seed=0,
                         layout="edge")
    torch.cuda.synchronize()
    log(f"[edge step] one step on {TRAIN_MOLS} molecules in {TRAIN_CHUNK}-"
        f"graph chunks: loss {losses[0]:.6f}")
    no_launches("edge step")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("edge training loss is not finite")
    model = GotenModel(cfg, head, "edge", seed=0)
    chunks = make_chunks(mols, TRAIN_CHUNK, "cuda", layout="edge")
    opt = make_optimizer(model.parameters(), LR)
    loss_fn = make_loss_fn(model, Task(None))

    def step():
        return train_step(model, opt, chunks, opt.grad_clip, loss_fn=loss_fn)

    step_ms, host_ms, step_losses = time_run(step, 2, 3)
    if not all(math.isfinite(x) for x in step_losses):
        raise AssertionError("edge training loss is not finite")
    real = sum(int(b.edge_mask.sum()) for b in chunks)
    log(f"[time] edge training step: {step_ms:.3f} ms (CUDA events), "
        f"{host_ms:.3f} ms (host clock); real edges {real}; "
        f"{real / (step_ms / 1e3):.1f} real edges/s; losses "
        f"{[round(x, 6) for x in step_losses]} | {card}")
    profile(step, step_ms, "edge training step", card)
    log(f"[edge step] peak memory {peak_gib(step):.3f} GiB "
        f"(torch.cuda.max_memory_allocated) | {card}")


def edge_cli_run(card, what, overrides, n_train, steps_per_epoch,
                 layout="edge") -> tuple:
    """``cli train`` with ``overrides`` on ``layout`` (no kernel launch: the
    edge layout, or the dense one unfused), every loss finite, the files
    written; the epochs' seconds,
    optimizer steps/s, molecules/s and evaluation seconds; then ``cli test``
    of ``ckpt_best`` against the run within TOL_CLI_TEST.  Returns the run's
    directory and the loaded config."""
    from gotennet_tpu_torch import cli
    from gotennet_tpu_torch.utils.config import load_config

    root = CLI_DIR / what.replace(" ", "_")
    shutil.rmtree(root, ignore_errors=True)
    run = root / "run"
    reset_counters()
    with trainer_timings() as times:
        t0 = time.perf_counter()
        cli.main(["train", *overrides, f"workdir={run}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log(f"[{what}] cli train: {wall:.2f} s on the wall")
    no_launches(what)
    meta = json.loads((run / "ckpt_best" / "meta.json").read_text())
    if meta["layout"] != layout:
        raise AssertionError(f"{what} trained on the {meta['layout']} layout")
    for name in ("ckpt_best", "ckpt_last", "splits.npz", "metrics.jsonl",
                 "test_results.json"):
        if not (run / name).exists():
            raise AssertionError(f"{what}: {name} was not written")
    recs = read_jsonl(run / "metrics.jsonl")
    steps = [r for r in recs if r["phase"] == "train"]
    epochs = [r for r in recs if r["phase"] == "val_epoch"]
    numbers = [r["loss"] for r in steps] + [
        r[k] for r in epochs for k in ("val_loss", "train_loss")]
    log(f"[{what}] {len(steps)} optimizer steps, losses "
        f"{[round(r['loss'], 6) for r in steps][:8]}...")
    if not steps or not all(math.isfinite(x) for x in numbers):
        raise AssertionError(f"{what}: a loss is not finite")
    vals = [s for p, s in times["evaluate"] if p == "validation"]
    for rec, val_s in zip(epochs, vals):
        train_s = rec["epoch_time_s"] - val_s
        log(f"[time] {what} epoch {rec['epoch']}: {rec['epoch_time_s']:.3f}"
            f" s, of which training {train_s:.3f} s ("
            f"{steps_per_epoch / train_s:.3f} optimizer steps/s, "
            f"{n_train / train_s:.1f} training molecules/s) and validation "
            f"{val_s:.3f} s | {card}")
    test_s = [s for p, s in times["evaluate"] if p == "test"]
    log(f"[time] {what}: test evaluation pass {test_s[0]:.3f} s, checkpoint "
        f"writes {[round(s, 3) for s in times['save']]} s | {card}")
    with trainer_timings() as times:
        cli.main(["test", f"checkpoint={run / 'ckpt_best'}", *overrides,
                  f"workdir={root / 'test'}"])
    log(f"[time] {what}: cli test evaluation pass "
        f"{times['evaluate'][0][1]:.3f} s | {card}")
    hold_results(f"{what} cli test",
                 json.loads((root / "test" / "test_results.json").read_text()),
                 json.loads((run / "test_results.json").read_text()),
                 TOL_CLI_TEST)
    return run, load_config(cli.CONFIG_DIR, "train.yaml",
                            [*overrides, f"workdir={root / 'again'}"])


def write_md17_npz(root) -> pathlib.Path:
    """An rMD17-format ``rmd17_aspirin.npz`` of MD17_CLI_FRAMES frames of one
    MD17_CLI_ATOMS-atom topology (a QM9-like spread), with the synthetic
    pair-potential energies and forces."""
    import numpy as np
    from gotennet_tpu_torch.data.dataset import synthetic_trajectory
    t = synthetic_trajectory(MD17_CLI_FRAMES, MD17_CLI_ATOMS, seed=0,
                             box=4.0)
    root.mkdir(parents=True, exist_ok=True)
    path = root / "rmd17_aspirin.npz"
    np.savez(path, nuclear_charges=t.z[0], coords=np.stack(t.pos),
             energies=t.y[:, 0].astype(np.float64), forces=np.stack(t.dy))
    return path


def md17_cli_phase(card) -> None:
    """Phase 33: ``cli train experiment=md17_aspirin`` as the yaml sets it
    (edge layout, 256 channels, 4 layers, 64 RBFs, batch 16, MSE energy 0.05
    / force 0.95, standardised, dropout 0.1, remat) for one epoch, then
    ``cli test``; the first optimizer step's gradients on the card against
    the same step on the CPU (the same weights, batch and dropout masks)
    within TOL_TRAIN; a step's time, busy share and peak memory."""
    from gotennet_tpu_torch import cli
    from gotennet_tpu_torch.models import gotennet
    from gotennet_tpu_torch.train.optim import make_optimizer
    from gotennet_tpu_torch.train.trainer import (accum_grads, make_loss_fn,
                                                  train_step)

    path = write_md17_npz(CLI_DIR / "md17_aspirin_data")
    overrides = ["experiment=md17_aspirin",
                 f"datamodule.dataset_root={path.parent}",
                 "trainer.max_epochs=1", "trainer.log_every=1"]
    run, cfg = edge_cli_run(card, "md17_aspirin cli", overrides, 950,
                            math.ceil(950 / 16))
    steps = [r for r in read_jsonl(run / "metrics.jsonl")
             if r["phase"] == "train"]
    log(f"[md17_aspirin cli] force losses "
        f"{[round(r['force_MSELoss'], 6) for r in steps][:8]}...")
    train_loader, _, _, meta = cli._build_data(cfg, cfg["label"])
    train_loader.set_epoch(0)
    batch = next(iter(train_loader))
    grads, models = [], []
    keep = torch.Generator()
    real_mask = gotennet.attention_keep_mask

    def same_masks(shape, rate, generator, device):
        return real_mask(shape, rate, keep, torch.device("cpu")).to(device)

    for device in ("cuda", "cpu"):
        model, task, _ = cli._build_model_and_trainer(cfg, meta,
                                                      torch.device(device))
        model.train()
        keep.manual_seed(0)
        t0 = time.perf_counter()
        with mock.patch.object(gotennet, "attention_keep_mask", same_masks):
            loss = accum_grads(model, make_loss_fn(model, task),
                               [batch.to(device)])
        grads.append({n: p.grad.float().cpu()
                      for n, p in model.named_parameters()})
        log(f"[md17_aspirin cli] first step on {device}: loss "
            f"{float(loss):.6f}, {time.perf_counter() - t0:.1f} s")
        models.append((model, task))
    errs = {n: rel_err(grads[0][n], g) for n, g in grads[1].items()}
    worst = max(errs, key=lambda n: errs[n][1])
    log(f"[md17_aspirin cli] first-step gradients, card vs CPU: {len(errs)} "
        f"tensors, worst {worst} abs {errs[worst][0]:.3e} rel "
        f"{errs[worst][1]:.3e} (tol {TOL_TRAIN:g} rel)")
    if errs[worst][1] > TOL_TRAIN or not all(
            torch.isfinite(g).all() for g in grads[0].values()):
        raise AssertionError("md17_aspirin gradients on the card disagree "
                             "with the CPU's")
    model, task = models[0]
    chunks = [batch.to("cuda")]
    opt = make_optimizer(model.parameters(), cfg["model"]["lr"])
    loss_fn = make_loss_fn(model, task)

    def step():
        return train_step(model, opt, chunks, opt.grad_clip, loss_fn=loss_fn)

    peak = peak_gib(step)
    step_ms, host_ms, _ = time_run(step, 1, 3)
    log(f"[time] md17_aspirin force-training step ({batch.num_graphs} frames, "
        f"{batch.num_edges} edge slots, double backward): {step_ms:.3f} ms "
        f"(CUDA events), {host_ms:.3f} ms (host clock); peak memory "
        f"{peak:.3f} GiB (torch.cuda.max_memory_allocated) | {card}")
    profile(step, step_ms, "md17_aspirin force-training step", card)


def options_phase(card) -> list:
    """Phase 34: every remaining option (``layernorm``, ``steerable_norm``,
    ``trainable_rbf``, ``edge_updates="gated_mlpa_linwa_postln"``,
    ``edge_ln``, ``evec_dim=128``) at full width on phase 10's 32 frames,
    on the edge, dense and ELL layouts (the fused message, the plain update)
    at one state dict: energies within TOL_OPTIONS of the edge layout's;
    rows 1 and 5 launch 32 times each, no other kernel; each request timed
    and profiled.  Returns rows 1 and 5's records on these inputs."""
    from gotennet_tpu_torch.models.gotennet import GotenNetConfig
    from gotennet_tpu_torch.ops import fused_ell, fused_gata
    from gotennet_tpu_torch.serve import Predictor
    from gotennet_tpu_torch.tasks.qm9 import QM9Task

    bf16 = torch.bfloat16
    cfg = GotenNetConfig(
        n_atom_basis=D, n_interactions=N_LAYERS, lmax=LMAX, n_rbf=64,
        num_heads=H, pair_dtype=bf16, node_dtype=bf16, remat=False,
        layernorm="pre", steerable_norm="pre", trainable_rbf=True,
        edge_updates="gated_mlpa_linwa_postln", edge_ln="layer",
        evec_dim=128)
    head = QM9Task("U0", dataset_meta={"mean": 0.0, "std": 1.0}).build_head()
    mols = md22_frames()
    edge = Predictor(cfg, head, seed=0, chunk=MD22_CHUNK, layout="edge")
    state = edge.model.state_dict()
    preds = {"edge": edge,
             "dense": Predictor(cfg, head, state, chunk=MD22_CHUNK,
                                bucket=False),
             "ELL": Predictor(cfg, head, state, chunk=MD22_CHUNK,
                              layout="ell")}
    n = math.ceil(MD22_FRAMES / MD22_CHUNK) * N_LAYERS
    expected = {"edge": [0] * 8, "dense": [n, 0, 0, 0, 0, 0, 0, 0],
                "ELL": [0, 0, 0, 0, n, 0, 0, 0]}
    answers = {}
    for what, pred in preds.items():
        reset_counters()
        answers[what] = pred.predict(mols)
        torch.cuda.synchronize()
        got = [c.launches for c in kernel_counters()]
        log(f"[options] {what}: launches {got} (expected {expected[what]})")
        if got != expected[what]:
            raise AssertionError(f"options, {what}: launches {got}")
    want = torch.from_numpy(answers["edge"])
    for what in ("dense", "ELL"):
        err, rel = rel_err(torch.from_numpy(answers[what]), want)
        log(f"[options] {what} vs edge energies: max abs err {err:.4e} (rel "
            f"{rel:.3e}, tol {TOL_OPTIONS:g})")
        if rel > TOL_OPTIONS or not torch.isfinite(want).all():
            raise AssertionError(f"options: {what} disagrees with the edge "
                                 "layout")
    for what, pred in preds.items():
        ms, host_ms, _ = time_run(lambda: pred.predict(mols), 2, 3)
        log(f"[time] {MD22_FRAMES}-frame options request, {what} layout: "
            f"{ms:.3f} ms (CUDA events), {host_ms:.3f} ms (host clock) | "
            f"{card}")
        profile(lambda: pred.predict(mols), ms,
                f"{MD22_FRAMES}-frame options request, {what} layout", card)
    records = []
    for what, module, fn_name, plain, bound, name, replaces in (
            ("dense", fused_gata, "fused_gata_forward",
             fused_gata.fused_gata_forward_reference, fwd_bound_ms,
             "fused_gata_fwd", "gotennet_tpu/ops/pallas/fused_gata.py:108"),
            ("ELL", fused_ell, "fused_ell_forward",
             fused_ell.fused_ell_forward_reference, ell_fwd_bound_ms,
             "fused_ell_fwd", "gotennet_tpu/ops/pallas/fused_ell.py:77")):
        captured = capture(module, fn_name,
                           lambda: preds[what].predict(mols))
        record = kernel_record(
            {"name": name, "route": "cuda",
             "source": f"gotennet_tpu_torch/csrc/{name}.cu",
             "replaces": replaces}, captured, getattr(module, fn_name),
            plain, bound, card)
        record["launches"] = n
        records.append(record)
    return records


def edge_phases(card, phase_done) -> list:
    """Phases 31-34; returns phase 34's kernel records."""
    edge_serve_phase(card)
    edge_train_phase(card)
    phase_done("31 (the edge layout: QM9 request and step)")
    edge_cli_run(card, "qm9_u0 cli", [
        "experiment=qm9_u0", "datamodule.dataset=synthetic",
        "datamodule.n_molecules=1280", "datamodule.min_atoms=12",
        "datamodule.max_atoms=29", "datamodule.train_size=1024",
        "datamodule.val_size=128", "datamodule.test_size=128",
        "trainer.max_epochs=1", "trainer.log_every=1"], 1024, 1024 // 32)
    edge_cli_run(card, "smoke cli", ["experiment=smoke"], 48, 6)
    phase_done("32 (qm9_u0 and smoke through the command line)")
    md17_cli_phase(card)
    phase_done("33 (md17_aspirin through the command line: forces)")
    records = options_phase(card)
    phase_done("34 (every remaining option on three layouts)")
    return records


def cli_phases(card, phase_done) -> tuple:
    """Phases 26 and 27; returns each one's two kernel records."""
    from gotennet_tpu_torch.ops import fused_ell, fused_gata, fused_htr
    qm9_records = cli_phase(
        card, "QM9 cli", CLI_QM9,
        [("fused_gata_fwd", fused_gata, "fused_gata_forward",
          fused_gata.fused_gata_forward_reference, fwd_bound_ms,
          "gotennet_tpu/ops/pallas/fused_gata.py:108"),
         ("fused_gata_bwd", fused_gata, "fused_gata_backward",
          fused_gata.fused_gata_backward_reference, bwd_bound_ms,
          "gotennet_tpu/ops/pallas/fused_gata.py:350")],
        (fused_gata, "fused_gata_forward",
         fused_gata.fused_gata_forward_reference),
        # 32 training batches an epoch, one validation and one test batch
        ((32 * 2 + 2 + 1) * N_LAYERS, 32 * 2 * N_LAYERS),
        [fused_htr.fused_htr_forward, fused_htr.fused_htr_backward],
        n_train=1024, steps_per_epoch=4, resume=True)
    phase_done("26 (QM9 through the command line)")
    large_records = cli_phase(
        card, "large_molecule cli", CLI_LARGE,
        [("fused_ell_fwd", fused_ell, "fused_ell_forward",
          fused_ell.fused_ell_forward_reference, ell_fwd_bound_ms,
          "gotennet_tpu/ops/pallas/fused_ell.py:77"),
         ("fused_ell_bwd", fused_ell, "fused_ell_backward",
          fused_ell.fused_ell_backward_reference, ell_bwd_bound_ms,
          "gotennet_tpu/ops/pallas/fused_ell.py:256")],
        (fused_ell, "fused_ell_forward",
         fused_ell.fused_ell_forward_reference),
        # 6 training batches, one validation and one test batch
        ((6 + 1 + 1) * N_LAYERS, 6 * N_LAYERS),
        [fused_htr.fused_htr_ell_forward, fused_htr.fused_htr_ell_backward],
        n_train=24, steps_per_epoch=2)
    phase_done("27 (large_molecule through the command line)")
    return qm9_records, large_records


# ---- phases 35-37: packed slabs, Molecule3D, two ranks on the card -----------
# phase 35: phase 4's 256 molecules packed into slabs of the largest
# molecule's M, PACK_BATCH molecules a batch (the qm9_u0_tpu batch); the
# step packs phase 6's molecules TRAIN_CHUNK a batch
PACK_BATCH = 32
# phase 36: Molecule3D-format files of M3D_MOLS synthetic 12-40-atom
# molecules, as SDF (two files and properties.csv) and as NPZ shards of
# M3D_SHARD molecules (four shards)
M3D_MOLS, M3D_SHARD = 320, 80
M3D_SIZES = dict(min_atoms=12, max_atoms=40)
M3D_DIR = CLI_DIR / "molecule3d"
# phase 37: the ranks' rendezvous files and outputs, and their time limit
RANKS_DIR = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_ranks"
RANK_TIMEOUT = 600
_SYMBOLS = {1: "H", 6: "C", 7: "N", 8: "O", 9: "F"}


def flagship_config():
    """Phase 3's model: 256 channels, 4 interactions, lmax 2, 64 RBFs, 8
    heads, bf16 pair and node types, merge_proj, fused, no remat."""
    from gotennet_tpu_torch.models.gotennet import GotenNetConfig
    return GotenNetConfig(n_atom_basis=D, n_interactions=N_LAYERS, lmax=LMAX,
                          n_rbf=64, num_heads=H, pair_dtype=torch.bfloat16,
                          node_dtype=torch.bfloat16, merge_proj=True,
                          remat=False)


def pack_phase(cfg, head, card) -> list:
    """Phase 35: phase 4's 256 molecules through ``DenseLoader(pack=True)``
    on the flagship model at phase 4's weights: a request (GATA forward
    launches = batches x layers, energies within TOL_SERVE of phase 4's
    bucketed request) and one step on phase 6's molecules packed
    TRAIN_CHUNK a batch (forward and backward launches = batches x layers,
    first-step gradients within TOL_TRAIN of the plain backward's); rows 1
    and 2 on the packed slabs against their plain versions, rerun to the
    same bits; both timed, profiled, their pairs a slab logged beside the
    bucketed ones.  Returns both kernels' records."""
    import numpy as np
    from gotennet_tpu_torch.data.dataset import (DenseLoader, MoleculeDataset,
                                                 synthetic_molecules)
    from gotennet_tpu_torch.models.model import GotenModel
    from gotennet_tpu_torch.ops import fused_gata
    from gotennet_tpu_torch.serve import Predictor
    from gotennet_tpu_torch.tasks.base import Task
    from gotennet_tpu_torch.train.optim import make_optimizer
    from gotennet_tpu_torch.train.trainer import (accum_grads, make_chunks,
                                                  make_loss_fn, train_step)

    fwd, bwd = fused_gata.fused_gata_forward, fused_gata.fused_gata_backward
    ds = synthetic_molecules(sum(REQUESTS), seed=0, min_atoms=12,
                             max_atoms=29)
    mols = ds.graph_dicts(range(len(ds)))[-REQUESTS[-1]:]
    n = len(mols)
    pred = Predictor(cfg, head, seed=0, chunk=CHUNK)
    bucketed = torch.from_numpy(pred.predict(mols))
    model = pred.model
    req = MoleculeDataset(z=[m["z"] for m in mols],
                          pos=[m["pos"] for m in mols])

    @torch.inference_mode()
    def request():
        out = torch.empty(n, 1, device="cuda")
        for idx, b in DenseLoader(req, PACK_BATCH, pack=True).batches():
            prop = model(b.to("cuda"))["property"]
            real = np.nonzero(idx >= 0)[0]
            out[torch.as_tensor(idx[real], device="cuda")] = \
                prop[torch.as_tensor(real, device="cuda")]
        return out

    # the main path: one packed request
    reset_counters()
    got = request()
    torch.cuda.synchronize()
    batches = [b.to("cuda") for b in DenseLoader(req, PACK_BATCH, pack=True)]
    launches = fwd.launches
    expected = len(batches) * N_LAYERS
    log(f"[packed request] {n} molecules in {len(batches)} packed batches "
        f"of {batches[0].num_graphs} slabs x {batches[0].max_atoms} slots, "
        f"at most {batches[0].mols_per_slab} molecules a slab: GATA forward "
        f"launches {launches} (batches x layers = {expected})")
    if launches != expected:
        raise AssertionError(f"{launches} launches, expected {expected}")
    no_other = [c.launches for c in kernel_counters() if c is not fwd]
    if any(no_other):
        raise AssertionError(f"packed request launched {no_other}")
    err, rel = rel_err(got.cpu(), bucketed)
    log(f"[packed request] energies vs phase 4's bucketed request: max abs "
        f"err {err:.4e} (rel {rel:.3e}, tol {TOL_SERVE:g})")
    if not torch.isfinite(got).all() or rel > TOL_SERVE:
        raise AssertionError("packed energies disagree with the bucketed "
                             "request")
    real, padded = count_pairs(batches, cfg)
    b_real, b_padded = count_pairs([b.to("cuda") for b in DenseLoader(
        req, batch_size=CHUNK, bucket=True,
        bucket_window=math.ceil(n / CHUNK))], cfg)
    n_slabs = sum(b.num_graphs for b in batches)
    req_ms, host_ms, _ = time_run(request, 2, 5)
    log(f"[time] 256-molecule packed request: {req_ms:.3f} ms (CUDA "
        f"events), {host_ms:.3f} ms (host clock); {n_slabs} slabs, real "
        f"pairs {real} (self-loops included) of {padded} padded pairs "
        f"({padded / n_slabs:.1f} a slab, {100 * real / padded:.1f} % real); "
        f"phase 4's bucketing: {b_real} of {b_padded} "
        f"({100 * b_real / b_padded:.1f} % real) | {card}")
    profile(request, req_ms, "256-molecule packed request", card)
    captured = capture(fused_gata, "fused_gata_forward", request)
    rerun_bits(fwd, captured, "fused_gata_fwd (packed request)")
    fwd_record = kernel_record(
        {"name": "fused_gata_fwd", "route": "cuda",
         "source": "gotennet_tpu_torch/csrc/fused_gata_fwd.cu",
         "replaces": "gotennet_tpu/ops/pallas/fused_gata.py:108"},
        captured, fwd, fused_gata.fused_gata_forward_reference, fwd_bound_ms,
        card)
    fwd_record["launches"] = launches

    # one step on phase 6's molecules, packed TRAIN_CHUNK a batch
    train = synthetic_molecules(TRAIN_MOLS, seed=1, min_atoms=12,
                                max_atoms=29)
    step_model = GotenModel(cfg, head, "dense", seed=0)
    chunks = [b.to("cuda") for b in DenseLoader(train, TRAIN_CHUNK,
                                                pack=True)]
    opt = make_optimizer(step_model.parameters(), LR)
    loss_fn = make_loss_fn(step_model, Task(None))

    def step():
        return train_step(step_model, opt, chunks, opt.grad_clip,
                          loss_fn=loss_fn)

    reset_counters()
    loss = step()
    torch.cuda.synchronize()
    launches = (fwd.launches, bwd.launches)
    expected = (len(chunks) * N_LAYERS,) * 2
    log(f"[packed step] one step on {TRAIN_MOLS} molecules in {len(chunks)} "
        f"packed batches of {chunks[0].num_graphs} slabs x "
        f"{chunks[0].max_atoms}: loss {loss:.6f}; GATA forward/backward "
        f"launches {launches[0]}/{launches[1]} (expected {expected})")
    if launches != expected or not math.isfinite(loss):
        raise AssertionError(f"packed step: launches {launches}, loss {loss}")
    step_model.train()
    accum_grads(step_model, loss_fn, chunks)
    grads = {k: p.grad.clone() for k, p in step_model.named_parameters()}
    with mock.patch.object(fused_gata, "fused_gata_backward",
                           fused_gata.fused_gata_backward_reference):
        accum_grads(step_model, loss_fn, chunks)
    errs = {k: rel_err(grads[k], p.grad)
            for k, p in step_model.named_parameters()}
    worst = max(errs, key=lambda k: errs[k][1])
    log(f"[packed step] gradients, kernel vs plain backward: {len(errs)} "
        f"tensors, worst {worst} rel {errs[worst][1]:.3e} (tol "
        f"{TOL_TRAIN:g})")
    if errs[worst][1] > TOL_TRAIN:
        raise AssertionError("packed step: gradients disagree with the plain "
                             "backward")
    step_ms, host_ms, losses = time_run(step, 2, 3)
    real, padded = count_pairs(chunks, cfg)
    b_real, b_padded = count_pairs(make_chunks(
        train.graph_dicts(range(TRAIN_MOLS)), TRAIN_CHUNK, "cuda"), cfg)
    log(f"[time] packed training step: {step_ms:.3f} ms (CUDA events), "
        f"{host_ms:.3f} ms (host clock); real pairs {real} of {padded} "
        f"padded ({100 * real / padded:.1f} % real; phase 6's bucketing "
        f"{100 * b_real / b_padded:.1f} %); losses "
        f"{[round(x, 6) for x in losses]} | {card}")
    profile(step, step_ms, "packed training step", card)
    captured = capture(fused_gata, "fused_gata_backward",
                       lambda: accum_grads(step_model, loss_fn, chunks))
    rerun_bits(bwd, captured, "fused_gata_bwd (packed step)")
    bwd_record = kernel_record(
        {"name": "fused_gata_bwd", "route": "cuda",
         "source": "gotennet_tpu_torch/csrc/fused_gata_bwd.cu",
         "replaces": "gotennet_tpu/ops/pallas/fused_gata.py:350"},
        captured, bwd, fused_gata.fused_gata_backward_reference,
        bwd_bound_ms, card)
    bwd_record["launches"] = launches[1]
    return [fwd_record, bwd_record]


def write_molecule3d(root) -> tuple:
    """Molecule3D's two layouts under ``root``: ``sdf/`` (two V2000 files of
    M3D_MOLS synthetic molecules and a ``properties.csv`` with their target
    as ``gap``) and ``shards/`` (the same molecules as NPZ shards of
    M3D_SHARD, by the port's ``save_shards``).  Returns both paths."""
    from gotennet_tpu_torch.data.dataset import synthetic_molecules
    from gotennet_tpu_torch.data.molecule3d import load_molecule3d, save_shards
    ds = synthetic_molecules(M3D_MOLS, seed=3, **M3D_SIZES)
    sdf, shards = root / "sdf", root / "shards"
    shutil.rmtree(root, ignore_errors=True)
    sdf.mkdir(parents=True)
    for part, (lo, hi) in enumerate(((0, M3D_MOLS // 2),
                                     (M3D_MOLS // 2, M3D_MOLS))):
        with open(sdf / f"combined_mols_{part}.sdf", "w") as f:
            for i in range(lo, hi):
                f.write(f"mol\n synthetic\n\n{len(ds.z[i]):3d}{0:3d}  0  0  "
                        "0  0  0  0  0  0999 V2000\n")
                for zj, p in zip(ds.z[i], ds.pos[i]):
                    f.write(f"{p[0]:10.4f}{p[1]:10.4f}{p[2]:10.4f} "
                            f"{_SYMBOLS[int(zj)]:<3}" + " 0" * 12 + "\n")
                f.write("M  END\n$$$$\n")
    with open(sdf / "properties.csv", "w") as f:
        f.write("index,dipole_x,dipole_y,dipole_z,homo,lumo,gap,scf_energy\n")
        for i in range(M3D_MOLS):
            gap = float(ds.y[i, 0])
            f.write(f"{i},0,0,0,-0.3,{-0.3 + gap},{gap},-40.0\n")
    paths = save_shards(load_molecule3d(str(sdf), label="gap"), str(shards),
                        shard_size=M3D_SHARD)
    log(f"[molecule3d] wrote {M3D_MOLS} synthetic 12-40-atom molecules as "
        f"SDF (+ properties.csv) and as {len(paths)} NPZ shards")
    return sdf, shards


def molecule3d_phase(card) -> pathlib.Path:
    """Phase 36: ``cli train experiment=molecule3d`` as the YAML sets it
    (dense, ``fused`` absent: the unfused message, no kernel; 256 channels,
    4 layers, dropout 0.1, remat, batch 32, standardised L1), one epoch,
    then ``cli test``, on an NPZ shard root and on an SDF root.  Returns
    the shard root."""
    sdf, shards = write_molecule3d(M3D_DIR)
    n_train = int(0.8 * M3D_MOLS)
    for what, root in (("molecule3d shards cli", shards),
                       ("molecule3d sdf cli", sdf)):
        edge_cli_run(card, what, [
            "experiment=molecule3d", f"datamodule.dataset_root={root}",
            "trainer.max_epochs=1", "trainer.log_every=1"], n_train,
            math.ceil(n_train / 32), layout="dense")
    return shards


def spawn_ranks(scenario, world, args=()) -> list:
    """``python3 chip_smoke.py --rank <scenario> <dir> <rank> <world>`` for
    every rank, started together; waits for all of them (every one killed
    at RANK_TIMEOUT seconds), logs every rank's output, and fails if any
    rank failed.  Returns each rank's output, in rank order."""
    work = RANKS_DIR / scenario
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--rank", scenario, str(work), str(r),
         str(world), *args], cwd=pathlib.Path(__file__).resolve().parent,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    deadline = time.monotonic() + RANK_TIMEOUT
    outs, failed = [], False
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(1.0,
                                               deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            out += f"\n(killed after {RANK_TIMEOUT} s)"
        failed |= p.returncode != 0
        outs.append(out)
    for r, (p, out) in enumerate(zip(procs, outs)):
        lines = out.splitlines()
        for line in (lines[-200:] if failed else lines):
            if failed or line.startswith("["):
                print(f"[rank {r}/{world}] {line}", flush=True)
    if failed:
        raise AssertionError(f"{scenario}: rank exit codes "
                             f"{[p.returncode for p in procs]}")
    return [torch.load(work / f"out_{r}.pt", map_location="cpu",
                       weights_only=False) for r in range(world)]


def cpu_state(model) -> dict:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def cpu_grads(model) -> dict:
    """The gradients a step left on the parameters (averaged over the ranks
    and clipped)."""
    return {k: p.grad.detach().cpu().clone()
            for k, p in model.named_parameters() if p.grad is not None}


def hold_states(what, got, want, tol, kind="parameters") -> None:
    """Every tensor of ``got`` (a state dict, or gradients by parameter)
    within ``tol`` of ``want``'s scale."""
    if got.keys() != want.keys():
        raise AssertionError(f"{what}: {kind} of other names")
    errs = {k: rel_err(got[k], want[k]) for k in want}
    worst = max(errs, key=lambda k: errs[k][1])
    log(f"[{what}] {kind}: {len(errs)} tensors, worst {worst} abs "
        f"{errs[worst][0]:.3e} rel {errs[worst][1]:.3e} (tol {tol:g})")
    if errs[worst][1] > tol:
        raise AssertionError(f"{what}: {kind} disagree")


def hold_step(what, got, want, tol) -> None:
    """A step's gradients within ``tol`` of one process's, each tensor to
    its scale; its parameters are logged.  (After AdamW's first step a
    parameter moves by about lr times the sign of its gradient, so an entry
    whose gradient is near zero can land 2 lr from the other run's: the
    gradients are what the two runs should share.)"""
    hold_states(what, got[1], want[1], tol, "gradients")
    errs = {k: rel_err(got[0][k], want[0][k]) for k in want[0]}
    worst = max(errs, key=lambda k: errs[k][0])
    log(f"[{what}] parameters after the step: worst abs {errs[worst][0]:.3e}"
        f" ({worst}; lr {LR:g})")


def capture_many(kernels, run) -> dict:
    """``capture`` of several wrappers at once: ``{name: calls}``."""
    with contextlib.ExitStack() as stack:
        kept = {}
        for module, name in kernels:
            kernel = getattr(module, name)
            kept[name] = []

            def record(*args, _k=kernel, _c=kept[name], **kwargs):
                _c.append((args, kwargs))
                return _k(*args, **kwargs)

            stack.enter_context(mock.patch.object(module, name, record))
        run()
        torch.cuda.synchronize()
    return kept


def parallel_references(md22_cfg, head) -> dict:
    """Phase 37's one-process results on the card: (a) one step of the
    flagship dense model with 2-batch accumulation, (b) the ELL request and
    step on one 600-700-atom frame, (c) one edge-layout step."""
    from gotennet_tpu_torch.data.dataset import synthetic_molecules
    from gotennet_tpu_torch.models.model import GotenModel
    from gotennet_tpu_torch.tasks.base import Task
    from gotennet_tpu_torch.train.optim import make_optimizer
    from gotennet_tpu_torch.train.trainer import (make_chunks, make_loss_fn,
                                                  train_step)

    def one_step(cfg, layout, chunks):
        model = GotenModel(cfg, head, layout, seed=0)
        opt = make_optimizer(model.parameters(), LR)
        loss = train_step(model, opt, chunks, opt.grad_clip,
                          loss_fn=make_loss_fn(model, Task(None)))
        return loss, (cpu_state(model), cpu_grads(model))

    out = {}
    qm9 = synthetic_molecules(TRAIN_MOLS, seed=1, min_atoms=12,
                              max_atoms=29).graph_dicts(range(2 * TRAIN_CHUNK))
    out["dp"] = one_step(flagship_config(), "dense",
                         make_chunks(qm9, TRAIN_CHUNK, "cuda"))
    frame = make_chunks(large_frames()[:1], 1, "cuda", layout="ell",
                        cutoff=md22_cfg.cutoff,
                        max_num_neighbors=md22_cfg.max_num_neighbors)
    model = GotenModel(md22_cfg, head, "ell", seed=0)
    with torch.inference_mode():
        out["ell_energy"] = model(frame[0])["property"].cpu()
    out["ell"] = one_step(md22_cfg, "ell", frame)
    cfg, _ = edge_flagship()
    out["edge"] = one_step(cfg, "edge", make_chunks(
        qm9[:TRAIN_CHUNK], TRAIN_CHUNK, "cuda", layout="edge"))
    return out


def rank_two(work, rank, world) -> dict:
    """Phase 37 on each of two ranks of a Gloo group on the one card: (a)
    data_parallel=2 on the flagship dense model, one step, rank d on batch
    d; (b) edge_parallel=2 on the ELL layout, one 600-700-atom frame (N =
    704, NR = 352 rows a rank), a request and a step, rows 5-8 captured and
    (rank 0, the other rank waiting) held against their plain versions and
    timed; (c) edge_parallel=2 on the edge layout, one step; (d) ``cli
    train experiment=molecule3d trainer.distributed=true
    trainer.data_parallel=2`` on phase 36's NPZ shards."""
    from gotennet_tpu_torch import cli
    from gotennet_tpu_torch.data import molecule3d
    from gotennet_tpu_torch.data.dataset import synthetic_molecules
    from gotennet_tpu_torch.models.model import GotenModel, set_edge_axis
    from gotennet_tpu_torch.ops import fused_ell, fused_gata, fused_htr
    from gotennet_tpu_torch.parallel import (make_mesh,
                                             make_parallel_train_step, psum,
                                             shard_graph_batch)
    from gotennet_tpu_torch.tasks.base import Task
    from gotennet_tpu_torch.tasks.qm9 import QM9Task
    from gotennet_tpu_torch.train import checkpoint
    from gotennet_tpu_torch.train.optim import make_optimizer
    from gotennet_tpu_torch.train.trainer import (Trainer, make_chunks,
                                                  make_loss_fn)

    card = card_line()
    head = QM9Task("U0", dataset_meta={"mean": 0.0, "std": 1.0}).build_head()
    out = {}

    def parallel_step(model, mesh, chunks):
        opt = make_optimizer(model.parameters(), LR)
        run = make_parallel_train_step(
            model, opt, make_loss_fn(model, Task(None)), mesh, opt.grad_clip)
        return run(chunks)

    # (a) data parallelism: rank d takes the d-th of the two batches
    qm9 = synthetic_molecules(TRAIN_MOLS, seed=1, min_atoms=12,
                              max_atoms=29).graph_dicts(range(2 * TRAIN_CHUNK))
    mesh = make_mesh((2, 1))
    model = GotenModel(flagship_config(), head, "dense", seed=0)
    batch = make_chunks(qm9, TRAIN_CHUNK, "cuda")[mesh.index("data")]
    reset_counters()
    loss = parallel_step(model, mesh, [batch])
    torch.cuda.synchronize()
    out["dp"] = (loss, (cpu_state(model), cpu_grads(model)), (
        fused_gata.fused_gata_forward.launches,
        fused_gata.fused_gata_backward.launches))
    log(f"[dp rank {rank}] one step on its batch of {TRAIN_CHUNK}: loss "
        f"{loss:.6f}, GATA launches {out['dp'][2]}")

    # (b) ELL row sharding: the whole frame on both ranks, 352 rows each
    md22 = dataclasses.replace(flagship_config(), fused_htr=True)
    mesh = make_mesh((1, 2))
    frame = make_chunks(large_frames()[:1], 1, "cuda", layout="ell",
                        cutoff=md22.cutoff,
                        max_num_neighbors=md22.max_num_neighbors)
    model = set_edge_axis(GotenModel(md22, head, "ell", seed=0), "edge")
    names = [(fused_ell, "fused_ell_forward"), (fused_htr,
                                                "fused_htr_ell_forward"),
             (fused_ell, "fused_ell_backward"),
             (fused_htr, "fused_htr_ell_backward")]
    reset_counters()
    energy = {}

    def request():
        with torch.inference_mode():
            model.eval()
            energy["e"] = model(frame[0])["property"].cpu()

    served = capture_many(names[:2], request)
    stepped = capture_many(names[2:], lambda: energy.update(
        loss=parallel_step(model, mesh, frame)))
    counts = [getattr(m, n).launches for m, n in names]
    shapes = sorted({c[0][0].shape[0] for calls in (*served.values(),
                                                     *stepped.values())
                     for c in calls})
    out["ell"] = (energy["e"], energy["loss"],
                  (cpu_state(model), cpu_grads(model)), counts, shapes)
    log(f"[ELL row-sharded rank {rank}] N = {frame[0].num_nodes}, rows a "
        f"rank {shapes}; launches ELL message fwd/bwd {counts[0]}/"
        f"{counts[2]}, ELL HTR fwd/bwd {counts[1]}/{counts[3]}")

    # (c) edge partitioning: the edge list split between the two ranks
    cfg, _ = edge_flagship()
    batch = make_chunks(qm9[:TRAIN_CHUNK], TRAIN_CHUNK, "cuda",
                        layout="edge")[0]
    model = set_edge_axis(GotenModel(cfg, head, "edge", seed=0), "edge")
    loss = parallel_step(model, mesh, [shard_graph_batch(batch, mesh)])
    out["edge"] = (loss, (cpu_state(model), cpu_grads(model)))

    # rows 5-8 on rank 0's inputs while rank 1 waits at the barrier
    records = []
    if rank == 0:
        for (module, name), calls, what in zip(
                names, (served[names[0][1]], served[names[1][1]],
                        stepped[names[2][1]], stepped[names[3][1]]),
                ("request", "request", "step", "step")):
            kernel = getattr(module, name)
            short = {"fused_ell_forward": "fused_ell_fwd",
                     "fused_htr_ell_forward": "fused_htr_ell_fwd",
                     "fused_ell_backward": "fused_ell_bwd",
                     "fused_htr_ell_backward": "fused_htr_ell_bwd"}[name]
            plain = getattr(module, f"{name}_reference")
            bound = {"fused_ell_fwd": ell_fwd_bound_ms,
                     "fused_htr_ell_fwd": htr_ell_fwd_bound_ms,
                     "fused_ell_bwd": ell_bwd_bound_ms,
                     "fused_htr_ell_bwd": htr_ell_bwd_bound_ms}[short]
            replaces = {"fused_ell_fwd": "fused_ell.py:77",
                        "fused_ell_bwd": "fused_ell.py:256",
                        "fused_htr_ell_fwd": "fused_htr.py:339",
                        "fused_htr_ell_bwd": "fused_htr.py:383"}[short]
            rerun_bits(kernel, calls, f"{short} (row-sharded {what})")
            record = kernel_record(
                {"name": short, "route": "cuda",
                 "source": f"gotennet_tpu_torch/csrc/{short}.cu",
                 "replaces": f"gotennet_tpu/ops/pallas/{replaces}"},
                calls, kernel, plain, bound, card)
            record["launches"] = len(calls)
            records.append((record, what))
    psum(torch.zeros(1, device="cuda"), ("data", "edge"))
    out["records"] = records

    # (d) the command line under distributed, on phase 36's NPZ shards
    reads, saves, fits = [], [], []
    load = molecule3d.load_molecule3d
    save = checkpoint.save_checkpoint
    fit = Trainer.fit

    def spy_load(root, *a, **kw):
        ds = load(root, *a, **kw)
        reads.append((kw.get("host"), kw.get("n_hosts"), len(ds)))
        return ds

    def spy_save(path, *a, **kw):
        saves.append(pathlib.Path(path).name)
        return save(path, *a, **kw)

    def spy_fit(self, *a, **kw):
        state, history = fit(self, *a, **kw)
        params = {k for k, _ in self.model.named_parameters()}
        fits.append(({k: v.cpu() for k, v in state.items() if k in params},
                     history))
        return state, history

    with mock.patch.object(molecule3d, "load_molecule3d", spy_load), \
            mock.patch.object(checkpoint, "save_checkpoint", spy_save), \
            mock.patch.object(Trainer, "fit", spy_fit):
        t0 = time.perf_counter()
        cli.main(["train", "experiment=molecule3d",
                  f"datamodule.dataset_root={M3D_DIR / 'shards'}",
                  "trainer.max_epochs=1", "trainer.distributed=true",
                  "trainer.data_parallel=2",
                  f"workdir={work / 'molecule3d'}"])
        torch.cuda.synchronize()
    out["cli"] = (reads, saves, fits[0], time.perf_counter() - t0)
    log(f"[molecule3d distributed rank {rank}] read {reads}; checkpoints "
        f"written {saves}; {time.perf_counter() - t0:.2f} s")
    return out


def rank_nccl(work, rank, world) -> dict:
    """Phase 37's NCCL check at world size 1 (NCCL refuses two ranks on one
    card): the group through ``initialize_distributed`` with NCCL, an
    all-reduce, and one ``Trainer`` step with ``distributed=True`` against
    the same step with no mesh."""
    import torch.distributed as dist
    from gotennet_tpu_torch.data.dataset import (DenseLoader,
                                                 synthetic_molecules)
    from gotennet_tpu_torch.models.model import GotenModel
    from gotennet_tpu_torch.parallel import initialize_distributed
    from gotennet_tpu_torch.tasks.qm9 import QM9Task
    from gotennet_tpu_torch.train.trainer import Trainer, TrainerConfig

    info = initialize_distributed(f"file://{work / 'rdv_nccl'}", 1, 0,
                                  backend="nccl")
    x = torch.full((4,), 3.0, device="cuda")
    dist.all_reduce(x)
    task = QM9Task("U0", dataset_meta={"mean": 0.0, "std": 1.0})
    ds = synthetic_molecules(2 * TRAIN_CHUNK, seed=1, min_atoms=12,
                             max_atoms=29)
    states = []
    for distributed in (True, False):
        model = GotenModel(flagship_config(), task.build_head(), "dense",
                           seed=0)
        loader = DenseLoader(ds, TRAIN_CHUNK, bucket=True)
        tr = Trainer(model, task, TrainerConfig(
            lr=LR, max_epochs=1, distributed=distributed,
            workdir=str(work / f"nccl_{distributed}")))
        state, _ = tr.fit(model.state_dict(), loader, loader, max_steps=1)
        states.append(({k: v.cpu() for k, v in state.items()},
                       cpu_grads(model)))
    dist.destroy_process_group()
    return {"info": info, "all_reduce": x.cpu(), "states": states}


RANK_SCENARIOS = {"two": rank_two, "nccl": rank_nccl}


def rank_main(argv) -> int:
    """One rank of ``spawn_ranks``: joins the Gloo group of ``world``
    ranks on the card through ``file://<dir>/rdv`` (the NCCL scenario
    starts its own), runs the scenario, writes its output."""
    import datetime
    import traceback

    import torch.distributed as dist
    scenario, work, rank, world = (argv[0], pathlib.Path(argv[1]),
                                   int(argv[2]), int(argv[3]))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        if scenario != "nccl":
            dist.init_process_group(
                "gloo", init_method=f"file://{work / 'rdv'}",
                world_size=world, rank=rank,
                timeout=datetime.timedelta(seconds=RANK_TIMEOUT))
        out = RANK_SCENARIOS[scenario](work, rank, world)
        torch.save(out, work / f"out_{rank}.pt")
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


def parallel_phase(card, md22_cfg, head) -> list:
    """Phase 37: two ranks on the one card over Gloo (``rank_two``), each
    held against the one-process result (``parallel_references``); then
    NCCL at world size 1 (``rank_nccl``).  Gloo copies CUDA tensors through
    the host: these times are not multi-GPU numbers.  Returns rows 5-8's
    records on the row-sharded path."""
    refs = parallel_references(md22_cfg, head)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    outs = spawn_ranks("two", 2)
    log(f"[two ranks] phase 37 (a)-(d) on two Gloo ranks on the one card in "
        f"{time.perf_counter() - t0:.1f} s (host-staged collectives: not a "
        f"multi-GPU time) | {card}")
    # (a) data parallelism against one process's 2-batch accumulation
    for r, o in enumerate(outs):
        loss, state, launches = o["dp"]
        if launches != (N_LAYERS, N_LAYERS):
            raise AssertionError(f"dp rank {r}: GATA launches {launches}")
        hold_step(f"dp=2 rank {r} vs grad_accum=2", state, refs["dp"][1],
                  TOL_TRAIN)
        hold_states(f"dp=2 rank {r} vs grad_accum=2", state[0],
                    refs["dp"][1][0], TOL_TRAIN)
    if not all(torch.equal(outs[1]["dp"][1][0][k], outs[0]["dp"][1][0][k])
               for k in outs[0]["dp"][1][0]):
        raise AssertionError("dp=2: the ranks' parameters differ")
    # (b) ELL row sharding against one process's request and step
    n_rows = ELL_N // 2
    for r, o in enumerate(outs):
        energy, loss, state, counts, shapes = o["ell"]
        want = [N_LAYERS, N_LAYERS - 1, N_LAYERS, N_LAYERS - 1]
        if shapes != [n_rows] or counts != [2 * want[0], 2 * want[1],
                                             want[2], want[3]]:
            raise AssertionError(f"ELL rank {r}: rows {shapes}, launches "
                                 f"{counts}")
        err, rel = rel_err(energy, refs["ell_energy"])
        log(f"[ELL row-sharded rank {r}] energy vs one process: abs "
            f"{err:.3e} rel {rel:.3e} (tol {TOL_TRAIN:g}); loss {loss:.6f} "
            f"vs {refs['ell'][0]:.6f}")
        if rel > TOL_TRAIN:
            raise AssertionError("row-sharded energy disagrees")
        hold_step(f"ELL ep=2 rank {r} vs one process", state,
                  refs["ell"][1], TOL_TRAIN)
    # (c) edge partitioning against one process's step
    for r, o in enumerate(outs):
        hold_step(f"edge ep=2 rank {r} vs one process", o["edge"][1],
                  refs["edge"][1], TOL_EDGE)
    # (d) the command line under distributed
    per_rank = M3D_MOLS // 2
    for r, o in enumerate(outs):
        reads, saves, _, secs = o["cli"]
        if reads != [(r, 2, per_rank)]:
            raise AssertionError(f"molecule3d rank {r} read {reads}")
        if bool(saves) != (r == 0):
            raise AssertionError(f"molecule3d rank {r} wrote {saves}")
        log(f"[molecule3d distributed rank {r}] read shards {r * 2}-"
            f"{r * 2 + 1} ({per_rank} molecules); wrote {saves or 'nothing'};"
            f" cli train + test {secs:.2f} s (Gloo) | {card}")
    # (the head's standardisation buffers differ: each rank standardises by
    # its own shards' targets, as the JAX package's hosts do)
    s0, s1 = (o["cli"][2][0] for o in outs)
    if not s0 or not all(torch.equal(s0[k], s1[k]) for k in s0):
        raise AssertionError("molecule3d distributed: the ranks' final "
                             "parameters differ")
    for key in ("val_loss", "MeanAbsoluteError"):
        values = [o["cli"][2][1][-1][key] for o in outs]
        if values[0] != values[1] or not math.isfinite(values[0]):
            raise AssertionError(f"molecule3d distributed: {key} {values}")
    log("[molecule3d distributed] final parameters bit-identical on both "
        f"ranks; val_loss {outs[0]['cli'][2][1][-1]['val_loss']:.6f}")
    # NCCL at world size 1
    nccl = spawn_ranks("nccl", 1)[0]
    log(f"[nccl] {nccl['info']}; all-reduce of 3.0 at world size 1: "
        f"{nccl['all_reduce'].tolist()}")
    if nccl["info"]["backend"] != "nccl" or not torch.equal(
            nccl["all_reduce"], torch.full((4,), 3.0)):
        raise AssertionError("the NCCL group did not run")
    hold_step("distributed=True step vs no group", nccl["states"][0],
              nccl["states"][1], TOL_TRAIN)
    return outs[0]["records"]


def slice_phases(card, phase_done, md22_cfg) -> list:
    """Phases 35-37; returns their kernel records with their paths."""
    from gotennet_tpu_torch.tasks.qm9 import QM9Task
    head = QM9Task("U0", dataset_meta={"mean": 0.0, "std": 1.0}).build_head()
    pack_records = pack_phase(flagship_config(), head, card)
    phase_done("35 (packed dense batches: request and step)")
    molecule3d_phase(card)
    phase_done("36 (molecule3d through the command line: shards and SDF)")
    ell_records = parallel_phase(card, md22_cfg, head)
    phase_done("37 (two ranks on the card over Gloo; NCCL at world size 1)")
    return ([(pack_records[0], "QM9 packed request"),
             (pack_records[1], "QM9 packed step")]
            + [(r, f"ELL row-sharded {what} (rank 0 of 2, NR = 352)")
               for r, what in ell_records])


# ---- phases 38-40: scan_layers, the command line's last modes, the tools ----
# phase 39: phase 26's molecules for one epoch of the scanned model; the
# reference .ckpt files' test data (128 molecules); phase 40's sweeps
CLI_SCAN = [*CLI_QM9, "trainer.max_epochs=1",
            "model.representation.scan_layers=true"]
CLI_CKPT_DATA = ["experiment=qm9_u0", "datamodule.dataset=synthetic",
                 "datamodule.n_molecules=256", "datamodule.min_atoms=12",
                 "datamodule.max_atoms=29", "datamodule.train_size=64",
                 "datamodule.val_size=64", "datamodule.test_size=128"]
SWEEP_SMOKE = ["experiment=smoke", "trainer.max_epochs=1"]
# phase 40: profile_fn's device total against phase 4's busy time
TOL_PROFILE = 0.10


def flat_tree(tree) -> dict:
    """``{'a/b/c': array}`` of a nested dict of arrays (the NPZ keys)."""
    from gotennet_tpu_torch.train.checkpoint import _flatten_dict
    return dict(_flatten_dict(tree))


def scanned_twin(cfg, head, unrolled):
    """Phase 38: the model's stacked tree (the JAX package's form for
    ``scan_layers``), its round trips held exact, and the scanned model's
    state dict from it; returns ``(scanned config, state dict)``."""
    from gotennet_tpu_torch.utils.convert import (jax_params_from_state_dict,
                                                  state_dict_from_jax_params)
    from gotennet_tpu_torch.utils.params import (roll_layer_params,
                                                 unroll_layer_params)
    import numpy as np
    scfg = dataclasses.replace(cfg, scan_layers=True)
    tree = jax_params_from_state_dict(unrolled.state_dict(), scfg, "dense")
    layers = flat_tree(tree["params"]["representation"]["layers"])
    axes = {v.shape[0] for v in layers.values()}
    if axes != {N_LAYERS - 1} or "gata_0" in tree["params"]["representation"]:
        raise AssertionError(f"stacked tree: leading axes {axes}")
    back = roll_layer_params(unroll_layer_params(tree, N_LAYERS), N_LAYERS)
    a, b = flat_tree(tree), flat_tree(back)
    if a.keys() != b.keys() or not all(np.array_equal(a[k], b[k]) for k in a):
        raise AssertionError("stacked -> unrolled -> stacked is not exact")
    state = state_dict_from_jax_params(tree, scfg, head)
    want = unrolled.state_dict()
    bad = [k for k in want if not torch.equal(
        state[k].to(want[k].device, want[k].dtype), want[k])]
    log(f"[scan] stacked tree: {len(layers)} leaves under layers/, leading "
        f"axis {N_LAYERS - 1}; round trips exact; state dict from it equal "
        f"to the unrolled model's: {not bad}")
    if bad:
        raise AssertionError(f"state dict from the stacked tree differs: "
                             f"{bad[:3]}")
    return scfg, state


def same_representation(what, unrolled, scanned, chunks) -> None:
    """h and X of both models on ``chunks``, bit for bit."""
    with torch.inference_mode():
        for b in chunks:
            u, s = unrolled(b), scanned(b)
            for key in ("representation", "vector_representation"):
                if not torch.equal(u[key], s[key]):
                    raise AssertionError(f"{what}: {key} differs from the "
                                         "unrolled model's")
    log(f"[scan] {what}: h and X the same bits as the unrolled model's on "
        f"{len(chunks)} chunks")


def stacked_grads(model, chunks, scfg) -> dict:
    """The first step's parameter gradients, in the stacked form."""
    from gotennet_tpu_torch.tasks.base import Task
    from gotennet_tpu_torch.train.trainer import accum_grads, make_loss_fn
    from gotennet_tpu_torch.utils.convert import jax_params_from_state_dict
    model.train()
    accum_grads(model, make_loss_fn(model, Task(None)), chunks)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return flat_tree(jax_params_from_state_dict(grads, scfg, "dense"))


def scan_path(card, what, cfg, head, mols, step_mols, chunk, step_chunk,
              bucket, counters, expected) -> tuple:
    """Phase 38 on one model: the scanned twin of the unrolled model (seed
    0) serves ``mols`` in ``chunk``-graph chunks and takes one step on
    ``step_mols`` in ``step_chunk``-graph chunks through the entry points,
    with the launch counts of ``counters`` against ``expected`` ((request),
    (step)) and the unrolled model held beside it; returns the scanned
    request and the scanned step's forward and backward as callables."""
    import numpy as np
    from gotennet_tpu_torch.models.model import GotenModel
    from gotennet_tpu_torch.serve import Predictor
    from gotennet_tpu_torch.tasks.base import Task
    from gotennet_tpu_torch.train.optim import make_optimizer
    from gotennet_tpu_torch.train.trainer import (accum_grads, make_chunks,
                                                  make_loss_fn, train_step,
                                                  train_steps)

    unrolled = Predictor(cfg, head, seed=0, chunk=chunk, bucket=bucket)
    scfg, state = scanned_twin(cfg, head, unrolled.model)
    pred = Predictor(scfg, head, state, seed=1, chunk=chunk, bucket=bucket)
    # the main path: one request and one step of the scanned model
    reset_counters()
    got = pred.predict(mols)
    torch.cuda.synchronize()
    serve_n = tuple(c.launches for c in counters)
    rest = sum(c.launches for c in kernel_counters()) - sum(serve_n)
    reset_counters()
    losses = train_steps(scfg, head, step_mols, 1, chunk=step_chunk, lr=LR,
                         seed=1, state_dict=state, bucket=bucket)
    torch.cuda.synchronize()
    step_n = tuple(c.launches for c in counters)
    rest += sum(c.launches for c in kernel_counters()) - sum(step_n)
    log(f"[scan] {what}: request launches {serve_n} (expected "
        f"{expected[0]}), step launches {step_n} (expected {expected[1]}), "
        f"other kernels {rest}; step loss {losses[0]:.6f}")
    if (serve_n, step_n) != expected or rest:
        raise AssertionError(f"{what}: launches {serve_n}/{step_n}, "
                             f"expected {expected}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{what}: the loss is not finite")

    want = unrolled.predict(mols)
    err, rel = rel_err(torch.from_numpy(got), torch.from_numpy(want))
    log(f"[scan] {what}: {len(mols)} energies vs the unrolled model: max abs "
        f"err {err:.4e} (rel {rel:.3e}, tol {TOL_SERVE:g})")
    if (got.shape != want.shape or rel > TOL_SERVE
            or not np.isfinite(got).all()):
        raise AssertionError(f"{what}: energies disagree with the unrolled "
                             "model")
    chunks = [b.to("cuda") for _, b in pred.loader(pred._request(mols))
              .batches()]
    same_representation(f"{what} request", unrolled.model, pred.model, chunks)

    step_chunks = make_chunks(step_mols, step_chunk, "cuda", bucket=bucket)
    model_u = GotenModel(cfg, head, seed=0)
    model_s = GotenModel(scfg, head, seed=1)
    model_s.load_state_dict(state)
    g_u = stacked_grads(model_u, step_chunks, scfg)
    g_s = stacked_grads(model_s, step_chunks, scfg)
    errs = {k: rel_err(torch.as_tensor(g_s[k]), torch.as_tensor(g_u[k]))
            for k in g_u}
    worst = max(errs, key=lambda k: errs[k][1])
    log(f"[scan] {what}: first-step gradients in the stacked form, scanned "
        f"vs unrolled: {len(errs)} arrays, worst {worst} abs "
        f"{errs[worst][0]:.3e} rel {errs[worst][1]:.3e} (tol {TOL_TRAIN:g})")
    if g_s.keys() != g_u.keys() or errs[worst][1] > TOL_TRAIN:
        raise AssertionError(f"{what}: gradients disagree")

    # timing: the scanned request and step (the unrolled model's are phases
    # 4/6 and 10/11's in the same run)
    def serve(p):
        return lambda: p.predict(mols)

    req_ms, host_ms, _ = time_run(serve(pred), 1, 3)
    busy = profile(serve(pred), req_ms, f"{what} request", card)
    log(f"[time] {what} request: {req_ms:.3f} ms (CUDA events), "
        f"{host_ms:.3f} ms (host clock), busy {busy} ms | {card}")
    loss_fn = make_loss_fn(model_s, Task(None))
    opt = make_optimizer(model_s.parameters(), LR)

    def step():
        return train_step(model_s, opt, step_chunks, opt.grad_clip,
                          loss_fn=loss_fn)

    step_ms, host_ms, _ = time_run(step, 1, 3)
    busy = profile(step, step_ms, f"{what} step", card)
    log(f"[time] {what} step: {step_ms:.3f} ms (CUDA events), "
        f"{host_ms:.3f} ms (host clock), busy {busy} ms | {card}")
    return serve(pred), lambda: accum_grads(model_s, loss_fn, step_chunks)


def scan_phase(card, cfg, head) -> list:
    """Phase 38: ``scan_layers=True`` on the QM9 and MD22 models; returns
    the records of rows 1-4 on the scanned paths with their paths."""
    from gotennet_tpu_torch.data.dataset import synthetic_molecules
    from gotennet_tpu_torch.ops import fused_gata, fused_htr
    fwd, bwd = fused_gata.fused_gata_forward, fused_gata.fused_gata_backward
    hfwd, hbwd = fused_htr.fused_htr_forward, fused_htr.fused_htr_backward
    # the request of phase 4 (256 molecules) and the molecules of phase 6
    ds = synthetic_molecules(sum(REQUESTS), seed=0, min_atoms=12,
                             max_atoms=29)
    qm9 = ds.graph_dicts(range(len(ds)))[-REQUESTS[-1]:]
    train = synthetic_molecules(TRAIN_MOLS, seed=1, min_atoms=12,
                                max_atoms=29).graph_dicts(range(TRAIN_MOLS))
    n_q = math.ceil(len(qm9) / CHUNK) * N_LAYERS
    n_t = math.ceil(TRAIN_MOLS / TRAIN_CHUNK) * N_LAYERS
    qm9_runs = scan_path(card, "QM9 scanned", cfg, head, qm9, train, CHUNK,
                         TRAIN_CHUNK, True, (fwd, bwd),
                         ((n_q, 0), (n_t, n_t)))
    n_c = math.ceil(MD22_FRAMES / MD22_CHUNK)
    md22_cfg = dataclasses.replace(cfg, fused_htr=True)
    frames = md22_frames()
    md22_runs = scan_path(
        card, "MD22 scanned", md22_cfg, head, frames, frames, MD22_CHUNK,
        MD22_CHUNK, False, (fwd, bwd, hfwd, hbwd),
        ((n_c * N_LAYERS, 0, n_c * (N_LAYERS - 1), 0),
         (n_c * N_LAYERS,) * 2 + (n_c * (N_LAYERS - 1),) * 2))
    rows = [("fused_gata_fwd", fused_gata, "fused_gata_forward",
             fwd_bound_ms, "fused_gata.py:108", n_q, "QM9 scanned request",
             qm9_runs[0]),
            ("fused_gata_bwd", fused_gata, "fused_gata_backward",
             bwd_bound_ms, "fused_gata.py:350", n_t, "QM9 scanned step",
             qm9_runs[1]),
            ("fused_htr_fwd", fused_htr, "fused_htr_forward",
             htr_fwd_bound_ms, "fused_htr.py:79", n_c * (N_LAYERS - 1),
             "MD22 scanned request", md22_runs[0]),
            ("fused_htr_bwd", fused_htr, "fused_htr_backward",
             htr_bwd_bound_ms, "fused_htr.py:115", n_c * (N_LAYERS - 1),
             "MD22 scanned step", md22_runs[1])]
    records = []
    for name, module, fn, bound, replaces, n, path, run in rows:
        record = kernel_record(
            {"name": name, "route": "cuda",
             "source": f"gotennet_tpu_torch/csrc/{name}.cu",
             "replaces": f"gotennet_tpu/ops/pallas/{replaces}"},
            capture(module, fn, run), getattr(module, fn),
            getattr(module, fn + "_reference"), bound, card)
        record["launches"] = n
        records.append((record, path))
    return records


def write_reference_ckpt(path, seed):
    """A reference-form Lightning ``.ckpt`` of the flagship edge-layout
    model (float32, seeded): its state dict, and hyper-parameters in the
    reference's shape (a ``__target__``, a ``cutoff_fn``, the cutoff
    outside the representation, the QM9 label as an index: 7 is U0);
    returns the model."""
    from gotennet_tpu_torch.models.model import GotenModel
    cfg, head = edge_flagship()
    model = GotenModel(cfg, head, "edge", seed=seed)
    torch.save({"hyper_parameters": {
        "cutoff": cfg.cutoff, "task": "QM9", "label": 7,
        "representation": {
            "__target__": "gotennet.models.representation.gotennet."
                          "GotenNetWrapper",
            "cutoff_fn": {"_target_": "CosineCutoff"},
            "n_atom_basis": D, "n_interactions": N_LAYERS, "lmax": LMAX,
            "n_rbf": 64, "num_heads": H}},
        "state_dict": {k: v.cpu() for k, v in model.state_dict().items()}},
        path)
    return model


def cli_tools_phase(card, tmp) -> None:
    """Phase 39: ``cli train`` with ``scan_layers`` and its NPZ, then
    reference ``.ckpt`` files through ``cli test``, ``cli parity`` and an
    alias from a ``CHECKPOINT_PATH`` cache, all under ``tmp``."""
    import os
    import numpy as np
    from gotennet_tpu_torch import cli
    from gotennet_tpu_torch.ops import fused_gata
    from gotennet_tpu_torch.train.checkpoint import save_checkpoint

    # the scanned QM9 model through cli train and cli test
    fwd, bwd = fused_gata.fused_gata_forward, fused_gata.fused_gata_backward
    reset_counters()
    run = tmp / "scan_run"
    t0 = time.perf_counter()
    cli.main(["train", *CLI_SCAN, f"workdir={run}"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # 32 training batches, one validation and one test batch
    expected = ((32 + 1 + 1) * N_LAYERS, 32 * N_LAYERS)
    launches = (fwd.launches, bwd.launches)
    epoch = epoch_record(run, 0)
    log(f"[scan cli] cli train, scan_layers: {wall:.2f} s on the wall, epoch "
        f"{epoch['epoch_time_s']:.3f} s; launches forward/backward {launches}"
        f" (expected {expected}) | {card}")
    if launches != expected:
        raise AssertionError(f"scanned cli train: launches {launches}")
    with np.load(run / "ckpt_best" / "params.npz") as f:
        kernel = f["params/representation/layers/gata/W_q/linear/kernel"]
        unrolled = [k for k in f.files if "/gata_0/" in k]
    log(f"[scan cli] ckpt_best: layers/gata/W_q kernel {kernel.shape}, "
        f"{len(unrolled)} gata_0 arrays")
    if kernel.shape != (N_LAYERS - 1, D, D) or unrolled:
        raise AssertionError("the scanned checkpoint is not in the stacked "
                             "form")
    results = json.loads((run / "test_results.json").read_text())
    cli.main(["test", f"checkpoint={run / 'ckpt_best'}", *CLI_SCAN,
              f"workdir={tmp / 'scan_test'}"])
    hold_results("scan cli test", json.loads(
        (tmp / "scan_test" / "test_results.json").read_text()), results,
        TOL_CLI_TEST)

    # reference .ckpt files: cli test against the same weights' NPZ
    # checkpoint, parity over two, an alias from the cache
    paths = [tmp / "a.ckpt", tmp / "b.ckpt"]
    model = write_reference_ckpt(paths[0], seed=0)
    write_reference_ckpt(paths[1], seed=1)
    save_checkpoint(str(tmp / "npz"), model,
                    extra_meta={"task": "QM9", "label": "U0"})
    got = {}
    for name, ck in (("ckpt", paths[0]), ("npz", tmp / "npz")):
        t0 = time.perf_counter()
        cli.main(["test", f"checkpoint={ck}", *CLI_CKPT_DATA,
                  f"workdir={tmp / ('test_' + name)}"])
        log(f"[time] cli test of the {name} checkpoint: "
            f"{time.perf_counter() - t0:.2f} s on the wall | {card}")
        got[name] = json.loads((tmp / ("test_" + name) /
                                "test_results.json").read_text())
    hold_results("reference .ckpt cli test vs its NPZ", got["ckpt"],
                 got["npz"], TOL_CLI_TEST)
    out = tmp / "parity.md"
    cli.main(["parity", f"checkpoints={paths[0]},{paths[1]}", f"out={out}",
              *CLI_CKPT_DATA, f"workdir={tmp / 'parity'}"])
    rows = [ln for ln in out.read_text().splitlines()
            if ln.startswith("| ") and ".ckpt" in ln]
    log(f"[parity] {len(rows)} rows: {rows}")
    if len(rows) != 2:
        raise AssertionError(f"parity wrote {len(rows)} rows")
    cache = tmp / "cache"
    cache.mkdir()
    shutil.copy(paths[0], cache / "QM9_small_U0.ckpt")
    with mock.patch.dict(os.environ, {"CHECKPOINT_PATH": str(cache)}):
        cli.main(["test", "checkpoint=QM9_small_U0", *CLI_CKPT_DATA,
                  f"workdir={tmp / 'alias'}"])
    hold_results("alias QM9_small_U0 from the cache", json.loads(
        (tmp / "alias" / "test_results.json").read_text()), got["ckpt"],
        TOL_CLI_TEST)


def tools_phase(card, tmp, pred, big, busy_ms) -> None:
    """Phase 40: ``cli sweep`` (grid and adaptive), ``profile_fn`` of phase
    4's request against its busy time, ``multichip_bench`` at world size 1,
    ``radius_graph`` on the card against the CPU."""
    from gotennet_tpu_torch import cli
    from gotennet_tpu_torch.data.dataset import synthetic_molecules
    from gotennet_tpu_torch.graph.neighborlist import radius_graph
    from gotennet_tpu_torch.utils.bench_multichip import multichip_bench
    from gotennet_tpu_torch.utils.profiling import profile_fn

    for name, ovs, n in (("grid", ["model.lr=1e-4,2e-4"], 2),
                         ("adaptive", ["sampler=adaptive", "n_trials=3",
                                       "model.lr=loguniform(1e-5,1e-3)"], 3)):
        sweep_dir = tmp / f"sweep_{name}"
        t0 = time.perf_counter()
        cli.main(["sweep", *SWEEP_SMOKE, *ovs, f"sweep_dir={sweep_dir}"])
        recs = read_jsonl(sweep_dir / "sweep.jsonl")
        log(f"[sweep] {name}: {len(recs) - 1} trials in "
            f"{time.perf_counter() - t0:.2f} s, metrics "
            f"{[r.get('metric') for r in recs[:-1]]}; last record {recs[-1]}"
            f" | {card}")
        if (len(recs) != n + 1 or "best_overrides" not in recs[-1]
                or any("error" in r for r in recs)):
            raise AssertionError(f"{name} sweep: {recs}")

    if busy_ms is None:
        raise AssertionError("phase 4's busy time was not measured")
    pred.predict(big)
    summary = profile_fn(lambda: pred.predict(big), top_k=5)
    total = summary["total_us"] / 1e3
    log(f"[profile_fn] phase 4's request: device total {total:.3f} ms against"
        f" phase 4's busy {busy_ms:.3f} ms (tol {TOL_PROFILE:.0%}); top ops "
        f"{[(o['name'][:40], round(o['us'], 1)) for o in summary['top_ops']]}"
        f" | {card}")
    if abs(total - busy_ms) > TOL_PROFILE * busy_ms:
        raise AssertionError("profile_fn's device total is off phase 4's")

    records = multichip_bench()
    for r in records:
        log(f"[multichip] {json.dumps(r)} | {card}")
    if [r["mode"] for r in records] != ["dense_dp", "edge_ep", "ell_rows"] \
            or any(r["n_devices"] != 1 for r in records):
        raise AssertionError(f"multichip_bench: {records}")

    import numpy as np
    ds = synthetic_molecules(16, seed=3, min_atoms=12, max_atoms=29)
    pos = np.concatenate([np.asarray(p, np.float32) for p in ds.pos]
                         + [np.zeros((8, 3), np.float32)])
    graph = np.concatenate([np.full(len(p), g, np.int32)
                            for g, p in enumerate(ds.pos)]
                           + [np.zeros(8, np.int32)])
    mask = np.arange(len(pos)) < len(pos) - 8
    args = [torch.from_numpy(a) for a in (pos, graph, mask)]
    for loop in (True, False):
        got = radius_graph(*[a.cuda() for a in args], 5.0, 32, loop)
        want = radius_graph(*args, 5.0, 32, loop)
        same = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
        log(f"[radius_graph] {len(pos)} nodes, loop={loop}, on "
            f"{got[0].device}: {int(want[2].sum())} real edges of "
            f"{want[2].numel()} slots, the same arrays as the CPU's: {same}")
        if not same:
            raise AssertionError("radius_graph differs on the card")


def last_phases(card, phase_done, pred, big, busy_ms) -> list:
    """Phases 38-40; returns phase 38's kernel records with their paths."""
    import tempfile
    from gotennet_tpu_torch.tasks.qm9 import QM9Task
    head = QM9Task("U0", dataset_meta={"mean": 0.0, "std": 1.0}).build_head()
    records = scan_phase(card, flagship_config(), head)
    phase_done("38 (scan_layers on the kernels: QM9 and MD22)")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        for sub in ("cli", "tools"):
            (pathlib.Path(d) / sub).mkdir()
        cli_tools_phase(card, pathlib.Path(d) / "cli")
        phase_done("39 (scan_layers, .ckpt files, parity and an alias "
                   "through the command line)")
        tools_phase(card, pathlib.Path(d) / "tools", pred, big, busy_ms)
        phase_done("40 (sweeps, profile_fn, multichip_bench, radius_graph)")
    return records


def main() -> int:
    if sys.argv[1:2] == ["--rank"]:
        return rank_main(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from gotennet_tpu_torch.data.dataset import DenseLoader, MoleculeDataset
    from gotennet_tpu_torch.data.dataset import synthetic_molecules
    from gotennet_tpu_torch.graph import native
    from gotennet_tpu_torch.ops import _build, fused_gata
    from gotennet_tpu_torch.serve import Predictor
    from gotennet_tpu_torch.tasks.qm9 import QM9Task

    bf16, f32 = torch.bfloat16, torch.float32
    kernel, plain = (fused_gata.fused_gata_forward,
                     fused_gata.fused_gata_forward_reference)

    start = time.time()

    def phase_done(name) -> None:
        log(f"[phase] {name} done at {time.time() - start:.1f} s")

    # ---- 1. device and build -------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind} | nvidia-smi: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    # the host neighbour list (g++) builds beside the kernels (nvcc)
    host_build = {}

    def build_host() -> None:
        t = time.time()
        host_build["path"] = native.build_library()
        host_build["s"] = time.time() - t

    thread = threading.Thread(target=build_host)
    t0 = time.time()
    thread.start()
    _build.build_all()
    thread.join()
    if "path" not in host_build:
        raise RuntimeError("the host neighbour list did not build")
    log(f"[build] {len(_build.SOURCES)} CUDA source(s) with nvcc and "
        f"{native.SOURCE.name} with g++ in {time.time() - t0:.1f} s "
        f"({native.SOURCE.name} alone {host_build['s']:.1f} s)")
    for src in _build.SOURCES:
        for line in _build.build_log(src).splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[ptxas] {src}: {line.strip()}")
    phase_done("1 (device and build)")
    # ---- 2. kernel vs plain at flagship shapes ---------------------------
    for M in (16, 24, 32):
        for pd in (f32, bf16):
            for head_scale in (False, True):
                check_gata_forward(M, pd, head_scale, G)
    phase_done("2 (GATA forward vs plain)")

    # ---- 3. serving path at full width -----------------------------------
    # remat off, as bench.py runs the fused paths (a layer recomputed in
    # the backward pass would launch its forward kernels twice)
    cfg = flagship_config()
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
    phase_done("3 (QM9 serving)")

    # ---- 4. timing ---------------------------------------------------------
    big = requests[-1]
    ds_big = MoleculeDataset(z=[m["z"] for m in big],
                             pos=[m["pos"] for m in big])
    real_edges, padded_pairs = count_pairs(
        [b.to("cuda") for b in DenseLoader(
            ds_big, batch_size=CHUNK, bucket=True,
            bucket_window=math.ceil(len(big) / CHUNK))], cfg)
    req_ms, host_ms, _ = time_run(lambda: pred.predict(big), 2, 5)
    log(f"[time] 256-molecule request: {req_ms:.3f} ms (CUDA events), "
        f"{host_ms:.3f} ms (host clock); real edges {real_edges} "
        f"(self-loops included), padded pairs {padded_pairs}; "
        f"{real_edges / (req_ms / 1e3):.1f} real edges/s | {card}")

    busy4 = profile(lambda: pred.predict(big), req_ms,
                    f"{len(big)}-molecule request", card)
    # the kernel on the inputs the 256-molecule request gave it
    captured = capture(fused_gata, "fused_gata_forward",
                       lambda: pred.predict(big))
    record = kernel_record(
        {"name": "fused_gata_fwd", "route": "cuda",
         "source": "gotennet_tpu_torch/csrc/fused_gata_fwd.cu",
         "replaces": "gotennet_tpu/ops/pallas/fused_gata.py:108"},
        captured, kernel, plain, fwd_bound_ms, card)
    record["launches"] = launches
    KERNEL_MS["fused_gata_fwd, QM9 request"] = record["ms"]
    qm9_shapes = [tuple(c[0][0].shape) for c in captured]
    phase_done("4 (QM9 timing)")

    # ---- 5. backward kernel vs plain at the training shapes --------------
    for M in (16, 24, 32):
        for pd in (f32, bf16):
            for head_scale in (False, True):
                check_gata_backward(M, pd, head_scale, TRAIN_CHUNK)
    phase_done("5 (GATA backward vs plain)")

    # ---- 6. training at full width ----------------------------------------
    bwd_record = train_phase(cfg, head, card)
    phase_done("6 (QM9 training)")

    # ---- 7.-8. HTR kernels vs plain ----------------------------------------
    check_htr_forward()
    phase_done("7 (HTR forward vs plain)")
    check_htr_backward()
    phase_done("8 (HTR backward vs plain)")

    # ---- 9. GATA kernels at the MD22 chunk's M ---------------------------
    for M in (112, 120):
        for pd in (f32, bf16):
            check_gata_forward(M, pd, False, MD22_CHUNK)
            check_gata_backward(M, pd, False, MD22_CHUNK)
    phase_done("9 (GATA kernels at M = 112/120)")

    # ---- 10.-11. MD22 serving and training at full width -----------------
    md22_cfg = dataclasses.replace(cfg, fused_htr=True)
    htr_record = md22_serve_phase(md22_cfg, head, card)
    phase_done("10 (MD22 serving)")
    htr_bwd_record = md22_train_phase(md22_cfg, head, card)
    phase_done("11 (MD22 training)")

    # ---- 12.-14. the ELL layout: both kernels, then 600-700-atom serving --
    check_ell_message()
    phase_done("12 (ELL message vs plain)")
    check_htr_ell()
    phase_done("13 (ELL HTR vs plain)")
    ell_records = ell_serve_phase(md22_cfg, head, card, large_frames(),
                                  "ELL request")
    phase_done("14 (ELL serving)")

    # ---- 15.-17. ELL training: both backward kernels, then one step -------
    check_ell_message_backward()
    phase_done("15 (ELL message backward vs plain)")
    check_htr_ell_backward()
    phase_done("16 (ELL HTR backward vs plain)")
    ell_bwd_records = ell_train_phase(md22_cfg, head, card, large_frames(),
                                      "ELL step")
    phase_done("17 (ELL training)")

    # ---- 18.-20. forces: the GATA backward's position half, then serving --
    for M, g in ((16, TRAIN_CHUNK), (24, TRAIN_CHUNK), (32, TRAIN_CHUNK),
                 (112, MD22_CHUNK), (120, MD22_CHUNK)):
        for pd in (f32, bf16):
            for head_scale in (False, True):
                check_gata_backward(M, pd, head_scale, g, pos_grads=True)
    phase_done("18 (GATA backward with position cotangents vs plain)")
    pos_record = md22_force_phase(md22_cfg, card)
    phase_done("19 (MD22 forces)")
    ell_force_phase(md22_cfg, card)
    phase_done("20 (ELL forces)")
    products_phase(card)
    yardsticks(card, qm9_shapes)
    phase_done("21 (the backward product alone; the yardsticks)")

    # ---- 22.-25. the xl mode and the large_molecule model ------------------
    native_phase(card)
    phase_done("22 (the native neighbour list vs numpy)")
    xl_records = ell_serve_phase(md22_cfg, head, card, xl_frames(),
                                 "xl request")
    phase_done("23 (xl serving)")
    xl_bwd_records = ell_train_phase(md22_cfg, head, card, xl_frames(),
                                     "xl step")
    phase_done("24 (xl training)")
    lm_cfg = dataclasses.replace(md22_cfg, fused_htr=False)
    ell_serve_phase(lm_cfg, head, card, large_frames(),
                    "large_molecule request", kernels=False)
    ell_train_phase(lm_cfg, head, card, large_frames(), "large_molecule step",
                    kernels=False)
    phase_done("25 (the large_molecule model: fused message, unfused "
               "update)")

    # ---- 26.-27. the command line's train and test --------------------------
    qm9_records, large_records = cli_phases(card, phase_done)
    # ---- 28.-30. the QM9 heads, the unfused dense message, force training --
    label_records = new_phases(card, phase_done, md22_cfg)
    # ---- 31.-34. the edge-list layout and the remaining model options ------
    option_records = edge_phases(card, phase_done)
    # ---- 35.-37. packed batches, Molecule3D, two ranks on the card ---------
    slice_records = slice_phases(card, phase_done, md22_cfg)
    # ---- 38.-40. scan_layers, .ckpt files, sweep and parity, the tools -----
    last_records = last_phases(card, phase_done, pred, big, busy4)
    paths = [(record, "QM9 request"), (bwd_record, "QM9 step"),
             (htr_record, "MD22 request"), (htr_bwd_record, "MD22 step"),
             (ell_records[0], "ELL request"), (ell_bwd_records[0], "ELL step"),
             (ell_records[1], "ELL request"), (ell_bwd_records[1], "ELL step"),
             (pos_record, "MD22 force request"),
             (xl_records[0], "xl request"), (xl_bwd_records[0], "xl step"),
             (xl_records[1], "xl request"), (xl_bwd_records[1], "xl step"),
             (qm9_records[0], "QM9 cli train and test"),
             (qm9_records[1], "QM9 cli train"),
             (large_records[0], "large_molecule cli train and test"),
             (large_records[1], "large_molecule cli train"),
             (label_records[0], "QM9 mu cli train and test"),
             (label_records[1], "QM9 mu cli train"),
             (label_records[2], "QM9 r2 cli train and test"),
             (label_records[3], "QM9 r2 cli train"),
             (option_records[0], "MD22 options request, dense"),
             (option_records[1], "MD22 options request, ELL"),
             *slice_records, *last_records]
    log(json.dumps({"kernels": [{**r, "path": p} for r, p in paths]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
