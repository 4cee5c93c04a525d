#!/usr/bin/env python3
"""Time every kernel of the port's main paths against another version of
its CUDA sources, on one NVIDIA GPU, inside one process.

    python3 compare_kernels.py OTHER_CSRC [--ell]   # from the repository root

OTHER_CSRC is the ``csrc/`` directory of another version of
``gotennet_tpu_torch`` (for instance the parent commit, unpacked with
``git archive`` under ``build/``).  Its sources must keep this version's C
entry points (a GATA or ELL forward without the workspace argument is
called through ``OldForward``): only the kernels change, the Python
wrappers stay this tree's.  Both versions are built with nvcc into
``build/`` (the library names carry the sources' hash).  The main paths run
once with this tree's kernels while their kernel calls are recorded: the
256-molecule QM9 request and the QM9 training step (M 16/24/32), the
32-frame MD22 request and step (M = 120), the MD22 force request, the
8-frame ELL request and step.  Then every kernel is timed on each path's
recorded inputs (CUDA events, mean ms per launch, grouped by the shape of
t) with the other version's libraries and this tree's, in turns: other,
this, this, other; and the device-busy time of the 256-molecule QM9
request, the 32-frame MD22 request, the MD22 step, the MD22 force request,
the 8-frame ELL request, the ELL step and the ELL force request
(``torch.profiler``) is read with each, in the same turns.  Every line
carries the card's name and power limit.  With ``--ell`` only the ELL
paths run (the request, the step and the force request: rows 5-8).  No
result is checked here: ``chip_smoke.py`` holds each kernel against its
plain version.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import sys
from pathlib import Path
from unittest import mock

import torch

import chip_smoke as cs


def libraries(csrc=None) -> dict:
    """{source: loaded library} of every kernel source, from ``csrc`` (this
    tree's own when None), built as the port builds its kernels."""
    from gotennet_tpu_torch.ops import _build
    own = _build.CSRC
    if csrc is not None:
        _build.CSRC = Path(csrc).resolve()
    try:
        paths = _build.build_all()
    finally:
        _build.CSRC = own
    libs = {}
    for src, path in zip(_build.SOURCES, paths):
        lib = ctypes.CDLL(str(path))
        old = OLD_FORWARDS.get(src)
        if old and not hasattr(lib, f"{old[0]}_workspace"):
            libs[src] = OldForward(lib, *old)
            continue
        _build._declare(lib, src)
        libs[src] = lib
    return libs


# A forward library from before its C entry point took a workspace (the bf16
# weights, and for the ELL forward the bf16 node tables): (entry point,
# pointers before the workspace argument, integers after it)
OLD_FORWARDS = {"fused_gata_fwd.cu": ("gotennet_fused_gata_fwd", 16, 11),
                "fused_ell_fwd.cu": ("gotennet_fused_ell_fwd", 17, 12)}


class OldForward:
    """Calls a forward library from before its C entry point took a
    workspace through the new signature: this tree's wrapper asks for no
    workspace bytes, and the workspace argument is dropped."""

    def __init__(self, lib, name, n_ptr, n_int):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * n_ptr + [i32] * n_int + [ptr]
        fn.restype = i32
        lib.gotennet_cuda_error_string.argtypes = [i32]
        lib.gotennet_cuda_error_string.restype = ctypes.c_char_p
        self.gotennet_cuda_error_string = lib.gotennet_cuda_error_string
        setattr(self, name, lambda *a: fn(*a[:n_ptr], *a[n_ptr + 1:]))
        setattr(self, f"{name}_workspace", lambda *_: 0)


def busy_ms(run) -> float:
    """Device time of ``run()`` (after one warm-up run), in ms."""
    run()
    return sum(e.self_device_time_total for e in cs.device_ops(run)) / 1e3


def main(argv) -> int:
    ell_only = argv[2:] == ["--ell"]
    if len(argv) - ell_only != 2 or not torch.cuda.is_available():
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from gotennet_tpu_torch.data.dataset import synthetic_molecules
    from gotennet_tpu_torch.models.gotennet import GotenNetConfig
    from gotennet_tpu_torch.models.model import GotenModel
    from gotennet_tpu_torch.ops import _build, fused_ell, fused_gata, fused_htr
    from gotennet_tpu_torch.serve import Predictor
    from gotennet_tpu_torch.tasks.base import Task
    from gotennet_tpu_torch.tasks.qm9 import QM9Task
    from gotennet_tpu_torch.train.optim import make_optimizer
    from gotennet_tpu_torch.train.trainer import (accum_grads, make_chunks,
                                                  make_loss_fn, train_step)

    card = cs.card_line()
    versions = {"other": libraries(argv[1]), "this": libraries()}
    cs.log(f"[compare] {torch.cuda.get_device_name(0)} | {card}; other "
           f"sources: {argv[1]}")

    def use(version) -> None:
        _build._libs.update(versions[version])

    use("this")
    bf16 = torch.bfloat16
    cfg = GotenNetConfig(n_atom_basis=cs.D, n_interactions=cs.N_LAYERS,
                         lmax=cs.LMAX, n_rbf=64, num_heads=cs.H,
                         pair_dtype=bf16, node_dtype=bf16, merge_proj=True)
    big_cfg = dataclasses.replace(cfg, fused_htr=True)
    head = QM9Task("U0", dataset_meta={"mean": 0.0, "std": 1.0}).build_head()

    def step_of(model, chunks):
        loss_fn = make_loss_fn(model, Task(None))
        model.train()
        opt = make_optimizer(model.parameters(), cs.LR)
        return (lambda: accum_grads(model, loss_fn, chunks),
                lambda: train_step(model, opt, chunks, opt.grad_clip,
                                   loss_fn=loss_fn))

    kernels = [(fused_gata, "fused_gata_forward", "row 1"),
               (fused_gata, "fused_gata_backward", "row 2"),
               (fused_htr, "fused_htr_forward", "row 3"),
               (fused_htr, "fused_htr_backward", "row 4"),
               (fused_ell, "fused_ell_forward", "row 5"),
               (fused_ell, "fused_ell_backward", "row 6"),
               (fused_htr, "fused_htr_ell_forward", "row 7"),
               (fused_htr, "fused_htr_ell_backward", "row 8")]
    paths, busy = [], []

    def record(what, run, names=None) -> None:
        """Every call of the kernels (those of ``names`` only, when given)
        during one run of the path ``what``."""
        calls = {}
        with contextlib.ExitStack() as stack:
            for module, name, _ in kernels:
                if names is None or name in names:
                    kernel = getattr(module, name)

                    def rec(*a, _n=name, _k=kernel, **kw):
                        calls.setdefault(_n, []).append((a, kw))
                        return _k(*a, **kw)

                    stack.enter_context(mock.patch.object(module, name, rec))
            run()
            torch.cuda.synchronize()
        for module, name, row in kernels:
            if name in calls:
                paths.append((f"{row} {name}, {what}", getattr(module, name),
                              calls[name]))

    if not ell_only:
        qm9 = synthetic_molecules(
            cs.TRAIN_MOLS, seed=1, min_atoms=12,
            max_atoms=29).graph_dicts(range(cs.TRAIN_MOLS))
        qm9_pred = Predictor(cfg, head, seed=0, chunk=cs.CHUNK)
        record("QM9 request", lambda: qm9_pred.predict(qm9))
        busy.append(("QM9 request", lambda: qm9_pred.predict(qm9)))
        grads, _ = step_of(GotenModel(cfg, head, seed=0),
                           make_chunks(qm9, cs.TRAIN_CHUNK, "cuda"))
        record("QM9 step", grads)

        md22 = cs.md22_frames()
        md22_pred = Predictor(big_cfg, head, seed=0, chunk=cs.MD22_CHUNK,
                              bucket=False)
        record("MD22 request", lambda: md22_pred.predict(md22))
        busy.append(("MD22 request", lambda: md22_pred.predict(md22)))
        grads, step = step_of(GotenModel(big_cfg, head, seed=0),
                              cs.md22_chunks(md22))
        record("MD22 step", grads)
        busy.append(("MD22 step", step))
        force = Predictor(big_cfg, cs.force_head(), seed=0,
                          chunk=cs.MD22_CHUNK, bucket=False)
        record("MD22 force request (pos_grads)",
               lambda: force.predict_with_forces(md22),
               ("fused_gata_backward",))
        busy.append(("MD22 force request",
                     lambda: force.predict_with_forces(md22)))

    large = cs.large_frames()
    pred = Predictor(big_cfg, head, seed=0, chunk=1, layout="ell",
                     spatial_sort=True, block_rows=64)
    record("ELL request", lambda: pred.predict(large))
    busy.append(("ELL request", lambda: pred.predict(large)))
    ell_chunks = make_chunks(large, 1, "cuda", layout="ell",
                             cutoff=big_cfg.cutoff,
                             max_num_neighbors=big_cfg.max_num_neighbors)
    grads, step = step_of(GotenModel(big_cfg, head, "ell", seed=0),
                          ell_chunks)
    record("ELL step", grads)
    busy.append(("ELL step", step))
    ell_force = Predictor(big_cfg, cs.force_head(), seed=0, chunk=1,
                          layout="ell", spatial_sort=True, block_rows=64)
    busy.append(("ELL force request",
                 lambda: ell_force.predict_with_forces(large)))

    order = ("other", "this", "this", "other")
    for what, kernel, calls in paths:
        by_shape = {}
        for c in calls:
            by_shape.setdefault(tuple(c[0][0].shape), []).append(c)
        for shape in sorted(by_shape):
            group = by_shape[shape]
            times = []
            for version in order:
                use(version)
                # inputs recorded while serving are inference tensors
                with torch.inference_mode():
                    times.append(cs.time_calls(
                        lambda c: kernel(*c[0], **c[1]), group, 3))
            other = (times[0] + times[3]) / 2
            this = (times[1] + times[2]) / 2
            cs.log(f"[compare] {what} t{list(shape)}: {len(group)} launches;"
                   f" ms a launch other/this/this/other "
                   + "/".join(f"{t:.4f}" for t in times)
                   + f"; this / other {this / other:.4f} | {card}")
    for what, run in busy:
        ms = []
        for version in order:
            use(version)
            ms.append(busy_ms(run))
        cs.log(f"[compare] {what}: device busy ms other/this/this/other "
               + "/".join(f"{t:.3f}" for t in ms)
               + f"; this / other {(ms[1] + ms[2]) / (ms[0] + ms[3]):.4f} | "
               f"{card}")
    use("this")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
