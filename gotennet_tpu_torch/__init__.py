"""GotenNet in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The PyTorch counterpart of ``gotennet_tpu``: same configuration names,
same parameter names (the reference state-dict keys), same batch
layouts.  This package imports torch and numpy only; the JAX package is
its reference in the tests and is never imported here.

What is ported so far: serving and energy-only training in the dense
layout (QM9- and MD22-sized molecules) and in the ELL layout (600-4,200-atom
frames), through the fused GATA and HTR kernels under ``ops/``, with
attention dropout and remat; the ``Trainer``, checkpoints in the JAX
package's NPZ form, the QM9 reader and the composed config tree.  Entry
points: ``serve.py`` (``Predictor``), ``train/trainer.py`` (``Trainer``,
``train_steps``) and ``cli.py`` (``python -m gotennet_tpu_torch.cli train
experiment=...`` / ``test checkpoint=...``).  They run on ``cuda`` unless
the caller passes ``device="cpu"`` (``device=cpu`` on the command line).
"""
