"""GotenNet in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The PyTorch counterpart of ``gotennet_tpu``: same configuration names,
same parameter names (the reference state-dict keys), same batch
layouts.  This package imports torch and numpy only; the JAX package is
its reference in the tests and is never imported here.

What is ported so far: serving in the dense layout (QM9- and MD22-sized
molecules) and in the ELL layout (600-700-atom frames), and the
energy-only training step in the dense layout, through the fused GATA
and HTR kernels under ``ops/``; see ``serve.py`` and ``train/trainer.py``
for the entry points.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""
