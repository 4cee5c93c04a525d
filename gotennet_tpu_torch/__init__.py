"""GotenNet in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The PyTorch counterpart of ``gotennet_tpu``: same configuration names,
same parameter names (the reference state-dict keys), same dense-block
layout.  This package imports torch and numpy only; the JAX package is
its reference in the tests and is never imported here.

What is ported so far is QM9-sized inference in the dense layout with
the fused GATA message kernel (``ops/fused_gata.py``); see ``serve.py``
for the entry point.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""

