"""GotenNet in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The PyTorch counterpart of ``gotennet_tpu``: same configuration names,
same parameter names (the reference state-dict keys), same batch
layouts.  This package imports torch and numpy only; the JAX package is
its reference in the tests and is never imported here.

What is ported: the edge-list layout (the JAX package's default), the
dense layout (QM9- and MD22-sized molecules, bucketed or packed several to
a slab) and the ELL layout (600-4,200-atom frames), the dense and ELL ones
through the fused GATA and HTR kernels under ``ops/``; serving, training
on energies and on forces, every model option but ``scan_layers``, the
``Trainer`` and checkpoints in the JAX package's NPZ form, the QM9, MD17,
MD22 and Molecule3D readers, the composed config tree, and more than one
device over ``torch.distributed`` (``parallel/``: data parallelism, edge
partitioning, ELL row sharding; one process per device).  Entry points:
``serve.py`` (``Predictor``), ``train/trainer.py`` (``Trainer``,
``train_steps``) and ``cli.py`` (``python -m gotennet_tpu_torch.cli train
experiment=...`` / ``test checkpoint=...``).  They run on ``cuda`` unless
the caller passes ``device="cpu"`` (``device=cpu`` on the command line).
"""
