"""GotenNet in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The PyTorch counterpart of ``gotennet_tpu``: same configuration names,
same parameter names (the reference state-dict keys), same batch
layouts.  This package imports torch and numpy only; the JAX package is
its reference in the tests and is never imported here.

It does what the JAX package does: the edge-list layout (the JAX
package's default), the dense layout (QM9- and MD22-sized molecules,
bucketed or packed several to a slab) and the ELL layout (600-4,200-atom
frames), the dense and ELL ones through the fused GATA and HTR kernels under
``ops/``; serving, training on energies and on forces, every model option
(``scan_layers`` included), the ``Trainer`` and checkpoints in the JAX
package's NPZ form, reference Lightning ``.ckpt`` files, the QM9, MD17,
MD22 and Molecule3D readers, the composed config tree, more than one
device over ``torch.distributed`` (``parallel/``: data parallelism, edge
partitioning, ELL row sharding; one process per device), and the tools
(``utils/``: sweeps, the checkpoint hub, profiling, the multi-device
bench).  Entry points: ``serve.py`` (``Predictor``), ``train/trainer.py``
(``Trainer``, ``train_steps``) and ``cli.py`` (``python -m
gotennet_tpu_torch.cli train|test|sweep|parity ...``).  They run on
``cuda`` unless the caller passes ``device="cpu"`` (``device=cpu`` on the
command line).

``GraphBatch`` is imported here; ``GotenNet``, ``GATA`` and ``EQFF`` (the
edge-list layout's modules) load on first use, so that data-only code does
not build the model modules.
"""

__version__ = "0.1.0"

from gotennet_tpu_torch.graph.batch import GraphBatch  # noqa: F401

__all__ = ["GraphBatch", "GotenNet", "GATA", "EQFF", "__version__"]


def __getattr__(name):
    if name in ("GotenNet", "GATA", "EQFF"):
        from gotennet_tpu_torch.models import gotennet as _g
        return getattr(_g, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
