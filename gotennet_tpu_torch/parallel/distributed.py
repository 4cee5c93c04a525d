"""Starting the process group (``gotennet_tpu/parallel/distributed.py``).

The JAX package calls ``jax.distributed.initialize`` and builds a global
mesh over every process's devices.  The port runs one process per device:
``initialize_distributed`` starts ``torch.distributed`` from explicit
arguments or from the variables ``torchrun`` sets (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), and
``global_mesh`` lays the ranks out as a ``(data, edge)`` grid.

    torchrun --nproc-per-node 4 -m gotennet_tpu_torch.cli train \
        experiment=molecule3d trainer.distributed=true trainer.data_parallel=4
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

__all__ = ["initialize_distributed", "global_mesh"]


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None) -> dict:
    """Start the default process group, unless it is started already or
    nothing asks for one (no ``init_method``, no ``MASTER_ADDR``, a world of
    one).  Explicit arguments win over the environment; ``init_method``
    defaults to ``env://``.  ``backend`` is ``nccl`` when CUDA is present
    and ``gloo`` otherwise, or what the caller asks (``gloo`` on CUDA
    tensors runs several ranks on one card, which NCCL refuses).  Under
    NCCL each process takes the CUDA device ``LOCAL_RANK``.  Returns a
    summary: ``process_index``, ``process_count``, ``local_rank`` and
    ``backend`` (None without a group)."""
    import torch
    import torch.distributed as dist

    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    local_rank = int(env.get("LOCAL_RANK", 0))
    wanted = (init_method is not None or "MASTER_ADDR" in env
              or (world_size or 1) > 1)
    if wanted and not dist.is_initialized():
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        if backend == "nccl":
            torch.cuda.set_device(local_rank)
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=world_size or 1, rank=rank or 0)
    if not dist.is_initialized():
        return {"process_index": 0, "process_count": 1,
                "local_rank": local_rank, "backend": None}
    return {"process_index": dist.get_rank(),
            "process_count": dist.get_world_size(),
            "local_rank": local_rank, "backend": dist.get_backend()}


def global_mesh(edge_dim: int = 1,
                axis_names: Tuple[str, str] = ("data", "edge")):
    """A mesh over every rank: ``data = world // edge_dim``."""
    import torch.distributed as dist

    from gotennet_tpu_torch.parallel.mesh import make_mesh
    n = dist.get_world_size()
    if n % edge_dim:
        raise ValueError(f"{n} ranks not divisible by edge_dim {edge_dim}")
    return make_mesh((n // edge_dim, edge_dim), axis_names)
