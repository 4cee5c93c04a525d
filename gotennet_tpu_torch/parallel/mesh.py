"""The (data, edge) grid of ranks (``gotennet_tpu/parallel/mesh.py``).

The JAX package lays its devices out row-major
(``np.asarray(devices).reshape(shape)``).  The port runs one process per
device, so its grid holds ranks: ``rank = data_index * edge_parallel +
edge_index``.  ``make_mesh`` builds one process group per data row (the
``edge`` axis: the ranks that share one batch) and one per edge column (the
``data`` axis), and makes the mesh the one the collectives
(``parallel.collectives``) resolve axis names in, as an enclosing
``shard_map`` does for JAX's.  An axis keeps its JAX name, a string such as
``"edge"``, so ``GotenNetConfig.edge_axis`` names it as there.

``torch.distributed.new_group`` is collective: every rank builds every
group, in the same order, so every rank calls ``make_mesh`` with the same
shape.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = ["Mesh", "make_mesh", "current_mesh"]

Axes = Union[str, Tuple[str, ...]]

_CURRENT: Optional["Mesh"] = None


class Mesh:
    """A grid of ranks with one process group per line of each axis.

    ``devices`` is the grid (an int array of ranks of ``shape``);
    ``axis_names`` names its axes.  ``group(axis)`` is the group of this
    rank's line along ``axis`` (a name, or a tuple of names for the ranks
    that differ in any of them), ``size(axis)`` its length and
    ``index(axis)`` this rank's place on it."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 rank: int, groups: Dict[Tuple[str, ...], object]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.rank = rank
        self._groups = groups
        self._coords = dict(zip(self.axis_names, (
            int(c[0]) for c in np.nonzero(devices == rank))))

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.devices.shape)

    def _axes(self, axis: Axes) -> Tuple[str, ...]:
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        unknown = [a for a in axes if a not in self.axis_names]
        if unknown:
            raise ValueError(f"unknown mesh axis {unknown}; the mesh has "
                             f"{self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axis: Axes):
        return self._groups[self._axes(axis)]

    def size(self, axis: Axes) -> int:
        return math.prod(self.devices.shape[self.axis_names.index(a)]
                         for a in self._axes(axis))

    def index(self, axis: str) -> int:
        return self._coords[self._axes(axis)[0]]


def _lines(devices: np.ndarray, axes: Tuple[int, ...]):
    """The lists of ranks that differ only along ``axes``, in grid order."""
    rest = [a for a in range(devices.ndim) if a not in axes]
    moved = np.transpose(devices, rest + list(axes))
    return moved.reshape(-1, math.prod(devices.shape[a] for a in axes))


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data", "edge")) -> Mesh:
    """A mesh over the ranks of the default process group, which must be
    initialised (``parallel.initialize_distributed``).  ``shape=None`` puts
    every rank on the first axis (data parallelism); a -1 entry is inferred
    from the world size.  The mesh becomes the current one."""
    import itertools

    import torch.distributed as dist

    global _CURRENT
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised torch.distributed process group "
            "(parallel.initialize_distributed): the port runs one process "
            "per device")
    n, rank = dist.get_world_size(), dist.get_rank()
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = list(shape)
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        shape[shape.index(-1)] = n // known
    need = int(np.prod(shape))
    if need != n:
        raise ValueError(f"mesh shape {shape} needs {need} ranks; the "
                         f"process group has {n}")
    names = tuple(axis_names[:len(shape)])
    devices = np.arange(need).reshape(shape)
    groups = {}
    # every rank creates every group, in this order
    for k in range(1, len(shape) + 1):
        for axes in itertools.combinations(range(len(shape)), k):
            key = tuple(names[a] for a in axes)
            for line in _lines(devices, axes):
                members = [int(r) for r in line]
                g = (dist.group.WORLD if len(members) == n
                     else dist.new_group(members))
                if rank in members:
                    groups[key] = g
    _CURRENT = Mesh(devices, names, rank, groups)
    return _CURRENT


def current_mesh() -> Mesh:
    """The mesh the collectives resolve axis names in (the last one
    ``make_mesh`` built)."""
    if _CURRENT is None:
        raise RuntimeError("no mesh: a collective over a named axis needs "
                           "parallel.make_mesh first")
    return _CURRENT
