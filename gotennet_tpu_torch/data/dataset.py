"""In-memory molecular datasets, the edge-list, dense- and ELL-batch
loaders and the split and standardisation helpers.

Counterpart of ``gotennet_tpu/data/dataset.py``: the same seed gives the
same molecules (numpy ``default_rng``), the same splits and, epoch by epoch
(``set_epoch``), the same batches as the JAX package.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from gotennet_tpu_torch.graph.batch import GraphBatch
from gotennet_tpu_torch.graph.dense_batch import (DenseBatch, collate_dense,
                                                  collate_dense_packed,
                                                  pack_molecules)
from gotennet_tpu_torch.graph.ell_batch import (ELLBatch, collate_ell,
                                                frame_graph)
from gotennet_tpu_torch.graph.neighborlist import collate_graphs
from gotennet_tpu_torch.models.heads import ATOMIC_MASSES

__all__ = ["MoleculeDataset", "BatchLoader", "DenseLoader", "ELLLoader",
           "synthetic_molecules", "synthetic_trajectory", "pair_potential",
           "make_splits", "center_positions",
           "standardize_energy", "ATOMIC_MASSES"]


@dataclasses.dataclass
class MoleculeDataset:
    """Ragged molecule storage: lists of per-molecule arrays."""

    z: List[np.ndarray]                     # [M_i] int
    pos: List[np.ndarray]                   # [M_i, 3] float
    y: Optional[np.ndarray] = None          # [n, T] graph targets
    dy: Optional[List[np.ndarray]] = None   # [M_i, 3] forces
    atomref: Optional[np.ndarray] = None    # [max_z, 1]

    def __len__(self) -> int:
        return len(self.z)

    def subset(self, idx: Sequence[int]) -> "MoleculeDataset":
        idx = np.asarray(idx)
        return MoleculeDataset(
            z=[self.z[i] for i in idx],
            pos=[self.pos[i] for i in idx],
            y=self.y[idx] if self.y is not None else None,
            dy=[self.dy[i] for i in idx] if self.dy is not None else None,
            atomref=self.atomref)

    def graph_dicts(self, idx: Sequence[int]) -> List[dict]:
        out = []
        for i in idx:
            g = {"z": self.z[i], "pos": self.pos[i]}
            if self.y is not None:
                g["y"] = self.y[i]
            if self.dy is not None:
                g["dy"] = self.dy[i]
            out.append(g)
        return out


def pair_potential(z: np.ndarray, pos: np.ndarray, forces: bool = False):
    """The synthetic target: ``0.01 * sum_{i != j} z_i z_j exp(-|r_ij|^2)``
    (float64 positions), and with ``forces`` its negative gradient
    ``[n, 3]`` float32 (else None)."""
    diff = pos[:, None] - pos[None, :]
    d2 = (diff ** 2).sum(-1)
    w = z[:, None] * z[None, :]
    np.fill_diagonal(d2, np.inf)
    e = float((w * np.exp(-d2)).sum()) * 0.01
    if not forces:
        return e, None
    k = w[..., None] * np.exp(-d2)[..., None] * (-2.0 * diff)
    g = 0.01 * 2.0 * np.nansum(
        np.where(np.isfinite(d2)[..., None], k, 0.0), axis=1)
    return e, (-g).astype(np.float32)


def synthetic_molecules(n: int, seed: int = 0, min_atoms: int = 6,
                        max_atoms: int = 24, box: float = 4.0,
                        with_forces: bool = False) -> MoleculeDataset:
    """Random QM9-like molecules: organic atom types, positions spread so
    typical neighbour counts match a 5 A cutoff, and a smooth synthetic
    target (``pair_potential``); ``with_forces`` adds its negative gradient
    as force targets (drawing nothing more from the generator)."""
    rng = np.random.default_rng(seed)
    zs, poss, ys, dys = [], [], [], []
    types = np.asarray([1, 6, 7, 8, 9])
    probs = np.asarray([0.5, 0.3, 0.1, 0.08, 0.02])
    for _ in range(n):
        m = int(rng.integers(min_atoms, max_atoms + 1))
        z = rng.choice(types, size=m, p=probs).astype(np.int32)
        pos = (rng.random((m, 3)) - 0.5) * box * (m / 12.0) ** (1 / 3)
        e, f = pair_potential(z, pos, with_forces)
        zs.append(z)
        poss.append(pos.astype(np.float32))
        ys.append([e])
        if with_forces:
            dys.append(f)
    return MoleculeDataset(z=zs, pos=poss, y=np.asarray(ys, np.float32),
                           dy=dys if with_forces else None)


def synthetic_trajectory(n_frames: int, n_atoms: int, seed: int = 0,
                         box: float = 6.3, jitter: float = 0.1
                         ) -> MoleculeDataset:
    """Frames of one molecule, as an MD trajectory gives them: one draw of
    atom types and positions as ``synthetic_molecules`` makes them (``box``
    6.3 is its condensed-phase density), then each frame moves every atom
    by a Gaussian step of ``jitter`` A; energies and forces from
    ``pair_potential``."""
    base = synthetic_molecules(1, seed=seed, min_atoms=n_atoms,
                               max_atoms=n_atoms, box=box)
    z = base.z[0]
    rng = np.random.default_rng([seed, 1])
    poss, ys, dys = [], [], []
    for _ in range(n_frames):
        pos = base.pos[0].astype(np.float64) + jitter * rng.standard_normal(
            (n_atoms, 3))
        e, f = pair_potential(z, pos, True)
        poss.append(pos.astype(np.float32))
        ys.append([e])
        dys.append(f)
    return MoleculeDataset(z=[z] * n_frames, pos=poss,
                           y=np.asarray(ys, np.float32), dy=dys)


def make_splits(n: int, train_size, val_size, test_size, seed: int,
                save_path: Optional[str] = None,
                splits_path: Optional[str] = None):
    """Seeded permutation split; each size an int, a float fraction or None
    (the remainder; at most one).  ``save_path`` writes ``splits.npz``;
    ``splits_path`` reads one back instead of splitting."""
    if splits_path is not None:
        f = np.load(splits_path)
        return f["idx_train"], f["idx_val"], f["idx_test"]

    def resolve(size):
        if size is None:
            return None
        if isinstance(size, float):
            return int(round(size * n))
        return int(size)

    tr, va, te = resolve(train_size), resolve(val_size), resolve(test_size)
    if sum(x is None for x in (tr, va, te)) > 1:
        raise ValueError("at most one of the split sizes may be None")
    if tr is None:
        tr = n - va - te
    elif va is None:
        va = n - tr - te
    if te is None:
        te = n - tr - va
    if tr + va + te > n:
        raise ValueError(f"splits {tr}+{va}+{te} exceed dataset size {n}")

    perm = np.random.default_rng(seed).permutation(n)
    idx_train = perm[:tr]
    idx_val = perm[tr:tr + va]
    idx_test = perm[tr + va:tr + va + te]
    if save_path is not None:
        np.savez(save_path, idx_train=idx_train, idx_val=idx_val,
                 idx_test=idx_test)
    return idx_train, idx_val, idx_test


def center_positions(ds: MoleculeDataset) -> MoleculeDataset:
    """Subtract each molecule's centre of mass from its positions (the
    datamodule's ``normalize_positions``)."""
    masses = np.asarray(ATOMIC_MASSES, np.float64)
    pos = []
    for z, p in zip(ds.z, ds.pos):
        w = masses[np.asarray(z)]
        com = (w[:, None] * p).sum(0) / w.sum()
        pos.append((p - com).astype(p.dtype))
    return dataclasses.replace(ds, pos=pos)


def standardize_energy(ds: MoleculeDataset, idx: Sequence[int],
                       label_col: int = 0, use_atomref: bool = True):
    """``(mean, std)`` of the target over a split, each molecule's atomref
    sum subtracted first when the dataset has a table and ``use_atomref``."""
    ys = []
    for i in idx:
        y = float(ds.y[i, label_col])
        if use_atomref and ds.atomref is not None:
            y -= float(ds.atomref[ds.z[i], 0].sum())
        ys.append(y)
    ys = np.asarray(ys, np.float64)
    return float(ys.mean()), float(ys.std(ddof=1))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def set_epoch(loader, epoch: int) -> None:
    """Make the loader's shuffle a pure function of ``(seed, epoch)``, so a
    resumed run repeats the uninterrupted run's batch order."""
    loader.rng = np.random.default_rng([loader.seed, epoch])


def set_shard(loader, world: int, rank: int, pad: bool = False) -> None:
    """Keep only every ``world``-th batch from the ``rank``-th on (torch's
    ``DistributedSampler`` at batch granularity).  Every rank draws the
    same global batch order (the same seed and ``set_epoch``), so the shards
    are the JAX package's device groups.  ``pad=False`` (training) leaves
    out the trailing batches that do not fill every rank, so all ranks take
    the same number of steps; ``pad=True`` (evaluation) wraps round to the
    start, so every rank evaluates as many batches (a wrapped batch is
    counted twice in the metrics)."""
    if world < 1 or not (0 <= rank < world):
        raise ValueError(f"bad shard ({world=}, {rank=})")
    loader.world, loader.rank, loader.pad_shard = world, rank, pad


def _shard_batch_indices(loader, n_batches: int) -> List[int]:
    """The global batch indices this loader's shard yields."""
    if loader.world == 1:
        return list(range(n_batches))
    if loader.pad_shard:
        total = -(-n_batches // loader.world) * loader.world
        return [i % n_batches
                for i in range(loader.rank, total, loader.world)]
    usable = (n_batches // loader.world) * loader.world
    return list(range(loader.rank, usable, loader.world))


class BatchLoader:
    """Iterates fixed-capacity ``GraphBatch``es (the edge-list layout, each
    node's self-loop included) over a dataset, ``batch_size`` molecules
    each, in order or, with ``shuffle``, in an order drawn from ``seed``
    (and the epoch, ``set_epoch``); ``drop_last`` leaves out a short last
    batch, which is otherwise padded with empty graph slots.

    Capacities, unless given: nodes for the ``batch_size`` largest
    molecules plus 8, rounded up to 8; edges for that many nodes at the
    largest edges-per-node ratio over the molecules ``neighbor_probe`` names
    (every one with ``"full"``, else that many spread evenly over the
    dataset, with 15 % slack), plus 16, rounded up to 128, as the JAX loader
    sets them.  A batch that still overflows its edges grows the capacity
    to 1.5x + 128 (rounded up to 128), logs a warning and is collated
    again; the larger capacity stays."""

    def __init__(self, ds: MoleculeDataset, batch_size: int,
                 cutoff: float = 5.0, shuffle: bool = False, seed: int = 0,
                 max_num_neighbors: int = 32,
                 node_capacity: Optional[int] = None,
                 edge_capacity: Optional[int] = None,
                 drop_last: bool = False,
                 neighbor_probe: "int | str" = 64):
        from gotennet_tpu_torch.graph.native import build_edges
        self.ds = ds
        self.batch_size = batch_size
        self.cutoff = cutoff
        self.shuffle = shuffle
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.max_num_neighbors = max_num_neighbors
        self.drop_last = drop_last
        if node_capacity is None or edge_capacity is None:
            sizes = np.asarray([len(z) for z in ds.z])
            full = neighbor_probe == "full"
            probe = (np.arange(len(ds)) if full else np.linspace(
                0, len(ds) - 1, min(len(ds), int(neighbor_probe))
            ).astype(int))
            e_per_node = [
                len(build_edges(ds.pos[i], cutoff, True,
                                max_num_neighbors)[0]) / max(len(ds.z[i]), 1)
                for i in probe]
            deg = max(e_per_node) if e_per_node else 8.0
            n_cap = int(np.sort(sizes)[-min(batch_size, len(sizes)):].sum())
            node_capacity = node_capacity or _round_up(n_cap + 8, 8)
            slack = 1.0 if full else 1.15
            edge_capacity = edge_capacity or _round_up(
                int(node_capacity * deg * slack) + 16, 128)
        self.node_capacity = node_capacity
        self.edge_capacity = edge_capacity
        self.with_forces = ds.dy is not None

    def __len__(self) -> int:
        n = len(self.ds)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    set_epoch = set_epoch
    set_shard = set_shard
    _shard_batch_indices = _shard_batch_indices
    world, rank, pad_shard = 1, 0, False

    def batches(self) -> Iterator[Tuple[np.ndarray, GraphBatch]]:
        """Yield ``(dataset indices, batch)``; graph g of the batch holds
        molecule ``indices[g]``."""
        from gotennet_tpu_torch.utils.logging import get_logger
        order = np.arange(len(self.ds))
        if self.shuffle:
            self.rng.shuffle(order)
        bs = self.batch_size
        stop = len(order) - (len(order) % bs if self.drop_last else 0)
        y_dim = self.ds.y.shape[1] if self.ds.y is not None else 1
        for b_idx in self._shard_batch_indices(len(range(0, stop, bs))):
            off = b_idx * bs
            idx = order[off:off + bs]
            graphs = self.ds.graph_dicts(idx)
            while True:
                try:
                    batch = collate_graphs(
                        graphs, self.node_capacity, self.edge_capacity, bs,
                        cutoff=self.cutoff, loop=True,
                        max_num_neighbors=self.max_num_neighbors,
                        y_dim=y_dim, with_forces=self.with_forces)
                    break
                except ValueError as e:
                    if "edge capacity" not in str(e):
                        raise
                    new_cap = _round_up(int(self.edge_capacity * 1.5) + 128,
                                        128)
                    get_logger().warning(
                        "edge capacity %d overflowed at batch offset %d; "
                        "rebucketing to %d", self.edge_capacity, off,
                        new_cap)
                    self.edge_capacity = new_cap
            yield idx, batch

    def __iter__(self) -> Iterator[GraphBatch]:
        return (b for _, b in self.batches())


class DenseLoader:
    """Iterates fixed-capacity DenseBatches over a dataset.

    ``max_atoms`` defaults to the largest molecule rounded up to a
    multiple of 8.  With ``bucket=True`` molecules are sorted by size
    inside windows of ``bucket_window`` batches and each batch is padded
    only to its own largest molecule (rounded up to a multiple of 8): at
    QM9's 12-29-atom spread that gives M in {16, 24, 32}.

    With ``pack=True`` each batch's molecules are packed block-diagonally
    into slabs of ``max_atoms`` slots (``collate_dense_packed``), at most
    ``mols_per_slab`` a slab (default: ``max_atoms`` over the smallest
    molecule, at most 8).  The slab count is estimated from the mean
    molecule size with 6 % slack for first-fit decreasing, plus one; a
    batch that packs worse grows it by a sixteenth (at least one), logs a
    warning and is collated again, and the larger count stays."""

    def __init__(self, ds: MoleculeDataset, batch_size: int,
                 shuffle: bool = False, seed: int = 0,
                 max_atoms: Optional[int] = None,
                 drop_last: bool = False,
                 bucket: bool = False,
                 bucket_window: int = 16,
                 pack: bool = False,
                 mols_per_slab: Optional[int] = None):
        self.ds = ds
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last
        if max_atoms is None:
            max_atoms = max((len(z) for z in ds.z), default=1)
        self.max_atoms = _round_up(max_atoms, 8)
        self.bucket = bucket
        self.bucket_window = bucket_window
        self.pack = pack
        if pack:
            sizes = np.asarray([len(z) for z in ds.z])
            if mols_per_slab is None:
                mols_per_slab = int(min(
                    8, max(1, self.max_atoms // max(1, sizes.min()))))
            self.mols_per_slab = mols_per_slab
            mean = float(sizes.mean()) if len(sizes) else 1.0
            self.num_slabs = max(1, int(np.ceil(
                batch_size * mean / self.max_atoms * 1.06)) + 1)

    def __len__(self) -> int:
        n = len(self.ds)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    set_epoch = set_epoch
    set_shard = set_shard
    _shard_batch_indices = _shard_batch_indices
    world, rank, pad_shard = 1, 0, False

    def _batch_index_arrays(self, order) -> List[np.ndarray]:
        bs = self.batch_size
        stop = len(order) - (len(order) % bs if self.drop_last else 0)
        order = order[:stop]
        if not self.bucket:
            return [order[off:off + bs] for off in range(0, stop, bs)]
        window = bs * max(1, self.bucket_window)
        sizes = np.asarray([len(z) for z in self.ds.z])
        out = []
        for wstart in range(0, stop, window):
            w = order[wstart:wstart + window]
            w = w[np.argsort(sizes[w], kind="stable")]
            out.extend(w[o:o + bs] for o in range(0, len(w), bs))
        return out

    def _packed(self, idx: np.ndarray, y_dim: int
                ) -> Tuple[np.ndarray, DenseBatch]:
        """One packed batch of the molecules ``idx``, and the molecule of
        each of its ``[G * P]`` slots (-1 where none)."""
        from gotennet_tpu_torch.utils.logging import get_logger
        graphs = self.ds.graph_dicts(idx)
        while True:
            try:
                batch = collate_dense_packed(
                    graphs, self.num_slabs, self.max_atoms,
                    self.mols_per_slab, y_dim=y_dim,
                    with_forces=self.ds.dy is not None)
                break
            except ValueError as e:
                if "slab capacity" not in str(e):
                    raise
                self.num_slabs += max(1, self.num_slabs // 16)
                get_logger().warning("packed slab capacity overflowed; "
                                     "growing to %d", self.num_slabs)
        slots = np.full((self.num_slabs, self.mols_per_slab), -1, np.int64)
        for s, members in enumerate(pack_molecules(
                [len(g["z"]) for g in graphs], self.max_atoms,
                self.mols_per_slab)):
            slots[s, :len(members)] = np.asarray(idx)[members]
        return slots.reshape(-1), batch

    def batches(self) -> Iterator[Tuple[np.ndarray, DenseBatch]]:
        """Yield ``(dataset indices, batch)``; row g of the batch holds
        molecule ``indices[g]`` (packed: molecule slot ``s * P + local``
        holds ``indices[s * P + local]``, -1 for an empty slot)."""
        order = np.arange(len(self.ds))
        if self.shuffle:
            self.rng.shuffle(order)
        y_dim = self.ds.y.shape[1] if self.ds.y is not None else 1
        sizes = np.asarray([len(z) for z in self.ds.z])
        batches = self._batch_index_arrays(order)
        for b_idx in self._shard_batch_indices(len(batches)):
            idx = batches[b_idx]
            if self.pack:
                yield self._packed(idx, y_dim)
                continue
            m = self.max_atoms if not self.bucket else min(
                self.max_atoms, _round_up(max(8, int(sizes[idx].max())), 8))
            yield idx, collate_dense(self.ds.graph_dicts(idx),
                                     self.batch_size, m, y_dim=y_dim,
                                     with_forces=self.ds.dy is not None)

    def __iter__(self) -> Iterator[DenseBatch]:
        return (b for _, b in self.batches())


class ELLLoader:
    """Iterates fixed-capacity ELLBatches (``[N, K]`` neighbour rows) over a
    dataset, ``batch_size`` molecules each, in order or, with ``shuffle``,
    in an order drawn from ``seed`` (and the epoch, ``set_epoch``);
    ``drop_last`` leaves out a short last batch.

    Node capacity: the ``batch_size`` largest molecules plus 8, rounded up
    to 8 and then to ``block_rows``.  ``max_neighbors`` defaults to the
    largest degree over the frames ``neighbor_probe`` names: every frame
    with ``"full"`` (the default), else that many frames spread evenly over
    the dataset (``np.linspace``), whose degree is given 25 % headroom
    (capped at ``max_num_neighbors`` + 1), as the JAX loader does; either
    is rounded up to a multiple of 4.  A batch whose degree overflows it
    grows K by 4 and is collated again.

    Each frame's radius graph is built once, on the frame in the order the
    batch will hold it (spatially sorted with ``spatial_sort``), by the
    native cell list: the degree probe and the collation share it (a degree
    does not depend on the atom order)."""

    def __init__(self, ds: MoleculeDataset, batch_size: int,
                 cutoff: float = 5.0, max_num_neighbors: int = 32,
                 max_neighbors: Optional[int] = None,
                 spatial_sort: bool = False,
                 block_rows: Optional[int] = None,
                 shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False,
                 neighbor_probe: "int | str" = "full"):
        self.ds = ds
        self.batch_size = batch_size
        self.cutoff = cutoff
        self.max_num_neighbors = max_num_neighbors
        self.spatial_sort = spatial_sort
        self.block_rows = block_rows
        self.shuffle = shuffle
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last
        sizes = np.asarray([len(z) for z in ds.z])
        n_cap = int(np.sort(sizes)[-min(batch_size, len(sizes)):].sum())
        self.node_capacity = _round_up(n_cap + 8, 8)
        if block_rows:
            self.node_capacity = _round_up(self.node_capacity, block_rows)
        self._frames = {}
        if max_neighbors is None:
            full = neighbor_probe == "full"
            probe = (np.arange(len(ds)) if full else np.linspace(
                0, len(ds) - 1, min(len(ds), int(neighbor_probe))
            ).astype(int))
            deg = 1
            for i in probe:
                _, _, dst = self._frame(int(i))
                if len(dst):
                    deg = max(deg, int(np.bincount(dst).max()))
            if not full:
                deg = min(int(deg * 1.25) + 1, max_num_neighbors + 1)
            max_neighbors = _round_up(deg, 4)
        self.max_neighbors = max_neighbors

    def __len__(self) -> int:
        n = len(self.ds)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    set_epoch = set_epoch
    set_shard = set_shard
    _shard_batch_indices = _shard_batch_indices
    world, rank, pad_shard = 1, 0, False

    def _frame(self, i: int):
        if i not in self._frames:
            self._frames[i] = frame_graph(self.ds.pos[i], self.cutoff,
                                          self.max_num_neighbors,
                                          self.spatial_sort)
        return self._frames[i]

    def batches(self) -> Iterator[Tuple[np.ndarray, ELLBatch]]:
        """Yield ``(dataset indices, batch)``; graph g of the batch holds
        molecule ``indices[g]``."""
        bs = self.batch_size
        y_dim = self.ds.y.shape[1] if self.ds.y is not None else 1
        order = np.arange(len(self.ds))
        if self.shuffle:
            self.rng.shuffle(order)
        stop = len(order) - (len(order) % bs if self.drop_last else 0)
        for b_idx in self._shard_batch_indices(len(range(0, stop, bs))):
            off = b_idx * bs
            idx = order[off:off + bs]
            graphs = self.ds.graph_dicts(idx)
            frames = [self._frame(int(i)) for i in idx]
            while True:
                try:
                    batch = collate_ell(
                        graphs, self.node_capacity, self.max_neighbors, bs,
                        cutoff=self.cutoff,
                        max_num_neighbors=self.max_num_neighbors,
                        y_dim=y_dim, block_rows=self.block_rows,
                        spatial_sort=self.spatial_sort,
                        with_forces=self.ds.dy is not None, frames=frames)
                    break
                except ValueError as e:
                    if "neighbor capacity" not in str(e):
                        raise
                    new_k = _round_up(self.max_neighbors + 4, 4)
                    logging.getLogger(__name__).warning(
                        "neighbor capacity %d overflowed; rebucketing to %d",
                        self.max_neighbors, new_k)
                    self.max_neighbors = new_k
            yield idx, batch

    def __iter__(self) -> Iterator[ELLBatch]:
        return (b for _, b in self.batches())
