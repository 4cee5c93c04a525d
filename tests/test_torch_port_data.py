"""The port's data pipeline against the JAX package's: the same seed
gives the same molecules, the same bucketed chunks, and the dense
pair mask counts the same edges as the JAX edge builder."""

import numpy as np
import pytest

from gotennet_tpu.data.dataset import BatchLoader as JBatchLoader
from gotennet_tpu.data.dataset import DenseLoader as JDenseLoader
from gotennet_tpu.data.dataset import synthetic_molecules as j_synthetic

from gotennet_tpu_torch.data.dataset import DenseLoader, synthetic_molecules
from gotennet_tpu_torch.models.gotennet_dense import pair_geometry


def test_synthetic_molecules_identical():
    a = j_synthetic(20, seed=4, min_atoms=12, max_atoms=29)
    b = synthetic_molecules(20, seed=4, min_atoms=12, max_atoms=29)
    assert len(a) == len(b)
    for i in range(len(a)):
        np.testing.assert_array_equal(a.z[i], b.z[i])
        np.testing.assert_array_equal(a.pos[i], b.pos[i])
    np.testing.assert_array_equal(a.y, b.y)


@pytest.mark.parametrize("shuffle,bucket,window", [
    (False, True, 2), (True, True, 2), (True, False, 16), (False, True, 8)])
def test_dense_loader_identical_chunks(shuffle, bucket, window):
    kw = dict(batch_size=8, shuffle=shuffle, seed=1, bucket=bucket,
              bucket_window=window)
    jds = j_synthetic(37, seed=0, min_atoms=12, max_atoms=29)
    ds = synthetic_molecules(37, seed=0, min_atoms=12, max_atoms=29)
    jb = list(JDenseLoader(jds, **kw))
    pb = list(DenseLoader(ds, **kw))
    assert len(jb) == len(pb) == 5
    for a, b in zip(jb, pb):
        for f in ("z", "pos", "mask", "graph_mask", "y"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          getattr(b, f).numpy(), err_msg=f)
    if bucket:
        assert {b.max_atoms for b in pb} <= {16, 24, 32}


def test_dense_loader_indices_follow_rows():
    ds = synthetic_molecules(19, seed=2, min_atoms=5, max_atoms=20)
    sizes = [len(z) for z in ds.z]
    seen = []
    for idx, b in DenseLoader(ds, batch_size=4, bucket=True,
                              bucket_window=5).batches():
        assert b.mask[:len(idx)].sum(1).tolist() == [sizes[i] for i in idx]
        assert not b.graph_mask[len(idx):].any()
        seen.extend(idx.tolist())
    assert sorted(seen) == list(range(19))


@pytest.mark.parametrize("cap", [32, 6])
def test_pair_mask_counts_edge_builder_edges(cap):
    """Real edges (self-loops included) from the dense pair mask equal the
    JAX BatchLoader's edge_mask count for the same molecules."""
    jds = j_synthetic(16, seed=0, min_atoms=12, max_atoms=29)
    ds = synthetic_molecules(16, seed=0, min_atoms=12, max_atoms=29)
    eb = next(iter(JBatchLoader(jds, batch_size=16, cutoff=5.0,
                                max_num_neighbors=cap)))
    want = int(np.asarray(eb.edge_mask).sum())
    got = 0
    for b in DenseLoader(ds, batch_size=8, bucket=True, bucket_window=2):
        got += int(pair_geometry(b.pos, b.mask, 5.0, cap).pair_mask.sum())
    assert got == want
