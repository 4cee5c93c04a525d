"""The port's serving entry point on the CPU: padding and bucketing must
not change a molecule's prediction, answers come back in request order,
and the entry points refuse to pick the CPU on their own."""

import numpy as np
import pytest
import torch

from gotennet_tpu_torch.data.dataset import synthetic_molecules
from gotennet_tpu_torch.graph.dense_batch import collate_dense
from gotennet_tpu_torch.models.gotennet import GotenNetConfig
from gotennet_tpu_torch.models.model import GotenModel, HeadConfig
from gotennet_tpu_torch.serve import Predictor
from gotennet_tpu_torch.train.trainer import train_steps

CFG = GotenNetConfig(n_atom_basis=32, n_interactions=2, lmax=2, num_heads=4,
                     n_rbf=8)
HEAD = HeadConfig(mean=0.5, stddev=2.0)


def test_predictor_matches_model_molecule_by_molecule():
    pred = Predictor(CFG, HEAD, seed=11, device="cpu", chunk=4)
    model = pred.model
    ds = synthetic_molecules(17, seed=5, min_atoms=4, max_atoms=21)
    mols = ds.graph_dicts(range(17))
    start = 0
    for n in (1, 5, 11):
        request = mols[start:start + n]
        start += n
        got = pred.predict(request)
        assert got.shape == (n, 1) and np.isfinite(got).all()
        with torch.inference_mode():
            want = [model(collate_dense([m], 1, len(m["z"])))["property"]
                    for m in request]
        # f32; padding and chunking only change the order of f32 sums
        np.testing.assert_allclose(got, torch.cat(want).numpy(), rtol=1e-4,
                                   atol=1e-4)
    assert pred.predict([]).shape == (0, 1)


def test_unbucketed_predictor_pads_every_chunk_to_the_largest():
    """bucket=False (bench.py's MD22 mode): every chunk is padded to the
    request's largest molecule, in request order, and the answers are the
    bucketed ones (f32; padding only changes the order of f32 sums)."""
    mols = synthetic_molecules(10, seed=6, min_atoms=4,
                               max_atoms=21).graph_dicts(range(10))
    want = Predictor(CFG, HEAD, seed=3, device="cpu", chunk=4).predict(mols)
    pred = Predictor(CFG, HEAD, seed=3, device="cpu", chunk=4, bucket=False)
    seen = []
    pred.model.register_forward_pre_hook(
        lambda _, args: seen.append((args[0].max_atoms,
                                     args[0].z[:, 0].tolist())))
    got = pred.predict(mols)
    largest = max(len(m["z"]) for m in mols)
    assert [m for m, _ in seen] == [(largest + 7) // 8 * 8] * 3
    assert [z for _, z in seen][0] == [int(m["z"][0]) for m in mols[:4]]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(CFG, HEAD)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GotenModel(CFG, HEAD)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GotenModel(CFG, HEAD, device="cuda")


@pytest.mark.parametrize("kw,item", [
    (dict(fused=False), "item 2"), (dict(aggr="mean"), "item 2"),
    (dict(layernorm="pre"), "item 3"), (dict(steerable_norm="pre"), "item 3"),
    (dict(trainable_rbf=True), "item 3"), (dict(edge_updates="gated"),
                                           "item 5"),
    (dict(edge_updates=False), "item 5"), (dict(pos_grads=True), "item 9"),
    (dict(scan_layers=True), "item 13")])
def test_unported_options_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        GotenNetConfig(**kw)


def test_unported_layouts_heads_and_training_dropout_raise():
    with pytest.raises(NotImplementedError, match="item 10"):
        GotenModel(CFG, HEAD, layout="edge", device="cpu")
    # the edge-list layout neither serves nor trains
    mols = synthetic_molecules(2, seed=0, min_atoms=4,
                               max_atoms=9).graph_dicts(range(2))
    with pytest.raises(NotImplementedError, match="item 10"):
        train_steps(CFG, HEAD, mols, 1, device="cpu", layout="edge")
    with pytest.raises(NotImplementedError, match="item 6"):
        GotenModel(CFG, HeadConfig(kind="dipole"), device="cpu")
    cfg = GotenNetConfig(n_atom_basis=32, n_interactions=1, num_heads=4,
                         n_rbf=8, attn_dropout=0.1)
    model = GotenModel(cfg, HEAD, device="cpu")
    batch = collate_dense([{"z": [6, 1], "pos": [[0, 0, 0], [1, 0, 0]]}],
                          1, 8)
    assert torch.isfinite(model(batch)["property"]).all()   # eval: no dropout
    model.train()
    with pytest.raises(NotImplementedError, match="item 1"):
        model(batch)
