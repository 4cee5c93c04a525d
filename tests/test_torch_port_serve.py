"""The port's serving entry point on the CPU: padding and bucketing must
not change a molecule's prediction, answers come back in request order,
and the entry points refuse to pick the CPU on their own."""

import jax
import numpy as np
import pytest
import torch

from gotennet_tpu.data.dataset import DenseLoader as JDenseLoader
from gotennet_tpu.data.dataset import synthetic_molecules as j_synthetic
from gotennet_tpu.models.gotennet import GotenNetConfig as JConfig
from gotennet_tpu.models.model import GotenModel as JModel
from gotennet_tpu.models.model import HeadConfig as JHead

from gotennet_tpu_torch.data.dataset import DenseLoader, synthetic_molecules
from gotennet_tpu_torch.graph.dense_batch import collate_dense
from gotennet_tpu_torch.models.gotennet import GotenNetConfig
from gotennet_tpu_torch.models.model import GotenModel, HeadConfig
from gotennet_tpu_torch.serve import Predictor
from gotennet_tpu_torch.train.trainer import train_steps
from gotennet_tpu_torch.utils.convert import state_dict_from_jax_params

CFG_KW = dict(n_atom_basis=32, n_interactions=2, lmax=2, num_heads=4,
              n_rbf=8)
CFG = GotenNetConfig(**CFG_KW)
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


# each option with the ROADMAP.md item that ported it: the update's gates
# and norej on the dense plain update, the MLP and linear variants, no
# update, edge_ln (item 5), the pre-norms and the trainable basis (item 3),
# scan_layers (item 13: JAX's stacked init through the converter)
@pytest.mark.parametrize("kw,item", [
    (dict(fused=False, edge_updates="gated"), "item 5"),
    (dict(fused=False, aggr="mean", edge_updates="norej"), "item 5"),
    (dict(layernorm="pre"), "item 3"), (dict(steerable_norm="pre"), "item 3"),
    (dict(trainable_rbf=True), "item 3"), (dict(edge_updates="gated"),
                                           "item 5"),
    (dict(edge_updates=False), "item 5"),
    (dict(fused=False, fused_htr=True, edge_updates="gatedt"), "item 5"),
    (dict(scan_layers=True), "item 13"), (dict(edge_ln="layer"), "item 5"),
    (dict(edge_updates="mlp"), "item 5")])
def test_unported_options_raise(kw, item):
    """Every option the port once refused builds the dense model, which
    matches JAX's from its init at 1e-5 of the output's scale (float32, the
    same math with sums in another order; JAX's XLA message, the port's
    fused one where ``fused`` is left at True).  None raises any more."""
    jkw = {k: v for k, v in kw.items() if k != "fused"}
    jmodel = JModel(JConfig(**CFG_KW, **jkw), JHead(mean=0.5, stddev=2.0),
                    layout="dense")
    jbatch = next(iter(JDenseLoader(j_synthetic(3, seed=2, min_atoms=4,
                                                max_atoms=12), 3)))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jbatch)
    cfg = GotenNetConfig(**{**CFG_KW, **kw})
    model = GotenModel(cfg, HEAD, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params, cfg, HEAD))
    batch = next(iter(DenseLoader(synthetic_molecules(3, seed=2, min_atoms=4,
                                                      max_atoms=12), 3)))
    want = np.asarray(jax.jit(jmodel.apply)(params, jbatch)["property"])
    with torch.inference_mode():
        got = model(batch)["property"].numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("kw", [dict(aggr="mean"), dict(aggr="max"),
                                dict(activation="ssp")])
def test_fused_message_options_raise_value_error(kw):
    """As the JAX config does: the fused message is silu and aggr='add'."""
    with pytest.raises(ValueError, match="fused=True"):
        GotenNetConfig(**kw)
    assert GotenNetConfig(fused=False, **kw).fused is False


def test_unported_layouts_heads_and_training_dropout_raise():
    # the edge-list layout is ported (item 10): it serves and trains, with
    # the port's default config (fused=True, which the edge layout ignores)
    mols = synthetic_molecules(2, seed=0, min_atoms=4,
                               max_atoms=9).graph_dicts(range(2))
    pred = Predictor(CFG, HEAD, device="cpu", layout="edge")
    assert pred.model.layout == "edge"
    out = pred.predict(mols)
    assert out.shape == (2, 1) and np.isfinite(out).all()
    losses = train_steps(CFG, HEAD, mols, 1, device="cpu", layout="edge")
    assert len(losses) == 1 and np.isfinite(losses).all()
    with pytest.raises(ValueError, match="unknown layout"):
        GotenModel(CFG, HEAD, layout="csr", device="cpu")
    # the Dipole and ESE heads are ported (item 6): they build and answer
    for kind in ("dipole", "electronic_spatial_extent"):
        model = GotenModel(CFG, HeadConfig(kind=kind), device="cpu")
        with torch.no_grad():
            out = model(collate_dense([{"z": [6, 1], "pos": [[0, 0, 0],
                                                             [1, 0, 0]]}],
                                      1, 8))["property"]
        assert out.shape == (1, 1) and torch.isfinite(out).all()
    cfg = GotenNetConfig(n_atom_basis=32, n_interactions=1, num_heads=4,
                         n_rbf=8, attn_dropout=0.1)
    model = GotenModel(cfg, HEAD, device="cpu")
    batch = collate_dense([{"z": [6, 1], "pos": [[0, 0, 0], [1, 0, 0]]}],
                          1, 8)
    want = model(batch)["property"]                         # eval: no dropout
    assert torch.isfinite(want).all()
    model.train()   # dropout in training is ported (item 1): no raise
    got = model(batch)["property"]
    assert torch.isfinite(got).all() and not torch.equal(got, want)
