"""Every remaining model option of the port against the JAX package, on
the edge-list, dense and ELL layouts.

``TensorLayerNorm`` (with and without its trainable weight), the
orthogonal inits (their properties: random draws cannot match JAX's bit
for bit), trainable radial bases, and each option family on each layout
from one JAX init converted by ``state_dict_from_jax_params``: the
pre-norms (``layernorm``, ``steerable_norm``), ``trainable_rbf``, the
``edge_updates`` variants (the MLP and linear ``gamma_w`` parts, ``ln`` and
``postln``, the gates, ``norej``, no update) with ``edge_ln``, and
``evec_dim != n_atom_basis``.  The dense and ELL models run the fused
message (its plain version on the CPU, held against JAX's XLA message,
the same math) with the plain update, which takes every variant, as in
JAX.  D = 32, 2 layers, 5-14-atom molecules.

Tolerance: float32, the same arithmetic with sums in another order ->
1e-5 of each output's scale (gradients through one backward pass: 1e-4).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gotennet_tpu.data.dataset import BatchLoader as JBatchLoader
from gotennet_tpu.data.dataset import DenseLoader as JDenseLoader
from gotennet_tpu.data.dataset import ELLLoader as JELLLoader
from gotennet_tpu.data.dataset import synthetic_molecules as j_synthetic
from gotennet_tpu.models.gotennet import GotenNetConfig as JConfig
from gotennet_tpu.models.model import GotenModel as JModel
from gotennet_tpu.models.model import HeadConfig as JHead
from gotennet_tpu.nn.dense import get_weight_init as j_get_weight_init
from gotennet_tpu.nn.norms import TensorLayerNorm as JTensorLayerNorm

from gotennet_tpu_torch.data.dataset import (BatchLoader, DenseLoader,
                                             ELLLoader, synthetic_molecules)
from gotennet_tpu_torch.models.gotennet import GotenNetConfig, kernel_paths
from gotennet_tpu_torch.models.model import GotenModel, HeadConfig
from gotennet_tpu_torch.nn.dense import init_weight_
from gotennet_tpu_torch.nn.norms import TensorLayerNorm
from gotennet_tpu_torch.ops.fused_ell import pick_chunking
from gotennet_tpu_torch.ops.rbf import RadialBasis
from gotennet_tpu_torch.train.trainer import check_force_training
from gotennet_tpu_torch.utils.convert import (jax_params_from_state_dict,
                                              state_dict_from_jax_params)

SMALL = dict(n_atom_basis=32, n_interactions=2, lmax=2, num_heads=4,
             n_rbf=8)
MOLS = dict(min_atoms=5, max_atoms=14)


def _scaled(got, want, tol, what):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err)


@pytest.mark.parametrize("trainable", [False, True])
def test_tensor_layer_norm_matches_jax(trainable):
    """Values and input (and weight) gradients at 1e-5 of scale; an
    all-zero node maps to zeros (its gradient is NaN in both: the norm's
    square root at zero)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 8, 6)).astype(np.float32)
    x[2] = 0.0
    cot = rng.standard_normal(x.shape).astype(np.float32)
    jnorm = JTensorLayerNorm(6, 2, trainable=trainable)
    params = jnorm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    if trainable:
        params = {"params": {"weight": jnp.asarray(
            rng.standard_normal(6).astype(np.float32))}}

    def jloss(p, x):
        out = jnorm.apply(p, x)
        return jnp.sum(out * cot), out

    (_, jout), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True)(params,
                                                             jnp.asarray(x))
    norm = TensorLayerNorm(6, 2, trainable=trainable)
    if trainable:
        with torch.no_grad():
            norm.weight.copy_(torch.from_numpy(np.asarray(
                params["params"]["weight"])))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = norm(xt)
    torch.sum(out * torch.from_numpy(cot)).backward()
    _scaled(out.detach().numpy(), jout, 1e-5, "values")
    real = np.arange(len(x)) != 2
    _scaled(xt.grad.numpy()[real], np.asarray(jgx)[real], 1e-5,
            "input gradient")
    assert torch.all(out[2] == 0)
    if trainable:
        _scaled(norm.weight.grad.numpy(), jgp["params"]["weight"], 1e-5,
                "weight gradient")
        assert np.isfinite(norm.weight.grad.numpy()).all()
    else:
        assert list(norm.parameters()) == []


def _orthogonal_properties(m, name):
    fan_out, fan_in = m.shape
    if name == "glo_orthogonal":
        np.testing.assert_allclose(m.var(), 2.0 / (fan_in + fan_out),
                                   rtol=1e-4)
        # orthogonal up to one common scale
        small = m if fan_out <= fan_in else m.T
        gram = small @ small.T
        np.testing.assert_allclose(gram, np.eye(len(gram)) * gram[0, 0],
                                   atol=1e-5)
    else:
        np.testing.assert_allclose(m.mean(axis=1), 0.0, atol=1e-6)
        # the standardisation divides by sqrt(var + 1e-6), with a row
        # variance down to 1 / 48 here: 1 - 5e-5 at most
        np.testing.assert_allclose(m.var(axis=1, ddof=1) * fan_in, 1.0,
                                   rtol=2e-4)


@pytest.mark.parametrize("name", ["glo_orthogonal", "he_orthogonal"])
def test_orthogonal_inits_have_the_reference_properties(name):
    """Torch's ``[out, in]`` weight holds what JAX's ``[in, out]`` kernel
    holds transposed: ``glo_orthogonal`` orthonormal rows (fewer outputs
    than inputs) or columns, rescaled to variance 2 / (fan_in + fan_out);
    ``he_orthogonal`` that basis standardised to zero mean and 1 / fan_in
    variance over each output's inputs."""
    g = torch.Generator().manual_seed(0)
    for fan_out, fan_in in ((16, 48), (48, 16), (24, 24)):
        w = init_weight_(torch.empty(fan_out, fan_in), name, g).numpy()
        jw = np.asarray(j_get_weight_init(name)(
            jax.random.PRNGKey(1), (fan_in, fan_out))).T
        for m in (w, jw):
            _orthogonal_properties(m, name)
    with pytest.raises(ValueError, match="matrix"):
        init_weight_(torch.empty(8), name, g)
    # a whole model takes it, as JAX's does
    model = GotenModel(GotenNetConfig(**SMALL, weight_init=name),
                       HeadConfig(), "edge", device="cpu")
    _orthogonal_properties(
        model.representation.gata_list[0].W_q.weight.detach().numpy(), name)


def test_radial_basis_parameters():
    """Trainable bases hold their parameters under the reference names; a
    constant one keeps them out of the state dict; a Bessel basis has none
    to train (ValueError, as in JAX)."""
    for basis, names in (("expnorm", ["means", "betas"]),
                         ("GaussianRBF", ["offsets", "widths"])):
        rbf = RadialBasis(basis, 8, 5.0, trainable=True)
        assert [n for n, _ in rbf.named_parameters()] == names
        assert RadialBasis(basis, 8, 5.0).state_dict() == {}
        r = torch.linspace(0.0, 6.0, 7)
        np.testing.assert_array_equal(rbf(r).detach().numpy(),
                                      RadialBasis(basis, 8, 5.0)(r).numpy())
    with pytest.raises(ValueError, match="no trainable parameters"):
        RadialBasis("BesselBasis", 8, 5.0, trainable=True)
    with pytest.raises(ValueError, match="no trainable parameters"):
        GotenModel(GotenNetConfig(**SMALL, radial_basis="BesselBasis",
                                  trainable_rbf=True), HeadConfig(), "edge",
                   device="cpu")


# ---- each option on each layout ------------------------------------------------
OPTIONS = {
    "norms": dict(layernorm="pre", steerable_norm="pre"),
    "trainable_rbf": dict(trainable_rbf=True),
    "mlp_edge_ln": dict(edge_updates="mlp", edge_ln="layer"),
    "gatedt_mlpa_linw_ln": dict(edge_updates="gatedt_mlpa_linw_ln"),
    "gated_linwa_postln_evec": dict(edge_updates="gated_linwa_postln",
                                    evec_dim=16),
    "act_norej": dict(edge_updates="act_norej"),
    "no_update": dict(edge_updates=False),
}
_PARAMS = {}


def _batches(layout):
    jds, ds = j_synthetic(3, seed=1, **MOLS), synthetic_molecules(3, seed=1,
                                                                  **MOLS)
    if layout == "edge":
        return next(iter(JBatchLoader(jds, 3))), next(iter(BatchLoader(ds,
                                                                       3)))
    if layout == "dense":
        return next(iter(JDenseLoader(jds, 3))), next(iter(DenseLoader(ds,
                                                                       3)))
    return (next(iter(JELLLoader(jds, 3, neighbor_probe="full"))),
            next(iter(ELLLoader(ds, 3))))


def _jax_params(name):
    """One JAX init per option (the three layouts share its tree)."""
    if name not in _PARAMS:
        jmodel = JModel(JConfig(**SMALL, **OPTIONS[name]), JHead(),
                        layout="edge")
        _PARAMS[name] = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                             _batches("edge")[0])
    return _PARAMS[name]


@pytest.mark.parametrize("layout", ["edge", "dense", "ell"])
@pytest.mark.parametrize("name", list(OPTIONS))
def test_option_matches_jax(name, layout):
    kw = OPTIONS[name]
    params = _jax_params(name)
    jbatch, batch = _batches(layout)
    # JAX's XLA message on every layout; the port's fused one (its plain
    # version here) on dense and ELL, the same math
    jout = jax.jit(JModel(JConfig(**SMALL, **kw), JHead(),
                          layout=layout).apply)(params, jbatch)
    cfg = GotenNetConfig(**SMALL, **kw, fused=layout != "edge")
    model = GotenModel(cfg, HeadConfig(), layout, device="cpu")
    state = state_dict_from_jax_params(params, cfg, HeadConfig())
    model.load_state_dict(state)
    with torch.inference_mode():
        out = model(batch)
    for key in ("property", "representation", "vector_representation"):
        _scaled(out[key].numpy(), jout[key], 1e-5, key)
    # the update is the plain one on every layout, with fused_htr as well
    htr = GotenNetConfig(**SMALL, **kw, fused_htr=True)
    if name in ("mlp_edge_ln", "gatedt_mlpa_linw_ln",
                "gated_linwa_postln_evec"):
        assert kernel_paths(htr, "dense") == (True, False)
        assert kernel_paths(htr, "ell", 64, 64, None) == (True, False)
    # the state dict maps back onto JAX's tree, array for array
    back = jax_params_from_state_dict(state, cfg)["params"]["representation"]
    want = jax.tree_util.tree_leaves_with_path(
        params["params"]["representation"])
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], np.asarray(leaf))


def test_trainable_rbf_gradients_match_jax():
    """The energy's gradient reaches the basis parameters and matches JAX's
    at 1e-4 of its scale (one backward pass, float32)."""
    kw = dict(trainable_rbf=True)
    params = _jax_params("trainable_rbf")
    jbatch, batch = _batches("edge")
    jmodel = JModel(JConfig(**SMALL, **kw), JHead(), layout="edge")
    jgrads = jax.jit(jax.grad(lambda p: jnp.sum(
        jmodel.apply(p, jbatch)["property"])))(params)
    cfg = GotenNetConfig(**SMALL, **kw)
    model = GotenModel(cfg, HeadConfig(), "edge", device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params, cfg,
                                                     HeadConfig()))
    model(batch)["property"].sum().backward()
    for f in ("means", "betas"):
        got = getattr(model.representation.radial_basis, f).grad.numpy()
        want = jgrads["params"]["representation"]["radial_basis"][f]
        assert np.abs(got).max() > 0
        _scaled(got, want, 1e-4, f)


# ---- which kernels a layer runs ------------------------------------------------
# name -> (options, whether the fused HTR kernel computes the update's
# grammar); every configuration asks for fused and fused_htr unless it says
# otherwise
PATH_CONFIGS = {
    "unfused": (dict(fused=False), True),
    "fused": (dict(fused_htr=False), True),
    "fused_htr": ({}, True),
    "gated": (dict(edge_updates="gated"), True),
    "gatedt": (dict(edge_updates="gatedt"), True),
    "act_norej": (dict(edge_updates="act_norej"), True),
    "norej": (dict(edge_updates="norej"), True),
    "mlp_edge_ln": (dict(edge_updates="mlp", edge_ln="layer"), False),
    "mlpa": (dict(edge_updates="mlpa"), False),
    "linw": (dict(edge_updates="linw"), False),
    "linw_evec": (dict(edge_updates="linw", evec_dim=16), False),
    "gated_postln": (dict(edge_updates="gated_postln"), False),
    "gatedt_mlpa_linw_ln": (dict(edge_updates="gatedt_mlpa_linw_ln"), False),
    "gated_linwa_postln_evec": (dict(edge_updates="gated_linwa_postln",
                                     evec_dim=16), False),
    "evec": (dict(evec_dim=16), False),
    # normalises to silu, so the config takes it with fused; the dense
    # layer's update takes it, the ELL one asks for the spelling "silu" or
    # "swish", as in the JAX package
    "SiLU": (dict(activation="SiLU"), True),
}
HALO = 64        # a 4,096-row table has a halo-windowed chunking with it
ROWS = [(64, None), (64, HALO), (4096, None), (4096, HALO)]


@pytest.mark.parametrize("layout", ["edge", "dense", "ell"])
@pytest.mark.parametrize("name", list(PATH_CONFIGS))
def test_kernel_paths_follow_the_rule_table(name, layout):
    """``kernel_paths`` for each layout, configuration and table (64 and
    4,096 rows, with and without a halo; fused_table_rows 2,048): the edge
    layout runs no kernel; the dense message is fused with ``fused``, the
    ELL one where its table is within fused_table_rows or has a chunking;
    the update with the fused message, ``fused_htr`` and a grammar the
    kernel computes, on the ELL layout with an activation spelt silu or
    swish.  A force head refuses training exactly where a kernel runs."""
    kw, grammar = PATH_CONFIGS[name]
    cfg = GotenNetConfig(**SMALL, **dict(dict(fused=True, fused_htr=True),
                                         **kw))
    assert cfg.fused_table_rows == 2048
    assert pick_chunking(4096, 4096, HALO, 2048) is not None
    force = HeadConfig(derivative=True)
    for N, halo in ROWS:
        if layout == "edge":
            want = (False, False)
        elif layout == "dense":
            want = (cfg.fused, cfg.fused and cfg.fused_htr and grammar)
        else:
            message = cfg.fused and (N <= 2048 or halo is not None)
            want = (message, message and cfg.fused_htr and grammar
                    and name != "SiLU")
        assert kernel_paths(cfg, layout, N, N, halo) == want, (N, halo)
        if layout != "ell":
            assert kernel_paths(cfg, layout) == want
        chunk = types.SimpleNamespace(nbr=torch.zeros(N, 4, dtype=torch.int32),
                                      gather_halo=halo)
        check_force_training(cfg, HeadConfig(), layout, [chunk])
        if any(want):
            with pytest.raises(ValueError, match="fused=False"):
                check_force_training(cfg, force, layout, [chunk])
        else:
            check_force_training(cfg, force, layout, [chunk])
