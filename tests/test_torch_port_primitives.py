"""The port's primitives against the JAX package's, on the same numpy
inputs: spherical harmonics, radial bases, the cosine cutoff, the
activation registry, and Dense/MLP with converted flax weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gotennet_tpu.nn.dense import MLP as JMLP
from gotennet_tpu.nn.dense import Dense as JDense
from gotennet_tpu.ops import activations as j_act
from gotennet_tpu.ops.cutoffs import cosine_cutoff as j_cutoff
from gotennet_tpu.ops.rbf import get_rbf as j_get_rbf
from gotennet_tpu.ops.spherical import spherical_harmonics as j_sh

from gotennet_tpu_torch.nn.dense import MLP, Dense
from gotennet_tpu_torch.ops import activations
from gotennet_tpu_torch.ops.cutoffs import cosine_cutoff
from gotennet_tpu_torch.ops.rbf import get_rbf
from gotennet_tpu_torch.ops.spherical import degree_slices, spherical_harmonics

RNG = np.random.default_rng(0)


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("lmax", [1, 2, 3, 4])
def test_spherical_harmonics(lmax):
    vec = RNG.standard_normal((50, 3)).astype(np.float32)
    vec /= np.linalg.norm(vec, axis=1, keepdims=True)
    vec[0] = 0.0                                   # self-loop -> zeros
    got = spherical_harmonics(torch.from_numpy(vec), lmax)
    _close(got, j_sh(jnp.asarray(vec), lmax))
    assert torch.all(got[0] == 0)
    assert degree_slices(lmax)[-1][1] == got.shape[-1]


@pytest.mark.parametrize("name", ["expnorm", "BesselBasis", "GaussianRBF"])
def test_radial_bases(name):
    r = np.concatenate([[0.0], RNG.random(40) * 6.0]).astype(np.float32)
    params, fn = j_get_rbf(name, 16, 5.0)
    _close(get_rbf(name, 16, 5.0)(torch.from_numpy(r)),
           fn(jnp.asarray(r), params), rtol=1e-5, atol=1e-5)


def test_cosine_cutoff():
    r = (RNG.random(64) * 7.0).astype(np.float32)
    _close(cosine_cutoff(torch.from_numpy(r), 5.0), j_cutoff(jnp.asarray(r),
                                                             5.0))


@pytest.mark.parametrize("name", sorted(activations._ACTIVATIONS))
def test_activations(name):
    x = (RNG.standard_normal(64) * 3).astype(np.float32)
    _close(activations.get_activation(name)(torch.from_numpy(x)),
           j_act.get_activation(name)(jnp.asarray(x)), rtol=1e-5, atol=1e-6)
    assert activations.is_silu_like(name) == j_act.is_silu_like(name)


def _load_dense(port: Dense, flax_params):
    p = flax_params["linear"]
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.array(p["kernel"]).T))
        if port.bias is not None:
            port.bias.copy_(torch.from_numpy(np.array(p["bias"])))
        if port.norm is not None:
            port.norm.weight.copy_(torch.from_numpy(
                np.asarray(flax_params["norm"]["scale"])))
            port.norm.bias.copy_(torch.from_numpy(
                np.asarray(flax_params["norm"]["bias"])))


# f32 within 1e-5; bf16 compute type: the same operations rounded to
# bf16 in both frameworks, held to 1e-2 (a couple of bf16 ulps)
@pytest.mark.parametrize("dtype,norm,bias,tol", [
    ("f32", "", True, 1e-5), ("f32", "layer", True, 1e-5),
    ("f32", "", False, 1e-5), ("bf16", "", True, 1e-2)])
def test_dense_matches_flax(dtype, norm, bias, tol):
    x = RNG.standard_normal((6, 24)).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bf16" else None
    td = torch.bfloat16 if dtype == "bf16" else None
    jm = JDense(16, use_bias=bias, activation=jax.nn.silu, norm=norm,
                dtype=jd)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(1), x)["params"])
    if bias:   # non-zero biases make the check meaningful
        params["linear"]["bias"] = RNG.standard_normal(16).astype(np.float32)
    port = Dense(24, 16, use_bias=bias, activation=torch.nn.functional.silu,
                 norm=norm, dtype=td)
    _load_dense(port, params)
    want = np.asarray(jm.apply({"params": params}, x), np.float32)
    got = port(torch.from_numpy(x)).float().detach().numpy()
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_mlp_matches_flax_and_seeded_init_is_deterministic():
    x = RNG.standard_normal((5, 12)).astype(np.float32)
    jm = JMLP([12, 20, 8], activation=jax.nn.silu, norm="layer")
    params = jm.init(jax.random.PRNGKey(2), x)["params"]
    port = MLP([12, 20, 8], activation=torch.nn.functional.silu,
               norm="layer")
    for i, layer in enumerate(port.dense_layers):
        _load_dense(layer, params[f"layers_{i}"])
    _close(port(torch.from_numpy(x)).detach(), jm.apply({"params": params},
                                                        x))
    a, b = MLP([12, 20, 8]), MLP([12, 20, 8])
    for m in (a, b):
        for layer in m.dense_layers:
            layer.reset_parameters(torch.Generator().manual_seed(3))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    bound = np.sqrt(6.0 / (12 + 20))
    w = a.dense_layers[0].weight
    assert w.abs().max() <= bound and w.std() > bound / 3
