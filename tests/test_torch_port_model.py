"""The PyTorch port's dense GotenModel against the JAX package's.

One JAX init, carried across by ``state_dict_from_jax_params``; the same
synthetic molecules go through both.  The port runs on the CPU, where
its fused message falls to the plain version of the kernel.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from gotennet_tpu.data.dataset import DenseLoader as JDenseLoader
from gotennet_tpu.data.dataset import synthetic_molecules as j_synthetic
from gotennet_tpu.models.gotennet import GotenNetConfig as JConfig
from gotennet_tpu.models.model import GotenModel as JModel
from gotennet_tpu.models.model import HeadConfig as JHead

from gotennet_tpu_torch.data.dataset import DenseLoader
from gotennet_tpu_torch.data.dataset import synthetic_molecules
from gotennet_tpu_torch.models.gotennet import GotenNetConfig
from gotennet_tpu_torch.models.model import GotenModel, HeadConfig
from gotennet_tpu_torch.utils.convert import state_dict_from_jax_params

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SMALL = dict(n_atom_basis=32, n_interactions=2, lmax=2, num_heads=4,
             n_rbf=8)


def _atomref():
    return np.random.default_rng(7).standard_normal((100, 1)).astype(
        np.float32)


def build_pair(jax_kw, port_kw, head_kw, batch_size=3, n_mols=3, seed=3,
               min_atoms=5, max_atoms=14, jax_seed=0):
    """(jax model, params, jax batch, port model, port batch)."""
    jhead = JHead(**head_kw)
    jds = j_synthetic(n_mols, seed=seed, min_atoms=min_atoms,
                      max_atoms=max_atoms)
    jbatch = next(iter(JDenseLoader(jds, batch_size=batch_size)))
    # the XLA path (fused=False): the same math as the port's fused one;
    # the kernel itself is held against the Pallas kernel in
    # test_torch_port_kernel.py
    jmodel = JModel(JConfig(**SMALL, **jax_kw), jhead, layout="dense")
    params = jmodel.init(jax.random.PRNGKey(jax_seed), jbatch)

    pcfg = GotenNetConfig(**SMALL, **port_kw)
    phead = HeadConfig(**head_kw)
    model = GotenModel(pcfg, phead, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params, pcfg, phead))
    ds = synthetic_molecules(n_mols, seed=seed, min_atoms=min_atoms,
                             max_atoms=max_atoms)
    batch = next(iter(DenseLoader(ds, batch_size=batch_size)))
    return jmodel, params, jbatch, model, batch


def _compare(jout, pout, tol):
    """Max abs error of each output within ``tol`` x its largest
    magnitude."""
    for key in ("property", "representation", "vector_representation"):
        want = np.asarray(jout[key], np.float32)
        got = pout[key].detach().numpy()
        assert got.shape == want.shape, key
        err = np.abs(got - want).max()
        assert err <= tol * np.abs(want).max(), (key, err)


# f32: the same math in both frameworks, only the order of the sums
# differs -> 1e-5 of the output's scale.
# bf16 pair/node types: both round at the same cast points, but XLA and
# torch fuse bf16 elementwise chains differently (XLA on the CPU keeps
# some chains in f32 before one final rounding), so single values differ
# by a few bf16 ulps (2^-8 relative each) that the layers carry on:
# measured ~5e-3 of the scale, held to a loose, stated 2e-2.
@pytest.mark.parametrize("dtypes,sep,cap,tol", [
    ("f32", True, 32, 1e-5),
    ("f32", False, 3, 1e-5),
    ("bf16", True, 32, 2e-2),
])
def test_dense_model_matches_jax(dtypes, sep, cap, tol):
    kw = dict(sep_dir=sep, sep_tensor=sep, sep_htr=sep,
              max_num_neighbors=cap, merge_proj=True)
    jkw, pkw = dict(kw), dict(kw)
    if dtypes == "bf16":
        jkw.update(pair_dtype=jnp.bfloat16, node_dtype=jnp.bfloat16)
        pkw.update(pair_dtype=torch.bfloat16, node_dtype=torch.bfloat16)
    head = dict(kind="atomwise", mean=0.3, stddev=1.7, atomref=_atomref(),
                activation="silu")
    jmodel, params, jbatch, model, batch = build_pair(jkw, pkw, head)
    jout = jmodel.apply(params, jbatch)
    with torch.inference_mode():
        pout = model(batch)
    _compare(jout, pout, tol)


def test_per_projection_path_matches_jax():
    """merge_proj=False (one product per projection) in f32."""
    kw = dict(merge_proj=False, scale_edge=True, radial_basis="GaussianRBF")
    head = dict(kind="atomwise", activation="silu")
    jmodel, params, jbatch, model, batch = build_pair(kw, kw, head)
    jout = jmodel.apply(params, jbatch)
    with torch.inference_mode():
        pout = model(batch)
    _compare(jout, pout, 1e-5)

