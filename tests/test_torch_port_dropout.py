"""Attention dropout and remat in the port against the JAX package.

The random bits of the two packages cannot match, so each side is handed
the same keep masks: the JAX side through ``jax.random.bernoulli``
(patched here, for the fused layers' draw and for flax's ``Dropout`` on
the unfused ELL message), the port through its hook
``models.gotennet.attention_keep_mask``.  One JAX init (D = 32, 2 layers)
is carried across by ``state_dict_from_jax_params``.  Outputs must agree
at 1e-5 of their scale in float32 (the same arithmetic, sums in another
order) and parameter gradients at 5e-4 of each gradient's scale, the
tolerance the JAX package holds its own fused gradients to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gotennet_tpu.data.dataset import DenseLoader as JDenseLoader
from gotennet_tpu.data.dataset import ELLLoader as JELLLoader
from gotennet_tpu.data.dataset import synthetic_molecules as j_synthetic
from gotennet_tpu.models.gotennet import GotenNetConfig as JConfig
from gotennet_tpu.models.model import GotenModel as JModel
from gotennet_tpu.models.model import HeadConfig as JHead

from gotennet_tpu_torch.data.dataset import (DenseLoader, ELLLoader,
                                             synthetic_molecules)
from gotennet_tpu_torch.models import gotennet
from gotennet_tpu_torch.models.gotennet import GotenNetConfig
from gotennet_tpu_torch.models.model import GotenModel, HeadConfig
from gotennet_tpu_torch.utils.convert import state_dict_from_jax_params

SMALL = dict(n_atom_basis=32, n_interactions=2, lmax=2, num_heads=4,
             n_rbf=8)
RATE = 0.1
SIZES = dict(min_atoms=5, max_atoms=14)
FRAMES = dict(min_atoms=40, max_atoms=60, box=6.3)


def _batches(layout):
    if layout == "dense":
        return (next(iter(JDenseLoader(j_synthetic(4, seed=1, **SIZES), 4))),
                next(iter(DenseLoader(synthetic_molecules(4, seed=1, **SIZES),
                                      4))))
    kw = dict(neighbor_probe="full")
    return (next(iter(JELLLoader(j_synthetic(2, seed=1, **FRAMES), 2, **kw))),
            next(iter(ELLLoader(synthetic_molecules(2, seed=1, **FRAMES), 2,
                                **kw))))


def _masks(layout, batch, seed=0):
    if layout == "dense":
        G, M = batch.z.shape
        shape = (G, M, M, SMALL["num_heads"])
    else:
        shape = tuple(batch.nbr.shape) + (SMALL["num_heads"],)
    rng = np.random.default_rng(seed)
    return [rng.random(shape) < 1.0 - RATE
            for _ in range(SMALL["n_interactions"])]


def _assert_scaled(got, want, tol, name):
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (name, err)


# (layout, the port's fused, JAX's fused): the port's dense layout has
# only the fused message, held against both of JAX's (the unfused one
# applies flax's Dropout to the attention, the fused one folds the mask
# into the scale)
@pytest.mark.parametrize("layout,fused,jax_fused", [
    ("dense", True, True), ("dense", True, False), ("ell", True, True),
    ("ell", False, False)])
def test_dropout_matches_jax_with_the_same_mask(monkeypatch, layout, fused,
                                                jax_fused):
    jbatch, batch = _batches(layout)
    masks = _masks(layout, batch)
    jmodel = JModel(JConfig(**SMALL, attn_dropout=RATE, fused=jax_fused,
                            remat=False), JHead(), layout=layout)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jbatch)

    queue = list(masks)

    def bernoulli(key, p=0.5, shape=None):
        mask = queue.pop(0)
        assert p == pytest.approx(1.0 - RATE) and tuple(shape) == mask.shape
        return jnp.asarray(mask)

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)

    def energy(p):
        out = jmodel.apply(p, jbatch, deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(1)})
        return jnp.sum(out["property"]), out["property"]

    # traced once: one patched draw a layer
    (_, want), jgrads = jax.jit(jax.value_and_grad(energy, has_aux=True))(
        params)
    assert not queue  # one mask a layer, each used once

    cfg = GotenNetConfig(**SMALL, attn_dropout=RATE, fused=fused)
    head = HeadConfig()
    model = GotenModel(cfg, head, layout, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params, cfg, head))
    queue = list(masks)
    monkeypatch.setattr(gotennet, "attention_keep_mask",
                        lambda shape, rate, gen, dev: torch.from_numpy(
                            queue.pop(0)))
    model.train()
    got = model(batch)["property"]
    got.sum().backward()
    assert not queue
    _assert_scaled(got.detach().numpy(), np.asarray(want), 1e-5, "property")
    # without the masks the answer differs: the masks were applied
    model.eval()
    with torch.no_grad():
        assert not np.allclose(model(batch)["property"].numpy(),
                               np.asarray(want), rtol=1e-4)
    want_g = state_dict_from_jax_params(jax.device_get(jgrads), cfg, head)
    for name, p in model.named_parameters():
        if p.grad is not None:
            _assert_scaled(p.grad.numpy(), want_g[name].numpy(), 5e-4, name)


def test_keep_rate_over_a_large_draw():
    gen = torch.Generator().manual_seed(0)
    keep = gotennet.attention_keep_mask((1000, 1000), RATE, gen,
                                        torch.device("cpu"))
    assert keep.dtype == torch.bool
    # the mean of 10^6 Bernoulli(0.9) draws: standard deviation 3e-4
    assert abs(keep.float().mean().item() - (1.0 - RATE)) < 2e-3


@pytest.mark.parametrize("layout", ["dense", "ell"])
def test_eval_mode_draws_no_mask(monkeypatch, layout):
    _, batch = _batches(layout)
    model = GotenModel(GotenNetConfig(**SMALL, attn_dropout=RATE),
                       HeadConfig(), layout, device="cpu")
    state = model.dropout_generator.get_state()

    def refuse(*args):
        raise AssertionError("a mask was drawn in eval mode")

    monkeypatch.setattr(gotennet, "attention_keep_mask", refuse)
    model.eval()
    model(batch)["property"].sum().backward()   # autograd on, still eval
    assert torch.equal(model.dropout_generator.get_state(), state)
    model.train()
    with pytest.raises(AssertionError, match="eval mode"):
        model(batch)


def test_a_reseeded_generator_gives_the_same_mask():
    cfg = GotenNetConfig(**SMALL, attn_dropout=RATE)
    gen = torch.Generator()
    draws = []
    for _ in range(2):
        gen.manual_seed(7)
        draws.append(gotennet.keep_masks(cfg, True, (3, 5, 5, 4), gen,
                                         torch.device("cpu")))
    assert len(draws[0]) == cfg.n_interactions
    assert all(torch.equal(a, b) for a, b in zip(*draws))
    assert not torch.equal(draws[0][0], draws[0][1])   # a mask a layer
    assert gotennet.keep_masks(cfg, False, (3, 5, 5, 4), gen,
                               torch.device("cpu")) == [None, None]


@pytest.mark.parametrize("layout", ["dense", "ell"])
def test_remat_gradients_equal_the_plain_ones_bit_for_bit(layout):
    """Each layer recomputed in the backward pass (torch.utils.checkpoint)
    gives the same gradients to the bit, dropout on: the masks are drawn
    outside the recomputed layer.  On one CPU thread: the ELL backward's
    scatter-adds (gathers' index_put with accumulate) split over several
    threads sum in no fixed order, remat or not."""
    _, batch = _batches(layout)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        grads = _grads_with_and_without_remat(layout, batch)
    finally:
        torch.set_num_threads(threads)
    assert grads[0].keys() == grads[1].keys() and grads[0]
    for name in grads[0]:
        assert torch.equal(grads[0][name], grads[1][name]), name


def _grads_with_and_without_remat(layout, batch):
    grads = []
    for remat in (True, False):
        model = GotenModel(GotenNetConfig(**SMALL, attn_dropout=RATE,
                                          remat=remat),
                           HeadConfig(), layout, device="cpu", seed=3)
        model.train()
        model(batch)["property"].sum().backward()
        grads.append({n: p.grad for n, p in model.named_parameters()
                      if p.grad is not None})
    return grads
