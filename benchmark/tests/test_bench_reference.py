"""The plain reference against the program, at a small size on the CPU
with float32 pairs, where the two must agree to float32 round-off: the
energies and forces of both layouts the cells run, and the first training
steps with the benchmark's attention keep masks."""


import numpy as np
import pytest
import torch

from bench_tiny import SEED
from harness import generators
from harness.weights import make_weights
from reference import model as ref
from reference import train as ref_train

M_CFG = dict(n_atom_basis=32, n_interactions=3, lmax=2, num_heads=4,
             n_rbf=16, cutoff=5.0, max_num_neighbors=8, max_z=100,
             sep_dir=True, sep_tensor=True, sep_htr=True, attn_dropout=0.1,
             head_hidden=32)


def port(fused, derivative):
    from gotennet_tpu_torch.models.gotennet import GotenNetConfig
    from gotennet_tpu_torch.models.model import GotenModel, HeadConfig
    cfg = GotenNetConfig(n_atom_basis=32, n_interactions=3, num_heads=4,
                         n_rbf=16, max_num_neighbors=8, attn_dropout=0.1,
                         fused=fused, remat=not fused)
    head = HeadConfig(n_hidden=32, mean=0.3, stddev=1.7,
                      derivative=derivative)
    return GotenModel(cfg, head, "dense", device="cpu")


def molecules(n=6):
    sizes = generators.balanced_sizes(n, 5, 14, SEED)
    return generators.synthetic_molecules(sizes, SEED, with_forces=True)


@pytest.mark.parametrize("fused", [False, True])
def test_energies_and_forces_agree(fused):
    from gotennet_tpu_torch.graph.dense_batch import collate_dense
    from gotennet_tpu_torch.models.model import apply_with_forces
    W = make_weights(M_CFG, SEED, "cpu", mean=0.3, stddev=1.7)
    mols = molecules()
    b = collate_dense([{"z": z, "pos": p} for z, p, _, _ in mols], 8, 16)
    model = port(fused, True)
    model.load_state_dict(W)
    out = apply_with_forces(model, b)
    e, f = ref.energy_forces(W, M_CFG, b.z, b.pos, b.mask)
    scale = e.abs().max()
    assert (out["property"][:, 0] - e).abs().max() <= 1e-5 * scale
    assert (out["forces"] - f).abs().max() <= 1e-5 * f.abs().max()


@pytest.mark.parametrize("accum", [1, 2])
def test_training_steps_agree_with_dropout(accum):
    """Three MSE steps on forces through the unfused path with remat, the
    keep masks drawn by the benchmark and handed to both; each step over
    ``accum`` accumulation chunks."""
    from gotennet_tpu_torch.graph.dense_batch import collate_dense
    from gotennet_tpu_torch.models import gotennet
    from gotennet_tpu_torch.tasks.force_task import MD22Task
    from gotennet_tpu_torch.train.optim import make_optimizer
    from gotennet_tpu_torch.train.trainer import make_loss_fn, train_step
    W = make_weights(M_CFG, SEED, "cpu", mean=0.3, stddev=1.7)
    model = port(False, True)
    model.load_state_dict(W)
    opt = make_optimizer(model.parameters(), 5e-3, 0.0, 5.0, 1e-7)
    task = {"kind": "force", "energy_weight": 0.05, "force_weight": 0.95}
    loss_fn = make_loss_fn(model, MD22Task("x", task_config={
        "task_loss": "MSELoss", "energy_weight": 0.05,
        "force_weight": 0.95}))
    gen = torch.Generator().manual_seed(3)
    masks = []

    def keep_mask(shape, rate, generator, device):
        k = torch.rand(tuple(shape), generator=gen) < 1.0 - rate
        masks.append(k)
        return k

    mols = molecules(12)
    steps, losses = [], []
    saved = gotennet.attention_keep_mask
    gotennet.attention_keep_mask = keep_mask
    try:
        for s in range(3):
            n = 4 // accum
            parts = [mols[4 * s + n * c:4 * s + n * c + n]
                     for c in range(accum)]
            chunks = [collate_dense([{"z": z, "pos": p, "y": [e], "dy": f}
                                     for z, p, e, f in part], n, 16,
                                    with_forces=True) for part in parts]
            masks.clear()
            losses.append(train_step(model, opt, chunks, 5.0,
                                     loss_fn=loss_fn))
            per = len(masks) // accum
            steps.append({"chunks": [
                {"mols": part, "M": 16, "keeps": masks[c * per:(c + 1) * per]}
                for c, part in enumerate(parts)]})
    finally:
        gotennet.attention_keep_mask = saved
    r = ref_train.train(W, M_CFG, task, {"lr": 5e-3, "eps": 1e-7,
                                         "weight_decay": 0.0,
                                         "grad_clip": 5.0}, steps, "cpu",
                        block=3)
    np.testing.assert_allclose(losses, r["losses"], rtol=1e-4)
    # leaves whose gradient is round-off (a key's bias under the softmax)
    # move under Adam by the sign of that round-off: left out, as the
    # benchmark's comparison leaves them out
    norms = {k: float(g.norm()) for k, g in r["grad1"].items()}
    floor = 1e-3 * float(np.median(list(norms.values())))
    moving = [k for k, v in norms.items() if v >= floor]
    assert len(moving) >= len(norms) - 8
    for k, p in model.named_parameters():
        if k in moving:
            got, want = p.detach() - W[k], r["change"][k]
            # Adam's step of an element with a near-zero gradient follows
            # its round-off: the leaf as a whole, not every element
            assert float((got - want).norm()) <= 1e-3 * float(want.norm()), k
