"""The ELL model in the grammar of the benchmark's ``large_ell``
configuration (``benchmark/configs/large_ell.json``) against the
benchmark's plain reference (``benchmark/reference/``), on the CPU at a
small width: seeded random weights at 32 channels, 4 heads, lmax 2 and 4
layers; 3 frames of 80-120 atoms at condensed-phase density (box 6.3),
their neighbour cap cut to 8 so that it binds; the frames spatially sorted
into 64-row gather windows by the program's ``ELLLoader``, as the
configuration's loader keys say.  On the CPU the fused ELL functions run
their plain versions.

- Energies through the fused message and HTR update and through the
  unfused paths, with float32 and with bfloat16 pairs.
- One accumulated training step (2 chunks) with attention dropout: the
  program's ``[N, K, H]`` keep masks go to the reference through the
  benchmark's slot-to-pair map (``traffic/ell_train_loop.py``
  ``pair_keeps``); the loss and the first gradient compared.
- The configuration's keys against the command line's composition of
  ``experiment=large_molecule``, except those its ``assumed`` names."""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import generators, port  # noqa: E402
from harness.registry import load_module  # noqa: E402
from harness.weights import make_weights  # noqa: E402
from reference import model as ref  # noqa: E402
from reference import train as ref_train  # noqa: E402

SEED = 2 ** 31 + 22
SIZES = (80, 101, 120)
CAP = 8
CONFIG = json.loads((BENCH / "configs/large_ell.json").read_text())
TRAFFIC = json.loads(
    (BENCH / "workloads/large_ell_train_b4x4.json").read_text())


def small_config(fused: bool, pair_dtype: str) -> dict:
    """The configuration at the test's width and neighbour cap, on the
    path asked for (``fused`` sets the message and the HTR update
    alike)."""
    cfg = json.loads(json.dumps(CONFIG))
    cfg["model"].update(n_atom_basis=32, num_heads=4, head_hidden=32,
                        max_num_neighbors=CAP)
    cfg["paths"]["train"].update(fused=fused, fused_htr=fused,
                                 pair_dtype=pair_dtype)
    return cfg


def frames():
    return generators.synthetic_molecules(SIZES, SEED, box=6.3)


def program(cfg: dict, batch_size: int):
    """The program's ELL model of ``cfg``'s train path with the benchmark's
    weights of the seed, and its loader of ``batch_size`` frames a batch
    over ``frames()``."""
    from gotennet_tpu_torch.data.dataset import ELLLoader
    from gotennet_tpu_torch.models.model import GotenModel
    weights = make_weights(cfg["model"], SEED, "cpu")
    model = GotenModel(port.model_config(cfg, "train"),
                       port.head_config(cfg, 0.0, 1.0), "ell", device="cpu")
    model.load_state_dict(weights)
    p = cfg["paths"]["train"]
    loader = ELLLoader(port.dataset(frames(), False), batch_size,
                       cutoff=cfg["model"]["cutoff"], max_num_neighbors=CAP,
                       spatial_sort=p["spatial_sort"],
                       block_rows=p["block_rows"],
                       neighbor_probe=p["neighbor_probe"])
    return model, weights, loader


def padded(n: int) -> int:
    return -(-n // 8) * 8


# float32 pairs: the two compute the same sums in another order (the
# reference over dense [M, M] blocks, the program over K slots), so they
# meet at float32 round-off of the energies' largest, 1e-5 of it.
# bfloat16 pairs: the program rounds its pair tensors to 8 bits of
# mantissa (relative 2^-8 = 0.4 % each) through 4 layers, the reference
# does not: 2e-2 of the largest energy, the bound the port's other bf16
# comparisons hold.
ENERGY_TOL = {"f32": 1e-5, "bf16": 2e-2}


@pytest.mark.parametrize("pair_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fused", [True, False])
def test_energies_agree(fused, pair_dtype):
    from gotennet_tpu_torch.models.gotennet import kernel_paths
    cfg = small_config(fused, pair_dtype)
    model, weights, loader = program(cfg, len(SIZES))
    (idx, batch), = loader.batches()
    assert batch.gather_window and batch.nbr.shape[1] == 12
    assert kernel_paths(model.cfg, "ell", batch.num_nodes, batch.num_nodes,
                        batch.gather_halo) == (fused, fused)
    with torch.no_grad():
        e = model(batch)["property"][:, 0]
    mols = [frames()[i] for i in idx]
    z, pos, mask, _, _ = ref_train.collate(mols, padded(max(SIZES)), "cpu")
    e_ref = ref.energy(weights, cfg["model"], z, pos, mask)
    gap = (e - e_ref).abs().max() / e_ref.abs().max()
    assert gap <= ENERGY_TOL[pair_dtype], float(gap)
    if pair_dtype == "f32":
        # the cap binds: the same frames with the cap lifted differ
        uncapped = dict(cfg["model"], max_num_neighbors=64)
        e_all = ref.energy(weights, uncapped, z, pos, mask)
        assert (e_all - e_ref).abs().max() > 100 * ENERGY_TOL["f32"] \
            * e_ref.abs().max()


# The first step's loss: float32 round-off, as the energies' (it reads
# below 1e-6).  The first gradient, as the optimizer gets it (after the
# clip), leaf by leaf: its largest element's gap over the larger of the
# leaf's largest element and the median leaf's.  The backward sums the
# chunks' slots in another order than the dense reference sums its pairs:
# float32 round-off again, which reads up to 1.2e-6 over 1 and 4 threads.
LOSS_TOL, GRAD_TOL = 1e-5, 1e-5


@pytest.mark.parametrize("fused", [True, False])
def test_accumulated_step_agrees_with_dropout(fused):
    """Two chunks (2 frames and 1) accumulated into one step, attention
    dropout on, float32 pairs: the reference takes the program's keep
    masks through the benchmark's slot-to-pair map."""
    from gotennet_tpu_torch.models import gotennet
    from gotennet_tpu_torch.train.optim import make_optimizer
    from gotennet_tpu_torch.train.trainer import make_loss_fn, train_step
    pair_keeps = load_module(BENCH / "traffic/ell_train_loop.py").pair_keeps
    cfg = small_config(fused, "f32")
    model, weights, loader = program(cfg, 2)
    o = cfg["optimizer"]
    opt = make_optimizer(model.parameters(), o["lr"], o["weight_decay"],
                         o["grad_clip"], o["eps"])
    chunks = list(loader.batches())
    assert len(chunks) == 2
    gen = torch.Generator().manual_seed(5)
    masks = []

    def keep_mask(shape, rate, generator, device):
        keep = torch.rand(tuple(shape), generator=gen) < 1.0 - rate
        masks.append(keep)
        return keep

    saved = gotennet.attention_keep_mask
    gotennet.attention_keep_mask = keep_mask
    try:
        loss = train_step(model, opt, [b for _, b in chunks], o["grad_clip"],
                          loss_fn=make_loss_fn(model, port.task(cfg)))
    finally:
        gotennet.attention_keep_mask = saved
    n = cfg["model"]["n_interactions"]
    assert len(masks) == 2 * n
    assert not all(bool(k.all()) for k in masks)
    pool = frames()
    steps = [{"chunks": []}]
    for c, (idx, batch) in enumerate(chunks):
        M = padded(max(SIZES[i] for i in idx))
        steps[0]["chunks"].append({
            "mols": [pool[i] for i in idx], "M": M,
            "keeps": pair_keeps(batch, masks[c * n:(c + 1) * n], len(idx),
                                M)})
    out = ref_train.train(weights, cfg["model"], cfg["task"], o, steps,
                          "cpu", block=1)
    assert abs(loss - out["losses"][0]) <= LOSS_TOL * abs(out["losses"][0])
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(out["grad1"])
    tops = {k: float(g.abs().max()) for k, g in out["grad1"].items()}
    med = float(np.median(list(tops.values())))
    for k, g in out["grad1"].items():
        gap = float((grads[k] - g).abs().max()) / max(tops[k], med)
        assert gap <= GRAD_TOL, (k, gap)


def test_keep_masks_map_slot_to_pair():
    """Each real slot's mask lands on (frame, its row's atom, its source's
    atom), the self-loop's on the diagonal; entries of no real slot are
    kept."""
    pair_keeps = load_module(BENCH / "traffic/ell_train_loop.py").pair_keeps
    _, _, loader = program(small_config(True, "f32"), len(SIZES))
    (idx, batch), = loader.batches()
    N, K = batch.nbr.shape
    keep = torch.rand((N, K, 4), generator=torch.Generator().manual_seed(1)
                      ) < 0.5
    dense, = pair_keeps(batch, [keep], len(idx), 120)
    nbr, real = batch.nbr.numpy(), batch.nbr_mask.numpy()
    atom, graph = batch.atom.numpy(), batch.node_graph.numpy()
    hit = np.zeros(dense.shape[:3], bool)
    for r, s in zip(*np.nonzero(real)):
        g, i, j = graph[r], atom[r], atom[nbr[r, s]]
        assert torch.equal(dense[g, i, j], keep[r, s])
        hit[g, i, j] = True
        if nbr[r, s] == r:
            assert i == j
    assert hit.sum() == real.sum()
    assert bool(dense[torch.from_numpy(~hit)].all())
    for g, i in enumerate(idx):
        n = SIZES[i]
        assert hit[g, np.arange(n), np.arange(n)].all()


def test_configuration_is_the_command_lines_composition():
    """``large_ell.json`` holds the model, optimizer, loader and step of
    ``cli``'s ``experiment=large_molecule``; ``fused_htr`` and the loss
    differ where its ``assumed`` says so."""
    from gotennet_tpu_torch import cli
    from gotennet_tpu_torch.utils.config import load_config
    comp = load_config(str(Path(cli.__file__).parent / "configs"),
                       overrides=["experiment=large_molecule"])
    composed = cli.model_config(comp)
    for key, value in CONFIG["model"].items():
        if key == "head_hidden":
            assert value == comp["model"]["output"]["n_hidden"]
        else:
            assert getattr(composed, key) == value, key
    for path in ("train", "serve"):
        ours = port.model_config(CONFIG, path)
        assert ours.fused_htr and not composed.fused_htr
        assert dataclasses.replace(ours, fused_htr=False) == composed
        p = CONFIG["paths"][path]
        assert p["layout"] == comp["model"]["layout"] == "ell"
        for key in ("spatial_sort", "block_rows", "neighbor_probe"):
            assert p[key] == comp["datamodule"][key], key
    assumed = " ".join(CONFIG["assumed"])
    assert "fused_htr true" in assumed
    for key in ("lr", "weight_decay", "grad_clip"):
        assert CONFIG["optimizer"][key] == comp["model"][key], key
    assert CONFIG["head"]["kind"] == "atomwise"
    assert CONFIG["head"]["standardize"] == comp["datamodule"]["standardize"]
    assert CONFIG["task"]["label"] == comp["label"]
    assert "task_loss" not in comp["model"]
    assert CONFIG["task"]["loss"] == "MSELoss" and "MSELoss" in assumed
    assert CONFIG["reduced"] == []
    pool = TRAFFIC["pool"]
    dm = comp["datamodule"]
    assert (pool["min_atoms"], pool["max_atoms"], pool["box"]) == (
        dm["min_atoms"], dm["max_atoms"], dm["box"])
    assert TRAFFIC["batch_size"] == dm["batch_size"]
    assert TRAFFIC["accum"] == comp["trainer"]["grad_accum_steps"]
