"""The plain reference against the port at 64 px on the CPU, on the same
weights and tiles made from one seed.  The reference never imports the port;
this test does, to hold one against the other.

The port runs in float32 here (``dtype=torch.float32``, and ``WEAK`` with a
float32 pixel pipeline), so the two should agree to float32 round-off: any
larger gap is a difference of semantics (layer order, padding, BatchNorm,
the augmentation's draws and stages, the loss, Adam)."""

import dataclasses
import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench import check, inputs
from port_bench.kinds.train_epoch import batch_statistics
from port_bench.reference import augment as ref_augment
from port_bench.reference import serve as ref_serve
from port_bench.reference import train as ref_train
from port_bench.reference import unet
from uda_aerial_semantic_segmentation_research_tpu_torch.inference.predict import predict_batch
from uda_aerial_semantic_segmentation_research_tpu_torch.models import create_unet
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.augment import WEAK, augment_batch
from uda_aerial_semantic_segmentation_research_tpu_torch.training import steps
from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import TrainState, adam

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
TILE, BATCH, SEED = 64, 4, 2 ** 31 + 11
WEAK_F32 = dataclasses.replace(WEAK, compute_dtype="float32")


def config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def port_model(cfg, weights, dtype=torch.float32):
    model = create_unet(cfg["encoder_name"], classes=cfg["classes"], device="cpu", dtype=dtype)
    model.load_state_dict(weights)
    return model


@pytest.fixture(scope="module")
def tiles():
    images, masks = inputs.make_tiles(SEED, 3 * BATCH, TILE, 23, "cpu")
    return torch.from_numpy(images), torch.from_numpy(masks)


@pytest.mark.parametrize("name", ["unet_resnet34", "unet_resnet50"])
def test_weight_tree_is_the_port_tree(name):
    cfg = config(name)
    model = create_unet(cfg["encoder_name"], classes=cfg["classes"], device="cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        n: tuple(s) for n, s, _ in unet.weight_spec(cfg)}


def test_augmentation_matches_draw_for_draw(tiles):
    images, masks = tiles
    x_p, m_p = augment_batch(torch.Generator().manual_seed(7), images[:BATCH],
                             masks[:BATCH], cfg=WEAK_F32)
    x_r, m_r = ref_augment.augment(torch.Generator().manual_seed(7), images[:BATCH],
                                   masks[:BATCH], ref_augment.AugmentConfig(
                                       **{**dataclasses.asdict(ref_augment.WEAK),
                                          "compute_dtype": "float32"}))
    assert torch.equal(m_p, m_r)
    torch.testing.assert_close(x_r, x_p, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["unet_resnet34", "unet_resnet50"])
def test_eval_forward_and_labels(name, tiles):
    cfg = config(name)
    weights = inputs.make_weights(unet.weight_spec(cfg), SEED, "cpu")
    model = port_model(cfg, weights)
    images = tiles[0][:BATCH]
    ref = ref_serve.logits(functools.partial(unet.Net, cfg), weights, images)
    with torch.no_grad():
        ours = model(ref_augment.normalize(ref_augment.dequantize(images)))
    torch.testing.assert_close(ours, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()))
    labels = predict_batch(model, images.numpy(), device="cpu")
    assert ref_serve.widest_gap(ref, labels) <= 1e-4 * float(ref.abs().max())


@pytest.mark.parametrize("name", ["unet_resnet34", "unet_resnet50"])
def test_three_train_steps(name, tiles, monkeypatch):
    """Augmentation, train-mode forward, CE, gradients and Adam over three
    steps, and the metrics the trainer reads back."""
    cfg = config(name)
    weights = inputs.make_weights(unet.weight_spec(cfg), SEED, "cpu")
    model = port_model(cfg, weights)
    step = steps.make_supervised_train_step(model, cfg["classes"], aug_cfg=WEAK_F32)
    state = TrainState(model, adam(1e-4))
    images, masks = tiles
    batches = [(images[i * BATCH:(i + 1) * BATCH], masks[i * BATCH:(i + 1) * BATCH])
               for i in range(3)]
    g = torch.Generator().manual_seed(3)
    losses, grad1 = [], None
    for x, m in batches:
        state, metrics = step(state, g, x, m)
        losses.append(float(metrics["loss"]))
        if grad1 is None:
            grad1 = {k: float(p.grad.norm()) for k, p in model.named_parameters()}
            stats1 = batch_statistics(model, weights)
    ref_cfg = ref_augment.AugmentConfig(**{**dataclasses.asdict(ref_augment.WEAK),
                                           "compute_dtype": "float32"})
    monkeypatch.setattr(ref_train, "augment",
                        lambda gen, x, m: ref_augment.augment(gen, x, m, ref_cfg))
    g = torch.Generator().manual_seed(3)
    ref = ref_train.follow(functools.partial(unet.Net, cfg), weights, batches, [g, g, g],
                          1e-4, remat=False)
    # step 1 to round-off; Adam's first update moves every weight by about
    # lr whatever the size of its gradient, so weights whose gradient is
    # round-off on both sides move apart by up to 2 lr: steps 2 and 3 agree
    # to 1e-4
    np.testing.assert_allclose(losses[:1], ref["loss"][:1], rtol=2e-6)
    np.testing.assert_allclose(losses, ref["loss"], rtol=1e-4)
    change = {k: float((p.detach() - weights[k]).norm()) for k, p in model.named_parameters()}
    numbers = check.training_numbers({"loss": losses, "grad1": grad1, "change": change,
                                      "stats1": stats1}, ref)
    # the port's batch variance is E[x^2] - mean^2 in float32 (the flax
    # formula), the reference's is the two-pass one: leaf gradients agree to
    # 7e-4 at these shapes; the change after three Adam steps carries the
    # sign noise above (6e-3)
    assert numbers["grad_gap"] < 3e-3
    assert numbers["change_gap"] < 2e-2
    assert numbers["stats_gap"] < 1e-4
