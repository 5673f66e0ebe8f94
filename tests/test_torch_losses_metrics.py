"""The port's remaining losses and metrics against the JAX package (CPU):
``WeightedSegmentationLoss`` (1e-5 relative), ``calculate_class_weights``
(exactly), ``SegmentationMetrics`` (1e-12) and its ``analysis`` import path,
and ``create_unet`` with the JAX signature (``encoder_weights``,
``image_size``), whose ImageNet encoder loads the same tensors as the JAX
``create_unet``.  Inputs are seeded numpy arrays at 32 px, 5 classes, B=2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_adversarial import few_torch_threads  # noqa: F401  (autouse)
from uda_aerial_semantic_segmentation_research_tpu import models as jax_models
from uda_aerial_semantic_segmentation_research_tpu.ops import losses as jax_losses
from uda_aerial_semantic_segmentation_research_tpu.ops import metrics as jax_metrics
from uda_aerial_semantic_segmentation_research_tpu_torch import analysis
from uda_aerial_semantic_segmentation_research_tpu_torch.analysis import metrics as analysis_metrics
from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
    create_unet,
    to_jax_state_dict,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops import losses, metrics

B, S, C = 2, 32, 5


def _logits_and_labels(seed, out_of_range=False):
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.normal(size=(B, S, S, C))).astype(np.float32)
    y = rng.integers(0, C, (B, S, S)).astype(np.int32)
    if out_of_range:
        y[0, :3, :3] = C          # an all-zero one-hot row in both packages
    return x, y


# ---------------------------------------------------------------------------
# WeightedSegmentationLoss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("alpha, gamma, reduction, domain_weight, weighted, out_of_range", [
    (0.25, 2.0, "mean", 1.0, False, False),
    (0.25, 2.0, "mean", 1.0, True, False),
    (0.5, 1.0, "sum", 0.3, True, False),
    (1.0, 0.0, "mean", 2.0, True, True),
    (0.25, 3.5, "sum", 1.0, False, True),
])
def test_weighted_segmentation_loss_matches_jax(alpha, gamma, reduction, domain_weight,
                                                weighted, out_of_range):
    x, y = _logits_and_labels(1, out_of_range)
    w = np.random.default_rng(2).uniform(0.2, 3.0, C).astype(np.float32) if weighted else None
    ref_fn = jax_losses.WeightedSegmentationLoss(C, class_weights=w, alpha=alpha, gamma=gamma,
                                                 reduction=reduction)
    fn = losses.WeightedSegmentationLoss(C, class_weights=w, alpha=alpha, gamma=gamma,
                                         reduction=reduction)
    ref = float(ref_fn(jnp.asarray(x), jnp.asarray(y), domain_weight=domain_weight))
    out = fn(torch.from_numpy(x), torch.from_numpy(y), domain_weight=domain_weight)
    assert out.shape == () and out.dtype == torch.float32
    assert abs(out.item() - ref) <= 1e-5 * abs(ref), (out.item(), ref)
    focal_ref = float(ref_fn.focal_loss(jnp.asarray(x), jnp.asarray(y)))
    focal = fn.focal_loss(torch.from_numpy(x), torch.from_numpy(y)).item()
    assert abs(focal - focal_ref) <= 1e-5 * abs(focal_ref), (focal, focal_ref)


def test_weighted_segmentation_loss_takes_bf16_logits_in_float32():
    """The focal term is computed in float32 from bf16 logits, as the JAX
    function casts them."""
    x, y = _logits_and_labels(3)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    fn = losses.WeightedSegmentationLoss(C)
    ref = float(jax_losses.WeightedSegmentationLoss(C)(
        jnp.asarray(xb.float().numpy()), jnp.asarray(y)))
    assert abs(fn(xb, torch.from_numpy(y)).item() - ref) <= 1e-5 * ref


# ---------------------------------------------------------------------------
# calculate_class_weights
# ---------------------------------------------------------------------------
class _Stats:
    class_stats = {0: 120, 1: 5, 2: 70000, 4: 1, 9: 33}      # class 3 absent, 9 out of range


def _masks(seed, as_torch):
    rng = np.random.default_rng(seed)
    items = []
    for _ in range(3):
        m = rng.choice(C, size=(S, S), p=[0.6, 0.25, 0.1, 0.05, 0.0]).astype(np.int64)
        items.append((np.zeros((S, S, 3), np.uint8), torch.from_numpy(m) if as_torch else m))
    return items


@pytest.mark.parametrize("method", ["effective_samples", "inverse_freq"])
@pytest.mark.parametrize("path", ["class_stats", "iteration", "iteration_torch"])
def test_calculate_class_weights_equals_jax(method, path):
    if path == "class_stats":
        ours = theirs = _Stats()
    else:
        ours = _masks(4, as_torch=path == "iteration_torch")
        theirs = _masks(4, as_torch=False)
    w = losses.calculate_class_weights(ours, C, method=method)
    ref = jax_losses.calculate_class_weights(theirs, C, method=method)
    assert w.dtype == np.float32 and w.shape == (C,)
    np.testing.assert_array_equal(w, ref)


# ---------------------------------------------------------------------------
# SegmentationMetrics
# ---------------------------------------------------------------------------
def _maps(seed):
    rng = np.random.default_rng(seed)
    pred = rng.integers(0, C, (B, S, S)).astype(np.int64)
    true = rng.integers(0, C - 1, (B, S, S)).astype(np.int64)   # class C-1 absent from truth
    pred[pred == 2] = 1                                          # class 2 absent from preds
    true[0, :4] = 255
    return pred, true


@pytest.mark.parametrize("ignore_index", [None, 255, 0])
@pytest.mark.parametrize("as_torch", [False, True])
def test_segmentation_metrics_match_jax(ignore_index, as_torch):
    pred, true = _maps(5)
    ref = jax_metrics.SegmentationMetrics(C, ignore_index=ignore_index)
    ours = metrics.SegmentationMetrics(C, ignore_index=ignore_index)
    p, t = (torch.from_numpy(pred), torch.from_numpy(true)) if as_torch else (pred, true)

    iou, iou_ref = ours.batch_iou(p, t), ref.batch_iou(pred, true)
    assert iou["mean_iou"] == pytest.approx(iou_ref["mean_iou"], rel=0, abs=1e-12)
    assert iou["class_iou"].keys() == iou_ref["class_iou"].keys()
    for k, v in iou_ref["class_iou"].items():
        assert iou["class_iou"][k] == pytest.approx(v, rel=0, abs=1e-12)
    assert ours.pixel_accuracy(p, t) == pytest.approx(ref.pixel_accuracy(pred, true),
                                                      rel=0, abs=1e-12)
    np.testing.assert_allclose(ours.f1_score(p, t), ref.f1_score(pred, true), rtol=0, atol=1e-12)
    for k in range(C):
        assert ours.f1_score(p, t, class_index=k) == pytest.approx(
            ref.f1_score(pred, true, class_index=k), rel=0, abs=1e-12)


def test_segmentation_metrics_with_no_class_present():
    pred = np.full((1, 4, 4), 255)
    ours = metrics.SegmentationMetrics(C)
    ref = jax_metrics.SegmentationMetrics(C)
    assert ours.batch_iou(pred, pred)["mean_iou"] == ref.batch_iou(pred, pred)["mean_iou"] == 0.0


def test_analysis_keeps_the_reference_import_path():
    assert analysis.SegmentationMetrics is metrics.SegmentationMetrics
    assert analysis_metrics.SegmentationMetrics is metrics.SegmentationMetrics
    assert analysis_metrics.confusion_matrix is metrics.confusion_matrix
    assert set(analysis_metrics.__all__) == {"SegmentationMetrics", "confusion_matrix",
                                             "iou_from_hist", "accuracy_from_hist"}


# ---------------------------------------------------------------------------
# create_unet with the JAX signature
# ---------------------------------------------------------------------------
def test_create_unet_takes_the_jax_signature_and_loads_the_same_encoder(tmp_path, monkeypatch):
    """The JAX call ``create_unet(encoder, "imagenet", in_channels, classes,
    activation, image_size)`` works positionally in the port, and a
    converted ``.npz`` gives the encoder the same tensors in both packages;
    without the file the port warns and keeps its seeded weights."""
    rng = np.random.default_rng(7)
    probe = jax_models.create_unet("resnet18", None, 3, C, None, S, dtype=jnp.float32)
    npz = {}
    for k, v in probe.state_dict().items():
        coll, rest = k.split("/", 1)
        if rest.startswith("encoder/"):
            key = rest[len("encoder/"):]
            npz[key if coll == "params" else f"batch_stats::{key}"] = (
                rng.normal(size=v.shape).astype(np.float32))
    path = tmp_path / "resnet18_imagenet.npz"
    np.savez(path, **npz)
    monkeypatch.setenv("UDA_TPU_IMAGENET_NPZ", str(path))

    bundle = jax_models.create_unet("resnet18", "imagenet", 3, C, None, S, dtype=jnp.float32)
    model = create_unet("resnet18", "imagenet", 3, C, None, S, dtype=torch.float32, device="cpu")
    assert model.classes == C and not model.training
    ours, theirs = to_jax_state_dict(model), bundle.state_dict()
    encoder = [k for k in theirs if "/encoder/" in k]
    assert len(encoder) == len(npz)
    for k in encoder:
        np.testing.assert_array_equal(ours[k], np.asarray(theirs[k]), err_msg=k)

    monkeypatch.setenv("UDA_TPU_IMAGENET_NPZ", str(tmp_path / "absent.npz"))
    with pytest.warns(UserWarning, match="randomly"):
        kept = create_unet(encoder_name="resnet18", encoder_weights="imagenet", in_channels=3,
                           classes=C, image_size=S, device="cpu")
    seeded = create_unet("resnet18", classes=C, device="cpu")
    for k, v in seeded.state_dict().items():
        assert torch.equal(kept.state_dict()[k], v), k
