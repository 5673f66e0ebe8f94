"""The port's serving path against the JAX package (CPU).

``make_predict_step``, ``predict_batch`` and ``predict_raster`` of the
port (``fused_eval=True``) vs the JAX package's counterparts on
``Unet(packed_decoder=True, pallas_eval=True)`` with the same weights.
Logits agree to 2e-4; label maps must be equal wherever the JAX logits'
top-2 margin is above 1e-3 (a closer call may flip within the
tolerance).  Also the normalization and tiling copies.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_adversarial import few_torch_threads  # noqa: F401  (autouse)
from tests.test_torch_models import (
    CLASSES,
    SIZE,
    images,
    jax_variables,
    port_unet,
    random_variables,
)
from uda_aerial_semantic_segmentation_research_tpu.data import tiling as jax_tiling
from uda_aerial_semantic_segmentation_research_tpu.inference import predict as jax_predict
from uda_aerial_semantic_segmentation_research_tpu.models.bundle import ModelBundle
from uda_aerial_semantic_segmentation_research_tpu.models.unet import Unet as JaxUnet
from uda_aerial_semantic_segmentation_research_tpu.ops import augment as jax_augment
from uda_aerial_semantic_segmentation_research_tpu.training.steps import (
    make_predict_step as jax_make_predict_step,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.data import tiling
from uda_aerial_semantic_segmentation_research_tpu_torch.inference.predict import (
    predict_batch,
    predict_raster,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.augment import (
    NONE,
    denormalize_images,
    normalize_images,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import (
    TrainState,
    adam,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.training.steps import (
    make_predict_step,
    make_supervised_train_step,
)

TOL = 2e-4
MARGIN = 1e-3


@pytest.fixture(scope="module")
def models():
    module = JaxUnet("resnet18", classes=CLASSES, dtype=jnp.float32,
                     packed_decoder=True, pallas_eval=True)
    flat = random_variables(module, jnp.zeros((1, SIZE, SIZE, 3), jnp.float32), seed=11)
    bundle = ModelBundle(module, jax_variables(flat))
    return bundle, port_unet(flat, fused_eval=True)


def _assert_labels_agree(pred, ref_logits):
    top2 = np.sort(ref_logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > MARGIN
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(pred[clear], ref_logits.argmax(-1)[clear])


def test_predict_step_matches_jax(models):
    bundle, model = models
    x = images(20)
    ref = jax_make_predict_step(bundle.module)(bundle.params, bundle.batch_stats, x)
    out = make_predict_step(model)(x)
    assert out.dtype == torch.float32 and tuple(out.shape) == (2, SIZE, SIZE, CLASSES)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("layout", ["nhwc_uint8", "nchw_uint8", "nhwc_float"])
def test_predict_batch_matches_jax(models, layout):
    bundle, model = models
    x = images(21)
    logits = np.asarray(bundle(jax_augment.normalize_images(jnp.asarray(x))))
    if layout == "nchw_uint8":
        x = np.transpose(x, (0, 3, 1, 2))
    elif layout == "nhwc_float":
        x = np.asarray(jax_augment.normalize_images(jnp.asarray(x)))
    ref = jax_predict.predict_batch(bundle, x)
    pred = predict_batch(model, x, device="cpu")
    assert pred.shape == ref.shape and pred.dtype == np.int32
    _assert_labels_agree(pred, logits)


def test_predict_batch_runs_the_model_in_eval_mode_after_a_train_step(models):
    """A train step leaves the model in train mode; ``predict_batch`` still
    predicts with the running BatchNorm statistics (as the JAX package's
    ``ModelBundle`` always does) and leaves them unchanged."""
    model = copy.deepcopy(models[1])
    masks = np.random.default_rng(31).integers(0, CLASSES, (2, SIZE, SIZE)).astype(np.uint8)
    step = make_supervised_train_step(model, CLASSES, aug_cfg=NONE)
    step(TrainState(model, adam(1e-3)), None, images(30), masks)
    assert model.training
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    x = images(32)
    pred = predict_batch(model, x, device="cpu")
    assert not model.training
    for k, v in model.named_buffers():
        assert torch.equal(v, buffers[k]), k
    eval_labels = make_predict_step(model)(x).argmax(-1).to(torch.int32).numpy()
    np.testing.assert_array_equal(pred, eval_labels)
    # what train mode would have predicted: other labels (batch statistics)
    model.train()
    with torch.no_grad():
        train_labels = model(normalize_images(torch.from_numpy(x))).argmax(-1).numpy()
    assert (train_labels != eval_labels).mean() > 0.05


def test_predict_raster_matches_jax(models):
    bundle, model = models
    raster = np.random.default_rng(22).integers(0, 255, (70, 90, 3)).astype(np.uint8)
    ref = jax_predict.predict_raster(bundle, raster, tile=SIZE, overlap=8, batch_size=2)
    pred = predict_raster(model, raster, tile=SIZE, overlap=8, batch_size=2, device="cpu")
    assert pred.shape == ref.shape == (70, 90) and pred.dtype == np.int32
    # the reference's stitched logits, for the margin
    tiles, origins, hw = jax_tiling.tile_image(raster, SIZE, 8)
    logits = np.concatenate([
        np.asarray(bundle(jax_augment.normalize_images(jnp.asarray(tiles[i:i + 2]))))
        for i in range(0, len(tiles), 2)])
    full = jax_tiling.stitch_tiles(logits, origins, hw)[:70, :90]
    np.testing.assert_array_equal(ref, full.argmax(-1))
    _assert_labels_agree(pred, full)


def test_predict_raster_rejects_paths(models, tmp_path):
    """A path is read with cv2 (tests/test_torch_inference.py holds it against
    the array input); one that names no readable image is refused."""
    with pytest.raises(ValueError, match="Failed to load image"):
        predict_raster(models[1], str(tmp_path / "image.png"), device="cpu")


def test_predict_batch_without_device_raises_without_cuda(models, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        predict_batch(models[1], images(0))


# ---------------------------------------------------------------------------
# normalization and tiling copies
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_normalize_matches_jax(dtype):
    x = images(23).astype(dtype)
    if dtype == np.float32:
        x = x / 255.0
    ref = np.asarray(jax_augment.normalize_images(jnp.asarray(x)))
    out = normalize_images(torch.from_numpy(np.asarray(x)))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=1e-6)
    back = denormalize_images(out).numpy()
    np.testing.assert_allclose(back, np.asarray(jax_augment.denormalize_images(ref)),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("hw, tile, overlap", [((70, 90), 32, 8), ((20, 50), 32, 0),
                                               ((512, 700), 256, 64)])
def test_tiling_matches_jax(hw, tile, overlap):
    rng = np.random.default_rng(24)
    raster = rng.integers(0, 255, hw + (3,)).astype(np.uint8)
    assert tiling.tile_grid(*hw, tile, overlap) == jax_tiling.tile_grid(*hw, tile, overlap)
    t, o, phw = tiling.tile_image(raster, tile, overlap)
    tj, oj, phwj = jax_tiling.tile_image(raster, tile, overlap)
    np.testing.assert_array_equal(t, tj)
    assert o == oj and phw == phwj
    logits = rng.normal(size=t.shape[:3] + (5,)).astype(np.float32)
    np.testing.assert_array_equal(tiling.stitch_tiles(logits, o, phw),
                                  jax_tiling.stitch_tiles(logits, oj, phwj))
    labels = rng.integers(0, 5, t.shape[:3])
    np.testing.assert_array_equal(tiling.stitch_tiles(labels, o, phw),
                                  jax_tiling.stitch_tiles(labels, oj, phwj))


def test_tile_grid_rejects_overlap_not_below_tile():
    with pytest.raises(ValueError):
        tiling.tile_grid(64, 64, 32, 32)
