"""The port's checkpoints, event files, visualization, figures and timing
against the JAX package's (CPU).

- Checkpoints: each package loads a file the other wrote; a port model's
  ``model_state_dict`` (JAX layout) loaded into a JAX ``ModelBundle`` gives
  the port's logits within 2e-4 (the repo's torch-parity tolerance: float32
  on both sides, sums in another order); an interrupted write leaves the
  previous file intact.
- Event files: the port writes them without the ``tensorboard`` package;
  ``tensorboard``'s ``EventAccumulator`` (which checks every record's CRC)
  reads the same tags, steps, scalar values and histogram buckets from the
  port's file as from the JAX logger's for the same calls, and the images
  decode to the same pixels.
- ``visualization/utils`` is bit-identical to the JAX module; the curve
  arithmetic of ``visualization/figures`` matches sklearn to 1e-12 on
  random scores with ties.
"""

import collections
import pickle
import time
import warnings

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import sklearn.metrics as skm
import torch
from tensorboard.backend.event_processing import event_accumulator
from tensorboard.compat.tensorflow_stub.pywrap_tensorflow import masked_crc32c

from tests.test_torch_models import jax_variables, random_variables
from uda_aerial_semantic_segmentation_research_tpu.models.bundle import ModelBundle
from uda_aerial_semantic_segmentation_research_tpu.models.unet import Unet as JaxUnet
from uda_aerial_semantic_segmentation_research_tpu.utils import checkpoint as jax_checkpoint
from uda_aerial_semantic_segmentation_research_tpu.visualization import utils as jax_viz
from uda_aerial_semantic_segmentation_research_tpu.visualization.tensorboard_logger import (
    TensorboardLogger as JaxLogger,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
    create_unet,
    from_jax_state_dict,
    to_jax_state_dict,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.utils import checkpoint, profiling
from uda_aerial_semantic_segmentation_research_tpu_torch.visualization import figures
from uda_aerial_semantic_segmentation_research_tpu_torch.visualization import utils as viz
from uda_aerial_semantic_segmentation_research_tpu_torch.visualization import (
    tensorboard_logger as tb,
)

# module-level, so that pickle finds it (optimizer states are NamedTuples)
Moments = collections.namedtuple("Moments", ["mu", "nu"])
SIZE, CLASSES = 32, 7


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def test_checkpoints_load_in_both_packages(tmp_path):
    obj = {"epoch": 3, "params": {"a": np.arange(6, dtype=np.float32).reshape(2, 3)},
           "opt": Moments(mu=np.zeros(2), nu=[np.ones(1), 2.5]), "metrics": {"iou": 0.5}}
    port_file, jax_file = tmp_path / "port.pth", tmp_path / "jax.pth"
    checkpoint.save_checkpoint(
        dict(obj, t=torch.arange(4, dtype=torch.bfloat16).reshape(2, 2),
             moments=Moments(torch.ones(3), torch.zeros(3))), port_file)
    jax_checkpoint.save_checkpoint(
        dict(obj, t=jnp.arange(4, dtype=jnp.bfloat16).reshape(2, 2),
             moments=Moments(jnp.ones(3), jnp.zeros(3))), jax_file)
    loaded = [load(f) for f in (port_file, jax_file)
              for load in (checkpoint.load_checkpoint, jax_checkpoint.load_checkpoint)]
    for back in loaded:
        assert back["epoch"] == 3 and back["metrics"] == {"iou": 0.5}
        assert back["t"].dtype == np.float32 and isinstance(back["t"], np.ndarray)
        np.testing.assert_array_equal(back["t"], np.arange(4, dtype=np.float32).reshape(2, 2))
        assert isinstance(back["moments"], Moments)
        np.testing.assert_array_equal(back["moments"].mu, np.ones(3, np.float32))
        np.testing.assert_array_equal(back["opt"].nu[0], np.ones(1))
        np.testing.assert_array_equal(back["params"]["a"], obj["params"]["a"])
    # the same payload gives the same pickle
    assert pickle.dumps(loaded[0]) == pickle.dumps(loaded[2])


def test_port_model_state_dict_loads_into_a_jax_bundle(tmp_path):
    module = JaxUnet("resnet18", classes=CLASSES, dtype=jnp.float32)
    x = np.random.default_rng(1).normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    flat = random_variables(module, jnp.asarray(x), seed=4)
    model = create_unet("resnet18", classes=CLASSES, dtype=torch.float32, device="cpu")
    model.load_state_dict(from_jax_state_dict(flat), strict=True)
    path = tmp_path / "best_model.pth"
    checkpoint.save_checkpoint({"model_state_dict": to_jax_state_dict(model)}, path)

    blob = jax_checkpoint.load_checkpoint(path)
    scrambled = {k: np.zeros_like(v) for k, v in flat.items()}
    bundle = ModelBundle(module, jax_variables(scrambled))
    bundle.load_state_dict(blob["model_state_dict"], strict=True)
    ref = np.asarray(jax.jit(lambda v, x: module.apply(v, x, train=False))(
        bundle.variables, x))
    with torch.no_grad():
        logits = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(logits, ref, rtol=2e-4, atol=2e-4)

    # and a JAX bundle's state_dict back into the port, exactly
    jax_checkpoint.save_checkpoint({"model_state_dict": bundle.state_dict()},
                                   tmp_path / "jax.pth")
    other = create_unet("resnet18", classes=CLASSES, dtype=torch.float32, device="cpu", seed=9)
    other.load_state_dict(from_jax_state_dict(
        checkpoint.load_checkpoint(tmp_path / "jax.pth")["model_state_dict"]), strict=True)
    for k, v in to_jax_state_dict(other).items():
        np.testing.assert_array_equal(v, flat[k], err_msg=k)


def test_interrupted_write_keeps_the_previous_checkpoint(tmp_path, monkeypatch):
    path = tmp_path / "best_model.pth"
    checkpoint.save_checkpoint({"epoch": 1, "w": torch.ones(3)}, path)
    before = path.read_bytes()

    def dies_midway(obj, f, protocol):
        f.write(b"\x80\x04partial")
        raise KeyboardInterrupt

    monkeypatch.setattr(checkpoint.pickle, "dump", dies_midway)
    with pytest.raises(KeyboardInterrupt):
        checkpoint.save_checkpoint({"epoch": 2, "w": torch.zeros(3)}, path)
    assert path.read_bytes() == before
    assert sorted(p.name for p in tmp_path.iterdir()) == ["best_model.pth"]
    assert checkpoint.load_checkpoint(path)["epoch"] == 1


# ---------------------------------------------------------------------------
# event files
# ---------------------------------------------------------------------------
def _log_everything(logger, rng):
    logger.log_scalar("test/loss", 0.5, 1)
    logger.log_scalar("test/loss", np.float32(0.25), 2)
    logger.log_scalar("test/big_step", 3.0, 2 ** 40)
    logger.log_scalars("test/metrics", {"accuracy": 0.85, "precision": 0.78}, 1)
    logger.log_image("test/image_f32", rng.random((16, 12, 3)).astype(np.float32), 1)
    logger.log_image("test/image_chw", rng.random((3, 16, 16)).astype(np.float32), 1)
    logger.log_image("test/image_u8", rng.integers(0, 256, (9, 7, 3)).astype(np.uint8), 3)
    logger.log_image("test/batch", rng.normal(size=(2, 8, 8, 3)).astype(np.float32), 4)
    logger.log_image("test/label_map", rng.integers(0, 5, (16, 16)), 1)
    logger.log_histogram("test/hist", rng.normal(size=500), 1)
    logger.log_histogram("test/hist_bins", rng.random(100), 2, bins=7)
    logger.log_text("test/text", "hello, événement")
    logger.close()


def _accumulate(logger):
    time.sleep(0.1)
    (event_file,) = list(logger.log_dir.glob("events.out.tfevents.*"))
    ea = event_accumulator.EventAccumulator(str(event_file), size_guidance={
        event_accumulator.IMAGES: 0, event_accumulator.SCALARS: 0,
        event_accumulator.HISTOGRAMS: 0, event_accumulator.TENSORS: 0})
    ea.Reload()
    return ea, event_file


def test_event_files_read_back_like_the_jax_loggers(tmp_path):
    port = tb.TensorboardLogger(log_dir=str(tmp_path / "port"))
    jax_logger = JaxLogger(log_dir=str(tmp_path / "jax"))
    _log_everything(port, np.random.default_rng(0))
    _log_everything(jax_logger, np.random.default_rng(0))
    (pa, pfile), (ja, _) = _accumulate(port), _accumulate(jax_logger)
    ptags, jtags = pa.Tags(), ja.Tags()
    for kind in ("scalars", "images", "histograms", "tensors"):
        assert sorted(ptags[kind]) == sorted(jtags[kind]), kind
    assert len(ptags["scalars"]) == 4 and len(ptags["images"]) == 5
    for tag in ptags["scalars"]:
        assert ([(e.step, e.value) for e in pa.Scalars(tag)]
                == [(e.step, e.value) for e in ja.Scalars(tag)])
    for tag in ptags["histograms"]:
        for p, j in zip(pa.Histograms(tag), ja.Histograms(tag), strict=True):
            assert p.step == j.step and p.histogram_value == j.histogram_value
    for tag in ptags["images"]:
        for p, j in zip(pa.Images(tag), ja.Images(tag), strict=True):
            assert (p.step, p.width, p.height) == (j.step, j.width, j.height)
            decode = lambda s: cv2.imdecode(np.frombuffer(s, np.uint8), cv2.IMREAD_UNCHANGED)
            np.testing.assert_array_equal(decode(p.encoded_image_string),
                                          decode(j.encoded_image_string))
    for tag in ptags["tensors"]:
        (p,), (j,) = pa.Tensors(tag), ja.Tensors(tag)
        assert p.tensor_proto.string_val == j.tensor_proto.string_val
        assert p.tensor_proto.string_val == ["hello, événement".encode()]
    # the port's own reader: every CRC, the same steps and scalar values
    events = tb.read_events(pfile)
    assert events[0]["file_version"] == "brain.Event:2"
    scalars = [(e["step"], v["tag"], v["value"]) for e in events for v in e["values"]
               if v["kind"] == "scalar"]
    assert (2 ** 40, "test/big_step", 3.0) in scalars and (2, "test/loss", 0.25) in scalars
    # a flipped byte is caught
    data = bytearray(pfile.read_bytes())
    data[len(data) // 2] ^= 0x10
    pfile.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        tb.read_events(pfile)


def test_figures_are_logged_as_given_and_late_events_are_dropped(tmp_path):
    logger = tb.TensorboardLogger(log_dir=str(tmp_path))
    fig = figures.heatmap_image(np.arange(9).reshape(3, 3))
    logger.log_figure("fig/heatmap", fig, 5)
    with pytest.raises(ValueError, match="uint8"):
        logger.log_figure("fig/bad", fig.astype(np.float32), 5)
    logger.close()
    logger.log_scalar("late", 1.0, 6)                          # dropped, no error
    ea, event_file = _accumulate(logger)
    (img,) = ea.Images("fig/heatmap")
    decoded = cv2.cvtColor(cv2.imdecode(np.frombuffer(img.encoded_image_string, np.uint8),
                                        cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(decoded, fig)
    assert "late" not in ea.Tags()["scalars"]


@pytest.mark.parametrize("n", [0, 1, 9, 1000, 32767, 32768, 100_003, 1 << 20])
def test_crc32c_matches_tensorboards(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    assert tb.masked_crc32c(data) == masked_crc32c(data)
    assert tb.crc32c(b"123456789") == 0xE3069283


# ---------------------------------------------------------------------------
# visualization and figures
# ---------------------------------------------------------------------------
def test_visualization_utils_are_bit_identical_to_jax():
    rng = np.random.default_rng(3)
    for n in (1, 5, 8, 23, 40):
        np.testing.assert_array_equal(viz.class_colors(n), jax_viz.class_colors(n))
        np.testing.assert_array_equal(viz.class_colors(n, seed=4),
                                      jax_viz.class_colors(n, seed=4))
    mask = rng.integers(-2, 30, (12, 9))
    for n in (None, 7, 23):
        np.testing.assert_array_equal(viz.colorize_mask(mask, n), jax_viz.colorize_mask(mask, n))
    labels = rng.integers(0, 23, (12, 9))
    for image in (rng.integers(0, 256, (12, 9, 3)).astype(np.uint8),
                  rng.random((12, 9, 3)).astype(np.float32),
                  rng.random((3, 12, 9)).astype(np.float32),
                  (2 * rng.random((12, 9, 3)) - 0.5).astype(np.float32)):
        for alpha in (0.5, 0.3):
            a = viz.create_overlay(image, labels, alpha=alpha)
            b = jax_viz.create_overlay(image, labels, alpha=alpha)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", range(6))
def test_curves_match_sklearn(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 4000))
    y = rng.random(n) < rng.uniform(0.05, 0.95)
    y[:2] = [True, False]
    scores = np.round(rng.random(n), int(rng.integers(1, 4))).astype(np.float32)  # ties
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for ours, theirs in ((figures.roc_curve(y, scores), skm.roc_curve(y, scores)),
                             (figures.precision_recall_curve(y, scores),
                              skm.precision_recall_curve(y, scores))):
            for a, b in zip(ours, theirs, strict=True):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
        fpr, tpr, _ = skm.roc_curve(y, scores)
        assert abs(figures.auc(fpr, tpr) - skm.auc(fpr, tpr)) <= 1e-12
        assert abs(figures.auc(fpr[::-1], tpr[::-1]) - skm.auc(fpr[::-1], tpr[::-1])) <= 1e-12
        assert abs(figures.average_precision_score(y, scores)
                   - skm.average_precision_score(y, scores)) <= 1e-12
    with pytest.raises(ValueError, match="increasing"):
        figures.auc([0.0, 1.0, 0.5], [0.0, 1.0, 1.0])


def test_figures_draw_the_data():
    cm = np.zeros((4, 4), np.int64)
    cm[2, 1] = 50
    img = figures.heatmap_image(cm)
    assert img.shape == (figures.CANVAS_H, figures.CANVAS_W, 3) and img.dtype == np.uint8
    rows, cols = np.nonzero((img == (8, 48, 107)).all(-1))        # the full-scale blue
    side = min(img.shape[:2]) - 2 * figures._MARGIN
    top, left = (img.shape[0] - side) // 2, (img.shape[1] - side) // 2
    # the one filled cell is row 2 (true), column 1 (predicted)
    assert set((rows - top) * 4 // side) == {2} and set((cols - left) * 4 // side) == {1}
    color = (np.asarray(viz.class_colors(23)[5]) * 255).round().astype(np.uint8)
    plot = figures.curves_image([(5, [0.0, 1.0], [0.0, 1.0], 0.5)], 23, diagonal=False)
    assert (plot == color).all(-1).sum() > 1000         # a 2-pixel line across the box


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def test_step_timer_and_trace(tmp_path):
    timer = profiling.StepTimer(items_per_step=4, warmup=1)
    for seconds in (1.0, 0.010, 0.020, 0.030):
        timer.record(seconds)
    summary = timer.summary()
    assert summary["steps"] == 3 and summary["step_ms_p50"] == pytest.approx(20.0)
    assert summary["items_per_sec"] == pytest.approx(4 / 0.02)
    with timer.step(sync=torch.ones(2)):
        pass
    assert timer.summary()["steps"] == 4
    assert profiling.StepTimer().summary() == {"steps": 0}
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("span"):
            torch.ones(8).sum()
    assert list(tmp_path.glob("trace_*.json"))
