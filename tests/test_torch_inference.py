"""The rest of the port's inference and its data entry points against the JAX
package (CPU): ``predict_mask`` on every input form, ``create_colored_mask``
and ``create_overlay`` (uint8-exact), ``load_class_dict``, ``predict_raster``
from a file, ``test_model`` end to end, ``TiledRasterDataset``,
``prepare_holyrood_dataset``, ``verify_csv``, ``download_semantic_drone``'s
offline paths, and ``TensorboardLogger.log_model_graph``.

One set of seeded weights (resnet18 U-Net, 5 classes, float32, 32 px) goes
into both packages through ``from_jax_state_dict``.  ``predict_mask``
thresholds ``sigmoid(logits)`` at 0.5: its masks must agree outside the
band |p - 0.5| < 1e-4 of the JAX probabilities (float32 sums in another
order move a logit by ~1e-6); the band holds 0 to 6 of the 5,120 values of
a case here, and must hold under 1%.
"""

import sys
import tempfile
import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_adversarial import few_torch_threads  # noqa: F401  (autouse)
from tests.test_torch_models import jax_variables, random_variables
from uda_aerial_semantic_segmentation_research_tpu import config as jax_config
from uda_aerial_semantic_segmentation_research_tpu.data import (
    download_semantic_drone as jax_download,
    prepare_holyrood as jax_holyrood,
    tiling as jax_tiling,
    verify_csv as jax_verify_csv,
)
from uda_aerial_semantic_segmentation_research_tpu.inference import predict as jax_predict
from uda_aerial_semantic_segmentation_research_tpu.models.bundle import ModelBundle
from uda_aerial_semantic_segmentation_research_tpu.models.unet import Unet as JaxUnet
from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
from uda_aerial_semantic_segmentation_research_tpu_torch.data import (
    download_semantic_drone,
    prepare_holyrood,
    tiling,
    verify_csv,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.data.setup_test_data import (
    _write_class_dict,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.inference import predict
from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
    create_unet,
    from_jax_state_dict,
    to_jax_state_dict,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.utils.checkpoint import save_checkpoint
from uda_aerial_semantic_segmentation_research_tpu_torch.visualization.tensorboard_logger import (
    TensorboardLogger,
    read_events,
)

cv2 = pytest.importorskip("cv2")

S, C = 32, 5
BAND = 1e-4
MEAN = np.asarray((0.485, 0.456, 0.406), np.float32)
STD = np.asarray((0.229, 0.224, 0.225), np.float32)


@pytest.fixture(scope="module")
def models():
    module = JaxUnet("resnet18", classes=C, dtype=jnp.float32)
    flat = random_variables(module, jnp.zeros((1, S, S, 3), jnp.float32), seed=31)
    model = create_unet("resnet18", classes=C, dtype=torch.float32, device="cpu")
    model.load_state_dict(from_jax_state_dict(flat), strict=True)
    return ModelBundle(module, jax_variables(flat)), model


@pytest.fixture
def configs(tmp_path, monkeypatch):
    """Both packages' ``Config`` at 32 px, 5 classes, B=2, with a class
    dictionary under a temporary ``DATA_DIR``."""
    for cls in (Config, jax_config.Config):
        monkeypatch.setattr(cls, "IMAGE_SIZE", S)
        monkeypatch.setattr(cls, "NUM_CLASSES", C)
        monkeypatch.setattr(cls, "BATCH_SIZE", 2)
        monkeypatch.setattr(cls, "DATA_DIR", str(tmp_path / "data"))
    (tmp_path / "data").mkdir()
    _write_class_dict(tmp_path / "data" / "class_dict_seg.csv", C)
    return tmp_path


def _uint8(seed, h=S, w=S):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3)).astype(np.uint8)


def _write_rgb(path, rgb):
    assert cv2.imwrite(str(path), cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))


# ---------------------------------------------------------------------------
# predict_mask
# ---------------------------------------------------------------------------
def _forms():
    u8 = _uint8(40)
    unit = u8.astype(np.float32) / 255.0
    norm = ((unit - MEAN) / STD).astype(np.float32)
    return {
        "uint8": (u8, u8),
        "uint8_resized": (_uint8(41, 48, 40),) * 2,
        "unit_float": (unit, unit),
        "normalized": (norm, norm),
        "batched_chw": (norm.transpose(2, 0, 1)[None],) * 2,
        "torch_uint8_batch": (torch.from_numpy(u8[None]), u8[None]),
    }


@pytest.mark.parametrize("form", list(_forms()))
def test_predict_mask_matches_jax(models, configs, form):
    bundle, model = models
    ours_in, jax_in = _forms()[form]
    model.train()                        # predict_mask must switch to eval mode
    mask = predict.predict_mask(model, ours_in, device="cpu")
    assert not model.training
    ref = jax_predict.predict_mask(bundle, jax_in)
    assert mask.shape == ref.shape == (S, S, C) and mask.dtype == np.float32
    np.testing.assert_array_equal(predict._prepare_input(ours_in, S),
                                  np.asarray(jax_predict._prepare_input(jax_in, S)))
    probs = np.asarray(jax.nn.sigmoid(bundle(jax_predict._prepare_input(jax_in, S))))[0]
    clear = np.abs(probs - 0.5) >= BAND
    assert (~clear).mean() < 1e-2, f"{(~clear).sum()} values in the band"
    np.testing.assert_array_equal(mask[clear], np.asarray(ref)[clear])


def test_predict_mask_takes_a_pil_image(models, configs):
    from PIL import Image

    bundle, model = models
    u8 = _uint8(42)
    mask = predict.predict_mask(model, Image.fromarray(u8), device="cpu")
    np.testing.assert_array_equal(mask, predict.predict_mask(model, u8, device="cpu"))
    assert mask.shape == np.asarray(jax_predict.predict_mask(bundle, Image.fromarray(u8))).shape


def test_predict_mask_without_device_raises_without_cuda(models, configs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        predict.predict_mask(models[1], _uint8(0))


# ---------------------------------------------------------------------------
# class dictionary, colored masks, overlays
# ---------------------------------------------------------------------------
def test_load_class_dict_rows_follow_the_jax_dataframe(configs):
    rows = predict.load_class_dict()
    df = jax_predict.load_class_dict()
    assert rows == df.values.tolist() and len(rows) == C
    assert [list(r) for _, r in df.iterrows()] == rows
    Path(Config.DATA_DIR, "class_dict_seg.csv").unlink()
    assert predict.load_class_dict() is None


def test_create_colored_mask_is_exact(configs):
    labels = np.random.default_rng(43).integers(0, C + 2, (S, S + 3))   # C, C+1: no row
    ours = predict.create_colored_mask(torch.from_numpy(labels), predict.load_class_dict())
    ref = jax_predict.create_colored_mask(labels, jax_predict.load_class_dict())
    assert ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("form", ["uint8", "unit_float", "normalized", "normalized_chw",
                                  "bf16"])
def test_create_overlay_is_exact(form):
    u8 = _uint8(44)
    norm = ((u8.astype(np.float32) / 255.0 - MEAN) / STD).astype(np.float32)
    ours_in = jax_in = {"uint8": u8, "unit_float": u8.astype(np.float32) / 255.0,
                        "normalized": norm, "normalized_chw": norm.transpose(2, 0, 1),
                        "bf16": norm}[form]
    if form == "bf16":
        ours_in = torch.from_numpy(norm).to(torch.bfloat16)
        jax_in = np.asarray(jnp.asarray(norm, jnp.bfloat16))
    mask = np.random.default_rng(45).integers(0, 3, (S, S))
    ours = predict.create_overlay(ours_in, mask, alpha=0.4)
    ref = jax_predict.create_overlay(jax_in, mask, alpha=0.4)
    assert ours.dtype == np.uint8 and ours.shape == (S, S, 3)
    np.testing.assert_array_equal(ours, ref)


# ---------------------------------------------------------------------------
# predict_raster from a file, test_model
# ---------------------------------------------------------------------------
def test_predict_raster_reads_a_path_like_the_array(models, tmp_path):
    raster = _uint8(46, 70, 90)
    path = tmp_path / "raster.png"
    _write_rgb(path, raster)
    from_path = predict.predict_raster(models[1], str(path), tile=S, overlap=8, batch_size=2,
                                       device="cpu")
    from_array = predict.predict_raster(models[1], raster, tile=S, overlap=8, batch_size=2,
                                        device="cpu")
    assert from_path.shape == (70, 90) and from_path.dtype == np.int32
    np.testing.assert_array_equal(from_path, from_array)
    np.testing.assert_array_equal(
        predict.predict_raster(models[1], path, tile=S, overlap=8, batch_size=2, device="cpu"),
        from_array)


def test_test_model_writes_what_jax_writes(models, configs):
    """Both ``test_model``s read one checkpoint in the JAX layout (written by
    the port) into a model of other weights, predict the same files, and
    write the same file names; the label maps agree on at least 99.9% of
    the pixels, and where they all agree so do the report and the images."""
    bundle, model = models
    tmp = configs
    test_dir = tmp / "test_images"
    test_dir.mkdir()
    for i in range(3):
        _write_rgb(test_dir / f"tile_{i}.png", _uint8(50 + i, S + 8 * i, S + 8 * i))
    ckpt = tmp / "model.pth"
    save_checkpoint({"model_state_dict": to_jax_state_dict(model)}, ckpt)

    other = JaxUnet("resnet18", classes=C, dtype=jnp.float32)
    fresh = ModelBundle(other, jax_variables(random_variables(other, jnp.zeros((1, S, S, 3)),
                                                              seed=32)))
    n_ref = jax_predict.test_model(str(ckpt), str(test_dir), str(tmp / "out_jax"), model=fresh,
                                   batch_size=2)
    port_model = create_unet("resnet18", classes=C, dtype=torch.float32, device="cpu", seed=9)
    n = predict.test_model(str(ckpt), str(test_dir), str(tmp / "out_port"), model=port_model,
                           batch_size=2, device="cpu")
    assert n == n_ref == 3

    out_jax, out_port = tmp / "out_jax", tmp / "out_port"
    names = lambda root: sorted(str(p.relative_to(root)) for p in root.rglob("*"))
    assert names(out_port) == names(out_jax)
    assert len(names(out_port)) == 3 + 3 * 3 + 1   # 3 dirs, 3 x 3 images, the report
    agree = total = 0
    for f in sorted((out_jax / "predictions").iterdir()):
        a = cv2.imread(str(f), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(str(out_port / "predictions" / f.name), cv2.IMREAD_UNCHANGED)
        agree, total = agree + int((a == b).sum()), total + a.size
    assert agree / total >= 0.999, f"{agree} of {total} pixels agree"
    print(f"label maps: {agree} of {total} pixels agree")
    if agree == total:
        assert ((out_port / "prediction_stats.txt").read_text()
                == (out_jax / "prediction_stats.txt").read_text())
        for sub in ("colored_masks", "overlays"):
            for f in sorted((out_jax / sub).iterdir()):
                np.testing.assert_array_equal(cv2.imread(str(out_port / sub / f.name)),
                                              cv2.imread(str(f)), err_msg=f"{sub}/{f.name}")


def test_test_model_loads_the_checkpoint_through_the_weight_bridge(models, configs):
    _, model = models
    tmp = configs
    (tmp / "imgs").mkdir()
    _write_rgb(tmp / "imgs" / "a.png", _uint8(60))
    save_checkpoint({"model_state_dict": to_jax_state_dict(model)}, tmp / "m.pth")
    fresh = create_unet("resnet18", classes=C, dtype=torch.float32, device="cpu", seed=11)
    predict.test_model(str(tmp / "m.pth"), str(tmp / "imgs"), str(tmp / "out"), model=fresh,
                       device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


# ---------------------------------------------------------------------------
# TiledRasterDataset
# ---------------------------------------------------------------------------
def test_tiled_raster_dataset_matches_jax(tmp_path):
    _write_rgb(tmp_path / "b_wide.png", _uint8(61, 70, 90))
    _write_rgb(tmp_path / "a_small.jpg", _uint8(62, 20, 50))
    (tmp_path / "notes.txt").write_text("not an image")
    flip = lambda image: {"image": image[:, ::-1].copy()}
    ours = tiling.TiledRasterDataset(str(tmp_path), tile=S, overlap=8, transform=flip)
    ref = jax_tiling.TiledRasterDataset(str(tmp_path), tile=S, overlap=8, transform=flip)
    assert ours.images == ref.images == ["a_small.jpg", "b_wide.png"]
    assert ours._index == ref._index and ours._sizes == ref._sizes
    assert len(ours) == len(ref) == 2 + 3 * 4
    for i in range(len(ref)):
        np.testing.assert_array_equal(ours.load_raw(i), ref.load_raw(i))
        np.testing.assert_array_equal(ours[i], ref[i])
        assert ours[i].shape == (S, S, 3)


# ---------------------------------------------------------------------------
# prepare_holyrood_dataset, verify_csv, download_semantic_drone
# ---------------------------------------------------------------------------
def _raw_archives(raw):
    raw.mkdir()
    rng = np.random.default_rng(63)
    blob = lambda: rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
    with zipfile.ZipFile(raw / "part1.zip", "w") as zf:
        for name in ("flight_a/sub/IMG_0001.JPG", "flight_a/.IMG_0002.jpg", "top.png",
                     "flight_a/notes.txt", "flight_a/sub/deeper/DJI_0003.jpeg"):
            zf.writestr(name, blob())
    with zipfile.ZipFile(raw / "part2.zip", "w") as zf:
        for name in ("flight_b/IMG_0001.JPG", "flight_b/x/top.png", "flight_b/DJI_0004.PNG"):
            zf.writestr(name, blob())


def test_prepare_holyrood_matches_jax(tmp_path, monkeypatch):
    raw = tmp_path / "raw"
    _raw_archives(raw)
    scratch = tmp_path / "tmp"
    scratch.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(scratch))
    n = prepare_holyrood.prepare_holyrood_dataset(str(raw), str(tmp_path / "port"))
    n_ref = jax_holyrood.prepare_holyrood_dataset(str(raw), str(tmp_path / "jax"))
    assert n == n_ref == 6                            # no dotfile, no .txt
    files = lambda d: {p.name: p.read_bytes() for p in (tmp_path / d).iterdir()}
    assert files("port") == files("jax")
    assert sum(name.startswith(("IMG_0001_", "top_")) for name in files("port")) == 2
    assert not list(scratch.iterdir())                # the extraction dir is gone
    # idempotent: a prepared directory is left alone
    assert prepare_holyrood.prepare_holyrood_dataset(str(raw), str(tmp_path / "port")) == 6
    assert prepare_holyrood.prepare_holyrood_dataset(str(tmp_path / "none"),
                                                     str(tmp_path / "empty")) == 0


def test_verify_csv_reads_what_pandas_reads(configs):
    path = Path(Config.DATA_DIR) / "class_dict_seg.csv"
    columns, rows = verify_csv.verify_csv()
    df = jax_verify_csv.verify_csv(str(path))
    assert columns == list(df.columns) == ["name", "r", "g", "b"]
    assert rows == df.values.tolist()
    assert [type(v) for v in rows[0]] == [str, int, int, int]
    mixed = configs / "mixed.csv"
    mixed.write_text("a, b, c\n1, 2.5, x\n\n3, 4, y\n")
    columns, rows = verify_csv.read_csv(str(mixed))
    assert rows == [[1, 2.5, "x"], [3, 4.0, "y"]] == jax_verify_csv.verify_csv(
        str(mixed)).values.tolist()


def test_download_semantic_drone_offline_paths(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "kaggle", None)          # no Kaggle API
    for name, fn in (("port", download_semantic_drone.download_semantic_drone_dataset),
                     ("jax", jax_download.download_semantic_drone_dataset)):
        assert fn(str(tmp_path / name / "empty")) is False
        present = tmp_path / name / "present"
        present.mkdir(parents=True)
        (present / "archive.zip").write_bytes(b"")
        assert fn(str(present)) is True


# ---------------------------------------------------------------------------
# log_model_graph
# ---------------------------------------------------------------------------
def _texts(path):
    return {v["tag"]: v["value"] for e in read_events(path) for v in e["values"]}


def test_log_model_graph_writes_the_structure_and_the_traced_graph(models, tmp_path):
    _, model = models
    model.train()
    logger = TensorboardLogger(log_dir=str(tmp_path))
    logger.log_model_graph(model, input_shape=(1, S, S, 3))
    logger.close()
    assert model.training                          # the mode is restored
    texts = _texts(logger.path)
    assert set(texts) == {"model/structure/text_summary", "model/graph/text_summary"}
    structure = texts["model/structure/text_summary"].decode("utf-8", "replace")
    assert "Unet(" in structure
    assert f"{sum(p.numel() for p in model.parameters()):,} parameters" in structure
    graph = texts["model/graph/text_summary"].decode("utf-8", "replace")
    assert "aten::_convolution" in graph and "(truncated)" in graph


def test_log_model_graph_logs_a_failure_instead_of_raising(tmp_path):
    class Broken(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(3))

        def forward(self, x):
            raise RuntimeError("no forward here")

    logger = TensorboardLogger(log_dir=str(tmp_path))
    logger.log_model_graph(Broken(), input_shape=(1, 4, 4, 3))
    logger.close()
    texts = _texts(logger.path)
    assert "model/graph_error/text_summary" in texts
    assert b"no forward here" in texts["model/graph_error/text_summary"]
    assert "model/graph/text_summary" not in texts
