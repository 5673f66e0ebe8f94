"""The port's phase-1 trainer and what it is built from, against the JAX
package (CPU).

- ``DiceLoss`` / ``SMPDiceLoss``: 1e-6 (float32 sums in another order).
- ``seg_loss="dice"`` train and eval steps under ``aug_cfg=NONE``: the
  tolerances of ``tests/test_torch_train_step.py``'s first step (loss and
  metrics 1e-5; BatchNorm buffers 1e-5; parameters moved by Adam within
  ``0.02 * lr`` plus a float32 ulp where the gradient is at least 1% of its
  tensor's largest, ``2.5 * lr`` everywhere).
- ``EarlyStopping``: identical decisions, best metrics and rates.
- ``SegmentationTrainer``: resnet18, 64 px, 7 classes, B=2, 2 epochs of 2
  steps, the same weights on both sides (``from_jax_state_dict``), both
  trainers' steps built with ``aug_cfg=NONE`` (JAX's threefry draws cannot
  be reproduced) and the early stopper's ``min_epochs`` lowered to 1 on
  both sides so that a best model is selected and saved; lr 1e-5.  Held:
  per-epoch train loss and validation loss 1e-4 relative (after the first
  Adam update an entry whose gradient is noise around zero moves by +lr in
  one package and -lr in the other; measured 1.6e-5 and 3e-6), validation
  IoU / accuracy 2e-3 (a pixel whose two best logits are within float32
  noise flips its argmax: one pixel is 1.2e-4 of the accuracy here, and one
  flipped), the best epoch (unless the two epochs' scores are within that
  noise), the checkpoint's keys, its weights within ``4 * 2.5 * lr``
  (measured 5.8e-5) and its BatchNorm buffers within 2e-3 + 1e-2 relative
  (they follow batch statistics of weights that differ by that Adam noise;
  measured 7.2e-4 at most, 3.3e-4 on means near 0), the event files' scalar
  and image tags with their steps.
"""

import functools
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from tensorboard.backend.event_processing import event_accumulator

from tests.test_torch_adversarial import few_torch_threads  # noqa: F401  (autouse)
from tests.test_torch_models import jax_variables, random_variables
from uda_aerial_semantic_segmentation_research_tpu.config import Config as JaxConfig
from uda_aerial_semantic_segmentation_research_tpu.data import dataset as jax_dataset
from uda_aerial_semantic_segmentation_research_tpu.data import loader as jax_loader
from uda_aerial_semantic_segmentation_research_tpu.models.bundle import ModelBundle
from uda_aerial_semantic_segmentation_research_tpu.models.pretrained import (
    load_imagenet_encoder as jax_load_imagenet_encoder,
)
from uda_aerial_semantic_segmentation_research_tpu.models.unet import Unet as JaxUnet
from uda_aerial_semantic_segmentation_research_tpu.ops import augment as jax_augment
from uda_aerial_semantic_segmentation_research_tpu.ops import losses as jax_losses
from uda_aerial_semantic_segmentation_research_tpu.training import state as jax_state
from uda_aerial_semantic_segmentation_research_tpu.training import steps as jax_steps
from uda_aerial_semantic_segmentation_research_tpu.training import train as jax_train
from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
from uda_aerial_semantic_segmentation_research_tpu_torch.data import dataset, loader
from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
    create_model,
    create_unet,
    from_jax_state_dict,
    to_jax_state_dict,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops import augment, losses
from uda_aerial_semantic_segmentation_research_tpu_torch.training import steps
from uda_aerial_semantic_segmentation_research_tpu_torch.training import train
from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import (
    TrainState,
    adam,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.utils.checkpoint import (
    load_checkpoint,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.visualization.tensorboard_logger import (
    read_events,
)

SIZE, CLASSES, BATCH = 64, 7, 2   # 64 px: at 32 px the deepest BatchNorm sees 2 values a channel
LR = 1e-5
PORT = "uda_aerial_semantic_segmentation_research_tpu_torch"


@functools.cache
def _weights():
    module = JaxUnet("resnet18", classes=CLASSES, dtype=jnp.float32)
    return module, random_variables(module, jnp.zeros((BATCH, SIZE, SIZE, 3)), seed=11)


def _port_model(flat):
    model = create_unet("resnet18", classes=CLASSES, dtype=torch.float32, device="cpu")
    model.load_state_dict(from_jax_state_dict(flat), strict=True)
    return model


def _tiles(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8),
            rng.integers(0, CLASSES, (n, SIZE, SIZE)).astype(np.int32))


# ---------------------------------------------------------------------------
# losses and the dice steps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("targets", ["labels", "labels_with_absent", "one_hot"])
@pytest.mark.parametrize("name", ["DiceLoss", "SMPDiceLoss"])
def test_dice_losses_match_jax(name, targets):
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(3, 9, 11, 6)).astype(np.float32) * 3
    labels = rng.integers(0, 6, (3, 9, 11))
    if targets == "labels_with_absent":
        labels = np.where(labels == 4, 1, labels)      # class 4 absent
    t = labels if targets != "one_hot" else np.eye(6, dtype=np.float32)[labels]
    ours = getattr(losses, name)()(torch.from_numpy(logits), torch.from_numpy(t))
    theirs = getattr(jax_losses, name)()(jnp.asarray(logits), jnp.asarray(t))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.item(), float(theirs), rtol=1e-6, atol=1e-6)


def test_dice_train_and_eval_steps_match_jax():
    module, flat = _weights()
    images, masks = _tiles(BATCH, seed=3)
    masks = masks.astype(np.uint8)
    variables = jax_variables(flat)
    tx = jax_state.adam(LR)
    jstate = jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                                  batch_stats=variables["batch_stats"],
                                  opt_state=tx.init(variables["params"]), tx=tx)
    jstep = jax_steps.make_supervised_train_step(module, CLASSES, aug_cfg=jax_augment.NONE,
                                                 seg_loss="dice")
    jstate, jm = jstep(jstate, jax.random.key(0), jnp.asarray(images), jnp.asarray(masks))
    model = _port_model(flat)
    pstep = steps.make_supervised_train_step(model, CLASSES, aug_cfg=augment.NONE,
                                             seg_loss="dice")
    _, pm = pstep(TrainState(model, adam(LR)), None, images, masks)
    for k in ("loss", "iou", "accuracy"):
        np.testing.assert_allclose(pm[k].item(), float(jm[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(pm["hist"].numpy(), np.asarray(jm["hist"]))
    port = to_jax_state_dict(model)
    grads = to_jax_state_dict(model, grads=True)
    ref = {"/".join(k): np.asarray(v) for k, v in flatten_dict(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}).items()}
    for k, v in ref.items():
        if k.startswith("batch_stats/"):
            np.testing.assert_allclose(port[k], v, rtol=1e-5, atol=1e-5, err_msg=k)
            continue
        diff = np.abs(port[k] - v)
        assert diff.max() <= 2.5 * LR, k
        significant = np.abs(grads[k]) >= 1e-2 * np.abs(grads[k]).max()
        assert (diff[significant] <= 0.02 * LR + 1.2e-7).all(), k

    variables = jax_variables(flat)
    jeval = jax_steps.make_eval_step(module, CLASSES, seg_loss="dice")(
        variables["params"], variables["batch_stats"], jnp.asarray(images), jnp.asarray(masks))
    peval = steps.make_eval_step(_port_model(flat), CLASSES, seg_loss="dice")(images, masks)
    for k in ("loss", "iou", "accuracy"):
        np.testing.assert_allclose(peval[k].item(), float(jeval[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    with pytest.raises(ValueError, match="class_weights"):
        steps.make_eval_step(model, CLASSES, seg_loss="dice",
                             class_weights=np.ones(CLASSES, np.float32))


# ---------------------------------------------------------------------------
# early stopping
# ---------------------------------------------------------------------------
class _Scalars:
    def __init__(self):
        self.calls = []

    def log_scalar(self, tag, value, step):
        self.calls.append((tag, float(value), step))


@pytest.mark.parametrize("mode,min_epochs,patience,min_delta",
                         [("max", 10, 7, 0.0), ("max", 2, 2, 0.0), ("min", 1, 3, 0.05),
                          ("min", 4, 1, 0.0)])
def test_early_stopping_matches_jax(mode, min_epochs, patience, min_delta):
    rng = np.random.default_rng(min_epochs + patience)
    kw = dict(patience=patience, mode=mode, min_epochs=min_epochs, min_delta=min_delta,
              metrics_to_track=["loss", "iou", "accuracy"],
              weights={"loss": -1.0, "iou": 1.0, "accuracy": 0.5})
    ours, theirs = train.EarlyStopping(**kw), jax_train.EarlyStopping(**kw)
    ours_log, theirs_log = _Scalars(), _Scalars()
    stopped = []
    for epoch in range(1, 25):
        metrics = {"loss": float(rng.random()), "iou": float(rng.random()),
                   "accuracy": float(rng.random()), "iou_epoch": 0.1}
        a = ours(epoch, metrics, ours_log)
        assert a == theirs(epoch, metrics, theirs_log)
        assert ours.counter == theirs.counter
        if a:
            stopped.append(epoch)
            break
    assert ours_log.calls == theirs_log.calls
    assert ours.get_best_metrics() == theirs.get_best_metrics()
    assert ours.get_improvement_rate() == theirs.get_improvement_rate()
    assert ours.early_stop == theirs.early_stop and ours.best_score == theirs.best_score
    assert mode == "max" and min_epochs == 10 or stopped        # these sequences stop


# ---------------------------------------------------------------------------
# the trainer against the JAX trainer
# ---------------------------------------------------------------------------
def _from_epoch_one(cls):
    class FromEpochOne(cls):
        def __init__(self, **kw):
            super().__init__(**{**kw, "min_epochs": 1})

    return FromEpochOne


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    """Both trainers, 2 epochs each, on the same tiles and weights."""
    module, flat = _weights()
    images, masks = _tiles()
    out = {}
    for name in ("jax", "port"):
        root = tmp_path_factory.mktemp(f"trainer_{name}")
        cfg, mod, dmod, lmod = ((JaxConfig, jax_train, jax_dataset, jax_loader)
                                if name == "jax" else (Config, train, dataset, loader))
        record = {"train_loss": [], "val": []}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(cfg, "LOGS_DIR", str(root / "logs"))
            mp.setattr(cfg, "CHECKPOINTS_DIR", str(root / "checkpoints"))
            mp.setattr(mod, "EarlyStopping", _from_epoch_one(mod.EarlyStopping))

            class Tiles:
                def __len__(self):
                    return len(images)

                def load_raw(self, i):
                    return images[i], masks[i]

                __getitem__ = load_raw

            tr, va = dmod.random_split(Tiles(), [4, 2], seed=0)
            train_loader = lmod.DataLoader(tr, batch_size=BATCH, drop_last=True)
            val_loader = lmod.DataLoader(va, batch_size=BATCH)
            if name == "jax":
                model = ModelBundle(module, jax_variables(flat))
                trainer = mod.SegmentationTrainer(model, device="cpu")
                trainer._train_step = jax_steps.make_supervised_train_step(
                    module, CLASSES, aug_cfg=jax_augment.NONE)
                trainer._eval_step = jax_steps.make_eval_step(module, CLASSES)
            else:
                model = _port_model(flat)
                trainer = mod.SegmentationTrainer(model, device="cpu")
                trainer._train_step = steps.make_supervised_train_step(
                    model, CLASSES, aug_cfg=augment.NONE)
                trainer._eval_step = steps.make_eval_step(model, CLASSES)
            epoch_fn, validate_fn = trainer.train_epoch, trainer.validate

            def train_epoch(*args, _fn=epoch_fn):
                state, loss = _fn(*args)
                record["train_loss"].append(loss)
                return state, loss

            def validate(*args, _fn=validate_fn):
                metrics = _fn(*args)
                record["val"].append(metrics)
                return metrics

            trainer.train_epoch, trainer.validate = train_epoch, validate
            record["best"] = trainer.train(train_loader, val_loader, epochs=2,
                                           learning_rate=LR)
            record["checkpoint"] = load_checkpoint(root / "checkpoints" / "best_model.pth")
            (record["events"],) = list((root / "logs").rglob("events.out.tfevents.*"))
            record["score"] = [m["iou"] + 0.5 * m["accuracy"] - m["loss"]
                               for m in record["val"]]
            record["model"] = model
        out[name] = record
    return out


def test_trainer_losses_and_metrics_match_jax(trainer_runs):
    j, p = trainer_runs["jax"], trainer_runs["port"]
    assert len(p["train_loss"]) == len(j["train_loss"]) == 2
    np.testing.assert_allclose(p["train_loss"], j["train_loss"], rtol=1e-4)
    assert p["train_loss"][0] != p["train_loss"][1]                  # it trained
    for pv, jv in zip(p["val"], j["val"], strict=True):
        assert set(pv) == set(jv) == {"loss", "iou", "accuracy", "iou_epoch"}
        np.testing.assert_allclose(pv["loss"], jv["loss"], rtol=1e-4)
        for k in ("iou", "accuracy", "iou_epoch"):
            np.testing.assert_allclose(pv[k], jv[k], rtol=0, atol=2e-3, err_msg=k)


def test_trainer_best_checkpoint_matches_jax(trainer_runs):
    j, p = trainer_runs["jax"], trainer_runs["port"]
    jc, pc = j["checkpoint"], p["checkpoint"]
    assert set(pc) == set(jc) == {"epoch", "model_state_dict", "optimizer_state_dict",
                                  "metrics", "improvement_rates"}
    if abs(j["score"][0] - j["score"][1]) > 1e-3:
        assert pc["epoch"] == jc["epoch"]
    assert pc["epoch"] == 1 + int(np.argmax(p["score"]))
    assert pc["metrics"] == p["val"][pc["epoch"] - 1] == p["best"]
    assert set(pc["improvement_rates"]) == set(jc["improvement_rates"])
    assert set(pc["model_state_dict"]) == set(jc["model_state_dict"])
    if pc["epoch"] == jc["epoch"]:
        for k, v in jc["model_state_dict"].items():
            stats = k.startswith("batch_stats/")
            np.testing.assert_allclose(pc["model_state_dict"][k], v, rtol=1e-2 * stats,
                                       atol=2e-3 if stats else 4 * 2.5 * LR, err_msg=k)
    # the checkpoint reloads into the port's model
    model = _port_model(pc["model_state_dict"])
    assert model is not None


def _event_tags(path):
    ea = event_accumulator.EventAccumulator(str(path), size_guidance={
        event_accumulator.IMAGES: 0, event_accumulator.SCALARS: 0})
    ea.Reload()
    tags = ea.Tags()
    return ({t: [e.step for e in ea.Scalars(t)] for t in tags["scalars"]},
            {t: [e.step for e in ea.Images(t)] for t in tags["images"]})


def test_trainer_event_files_have_the_jax_tags_and_steps(trainer_runs):
    jscalars, jimages = _event_tags(trainer_runs["jax"]["events"])
    pscalars, pimages = _event_tags(trainer_runs["port"]["events"])
    assert pscalars == jscalars and pimages == jimages
    assert "val/iou_epoch" in pscalars and "train/roc_curves" in pimages
    assert len(read_events(trainer_runs["port"]["events"])) > 50


def test_trainer_runs_the_default_weak_step(tmp_path, monkeypatch):
    """No step override: the trainer builds the WEAK train step."""
    monkeypatch.setattr(Config, "LOGS_DIR", str(tmp_path / "logs"))
    monkeypatch.setattr(Config, "CHECKPOINTS_DIR", str(tmp_path / "checkpoints"))
    monkeypatch.setattr(train, "EarlyStopping", _from_epoch_one(train.EarlyStopping))
    images, masks = _tiles(4, seed=5)
    loaders = (loader.DataLoader(dataset.Subset(list(zip(images, masks)), [0, 1]),
                                 batch_size=BATCH),
               loader.DataLoader(dataset.Subset(list(zip(images, masks)), [2, 3]),
                                 batch_size=BATCH))
    model = _port_model(_weights()[1])
    trainer = train.SegmentationTrainer(model, device="cpu")
    best = trainer.train(*loaders, epochs=1, learning_rate=1e-4)
    assert trainer._train_step is not None and np.isfinite(best["loss"])
    ckpt = load_checkpoint(tmp_path / "checkpoints" / "best_model.pth")
    assert all(np.isfinite(v).all() for v in ckpt["model_state_dict"].values())
    assert ckpt["epoch"] == 1


def test_trainer_requires_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.SegmentationTrainer(_port_model(_weights()[1]))
    with pytest.raises(RuntimeError, match="CUDA"):
        Config.get_device()
    monkeypatch.setattr(Config, "DEVICE", "cpu")
    assert Config.get_device() == torch.device("cpu")


# ---------------------------------------------------------------------------
# the entry point, configuration, model factory, pretrained encoder
# ---------------------------------------------------------------------------
def test_train_model_end_to_end_on_fixture_files(tmp_path, monkeypatch):
    from uda_aerial_semantic_segmentation_research_tpu_torch.data.setup_test_data import (
        setup_test_data,
    )

    for cls in (Config, JaxConfig):
        monkeypatch.setattr(cls, "DATA_DIR", str(tmp_path / "data"))
    monkeypatch.setattr(Config, "SAMPLE_DATA_DIR", str(tmp_path / "data" / "sample"))
    for name, value in (("LOGS_DIR", "logs"), ("CHECKPOINTS_DIR", "ckpt"),
                        ("CHECKPOINT_DIR", "final")):
        monkeypatch.setattr(Config, name, str(tmp_path / value))
    for name, value in (("DEVICE", "cpu"), ("ENCODER_NAME", "resnet18"), ("IMAGE_SIZE", 32),
                        ("BATCH_SIZE", 2), ("NUM_WORKERS", 2), ("NUM_CLASSES", CLASSES)):
        monkeypatch.setattr(Config, name, value)
    setup_test_data(num_source=5, num_holyrood=0, image_size=40, force=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        model, best = train.train_model(epochs=1)
    assert any("imagenet" in str(w.message) for w in caught)         # no file: warned
    assert best == {}                                                  # min_epochs 10
    final = load_checkpoint(tmp_path / "final" / "final_model.pth")
    assert set(final) == {"model_state_dict", "metrics", "class_dict"}
    assert final["class_dict"] == jax_train.load_class_dict().to_dict()
    assert set(final["model_state_dict"]) == set(to_jax_state_dict(model))
    assert list(Path(tmp_path / "logs").rglob("events.out.tfevents.*"))
    monkeypatch.setattr(Config, "DATA_DIR", str(tmp_path / "nowhere"))
    assert train.load_class_dict() is None


def test_setup_directories_matches_jax(tmp_path, monkeypatch):
    made = {}
    for name, cls in (("port", Config), ("jax", JaxConfig)):
        root = tmp_path / name
        for attr in ("LOGS_DIR", "CHECKPOINTS_DIR", "DATA_DIR", "RESULTS_DIR"):
            monkeypatch.setattr(cls, attr, str(root / getattr(cls, attr)))
        cls.setup_directories()
        made[name] = sorted(str(p.relative_to(root)) for p in root.rglob("*"))
    assert made["port"] == made["jax"] and "results/plots" in made["port"]


def test_create_model_by_name():
    model = create_model("Unet", "resnet18", classes=CLASSES, device="cpu",
                         dtype=torch.float32)
    reference = create_unet("resnet18", classes=CLASSES, device="cpu", dtype=torch.float32)
    for k, v in reference.state_dict().items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0)
    # every name of the JAX registry builds (JAX models/__init__.py:69-72), here
    # on the small mobilenet_v2 encoder, and runs; the trees and values are
    # held against JAX in tests/test_torch_architectures*.py
    for name in ("Unet", "UnetPlusPlus", "FPN", "PSPNet", "Linknet", "DeepLabV3Plus", "PAN",
                 "MAnet"):
        model = create_model(name, "mobilenet_v2", classes=CLASSES, device="cpu",
                             dtype=torch.float32)
        assert type(model).__name__ == name and not model.training
        with torch.no_grad():
            logits = model(torch.zeros(1, 64, 64, 3))
        assert logits.shape == (1, 64, 64, CLASSES) and torch.isfinite(logits).all()
    with pytest.raises(ValueError, match="Unknown model"):
        create_model("Transformer", "resnet18", device="cpu")


def test_load_imagenet_encoder_matches_jax(tmp_path, monkeypatch):
    module, flat = _weights()
    rng = np.random.default_rng(6)
    npz = {}
    for k, v in flat.items():
        coll, rest = k.split("/", 1)
        if rest.startswith("encoder/"):
            key = rest[len("encoder/"):]
            npz[key if coll == "params" else f"batch_stats::{key}"] = (
                v + rng.normal(size=v.shape).astype(np.float32))
    path = tmp_path / "resnet18_imagenet.npz"
    np.savez(path, **npz)
    monkeypatch.setenv("UDA_TPU_IMAGENET_NPZ", str(path))
    bundle = ModelBundle(module, jax_variables(flat))
    assert jax_load_imagenet_encoder(bundle, "resnet18")
    model = create_model("Unet", "resnet18", classes=CLASSES, device="cpu",
                         dtype=torch.float32, encoder_weights="imagenet")
    ours, theirs = to_jax_state_dict(model), bundle.state_dict()
    encoder = [k for k in theirs if "/encoder/" in k]
    assert len(encoder) == len(npz)
    for k in encoder:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)

    monkeypatch.setenv("UDA_TPU_IMAGENET_NPZ", str(tmp_path / "absent.npz"))
    with pytest.warns(UserWarning, match="randomly"):
        kept = create_model("Unet", "resnet18", classes=CLASSES, device="cpu",
                            encoder_weights="imagenet")
    seeded = create_unet("resnet18", classes=CLASSES, device="cpu")
    for k, v in seeded.state_dict().items():
        assert torch.equal(kept.state_dict()[k], v), k


# ---------------------------------------------------------------------------
# the card's installation: none of the JAX trainer path's host packages
# ---------------------------------------------------------------------------
BLOCKED = ("cv2", "pandas", "tqdm", "matplotlib", "seaborn", "sklearn", "tensorboard", "PIL",
           "jax", "flax", "optax")

_BLOCKED_RUN = r'''
import sys
for m in {blocked!r}:
    sys.modules[m] = None
import importlib, numpy as np, torch
for m in {modules!r}:
    importlib.import_module(m)
from {port}.config import Config
from {port}.data.dataset import Subset
from {port}.data.loader import DataLoader
from {port}.models import create_unet
from {port}.training.train import SegmentationTrainer
from {port}.utils.checkpoint import load_checkpoint
Config.LOGS_DIR, Config.CHECKPOINTS_DIR = {logs!r}, {ckpt!r}
rng = np.random.default_rng(0)
tiles = [(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8),
          rng.integers(0, 7, (32, 32)).astype(np.int32)) for _ in range(4)]
model = create_unet("resnet18", classes=7, device="cpu", dtype=torch.float32)
trainer = SegmentationTrainer(model, device="cpu")
trainer.train(DataLoader(Subset(tiles, [0, 1]), batch_size=2, num_workers=2),
              DataLoader(Subset(tiles, [2, 3]), batch_size=2), epochs=1, learning_rate=1e-4)
jax_ckpt = load_checkpoint({jax_ckpt!r})
names, todo = set(), [jax_ckpt["optimizer_state_dict"]]
while todo:
    node = todo.pop()
    names.add(type(node).__name__)
    if isinstance(node, tuple):
        todo.extend(node)
print("opt", sorted(names), len(jax_ckpt["model_state_dict"]))
bad = sorted(m for m in {blocked!r} if sys.modules.get(m) is not None)
assert not bad, bad
print("ok")
'''


def test_port_trains_without_the_jax_trainers_host_packages(tmp_path, trainer_runs):
    """A fresh process where cv2, pandas, tqdm, matplotlib, seaborn, sklearn,
    tensorboard, PIL, JAX, flax and optax cannot be imported: every port
    module imports, one trainer epoch runs on the CPU from an in-memory
    dataset, and a JAX trainer's best checkpoint (optax state inside) loads."""
    root = Path(__file__).resolve().parents[1]
    modules = sorted(".".join(f.relative_to(root).with_suffix("").parts)
                     for f in (root / PORT).rglob("*.py"))
    assert f"{PORT}.training.train" in modules and f"{PORT}.data.loader" in modules
    assert f"{PORT}.test_system" in modules and f"{PORT}.inference.predict" in modules
    jax_ckpt = trainer_runs["jax"]["events"].parents[2] / "checkpoints" / "best_model.pth"
    code = _BLOCKED_RUN.format(blocked=BLOCKED, modules=modules, port=PORT,
                               logs=str(tmp_path / "logs"), ckpt=str(tmp_path / "ckpt"),
                               jax_ckpt=str(jax_ckpt))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "'ScaleByAdamState'" in proc.stdout and proc.stdout.strip().endswith("ok")
    assert list((tmp_path / "logs").rglob("events.out.tfevents.*"))
