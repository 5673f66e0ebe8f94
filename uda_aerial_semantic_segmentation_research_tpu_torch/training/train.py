"""Supervised segmentation training (phase 1): the trainer and its entry point.

Counterpart of the JAX package's ``training/train.py``:

- ``load_class_dict``     the class_dict_seg.csv loader (``csv`` module; the
                          ``DataFrame.to_dict()`` shape the JAX package stores)
- ``launch_tensorboard``  TensorBoard server helper
- ``EarlyStopping``       weighted multi-metric early stop
- ``SegmentationTrainer`` train / validate loops, logging, best checkpoint
- ``train_model``         the standalone training entry point (and CLI)

The trainer is an epoch loop around one train step and one eval step
(``training.steps``) on a single device.  It keeps the JAX trainer's
behaviour: the metrics of step N are read back while step N+1 is queued
(one step of lag), validation reports per-batch means plus the exact
``iou_epoch`` of the summed confusion matrix, early stopping with the JAX
settings, the best model's checkpoint, and the same TensorBoard tags and
steps.  Differences, by design:

- the model is the ``nn.Module`` that ``create_model`` returns, trained in
  place; checkpoints hold its ``model_state_dict`` in the JAX layout
  (``models.convert.to_jax_state_dict``), loadable by either package;
- the augmentation's draws come from a ``torch.Generator`` on the model's
  device, one per epoch, seeded with
  ``SeedSequence([Config.SEED, epoch]).generate_state(1, uint64)`` (low 63
  bits); the steps of an epoch draw from it one after the other (the JAX
  trainer folds the step number into one key per epoch);
- batches reach the device through ``data.loader.prefetch_to_device``
  (pinned memory, a copy stream, two batches ahead);
- the three figures (confusion matrix, ROC and precision-recall curves)
  are drawn in numpy (``visualization.figures``), progress is printed
  without tqdm, and the three scalars of a step come back in one read.
"""

from __future__ import annotations

import argparse
import csv
import os
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
from uda_aerial_semantic_segmentation_research_tpu_torch.data.loader import (
    prefetch_to_device,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.models.convert import (
    to_jax_state_dict,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.losses import DiceLoss
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.metrics import iou_from_hist
from uda_aerial_semantic_segmentation_research_tpu_torch.training import steps as step_lib
from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import (
    TrainState,
    adam,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.utils.checkpoint import (
    save_checkpoint,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.utils.device import (
    resolve_device,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.utils.profiling import (
    StepTimer,
    trace,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.visualization import figures
from uda_aerial_semantic_segmentation_research_tpu_torch.visualization import (
    utils as viz_utils,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.visualization.tensorboard_logger import (
    TensorboardLogger,
)

# pixels fed to the ROC and precision-recall curves per figure (a seeded subsample, as in
# the JAX package)
_CURVE_PIXEL_CAP = 20_000


def _column(values: List[str]):
    """A CSV column typed as pandas would read it: all ints, all floats, or strings."""
    for kind in (int, float):
        try:
            return [kind(v) for v in values]
        except ValueError:
            continue
    return values


def load_class_dict():
    """The class-color CSV at ``<DATA_DIR>/class_dict_seg.csv`` as
    ``{column: {row: value}}`` (what ``pandas.read_csv(...,
    skipinitialspace=True).to_dict()`` gives), or None when it cannot be
    read."""
    csv_path = os.path.join(Config.DATA_DIR, "class_dict_seg.csv")
    try:
        with open(csv_path, newline="") as f:
            rows = [r for r in csv.reader(f, skipinitialspace=True) if r]
        header, body = rows[0], rows[1:]
        table = {name: dict(enumerate(_column([r[j] for r in body])))
                 for j, name in enumerate(header)}
    except (OSError, csv.Error, IndexError) as e:
        print(f"Error loading class dictionary: {e}")
        return None
    print("\nLoaded class mapping:")
    for i in range(len(body)):
        print("  " + ", ".join(f"{name}={table[name][i]}" for name in header))
    return table


def launch_tensorboard(logdir, port: int = 6006):
    """Start a TensorBoard server on ``logdir``; the process, or None when
    the ``tensorboard`` program is not installed."""
    os.makedirs(logdir, exist_ok=True)
    try:
        return subprocess.Popen(
            ["tensorboard", "--logdir", str(logdir), "--port", str(port)],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    except OSError as e:
        print(f"Warning: Could not start TensorBoard: {e}")
        print(f"You can manually start TensorBoard with: tensorboard --logdir {logdir}")
        return None


class EarlyStopping:
    """Weighted multi-metric early stopping (the JAX package's semantics):
    combined score = sum(weights[m] * value), 'min'/'max' mode with
    min_delta, no stopping and no best before ``min_epochs``, metric history
    and improvement rates, and the ``early_stopping/score`` /
    ``early_stopping/counter`` scalars."""

    def __init__(self, patience: int = 7, min_delta: float = 0.0,
                 mode: str = "min", min_epochs: int = 10,
                 metrics_to_track: Optional[List[str]] = None,
                 weights: Optional[Dict[str, float]] = None,
                 verbose: bool = False):
        self.patience = patience
        self.min_delta = min_delta
        self.mode = mode
        self.min_epochs = min_epochs
        self.metrics_to_track = metrics_to_track or ["loss"]
        self.weights = weights or {"loss": 1.0}
        self.verbose = verbose

        self.counter = 0
        self.best_score = None
        self.early_stop = False
        self.best_metrics: Dict[str, float] = {}
        self.metric_history = {m: [] for m in self.metrics_to_track}

    def _calculate_score(self, metrics: Dict[str, float]) -> float:
        return sum(self.weights[m] * float(v) for m, v in metrics.items()
                   if m in self.weights)

    def _is_better(self, current: float, best: float) -> bool:
        if self.mode == "min":
            return current < best - self.min_delta
        return current > best + self.min_delta

    def __call__(self, epoch: int, metrics: Dict[str, float],
                 logger: Optional[TensorboardLogger] = None) -> bool:
        for m, v in metrics.items():
            if m in self.metric_history:
                self.metric_history[m].append(float(v))

        current_score = self._calculate_score(metrics)
        if logger:
            logger.log_scalar("early_stopping/score", current_score, epoch)
            logger.log_scalar("early_stopping/counter", self.counter, epoch)

        if epoch < self.min_epochs:
            return False

        if self.best_score is None:
            self.best_score = current_score
            self.best_metrics = dict(metrics)
        elif self._is_better(current_score, self.best_score):
            self.best_score = current_score
            self.best_metrics = dict(metrics)
            self.counter = 0
        else:
            self.counter += 1
            if self.verbose:
                print(f"EarlyStopping counter: {self.counter} out of {self.patience}")
            if self.counter >= self.patience:
                self.early_stop = True
                if self.verbose:
                    print(f"Early stopping triggered after {epoch} epochs")
                return True
        return False

    def get_best_metrics(self) -> Dict[str, float]:
        return self.best_metrics

    def get_improvement_rate(self) -> Dict[str, float]:
        rates = {}
        for m, hist in self.metric_history.items():
            if len(hist) > 1:
                rates[m] = (hist[-1] - hist[0]) / len(hist)
        return rates


def _raw_batches(dataloader, device=None, depth: int = 2):
    """Yield raw (uint8 images NHWC, int masks NHW) batches: the loader's
    raw path when it has one, else its batches as they come.  With
    ``device``, batches arrive as tensors on it, ``depth`` batches ahead
    (``prefetch_to_device``)."""
    it = dataloader.iter_raw() if hasattr(dataloader, "iter_raw") else iter(dataloader)

    def norm(batch):
        if isinstance(batch, (tuple, list)) and len(batch) == 2:
            return batch[0], batch[1]
        return batch, None

    if device is None:
        for batch in it:
            yield norm(batch)
        return
    yield from prefetch_to_device((norm(b) for b in it), device, size=depth)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _scalars(*tensors) -> List[float]:
    """Device scalars as Python floats, in one read back to the host."""
    return torch.stack([t.detach().float().reshape(()) for t in tensors]).tolist()


class SegmentationTrainer:
    """Phase-1 supervised trainer on one device."""

    def __init__(self, model: torch.nn.Module, device=None, log_dir: Optional[str] = None):
        """``model``: the module ``create_model`` returns, moved to ``device``
        (default ``Config.get_device()``: ``cuda``, an error without a GPU)."""
        self.device = resolve_device(device) if device is not None else Config.get_device()
        self.model = model.to(self.device)
        self.num_classes = getattr(model, "classes", Config.NUM_CLASSES)
        self.logger = TensorboardLogger(log_dir=log_dir or Config.LOGS_DIR)
        self.current_epoch = 0
        self.timer: Optional[StepTimer] = None       # the last epoch's step times
        self._train_step = None
        self._eval_step = None
        self._predict_step = step_lib.make_predict_step(model)

    def _epoch_generator(self, epoch: int) -> torch.Generator:
        """The augmentation's generator for ``epoch`` (module docstring)."""
        seed = np.random.SeedSequence([Config.SEED, epoch]).generate_state(1, np.uint64)[0]
        return torch.Generator(device=self.device).manual_seed(int(seed) & ((1 << 63) - 1))

    def _build_steps(self):
        if self._train_step is None:
            self._train_step = step_lib.make_supervised_train_step(
                self.model, self.num_classes)
            self._eval_step = step_lib.make_eval_step(self.model, self.num_classes)

    # ------------------------------------------------------------------
    # figure logging
    # ------------------------------------------------------------------
    def _log_confusion_matrix(self, hist, step: int, prefix: str = "train"):
        self.logger.log_figure(f"{prefix}/confusion_matrix",
                               figures.heatmap_image(_host(hist)), step)

    def _curve_inputs(self, outputs, masks):
        probs = _host(torch.softmax(torch.as_tensor(outputs).float(), dim=-1))
        true = _host(masks).reshape(-1)
        probs = probs.reshape(-1, probs.shape[-1])
        if len(true) > _CURVE_PIXEL_CAP:
            idx = np.random.default_rng(0).choice(len(true), _CURVE_PIXEL_CAP,
                                                  replace=False)
            probs, true = probs[idx], true[idx]
        return probs, true

    def _log_roc_curves(self, outputs, masks, step: int, prefix: str = "train"):
        probs, true = self._curve_inputs(outputs, masks)
        curves = []
        for c in range(self.num_classes):
            y = true == c
            if y.sum() == 0 or y.sum() == len(y):
                continue
            fpr, tpr, _ = figures.roc_curve(y, probs[:, c])
            curves.append((c, fpr, tpr, figures.auc(fpr, tpr)))
        self.logger.log_figure(f"{prefix}/roc_curves",
                               figures.curves_image(curves, self.num_classes, diagonal=True),
                               step)

    def _log_pr_curves(self, outputs, masks, step: int, prefix: str = "train"):
        probs, true = self._curve_inputs(outputs, masks)
        curves = []
        for c in range(self.num_classes):
            y = true == c
            if y.sum() == 0:
                continue
            precision, recall, _ = figures.precision_recall_curve(y, probs[:, c])
            curves.append((c, recall, precision,
                           figures.average_precision_score(y, probs[:, c])))
        self.logger.log_figure(f"{prefix}/pr_curves",
                               figures.curves_image(curves, self.num_classes), step)

    def _log_predictions(self, image, mask, output, step: int, prefix="train"):
        """Sample image / ground truth / prediction / overlay."""
        pred_mask = _host(torch.as_tensor(output).argmax(dim=-1))
        img = _host(image)
        self.logger.log_image(f"{prefix}/image", img, step)
        self.logger.log_image(f"{prefix}/ground_truth",
                              viz_utils.colorize_mask(_host(mask), self.num_classes), step)
        self.logger.log_image(f"{prefix}/prediction",
                              viz_utils.colorize_mask(pred_mask, self.num_classes), step)
        self.logger.log_image(f"{prefix}/overlay", viz_utils.create_overlay(img, pred_mask),
                              step)

    def _log_figures(self, images, masks, hist, step: int, prefix: str):
        """The figure-logging batch: predictions, confusion matrix, curves."""
        logits = self._predict_step(images[:1])
        self._log_predictions(images[0], masks[0], logits[0], step, prefix=prefix)
        self._log_confusion_matrix(hist, step, prefix)
        self._log_roc_curves(logits, masks[:1], step, prefix)
        self._log_pr_curves(logits, masks[:1], step, prefix)

    # ------------------------------------------------------------------
    # epoch loops
    # ------------------------------------------------------------------
    def train_epoch(self, dataloader, state: TrainState, epoch: int):
        """One training epoch; returns (state, mean loss)."""
        total_loss, n_batches = 0.0, 0
        n_total = len(dataloader) if hasattr(dataloader, "__len__") else None
        generator = self._epoch_generator(epoch)
        self.timer = timer = StepTimer(warmup=1)
        pending = None  # (global_step, batch_idx, metrics, images, masks)
        progress = (epoch, n_total)
        for batch_idx, (images, masks) in enumerate(_raw_batches(dataloader, self.device)):
            timer.items_per_step = images.shape[0]
            global_step = (epoch - 1) * (n_total or 1) + batch_idx
            with timer.step(sync=None):
                state, metrics = self._train_step(state, generator, images, masks)
                # read the LAST step's metrics: the host waits for step N-1
                # while step N is queued on the device
                if pending is not None:
                    total_loss += self._log_train_batch(progress, *pending)
                    n_batches += 1
            pending = (global_step, batch_idx, metrics, images, masks)

        if pending is not None:
            total_loss += self._log_train_batch(progress, *pending)
            n_batches += 1

        perf = timer.summary()
        if perf.get("steps"):
            self.logger.log_scalar("perf/steps_per_sec", perf["steps_per_sec"], epoch)
            self.logger.log_scalar("perf/tiles_per_sec", perf["items_per_sec"], epoch)
            self.logger.log_scalar("perf/step_ms_p50", perf["step_ms_p50"], epoch)
        return state, total_loss / max(n_batches, 1)

    def _log_train_batch(self, progress, global_step, batch_idx, metrics,
                         images, masks) -> float:
        """Read back and log one (already queued) step's metrics; returns its loss."""
        loss, iou, acc = _scalars(metrics["loss"], metrics["iou"], metrics["accuracy"])
        self.logger.log_scalar("train/loss", loss, global_step)
        self.logger.log_scalar("train/iou", iou, global_step)
        self.logger.log_scalar("train/accuracy", acc, global_step)
        self.logger.log_scalar("train/learning_rate", self._lr, global_step)

        if batch_idx % Config.LOG_INTERVAL == 0:
            self._log_figures(images, masks, metrics["hist"], global_step, "train")
            per_class = _host(metrics["per_class_iou"])
            for c in range(self.num_classes):
                self.logger.log_scalar(f"train/iou_class_{c}", float(per_class[c]),
                                       global_step)
        epoch, n_total = progress
        if batch_idx % Config.LOG_INTERVAL == 0 or batch_idx + 1 == n_total:
            print(f"Epoch {epoch} [{batch_idx + 1}/{n_total}] loss {loss:.4f} "
                  f"iou {iou:.4f} acc {acc:.4f}", flush=True)
        return loss

    def validate(self, dataloader):
        """Full-dataset validation.  'iou' and 'accuracy' are means over the
        batches; 'iou_epoch' is the IoU of the summed confusion matrix."""
        self._build_steps()
        total_loss, per_batch_iou, per_batch_acc, n = 0.0, [], [], 0
        hist_sum = None
        for batch_idx, (images, masks) in enumerate(_raw_batches(dataloader)):
            m = self._eval_step(images, masks)
            loss, iou, acc = _scalars(m["loss"], m["iou"], m["accuracy"])
            total_loss += loss
            per_batch_iou.append(iou)
            per_batch_acc.append(acc)
            hist_sum = m["hist"] if hist_sum is None else hist_sum + m["hist"]
            n += 1

            if batch_idx % Config.LOG_INTERVAL == 0:
                self._log_figures(images, masks, m["hist"], self.current_epoch, "val")

        epoch_iou = iou_from_hist(hist_sum)[1].item() if hist_sum is not None else 0.0
        avg = {
            "loss": total_loss / max(n, 1),
            "iou": float(np.mean(per_batch_iou)) if per_batch_iou else 0.0,
            "accuracy": float(np.mean(per_batch_acc)) if per_batch_acc else 0.0,
            "iou_epoch": float(epoch_iou),
        }
        for k, v in avg.items():
            self.logger.log_scalar(f"val/{k}", v, self.current_epoch)
        return avg

    # ------------------------------------------------------------------
    def train(self, train_dataloader, valid_dataloader, epochs: int,
              learning_rate: float, patience: int = 7):
        """Full training run; returns the early stopper's best metrics (empty
        before ``min_epochs``)."""
        self._build_steps()
        self._lr = float(learning_rate)
        state = TrainState(self.model, adam(learning_rate))

        early_stopping = EarlyStopping(
            patience=patience, mode="max", min_epochs=10,
            metrics_to_track=["loss", "iou", "accuracy"],
            weights={"loss": -1.0, "iou": 1.0, "accuracy": 0.5},
            verbose=True)

        self.current_epoch = 0
        profile_dir = os.environ.get("UDA_TPU_PROFILE")
        for epoch in range(1, epochs + 1):
            self.current_epoch = epoch
            if profile_dir and epoch == 2:
                # trace the second epoch: the first includes the warm-up
                with trace(profile_dir):
                    state, train_loss = self.train_epoch(train_dataloader, state, epoch)
            else:
                state, train_loss = self.train_epoch(train_dataloader, state, epoch)
            valid_metrics = self.validate(valid_dataloader)

            print(f"Train Loss: {train_loss:.4f}")
            print(f'Valid Loss: {valid_metrics["loss"]:.4f}')
            print(f"Valid Metrics: {valid_metrics}")

            if early_stopping(epoch, valid_metrics, self.logger):
                print(f"Early stopping triggered. Best metrics: "
                      f"{early_stopping.get_best_metrics()}")
                break

            if valid_metrics == early_stopping.get_best_metrics():
                save_checkpoint({
                    "epoch": epoch,
                    "model_state_dict": to_jax_state_dict(self.model),
                    "optimizer_state_dict": state.optimizer.state_dict(),
                    "metrics": valid_metrics,
                    "improvement_rates": early_stopping.get_improvement_rate(),
                }, Path(Config.CHECKPOINTS_DIR) / "best_model.pth")
                print("Saved new best model!")

        self.logger.close()
        return early_stopping.get_best_metrics()


def train_model(epochs: Optional[int] = None, learning_rate: Optional[float] = None,
                batch_size: Optional[int] = None, start_tensorboard: bool = False):
    """Standalone training entry point: the class dictionary, the sample
    dataset split ``TRAIN_VAL_SPLIT`` with weighted sampling of the training
    part, the configured model, ``SegmentationTrainer.train``, and the final
    checkpoint under ``CHECKPOINT_DIR``.  Tiles are decoded at
    ``Config.IMAGE_SIZE`` (through the native decoder where it is built)."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.data.dataset import (
        DroneDataset,
        random_split,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.data.loader import DataLoader
    from uda_aerial_semantic_segmentation_research_tpu_torch.models import create_model

    epochs = epochs or Config.NUM_EPOCHS
    learning_rate = learning_rate or Config.LEARNING_RATE
    batch_size = batch_size or Config.BATCH_SIZE

    class_dict = load_class_dict()
    if start_tensorboard:
        launch_tensorboard(Config.LOGS_DIR)

    device = Config.get_device()
    print(f"Device: {device}")

    dataset = DroneDataset(
        images_dir=os.path.join(Config.SAMPLE_DATA_DIR, "original_images"),
        masks_dir=os.path.join(Config.SAMPLE_DATA_DIR, "label_images_semantic"),
        balance_classes=True, image_size=Config.IMAGE_SIZE)
    train_size = int(Config.TRAIN_VAL_SPLIT * len(dataset))
    train_ds, val_ds = random_split(
        dataset, [train_size, len(dataset) - train_size], seed=Config.SEED)
    sampler = dataset.get_sampler(indices=train_ds.indices)
    train_loader = DataLoader(train_ds, batch_size=batch_size, sampler=sampler,
                              drop_last=False, num_workers=Config.NUM_WORKERS)
    val_loader = DataLoader(val_ds, batch_size=batch_size)

    model = create_model(model_name=Config.MODEL_NAME, encoder_name=Config.ENCODER_NAME,
                         encoder_weights=Config.ENCODER_WEIGHTS,
                         in_channels=Config.IN_CHANNELS, classes=Config.NUM_CLASSES,
                         device=device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Model: {Config.MODEL_NAME} ({n_params:,} params)")

    trainer = SegmentationTrainer(model, device)
    best = trainer.train(train_loader, val_loader, epochs=epochs,
                         learning_rate=learning_rate, patience=Config.PATIENCE)

    final_path = Path(Config.CHECKPOINT_DIR) / "final_model.pth"
    save_checkpoint({"model_state_dict": to_jax_state_dict(model), "metrics": best,
                     "class_dict": class_dict}, final_path)
    print(f"Saved final model to {final_path}")
    return model, best


# kept beside the trainer as in the JAX package (the reference's dice scoring)
dice_loss = DiceLoss()

if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="Supervised segmentation training")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--learning-rate", type=float, default=None)
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    parser.add_argument("--tensorboard", action="store_true",
                        help="launch a TensorBoard server on the log dir")
    args = parser.parse_args()
    Config.apply_env_overrides()
    if args.device:
        Config.DEVICE = args.device
    train_model(epochs=args.epochs, learning_rate=args.learning_rate,
                batch_size=args.batch_size, start_tensorboard=args.tensorboard)
