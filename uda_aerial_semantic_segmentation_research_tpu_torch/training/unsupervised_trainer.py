"""Phase-3 unsupervised fine-tuning trainer.

Counterpart of the JAX package's ``training/unsupervised_trainer.py``:
consistency regularization between two ``STRONG`` views of unlabeled
target images plus a domain-confusion term, with a linear rampup
(``steps.make_unsupervised_train_step``), one clipped Adam over the
segmentation and discriminator parameters together, non-finite updates
dropped on the device, IoU-max early stopping.

It accepts a plain segmentation model or a ``DomainAdaptationModel`` and
reuses that model's discriminator when it has one (a fresh one otherwise).
As in the JAX trainer, both slots of the domain metrics receive the target
probabilities (phase 3 has no source batch).

The memory options resolve as in the JAX trainer, with the card in the
TPU's place (``resolve_phase3_options``); remat, the sequential split and
the bf16 logits are exact, the bf16 carry rounds the KL targets:

- ``remat``: ``"auto"`` is ``"encoder"`` (per-block recompute of the
  encoder); any ``Unet`` remat mode is accepted;
- ``sequential``: ``None`` is on when the trainer's device is CUDA
  (``make_unsupervised_sequential_step``, one forward and backward at a
  time), with ``carry_dtype=torch.bfloat16`` unless one is given; off on the
  CPU (the joint ``make_unsupervised_train_step``);
- a bf16 U-Net with float32 logits computes bf16 logits inside the step
  (value-identical: the head computes in bf16).

The step runs a ``Unet.clone`` carrying these options, which shares the
model's parameters and buffers: ``self.model`` itself keeps its own remat
and logits dtype for validation, prediction and checkpoints.

Under a process group each process trains on its rows of the global batch
(``_setup_mesh``, as the phase-1 trainer), the domain metrics
gather every process's probabilities, and validation runs the whole set on
every process.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch

from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
from uda_aerial_semantic_segmentation_research_tpu_torch.models import create_discriminator
from uda_aerial_semantic_segmentation_research_tpu_torch.models.domain_model import (
    DomainAdaptationModel,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.losses import FineTuningLoss
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.metrics import (
    DomainAdaptationMetrics,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.parallel import distributed as dist
from uda_aerial_semantic_segmentation_research_tpu_torch.training import steps as step_lib
from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import (
    TrainState,
    adam,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.training.train import (
    SegmentationTrainer,
    _raw_batches,
    _scalars,
)

_LOSS_NAMES = ("total", "consistency", "domain_confusion", "supervised", "rampup_weight")


def resolve_phase3_options(device, remat="auto", sequential: Optional[bool] = None,
                           carry_dtype=None):
    """``(remat, sequential, carry_dtype)`` as the trainer runs them on
    ``device``: ``"auto"`` -> ``"encoder"``; ``sequential=None`` -> whether
    ``device`` is CUDA, and then a missing ``carry_dtype`` -> bfloat16."""
    remat = "encoder" if remat == "auto" else remat
    if sequential is None:
        sequential = torch.device(device).type == "cuda"
        if sequential and carry_dtype is None:
            carry_dtype = torch.bfloat16
    return remat, sequential, carry_dtype


class UnsupervisedTrainer(SegmentationTrainer):
    """Unsupervised consistency fine-tuning (phase 3), one device per process."""

    def __init__(self, model, device=None, consistency_weight: float = 1.0,
                 domain_weight: float = 0.1, supervised_weight: float = 0.1,
                 rampup_length: int = 40, log_interval: int = 10, patience: int = 7,
                 remat="auto", sequential: Optional[bool] = None, carry_dtype=None):
        if isinstance(model, DomainAdaptationModel):
            seg, discriminator = model.segmentation_model, model.discriminator
        else:
            seg, discriminator = model, None
        super().__init__(seg, device)
        if discriminator is None:
            discriminator = create_discriminator(input_channels=3,
                                                 image_size=Config.IMAGE_SIZE,
                                                 device=self.device)
        self.discriminator = discriminator.to(self.device)
        self.domain_model = DomainAdaptationModel(seg, self.discriminator)

        self.fine_tuning_loss = FineTuningLoss(
            consistency_weight=consistency_weight, domain_weight=domain_weight,
            supervised_weight=supervised_weight, rampup_length=rampup_length)
        self.domain_metrics = DomainAdaptationMetrics()
        self.log_interval = log_interval
        self.patience = patience
        self.remat, self.sequential, self.carry_dtype = resolve_phase3_options(
            self.device, remat, sequential, carry_dtype)

        self.best_score = float("-inf")
        self.best_epoch = 0
        self.counter = 0
        self._unsup_steps: dict = {}

    # ------------------------------------------------------------------
    def _make_state(self, learning_rate: float) -> TrainState:
        """One Adam over both models, gradients clipped at a global norm of
        1.0, non-finite updates dropped on the device."""
        return TrainState(self.domain_model, adam(learning_rate, clip_norm=1.0),
                          skip_nonfinite=True)

    def _step_model(self):
        """The U-Net the step runs: ``self.model``, or a clone of it (shared
        parameters and buffers) with the trainer's remat and, for a bf16
        U-Net with float32 logits, bf16 logits."""
        changes = {}
        if getattr(self.model, "remat", self.remat) != self.remat:
            changes["remat"] = self.remat
        if (getattr(self.model, "dtype", None) == torch.bfloat16
                and getattr(self.model, "logits_dtype", None) == torch.float32):
            changes["logits_dtype"] = torch.bfloat16
        return self.model.clone(**changes) if changes else self.model

    def _get_unsup_step(self, with_supervised: bool):
        if with_supervised not in self._unsup_steps:
            if self.sequential:
                make = functools.partial(step_lib.make_unsupervised_sequential_step,
                                         carry_dtype=self.carry_dtype)
            else:
                make = step_lib.make_unsupervised_train_step
            self._unsup_steps[with_supervised] = make(
                self._step_model(), self.discriminator, self.num_classes,
                self.fine_tuning_loss, with_supervised=with_supervised)
        return self._unsup_steps[with_supervised]

    # ------------------------------------------------------------------
    def train_epoch(self, target_dataloader, state: TrainState, epoch: int,
                    supervised_dataloader=None):
        """One unsupervised epoch; returns (state, mean finite loss, domain metrics)."""
        self.domain_metrics.reset()
        total_loss, n = 0.0, 0
        n_total = len(target_dataloader) if hasattr(target_dataloader, "__len__") else None

        sup_iter = None
        if supervised_dataloader is not None:
            def _cycle():
                while True:
                    yield from _raw_batches(supervised_dataloader, self.device)
            sup_iter = _cycle()
        step = self._get_unsup_step(sup_iter is not None)
        generator = self._epoch_generator(epoch)

        def log_pending(batch_idx, metrics):
            """Read back (one read) and log one already-queued step."""
            nonlocal total_loss, n
            values = torch.cat([torch.stack([metrics[k].float() for k in _LOSS_NAMES]),
                                dist.gather_rows(metrics["domain_prob"]).reshape(-1)]).tolist()
            losses = dict(zip(_LOSS_NAMES, values))
            probs = np.float32(values[len(_LOSS_NAMES):])
            # phase 3 has no source batch: both slots see the target probabilities
            self.domain_metrics.update(source_pred=probs, target_pred=probs)
            loss = losses["total"]
            if np.isfinite(loss):
                total_loss += loss
                n += 1
            md = self.domain_metrics.get_metrics()
            if batch_idx % self.log_interval == 0:
                self._log_training_step(losses, md, epoch * (n_total or 1) + batch_idx)
            if batch_idx % Config.LOG_INTERVAL == 0 or batch_idx + 1 == n_total:
                shown = f"{loss:.4f}" if np.isfinite(loss) else "NaN"
                print(f"Epoch {epoch} [{batch_idx + 1}/{n_total}] loss {shown} "
                      f"cons_loss {losses['consistency']:.4f} "
                      f"domain_conf {md['domain_confusion']:.4f} "
                      f"rampup {losses['rampup_weight']:.2f}", flush=True)

        pending = None
        for batch_idx, (tgt_images, _) in enumerate(
                _raw_batches(target_dataloader, self.device)):
            if sup_iter is not None:
                sup_images, sup_masks = next(sup_iter)
                state, metrics = step(state, generator, tgt_images, float(epoch),
                                      sup_images, sup_masks)
            else:
                state, metrics = step(state, generator, tgt_images, float(epoch))
            if pending is not None:
                log_pending(*pending)
            pending = (batch_idx, metrics)

        if pending is not None:
            log_pending(*pending)
        return state, total_loss / max(n, 1), self.domain_metrics.get_metrics()

    # ------------------------------------------------------------------
    def _log_training_step(self, loss_dict: Dict, metrics: Dict[str, float], step: int):
        for name in _LOSS_NAMES:
            if name in loss_dict:
                self.logger.log_scalar(f"train/loss_{name}", float(loss_dict[name]), step)
        for name, value in metrics.items():
            self.logger.log_scalar(f"train/{name}", float(value), step)

    def _log_validation_step(self, metrics: Dict[str, float], step: int):
        for name, value in metrics.items():
            self.logger.log_scalar(f"val/{name}", float(value), step)
        for name, value in self.domain_metrics.get_metrics().items():
            self.logger.log_scalar(f"val/domain_{name}", float(value), step)

    # ------------------------------------------------------------------
    def validate(self, dataloader, state: Optional[TrainState] = None):
        """Labelled source-val ``{"iou", "accuracy", "loss"}``, means over the
        batches, logged every ``log_interval`` batches.  ``state`` is
        accepted for the JAX signature: the models train in place
        (``_local_eval_variables``).  The whole set on every process, with
        no collective."""
        del state
        self._build_steps()
        total_iou, accs, losses, n = 0.0, [], [], 0
        metrics: Dict[str, float] = {}
        for batch_idx, (images, masks) in enumerate(_raw_batches(dataloader)):
            m = self._eval_step(images, masks)
            iou, acc, loss = _scalars(m["iou"], m["accuracy"], m["loss"])
            metrics = {"iou": iou, "accuracy": acc, "loss": loss}
            total_iou += iou
            accs.append(acc)
            losses.append(loss)
            if batch_idx % self.log_interval == 0:
                self._log_validation_step(
                    metrics, self.current_epoch * max(len(dataloader), 1) + batch_idx)
            n += 1
        metrics["iou"] = total_iou / max(n, 1)
        if accs:
            metrics["accuracy"] = float(np.mean(accs))
            metrics["loss"] = float(np.mean(losses))
        return metrics

    # ------------------------------------------------------------------
    def train(self, target_dataloader, valid_dataloader, epochs: int, learning_rate: float,
              supervised_dataloader=None, patience: Optional[int] = None):
        """The fine-tuning loop; returns the best validation IoU."""
        if patience is not None:
            self.patience = patience
        self._lr = float(learning_rate)
        state = self._setup_mesh(target_dataloader, self._make_state(learning_rate))
        for epoch in range(1, epochs + 1):
            self.current_epoch = epoch
            state, train_loss, train_metrics = self.train_epoch(
                target_dataloader, state, epoch, supervised_dataloader=supervised_dataloader)
            valid_metrics = self.validate(valid_dataloader, state)

            print(f"\nEpoch {epoch}:")
            print(f"Train Loss: {train_loss:.4f}")
            print(f"Train Metrics: {train_metrics}")
            print(f"Valid Metrics: {valid_metrics}")

            if self.early_stopping(epoch, valid_metrics):
                print("Early stopping triggered")
                break
        self.logger.flush()
        return self.best_score

    # ------------------------------------------------------------------
    def early_stopping(self, epoch: int, metrics: Dict[str, float]) -> bool:
        """IoU-max early stopping with the ``early_stopping/*`` scalars."""
        current_score = float(metrics.get("iou", 0))
        if current_score > self.best_score:
            self.best_score = current_score
            self.best_epoch = epoch
            self.counter = 0
        else:
            self.counter += 1

        self.logger.log_scalar("early_stopping/score", current_score, epoch)
        self.logger.log_scalar("early_stopping/counter", self.counter, epoch)

        if self.counter >= self.patience:
            print(f"\nEarly stopping triggered. Best score: "
                  f"{self.best_score:.4f} at epoch {self.best_epoch}")
            return True
        return False
