"""Phase-2 adversarial domain-adaptation trainer.

Counterpart of the JAX package's ``training/adversarial_trainer.py``: an
image-level discriminator learns to tell source (1) from target (0) and the
segmentation "generator" trains on source CE plus a ``lambda_adv``-scaled
term pushing D(target) toward 1 (``steps.make_adversarial_train_step``: D
update, then G update, in one step).  The cycling target iterator lives on
the host; a short target batch is cycled to the source batch's size.

As in the phase-1 trainer (``training/train.py``): the models train in
place, batches reach the device through ``prefetch_to_device``, the
augmentation's draws come from one ``torch.Generator`` per epoch, and a
step's metrics are read back (in one read) while the next step is queued.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
from uda_aerial_semantic_segmentation_research_tpu_torch.models import create_discriminator
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.losses import AdversarialLoss
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.metrics import (
    DomainAdaptationMetrics,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.training import steps as step_lib
from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import (
    AdversarialState,
    TrainState,
    adam,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.training.train import (
    SegmentationTrainer,
    _raw_batches,
    _scalars,
)


def _cycle_raw(dataloader, device=None):
    """Endlessly cycle the raw batches of a loader (on ``device`` when given)."""
    while True:
        got = False
        for batch in _raw_batches(dataloader, device):
            got = True
            yield batch
        if not got:
            raise ValueError("empty target dataloader")


def match_batch_size(arr, b: int):
    """Cycle-repeat, then trim, ``arr`` (numpy or tensor) to exactly ``b``
    leading rows, so that every source batch is paired with a target batch
    of its size."""
    if arr.shape[0] < b:
        reps = -(-b // arr.shape[0])
        arr = (torch.cat([arr] * reps) if isinstance(arr, torch.Tensor)
               else np.concatenate([arr] * reps))
    return arr[:b] if arr.shape[0] > b else arr


class AdversarialTrainer(SegmentationTrainer):
    """Adversarial UDA trainer (phase 2) on one device."""

    def __init__(self, model: torch.nn.Module, device=None, lambda_adv: float = 0.001):
        super().__init__(model, device)
        self.discriminator = create_discriminator(
            input_channels=3, image_size=Config.IMAGE_SIZE, device=self.device)
        self.adversarial_loss = AdversarialLoss(lambda_adv)
        self.lambda_adv = float(lambda_adv)
        self.domain_metrics = DomainAdaptationMetrics()
        self._adv_step = None

    def calculate_iou(self, pred, target) -> float:
        """Binary IoU of two masks: |p & t| / (|p | t| + 1e-8)."""
        p = np.asarray(pred).astype(bool)
        t = np.asarray(target).astype(bool)
        inter = np.float32(np.logical_and(p, t).sum())
        union = np.float32(np.logical_or(p, t).sum())
        return float(inter / (union + np.float32(1e-8)))

    def _build_adv_step(self):
        if self._adv_step is None:
            self._adv_step = step_lib.make_adversarial_train_step(
                self.model, self.discriminator, self.num_classes, self.lambda_adv)

    # ------------------------------------------------------------------
    def train_epoch(self, source_dataloader, target_dataloader, state: AdversarialState,
                    epoch: int):
        """One adversarial epoch; returns (state, mean total loss, domain metrics)."""
        self._build_adv_step()
        self.domain_metrics.reset()
        total_loss, n = 0.0, 0
        target_iter = _cycle_raw(target_dataloader, self.device)
        n_total = len(source_dataloader) if hasattr(source_dataloader, "__len__") else None
        generator = self._epoch_generator(epoch)

        def log_pending(global_step, batch_idx, metrics):
            """Read back (one read) and log one already-queued step."""
            b = metrics["source_domain_prob"].numel()
            values = torch.cat([
                torch.stack([metrics[k].float() for k in ("loss", "seg_loss", "d_loss",
                                                          "adv_loss")]),
                metrics["source_domain_prob"].reshape(-1),
                metrics["target_domain_prob"].reshape(-1)]).tolist()
            loss, seg_loss, d_loss, adv_loss = values[:4]
            self.domain_metrics.update(np.float32(values[4:4 + b]),
                                       np.float32(values[4 + b:]))
            self.logger.log_scalar("train/seg_loss", seg_loss, global_step)
            self.logger.log_scalar("train/d_loss", d_loss, global_step)
            self.logger.log_scalar("train/adv_loss", adv_loss, global_step)
            if batch_idx % Config.LOG_INTERVAL == 0 or batch_idx + 1 == n_total:
                md = self.domain_metrics.get_metrics()
                print(f"Epoch {epoch} [{batch_idx + 1}/{n_total}] seg_loss {seg_loss:.4f} "
                      f"d_loss {d_loss:.4f} adv_loss {adv_loss:.4f} "
                      f"domain_conf {md['domain_confusion']:.4f}", flush=True)
            return loss

        pending = None
        for batch_idx, (src_images, src_masks) in enumerate(
                _raw_batches(source_dataloader, self.device)):
            tgt_images, _ = next(target_iter)
            tgt_images = match_batch_size(tgt_images, src_images.shape[0])
            state, metrics = self._adv_step(state, generator, src_images, src_masks,
                                            tgt_images)
            if pending is not None:
                total_loss += log_pending(*pending)
                n += 1
            pending = ((epoch - 1) * (n_total or 1) + batch_idx, batch_idx, metrics)

        if pending is not None:
            total_loss += log_pending(*pending)
            n += 1
        return state, total_loss / max(n, 1), self.domain_metrics.get_metrics()

    # ------------------------------------------------------------------
    def validate(self, dataloader, state: Optional[AdversarialState] = None):
        """Source-val CE, IoU and accuracy as ``(loss, {"iou", "accuracy"})``
        floats (means over batches).  ``state`` is accepted for the JAX
        signature: the models train in place."""
        del state
        self._build_steps()
        total_loss, ious, accs, n = 0.0, [], [], 0
        for images, masks in _raw_batches(dataloader):
            m = self._eval_step(images, masks)
            loss, iou, acc = _scalars(m["loss"], m["iou"], m["accuracy"])
            total_loss += loss
            ious.append(iou)
            accs.append(acc)
            n += 1
        metrics = {"iou": float(np.mean(ious)) if ious else 0.0,
                   "accuracy": float(np.mean(accs)) if accs else 0.0}
        return total_loss / max(n, 1), metrics

    # ------------------------------------------------------------------
    def train(self, source_dataloader, target_dataloader, valid_dataloader, epochs: int,
              learning_rate: float, patience: int = 3):
        """Adversarial training loop: one Adam per model at ``learning_rate``,
        early stopping on the validation loss after ``patience`` epochs
        without improvement.  Returns the best validation loss."""
        self._build_steps()
        self._build_adv_step()
        self._lr = float(learning_rate)
        state = AdversarialState(seg=TrainState(self.model, adam(learning_rate)),
                                 disc=TrainState(self.discriminator, adam(learning_rate)))

        best_valid_loss = float("inf")
        patience_counter = 0
        for epoch in range(1, epochs + 1):
            self.current_epoch = epoch
            state, train_loss, domain_metrics = self.train_epoch(
                source_dataloader, target_dataloader, state, epoch)
            valid_loss, valid_metrics = self.validate(valid_dataloader, state)

            print(f"Train Loss: {train_loss:.4f}")
            print(f"Valid Loss: {valid_loss:.4f}")
            print(f"Valid Metrics: {valid_metrics}")
            print(f"Domain Metrics: {domain_metrics}")
            self.logger.log_scalar("val/loss", valid_loss, epoch)
            self.logger.log_scalars("val/domain", domain_metrics, epoch)

            if valid_loss < best_valid_loss:
                best_valid_loss = valid_loss
                patience_counter = 0
            else:
                patience_counter += 1
                if patience_counter >= patience:
                    print(f"Early stopping after {epoch} epochs")
                    break
        self.logger.flush()
        return best_valid_loss
