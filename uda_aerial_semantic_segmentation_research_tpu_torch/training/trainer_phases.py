"""Self-contained multi-phase trainer over the GRL UDA model.

Counterpart of the JAX package's ``training/trainer_phases.py``: it trains a
``UDASegmentationModel`` (a U-Net whose bottleneck feeds a feature-level
domain discriminator through a gradient-reversal layer) with one Adam per
phase, each phase starting a fresh one:

- ``phase1_train``  supervised segmentation with ``SMPDiceLoss``
                    (``make_supervised_train_step(..., seg_loss="dice")``),
                    validated with the same criterion; a patience counter
                    on the validation IoU;
- ``phase2_train``  the joint ``dice + lambda_domain * domain`` GRL loss
                    (``make_grl_sequential_step``), validated on source and
                    target batches (``make_grl_eval_step``); the selection
                    score is ``val_iou * val_domain_acc``;
- ``phase3_train``  MSE between the segmentations of two ``STRONG`` views
                    plus ``confusion_weight * -mean|sigmoid(d) - 0.5|`` on
                    the un-augmented batch (sigmoid first: the JAX
                    package's documented divergence from the reference).

``phase{n}_best.pth`` holds ``model_state_dict`` in the JAX layout,
``metrics`` and ``phase``.  As in the port's other trainers, the model
trains in place, batches reach the device through ``prefetch_to_device``
and the augmentation draws from one ``torch.Generator`` per phase and
epoch, seeded with ``SeedSequence([Config.SEED, phase, epoch])`` (the JAX
trainer splits one key per step).  A step reads nothing back to the host;
phase 2's ``domain_acc`` and phase 3's losses are read once, at the end of
the epoch.  Under a process group (``parallel.distributed``) each process
trains on its rows of the global batch (``_engage_mesh``, the JAX
trainer's), the steps' collectives make the global batch's update, and
phase 2's validation scores -- taken on process-local target batches -- are
process 0's on every process (``broadcast_from_primary``), so the
checkpoint selection and the patience counter agree everywhere.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
from uda_aerial_semantic_segmentation_research_tpu_torch.models.convert import (
    to_jax_state_dict,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.augment import (
    STRONG,
    normalize_images,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.parallel import distributed as dist
from uda_aerial_semantic_segmentation_research_tpu_torch.training import steps as step_lib
from uda_aerial_semantic_segmentation_research_tpu_torch.training.adversarial_trainer import (
    _cycle_raw,
    match_batch_size,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import (
    TrainState,
    adam,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.training.train import (
    _raw_batches,
    _scalars,
    data_parallel_mesh,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.utils.checkpoint import (
    save_checkpoint,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.utils.device import (
    resolve_device,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.visualization.tensorboard_logger import (
    TensorboardLogger,
)


def _epoch_mean(values) -> float:
    """The mean of an epoch's per-step device scalars, read back in one
    transfer (0.0 for none)."""
    if not values:
        return 0.0
    return float(np.mean(torch.stack([v.float() for v in values]).tolist()))


class MultiPhaseTrainer:
    """Three-phase UDA training of a ``UDASegmentationModel``, one device per
    process."""

    def __init__(self, model: torch.nn.Module, device=None,
                 checkpoint_dir: str = "checkpoints", num_classes: Optional[int] = None,
                 lambda_domain: float = 0.001, confusion_weight: float = 0.1,
                 log_dir: Optional[str] = None):
        """``model``: the module ``create_uda_model`` returns, moved to
        ``device`` (default ``Config.get_device()``: ``cuda``, an error
        without a GPU).  ``lambda_domain``: phase 2's joint-loss weight;
        ``confusion_weight``: phase 3's domain-confusion weight (the
        reference's 0.001 and 0.1)."""
        self.device = resolve_device(device) if device is not None else Config.get_device()
        self.model = model.to(self.device)
        self.num_classes = num_classes or Config.NUM_CLASSES
        self.lambda_domain = float(lambda_domain)
        self.confusion_weight = float(confusion_weight)
        self.checkpoint_dir = Path(checkpoint_dir)
        self.checkpoint_dir.mkdir(parents=True, exist_ok=True)
        self.logger = TensorboardLogger(log_dir=log_dir or Config.LOGS_DIR)
        self._steps: dict = {}
        self._mesh = None

    def _generator(self, phase: int, epoch: int) -> torch.Generator:
        seed = np.random.SeedSequence([Config.SEED, phase, epoch]).generate_state(1, np.uint64)[0]
        return torch.Generator(device=self.device).manual_seed(int(seed) & ((1 << 63) - 1))

    def _state(self, lr: float) -> TrainState:
        """A fresh Adam over every parameter of the model."""
        return TrainState(self.model, adam(lr))

    # ------------------------------------------------------------------
    # data parallelism (the contract of SegmentationTrainer._setup_mesh,
    # training/train.py)
    # ------------------------------------------------------------------
    def _engage_mesh(self, loader, state) -> TrainState:
        """With several processes: the data-parallel mesh, and ``state``
        checked to be the same on every process; a no-op otherwise."""
        del loader
        self._mesh = data_parallel_mesh()
        return state if self._mesh is None else dist.replicate_global(state, self._mesh)

    # ------------------------------------------------------------------
    # step builders (cached per phase)
    # ------------------------------------------------------------------
    def _phase1_step(self):
        if "p1" not in self._steps:
            self._steps["p1"] = step_lib.make_supervised_train_step(
                self.model, self.num_classes, seg_loss="dice")
        return self._steps["p1"]

    def _phase2_step(self):
        if "p2" not in self._steps:
            self._steps["p2"] = step_lib.make_grl_sequential_step(
                self.model, self.num_classes, lambda_domain=self.lambda_domain)
        return self._steps["p2"]

    def _phase3_step(self):
        """``step(state, generator, tgt_images, draws=None) -> (state,
        metrics)``: two ``STRONG`` views v1, v2 (draws from ``generator`` in
        that order, or ``draws = ((abc, params) of v1, (abc, params) of
        v2)``) and ``x0 = normalize_images(tgt_images)``; three train-mode
        forwards whose BatchNorm statistics chain v1 -> v2 -> x0 (x0 runs
        the whole U-Net as well, its segmentation dropped at once, so its
        decoder gets no gradient); ``mse(p1, p2) + confusion_weight *
        -mean|sigmoid(d) - 0.5|``; one Adam update, no clip.  Metrics:
        ``loss``, ``consistency``, ``confusion`` (device tensors)."""
        if "p3" in self._steps:
            return self._steps["p3"]
        model, confusion_weight = self.model, self.confusion_weight

        def step(state, generator, tgt_images, draws=None):
            if state.model is not model:
                raise ValueError("the state belongs to another model than the step")
            tgt_images = torch.as_tensor(tgt_images, device=step_lib.model_device(model))
            with torch.no_grad():
                views = [step_lib._augment(generator, tgt_images, None, STRONG,
                                           *step_lib._draws(draws, i))[0] for i in range(2)]
                x0 = normalize_images(tgt_images)
            model.train()
            state.optimizer.zero_grad(set_to_none=True)
            p1 = model(views[0])
            p2 = model(views[1])
            d_logits = model(x0, domain_adaptation=True)[1]
            consistency = ((p1.float() - p2.float()) ** 2).mean()
            confusion = -(torch.sigmoid(d_logits) - 0.5).abs().mean()
            total = consistency + confusion_weight * confusion
            total.backward()
            state.apply_gradients()
            return state, dist.reduce_metrics({"loss": total.detach(),
                                               "consistency": consistency.detach(),
                                               "confusion": confusion.detach()})

        self._steps["p3"] = step
        return step

    # ------------------------------------------------------------------
    def _save_best(self, phase: int, metrics: Dict[str, float]):
        save_checkpoint({"model_state_dict": to_jax_state_dict(self.model),
                         "metrics": metrics, "phase": phase},
                        self.checkpoint_dir / f"phase{phase}_best.pth")

    def _log_metrics(self, metrics: Dict[str, float], step: int, prefix: str):
        for k, v in metrics.items():
            if np.ndim(v) == 0:
                self.logger.log_scalar(f"{prefix}/{k}", float(v), step)

    # ------------------------------------------------------------------
    # phase 1: supervised
    # ------------------------------------------------------------------
    def phase1_train(self, train_loader, val_loader, epochs: int = 50,
                     learning_rate: float = 1e-4, patience: int = 7):
        """Returns the best validation IoU."""
        step = self._phase1_step()
        eval_step = step_lib.make_eval_step(self.model, self.num_classes, seg_loss="dice")
        state = self._engage_mesh(train_loader, self._state(learning_rate))
        best_iou, counter = -1.0, 0
        for epoch in range(1, epochs + 1):
            generator = self._generator(1, epoch)
            for images, masks in _raw_batches(train_loader, self.device):
                state, _ = step(state, generator, images, masks)
            val = self._validate_phase1(val_loader, eval_step)
            self._log_metrics(val, epoch, "phase1/val")
            if val["iou"] > best_iou:
                best_iou, counter = val["iou"], 0
                self._save_best(1, val)
            else:
                counter += 1
                if counter >= patience:
                    break
        self.logger.flush()
        return best_iou

    def _validate_phase1(self, val_loader, eval_step) -> Dict[str, float]:
        rows = []
        for images, masks in _raw_batches(val_loader):
            m = eval_step(images, masks)
            rows.append(_scalars(m["iou"], m["accuracy"], m["loss"]))
        means = [float(np.mean(col)) for col in zip(*rows)] if rows else [0.0] * 3
        return dict(zip(("iou", "accuracy", "loss"), means))

    # ------------------------------------------------------------------
    # phase 2: GRL adversarial
    # ------------------------------------------------------------------
    def phase2_train(self, source_loader, target_loader, val_loader, epochs: int = 30,
                     learning_rate: float = 5e-5, patience: int = 7, alpha: float = 1.0,
                     target_val_loader=None):
        """Returns the best selection score ``val_iou * val_domain_acc``.

        ``target_val_loader``: unlabelled target batches for validation;
        when None, the target TRAIN batches stand in (the fixtures carry no
        target validation split)."""
        step = self._phase2_step()
        eval_step = step_lib.make_grl_eval_step(self.model, self.num_classes,
                                                lambda_domain=self.lambda_domain)
        state = self._engage_mesh(source_loader, self._state(learning_rate))
        best_score, counter = -1.0, 0
        target_iter = _cycle_raw(target_loader, self.device)
        for epoch in range(1, epochs + 1):
            generator = self._generator(2, epoch)
            accs = []
            for src_images, src_masks in _raw_batches(source_loader, self.device):
                tgt_images, _ = next(target_iter)
                tgt_images = match_batch_size(tgt_images, src_images.shape[0])
                state, m = step(state, generator, src_images, src_masks, tgt_images,
                                float(alpha))
                accs.append(m["domain_acc"])
            if accs:
                self._log_metrics({"domain_acc": _epoch_mean(accs)}, epoch, "phase2/train")

            val = self._validate_phase2(
                val_loader,
                target_val_loader if target_val_loader is not None else target_loader,
                eval_step)
            score = val["iou"] * val["domain_acc"]
            val["score"] = score
            self._log_metrics(val, epoch, "phase2/val")
            if score > best_score:
                best_score, counter = score, 0
                self._save_best(2, val)
            else:
                counter += 1
                if counter >= patience:
                    break
        self.logger.flush()
        return best_score

    def _validate_phase2(self, val_loader, target_val_loader, eval_step) -> Dict[str, float]:
        """Per source-val batch a target-val batch from a fresh cycling
        iterator, matched to its size; means of ``iou``, ``accuracy``,
        ``loss`` (dice + lambda * domain) and ``domain_acc``, process 0's on
        every process (the target batches may be process-local)."""
        keys = ("iou", "accuracy", "loss", "domain_acc")
        target_iter = _cycle_raw(target_val_loader)
        rows = []
        for images, masks in _raw_batches(val_loader):
            tgt_images, _ = next(target_iter)
            tgt_images = match_batch_size(tgt_images, images.shape[0])
            m = eval_step(images, masks, tgt_images)
            rows.append(_scalars(*(m[k] for k in keys)))
        means = [float(np.mean(col)) for col in zip(*rows)] if rows else [0.0] * len(keys)
        return dict(zip(keys, dist.broadcast_from_primary(means)))

    # ------------------------------------------------------------------
    # phase 3: consistency fine-tuning
    # ------------------------------------------------------------------
    def phase3_train(self, target_loader, val_loader=None, epochs: int = 20,
                     learning_rate: float = 1e-5):
        """Returns the last epoch's mean loss; ``phase3_best.pth`` holds the
        final model.  ``val_loader`` is accepted and unused: the reference
        validates nothing in phase 3."""
        step = self._phase3_step()
        state = self._engage_mesh(target_loader, self._state(learning_rate))
        last_loss = 0.0
        for epoch in range(1, epochs + 1):
            generator = self._generator(3, epoch)
            losses = []
            for tgt_images, _ in _raw_batches(target_loader, self.device):
                state, m = step(state, generator, tgt_images)
                losses.append(m["loss"])
            last_loss = _epoch_mean(losses)
            self._log_metrics({"loss": last_loss}, epoch, "phase3/train")
        self._save_best(3, {"loss": last_loss})
        self.logger.flush()
        return last_loss
