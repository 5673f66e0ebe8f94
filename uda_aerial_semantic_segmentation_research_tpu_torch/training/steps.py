"""Step factories of the PyTorch port.

Counterpart of the JAX package's ``training/steps.py``.  Ported so far:
the phase-1 supervised train step, the eval step and the serving step
(``make_supervised_train_step``, ``make_eval_step``, ``make_predict_step``).
Each factory closes over the static pieces and returns an eager function.
Properties shared by the steps:

- raw uint8 batches go straight to the device; dequantization,
  augmentation and normalization run there;
- the train step updates the model, its BatchNorm buffers and the
  optimizer in place;
- metrics (loss scalars and the confusion matrix) are returned as device
  tensors, and a step reads nothing back to the host itself.
"""

from __future__ import annotations

import torch

from uda_aerial_semantic_segmentation_research_tpu_torch.ops.augment import (
    WEAK,
    AugmentConfig,
    augment_batch,
    normalize_images,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.fused_ce import (
    fused_cross_entropy,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.losses import (
    SMPDiceLoss,
    softmax_cross_entropy,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.metrics import (
    accuracy_from_hist,
    confusion_matrix,
    iou_from_hist,
)


def model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _seg_metrics(logits, masks, num_classes: int):
    preds = logits.argmax(dim=-1)
    hist = confusion_matrix(preds, masks, num_classes)
    per_class_iou, mean_iou = iou_from_hist(hist)
    return {
        "iou": mean_iou,
        "accuracy": accuracy_from_hist(hist),
        "per_class_iou": per_class_iou,
        "hist": hist,
    }


def _check_seg_loss(seg_loss: str) -> None:
    if seg_loss not in ("ce", "dice"):
        raise ValueError(f"seg_loss must be 'ce' or 'dice', got {seg_loss!r}")


# ---------------------------------------------------------------------------
# phase 1: supervised segmentation
# ---------------------------------------------------------------------------
def make_supervised_train_step(model: torch.nn.Module, num_classes: int,
                               aug_cfg: AugmentConfig = WEAK,
                               class_weights=None, fused_ce: bool = False,
                               seg_loss: str = "ce"):
    """``step(state, generator, images, masks, abc=None, params=None) -> (state, metrics)``.

    ``images`` uint8 NHWC, ``masks`` uint8/int NHW (numpy arrays or
    tensors; moved to the model's device).  One step: augmentation
    (``augment_batch`` with ``aug_cfg``, ``WEAK`` by default as in the JAX
    package: its draws come from ``generator``, a ``torch.Generator`` on the
    model's device that the caller owns, or are given as ``abc`` and
    ``params``), train-mode forward, loss, backward, Adam update of
    ``state`` (a ``TrainState`` over ``model``) in place, metrics.  Metrics:
    ``loss``, ``iou``, ``accuracy``, ``per_class_iou``, ``hist``, all
    device tensors.  After a step the parameters' ``.grad`` hold that
    step's gradients (clipped, when the state clips).

    ``fused_ce`` swaps ``softmax_cross_entropy`` for the fused kernels
    (``ops.fused_ce.fused_cross_entropy``): one read of the logits
    forward, one read and one write backward, no float32 softmax or
    per-pixel loss in device memory; requires ``class_weights=None``.

    ``seg_loss``: ``"ce"`` (softmax cross-entropy) or ``"dice"``
    (``SMPDiceLoss``, the GRL stack's phase-1 criterion).
    """
    _check_seg_loss(seg_loss)
    if fused_ce and class_weights is not None:
        raise ValueError("fused_ce does not support class_weights")
    if seg_loss == "dice":
        if fused_ce or class_weights is not None:
            raise ValueError(
                "seg_loss='dice' supports neither fused_ce nor class_weights")
        ce = SMPDiceLoss()
    elif fused_ce:
        ce = fused_cross_entropy
    else:
        def ce(logits, m):
            return softmax_cross_entropy(logits, m, class_weights)

    def step(state, generator, images, masks, abc=None, params=None):
        if state.model is not model:
            raise ValueError("the state belongs to another model than the step")
        device = model_device(model)
        images = torch.as_tensor(images, device=device)
        masks = torch.as_tensor(masks, device=device)
        with torch.no_grad():
            x, m = augment_batch(generator, images, masks, cfg=aug_cfg, abc=abc,
                                 params=params)
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        logits = model(x)
        loss = ce(logits, m)
        loss.backward()
        state.apply_gradients()
        with torch.no_grad():
            metrics = _seg_metrics(logits.detach(), m, num_classes)
        metrics["loss"] = loss.detach()
        return state, metrics

    return step


def make_eval_step(model: torch.nn.Module, num_classes: int, class_weights=None,
                   seg_loss: str = "ce"):
    """``step(images, masks) -> metrics`` (loss / iou / accuracy /
    per_class_iou / hist, device tensors): normalize, eval-mode forward
    with the running BatchNorm statistics, then ``softmax_cross_entropy``
    or, with ``seg_loss="dice"``, ``SMPDiceLoss``.
    """
    _check_seg_loss(seg_loss)
    if seg_loss == "dice":
        if class_weights is not None:
            raise ValueError("seg_loss='dice' does not support class_weights")
        loss_fn = SMPDiceLoss()
    else:
        def loss_fn(logits, m):
            return softmax_cross_entropy(logits, m, class_weights)

    def step(images, masks):
        device = model_device(model)
        model.eval()
        with torch.inference_mode():
            x = normalize_images(torch.as_tensor(images, device=device))
            m = torch.as_tensor(masks, device=device).to(torch.int32)
            logits = model(x)
            metrics = _seg_metrics(logits, m, num_classes)
            metrics["loss"] = loss_fn(logits, m)
        return metrics

    return step


def make_predict_step(model: torch.nn.Module):
    """``step(images)``: uint8/float NHWC images -> float32 NHWC logits.

    Normalizes (ImageNet statistics; integers divided by 255), then runs
    the model's eval-mode forward under ``torch.inference_mode``.  Images
    may be a numpy array or a tensor; they are moved to the model's
    device.
    """
    device = model_device(model)

    def step(images):
        model.eval()
        with torch.inference_mode():
            x = normalize_images(torch.as_tensor(images, device=device))
            return model(x).float()

    return step
