"""Task losses of the PyTorch port.

Counterpart of the JAX package's ``ops/losses.py``.  Ported so far:
``softmax_cross_entropy``, ``DiceLoss`` and ``SMPDiceLoss``; the other
losses follow with the phases that use them.  Reductions accumulate in float32 whatever the input dtype;
segmentation logits are channel-last ``(..., C)``.
"""

from __future__ import annotations

import torch

from uda_aerial_semantic_segmentation_research_tpu_torch.utils.dtypes import to_f32


def softmax_cross_entropy(logits, labels, class_weights=None, reduction="mean"):
    """Per-pixel CE over channel-last logits.

    ``logits``: (..., C) float; ``labels``: (...) int.  A label outside
    ``[0, C)`` has an all-zero one-hot, so its pixel contributes a zero
    loss (and still counts in the mean's divisor), as in the JAX function.
    With class weights (labels must then lie in ``[0, C)``), mean reduction
    divides by the summed weights of the realized labels
    (``F.cross_entropy(weight=...)`` semantics).  ``reduction``: ``"mean"``,
    ``"sum"``, anything else returns the per-pixel loss.
    """
    logp = torch.log_softmax(to_f32(logits), dim=-1)
    labels = labels.long()
    c = logits.shape[-1]
    valid = (labels >= 0) & (labels < c)
    picked = logp.gather(-1, labels.clamp(0, c - 1).unsqueeze(-1)).squeeze(-1)
    nll = -picked * valid.to(logp.dtype)
    if class_weights is not None:
        idx = torch.where(labels < 0, labels + c, labels).clamp(0, c - 1)
        w = torch.as_tensor(class_weights, dtype=logp.dtype, device=logits.device)[idx]
        nll = nll * w
        if reduction == "mean":
            return nll.sum() / torch.clamp_min(w.sum(), 1e-12)
    if reduction == "mean":
        return nll.mean()
    if reduction == "sum":
        return nll.sum()
    return nll


def one_hot_nhwc(labels, num_classes: int) -> torch.Tensor:
    """float32 one-hot on a last axis; a label outside ``[0, C)`` gives an
    all-zero row (``jax.nn.one_hot``)."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels.long().unsqueeze(-1) == classes).to(torch.float32)


def _probs_and_targets(predictions, targets):
    num_classes = predictions.shape[-1]
    probs = torch.softmax(to_f32(predictions), dim=-1)
    if targets.ndim == predictions.ndim - 1:
        targets = one_hot_nhwc(targets, num_classes)
    return probs, to_f32(targets)


class DiceLoss:
    """Multiclass soft-dice: softmax probs vs one-hot, smooth=1.0, 1 - mean dice
    over (sample, class)."""

    def __init__(self, smooth: float = 1.0):
        self.smooth = float(smooth)

    def __call__(self, predictions, targets):
        """``predictions``: (B, H, W, C) logits; ``targets``: (B, H, W) int
        or (B, H, W, C) one-hot."""
        probs, targets = _probs_and_targets(predictions, targets)
        intersection = (probs * targets).sum(dim=(1, 2))           # (B, C)
        union = probs.sum(dim=(1, 2)) + targets.sum(dim=(1, 2))
        dice = (2.0 * intersection + self.smooth) / (union + self.smooth)
        return 1.0 - dice.mean()


class SMPDiceLoss:
    """``smp.losses.DiceLoss(mode='multiclass')`` semantics, as the JAX
    package's ``SMPDiceLoss``: intersection and cardinality per class over
    batch and space, ``smooth=0.0`` with an ``eps=1e-7`` clamp on the
    denominator, classes absent from the target contribute 0 but count in
    the mean over C."""

    def __init__(self, smooth: float = 0.0, eps: float = 1e-7):
        self.smooth = float(smooth)
        self.eps = float(eps)

    def __call__(self, predictions, targets):
        """``predictions``: (B, H, W, C) logits; ``targets``: (B, H, W) int
        or (B, H, W, C) one-hot."""
        probs, targets = _probs_and_targets(predictions, targets)
        dims = tuple(range(predictions.ndim - 1))                 # batch + space
        intersection = (probs * targets).sum(dim=dims)             # (C,)
        cardinality = (probs + targets).sum(dim=dims)
        score = (2.0 * intersection + self.smooth) / torch.clamp_min(
            cardinality + self.smooth, self.eps)
        present = (targets.sum(dim=dims) > 0).to(torch.float32)
        return ((1.0 - score) * present).mean()
