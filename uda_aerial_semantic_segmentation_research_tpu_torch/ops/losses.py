"""Task losses of the PyTorch port.

Counterpart of the JAX package's ``ops/losses.py``: ``sigmoid_bce_with_logits``,
``softmax_cross_entropy``, ``AdversarialLoss``, ``ConsistencyLoss``,
``DiceLoss``, ``SMPDiceLoss``, ``WeightedSegmentationLoss``,
``calculate_class_weights`` (numpy) and ``FineTuningLoss``.
Reductions accumulate in float32 whatever the input dtype; segmentation
logits are channel-last ``(..., C)``; discriminators produce LOGITS and the
adversarial losses are logit-BCE (the JAX package's documented convention).
"""

from __future__ import annotations

import numpy as np
import torch

from uda_aerial_semantic_segmentation_research_tpu_torch.parallel import distributed as dist
from uda_aerial_semantic_segmentation_research_tpu_torch.utils.dtypes import to_f32


def sigmoid_bce_with_logits(logits, labels):
    """Numerically stable mean BCE-with-logits (``BCEWithLogitsLoss``
    semantics): ``max(z, 0) - z * y + log1p(exp(-|z|))``, averaged."""
    logits = to_f32(logits)
    labels = to_f32(torch.as_tensor(labels, device=logits.device))
    loss = torch.clamp_min(logits, 0.0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    return loss.mean()


def softmax_cross_entropy(logits, labels, class_weights=None, reduction="mean",
                          over_ranks: bool = False):
    """Per-pixel CE over channel-last logits.

    ``logits``: (..., C) float; ``labels``: (...) int.  A label outside
    ``[0, C)`` has an all-zero one-hot, so its pixel contributes a zero
    loss (and still counts in the mean's divisor), as in the JAX function.
    With class weights (labels must then lie in ``[0, C)``), mean reduction
    divides by the summed weights of the realized labels
    (``F.cross_entropy(weight=...)`` semantics).  ``reduction``: ``"mean"``,
    ``"sum"``, anything else returns the per-pixel loss.

    ``over_ranks`` (a data-parallel train step's rows of the global batch):
    the class-weighted mean is that of the global batch, its two sums taken
    over the processes (``parallel.distributed.sum_over_ranks``); the other
    reductions are means over rows already, which the gradient average
    makes global.
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
            num, den = nll.sum(), w.sum()
            if over_ranks and dist.is_initialized():
                num, den = dist.sum_over_ranks(torch.stack([num, den])).unbind()
            return num / torch.clamp_min(den, 1e-12)
    if reduction == "mean":
        return nll.mean()
    if reduction == "sum":
        return nll.sum()
    return nll


class AdversarialLoss:
    """Domain-adversarial BCE over discriminator logits: source=1, target=0
    (``discriminator_loss`` averages the two); ``generator_loss`` pushes
    target predictions toward 1, scaled by ``lambda_adv``."""

    def __init__(self, lambda_adv: float = 0.001):
        self.lambda_adv = float(lambda_adv)

    def discriminator_loss(self, source_logits, target_logits):
        src = sigmoid_bce_with_logits(source_logits, torch.ones_like(source_logits))
        tgt = sigmoid_bce_with_logits(target_logits, torch.zeros_like(target_logits))
        return (src + tgt) / 2.0

    def generator_loss(self, target_logits):
        return self.lambda_adv * sigmoid_bce_with_logits(
            target_logits, torch.ones_like(target_logits))


class ConsistencyLoss:
    """Symmetric temperature-scaled KL between two prediction maps:
    ``F.kl_div(log_softmax(p/T), softmax(q/T), reduction='batchmean')`` in
    both directions, averaged -- the sum over classes and pixels divided by
    the batch size only."""

    def __init__(self, temperature: float = 0.5):
        self.temperature = float(temperature)

    def __call__(self, pred1, pred2):
        t = self.temperature
        logq1 = torch.log_softmax(to_f32(pred1) / t, dim=-1)
        logq2 = torch.log_softmax(to_f32(pred2) / t, dim=-1)
        q1, q2 = torch.exp(logq1), torch.exp(logq2)
        b = pred1.shape[0]
        kl1 = (q2 * (logq2 - logq1)).sum() / b          # KL(q2 || q1), batchmean
        kl2 = (q1 * (logq1 - logq2)).sum() / b
        return (kl1 + kl2) / 2.0

    def get_similarity_matrix(self, pred1, pred2):
        """Per-pixel cosine similarity between the softmax maps -> (B, H, W)."""
        q1 = torch.softmax(to_f32(pred1), dim=-1)
        q2 = torch.softmax(to_f32(pred2), dim=-1)
        num = (q1 * q2).sum(-1)
        den = torch.linalg.vector_norm(q1, dim=-1) * torch.linalg.vector_norm(q2, dim=-1)
        return num / torch.clamp_min(den, 1e-8)


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

    def __call__(self, predictions, targets, over_ranks: bool = False):
        """``predictions``: (B, H, W, C) logits; ``targets``: (B, H, W) int
        or (B, H, W, C) one-hot.  ``over_ranks`` (a data-parallel train
        step's rows of the global batch): the per-class sums are the global
        batch's, taken over the processes
        (``parallel.distributed.sum_over_ranks``)."""
        probs, targets = _probs_and_targets(predictions, targets)
        dims = tuple(range(predictions.ndim - 1))                 # batch + space
        intersection = (probs * targets).sum(dim=dims)             # (C,)
        cardinality = (probs + targets).sum(dim=dims)
        counts = targets.sum(dim=dims)
        if over_ranks and dist.is_initialized():
            intersection, cardinality, counts = dist.sum_over_ranks(
                torch.stack([intersection, cardinality, counts])).unbind()
        score = (2.0 * intersection + self.smooth) / torch.clamp_min(
            cardinality + self.smooth, self.eps)
        present = (counts > 0).to(torch.float32)
        return ((1.0 - score) * present).mean()


class WeightedSegmentationLoss:
    """Class-weighted focal + dice combination, times ``domain_weight``.

    The JAX package's quirk is kept: ``pt = exp(-ce)`` is taken from the
    *class-weighted* CE, so the focal modulation also sees the weights.  The
    focal term is computed in float32; a label outside ``[0, C)`` has an
    all-zero one-hot (zero CE, zero weight)."""

    def __init__(self, num_classes: int, class_weights=None,
                 alpha: float = 0.25, gamma: float = 2.0, reduction: str = "mean"):
        self.num_classes = num_classes
        self.class_weights = (torch.ones(num_classes, dtype=torch.float32)
                              if class_weights is None
                              else torch.as_tensor(np.asarray(class_weights), dtype=torch.float32))
        self.alpha = float(alpha)
        self.gamma = float(gamma)
        self.reduction = reduction
        self.dice_loss = DiceLoss()

    def focal_loss(self, logits, targets):
        logits = to_f32(logits)
        logp = torch.log_softmax(logits, dim=-1)
        onehot = one_hot_nhwc(targets, logits.shape[-1])
        nll = -(logp * onehot).sum(-1)
        ce = nll * (self.class_weights.to(logits.device) * onehot).sum(-1)
        pt = torch.exp(-ce)
        focal = self.alpha * (1.0 - pt) ** self.gamma * ce
        return focal.mean() if self.reduction == "mean" else focal.sum()

    def __call__(self, logits, targets, domain_weight: float = 1.0):
        focal = self.focal_loss(logits, targets)
        dice = self.dice_loss(logits, one_hot_nhwc(targets, self.num_classes))
        return domain_weight * (focal + dice)


def calculate_class_weights(dataset, num_classes: int,
                            method: str = "effective_samples") -> np.ndarray:
    """Per-class weights from pixel frequencies (numpy, float32).

    Reads the ``class_stats`` dict that ``DroneDataset`` computes when the
    dataset has one, else counts the masks of every ``(image, mask)`` item.
    ``"effective_samples"``: ``(1 - beta) / (1 - beta**count)`` with beta =
    0.9999; any other method: ``1 / count``; counts are clipped at 1 and the
    weights normalized to sum to ``num_classes``.
    """
    counts = np.zeros(num_classes, dtype=np.float64)
    stats = getattr(dataset, "class_stats", None)
    if stats:
        for cls, c in stats.items():
            if 0 <= int(cls) < num_classes:
                counts[int(cls)] += c
    else:
        for _, mask in dataset:
            m = mask.cpu().numpy() if isinstance(mask, torch.Tensor) else np.asarray(mask)
            binc = np.bincount(m.reshape(-1), minlength=num_classes)
            counts += binc[:num_classes]

    counts = np.clip(counts, 1.0, None)
    if method == "effective_samples":
        beta = 0.9999
        effective = 1.0 - np.power(beta, counts)
        weights = (1.0 - beta) / effective
    else:
        weights = 1.0 / counts
    weights = weights / weights.sum() * num_classes
    return weights.astype(np.float32)


class FineTuningLoss:
    """Phase-3 combined loss: rampup * (consistency + domain confusion)
    [+ supervised dice], as the component dict ``{'total', 'consistency',
    'domain_confusion', 'supervised', 'rampup_weight'}`` (every component
    but ``total`` detached)."""

    def __init__(self, consistency_weight: float = 1.0, domain_weight: float = 0.1,
                 supervised_weight: float = 0.1, rampup_length: int = 40,
                 temperature: float = 0.5):
        self.consistency_loss = ConsistencyLoss(temperature=temperature)
        self.domain_loss = AdversarialLoss(lambda_adv=domain_weight)
        self.supervised_loss = DiceLoss()
        self.consistency_weight = float(consistency_weight)
        self.domain_weight = float(domain_weight)
        self.supervised_weight = float(supervised_weight)
        self.rampup_length = int(rampup_length)

    def rampup(self, epoch, device=None) -> torch.Tensor:
        """Linear 0 -> 1 over ``rampup_length`` epochs, a float32 tensor on
        ``device``.  A number ``epoch`` is divided in float32 on the host and
        the result filled on the device (no host-to-device copy).  A tensor
        ``epoch`` (0-d, e.g. one step's slice of ``make_scan_driver``'s
        ``(S,)`` epochs) is divided on its device by a device-resident
        float32 divisor -- the same IEEE float32 division, so the same bits
        -- and clipped there, with no read-back."""
        if isinstance(epoch, torch.Tensor):
            e = epoch.to(device=device or epoch.device, dtype=torch.float32)
            length = torch.full((), float(self.rampup_length), dtype=torch.float32,
                                device=e.device)
            return (e / length).clamp(0.0, 1.0)
        r = np.clip(np.float32(epoch) / np.float32(self.rampup_length), 0.0, 1.0)
        return torch.full((), float(r), dtype=torch.float32, device=device)

    def __call__(self, pred1, pred2, domain_logits, epoch,
                 supervised_pred=None, supervised_target=None):
        rampup_weight = self.rampup(epoch, pred1.device)
        consistency = self.consistency_loss(pred1, pred2)
        domain_confusion = self.domain_loss.generator_loss(domain_logits)
        total = (consistency * self.consistency_weight * rampup_weight
                 + domain_confusion * self.domain_weight * rampup_weight)
        supervised = torch.zeros((), dtype=torch.float32, device=pred1.device)
        if supervised_pred is not None and supervised_target is not None:
            supervised = self.supervised_loss(supervised_pred, supervised_target)
            total = total + supervised * self.supervised_weight
        return {
            "total": total,
            "consistency": consistency.detach(),
            "domain_confusion": domain_confusion.detach(),
            "supervised": supervised.detach(),
            "rampup_weight": rampup_weight,
        }
