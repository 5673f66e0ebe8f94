"""Segmentation metrics computed on the device, and the domain metrics'
host accumulators.

Counterpart of ``confusion_matrix``, ``iou_from_hist``,
``accuracy_from_hist``, ``binary_entropy``, ``DomainAdaptationMetrics`` and
``SegmentationMetrics`` in the JAX package's ``ops/metrics.py``.  The JAX
function builds the histogram as a one-hot matrix product because a
scatter-add serializes on the TPU; on the GPU it is an integer scatter-add,
exact at any pixel count, spread over ``_ROWS`` private histograms so that
a dominant class does not pile every atomic onto one address.  Nothing here
reads a value back to the host, except ``DomainAdaptationMetrics``, whose
accumulators are numpy on the host by design, and ``SegmentationMetrics``,
which finishes its scores in float64 on the host.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

import torch
import torch.nn.functional as F

_ROWS = 256  # private histograms summed at the end


def confusion_matrix(pred, true, num_classes: int, ignore_index: Optional[int] = None):
    """(num_classes, num_classes) int32 histogram; rows = true, cols = pred.

    Pixels whose ``true`` label is outside ``[0, num_classes)`` or equals
    ``ignore_index`` are dropped, as are pixels whose ``pred`` is outside
    the range (their one-hot row is zero in the JAX function).
    """
    pred = pred.reshape(-1).long()
    true = true.reshape(-1).long()
    keep = (true >= 0) & (true < num_classes) & (pred >= 0) & (pred < num_classes)
    if ignore_index is not None:
        keep = keep & (true != ignore_index)
    dump = num_classes * num_classes            # one extra bin for dropped pixels
    idx = torch.where(keep, true * num_classes + pred, dump)
    idx = F.pad(idx, (0, (-idx.numel()) % _ROWS), value=dump).view(_ROWS, -1)
    hist = torch.zeros((_ROWS, dump + 1), dtype=torch.int32, device=idx.device)
    hist.scatter_add_(1, idx, torch.ones((), dtype=torch.int32,
                                         device=idx.device).expand_as(idx))
    return hist.sum(0, dtype=torch.int32)[:dump].view(num_classes, num_classes)


def iou_from_hist(hist):
    """Per-class IoU + mean IoU over the classes present (float32)."""
    hist = hist.float()
    tp = hist.diagonal()
    support = hist.sum(1) + hist.sum(0)
    iou = tp / (support - tp + 1e-7)
    present = support > 0
    mean_iou = torch.where(present, iou, torch.zeros_like(iou)).sum() / torch.clamp_min(
        present.float().sum(), 1.0)
    return iou, mean_iou


def accuracy_from_hist(hist):
    hist = hist.float()
    return hist.diagonal().sum() / torch.clamp_min(hist.sum(), 1e-7)


def binary_entropy(probs):
    """Elementwise binary entropy of probabilities (natural log, float32)."""
    p = torch.clamp(probs.float(), 0.0, 1.0)
    return -p * torch.log(p + 1e-10) - (1.0 - p) * torch.log(1.0 - p + 1e-10)


def _host(x) -> np.ndarray:
    """``x`` on the host through ``parallel.distributed.host_array``: a
    tensor (float32) with every process's rows, anything else as it is."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.parallel.distributed import (
        host_array,
    )

    return host_array(x.detach().float() if isinstance(x, torch.Tensor) else x)


class DomainAdaptationMetrics:
    """Streaming host accumulators over discriminator outputs.

    ``update*`` takes probabilities in [0, 1] (shape (B, 1) or (B,); device
    tensors are read back).  Source counts as correct when p >= 0.5, target
    when p < 0.5; domain confusion is the mean binary entropy of each
    update's source and target probabilities together, averaged over
    updates.  Under a process group a tensor input is this process's rows
    and the rows of every process are gathered (``host_array``), so the
    accumulators are the global batch's, the same on every process; a
    numpy input is taken as the whole batch.
    """

    def __init__(self):
        self.reset()

    def reset(self):
        self.source_correct = 0
        self.source_total = 0
        self.target_correct = 0
        self.target_total = 0
        self.domain_entropy_sum = 0.0
        self.feature_alignment_sum = 0.0
        self.n_batches = 0

    def update(self, source_pred, target_pred, source_features=None,
               target_features=None):
        sp, tp = _host(source_pred).reshape(-1), _host(target_pred).reshape(-1)
        self.update_domain_accuracy(sp, tp)
        self.update_confusion_metrics(source_features, target_features,
                                      np.concatenate([sp, tp]))

    def update_domain_accuracy(self, source_pred, target_pred):
        sp, tp = _host(source_pred).reshape(-1), _host(target_pred).reshape(-1)
        self.source_correct += int((sp >= 0.5).sum())
        self.source_total += sp.size
        self.target_correct += int((tp < 0.5).sum())
        self.target_total += tp.size

    def update_confusion_metrics(self, source_features, target_features,
                                 domain_predictions):
        probs = np.clip(_host(domain_predictions).reshape(-1), 0.0, 1.0)
        ent = -probs * np.log(probs + 1e-10) - (1 - probs) * np.log(1 - probs + 1e-10)
        self.domain_entropy_sum += float(ent.mean())
        if source_features is not None and target_features is not None:
            s = _host(source_features).mean(axis=0).reshape(-1)
            t = _host(target_features).mean(axis=0).reshape(-1)
            s = s / max(np.linalg.norm(s), 1e-12)
            t = t / max(np.linalg.norm(t), 1e-12)
            self.feature_alignment_sum += float(np.dot(s, t))
        self.n_batches += 1

    def get_metrics(self) -> Dict[str, float]:
        return {
            "source_domain_acc": self.source_correct / max(self.source_total, 1),
            "target_domain_acc": self.target_correct / max(self.target_total, 1),
            "domain_confusion": self.domain_entropy_sum / max(self.n_batches, 1),
        }

    def get_confusion_metrics(self) -> Dict[str, float]:
        return {
            "domain_entropy": self.domain_entropy_sum / max(self.n_batches, 1),
            "feature_alignment": self.feature_alignment_sum / max(self.n_batches, 1),
        }


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


class SegmentationMetrics:
    """Histogram-based IoU / pixel accuracy / F1 with an optional
    ``ignore_index``.  The histogram (``confusion_matrix``) and the pixel
    counts are taken on the device the inputs lie on; the scores are
    finished in float64 on the host."""

    def __init__(self, num_classes: int, ignore_index: Optional[int] = None):
        self.num_classes = num_classes
        self.ignore_index = ignore_index

    def _hist(self, predictions, targets) -> np.ndarray:
        hist = confusion_matrix(_tensor(predictions), _tensor(targets), self.num_classes,
                                self.ignore_index)
        return hist.cpu().numpy().astype(np.float64)

    def batch_iou(self, predictions, targets) -> dict:
        """``{"mean_iou", "class_iou"}``: the mean over the classes present in
        either map (NaN for the absent ones, then ``nanmean``), 0.0 when none is."""
        hist = self._hist(predictions, targets)
        tp = np.diag(hist)
        denom = hist.sum(axis=1) + hist.sum(axis=0) - tp + 1e-7
        iu = tp / denom
        present = (hist.sum(axis=1) + hist.sum(axis=0)) > 0
        iu_masked = np.where(present, iu, np.nan)
        mean_iou = float(np.nanmean(iu_masked)) if present.any() else 0.0
        return {"mean_iou": mean_iou,
                "class_iou": {i: float(v) for i, v in enumerate(iu)}}

    def pixel_accuracy(self, predictions, targets) -> float:
        p, t = _tensor(predictions), _tensor(targets)
        mask = (t != self.ignore_index) if self.ignore_index is not None \
            else torch.ones_like(t, dtype=torch.bool)
        correct = float(((p.to(t.device) == t) & mask).sum().item())
        total = float(mask.sum().item())
        return correct / (total + 1e-7)

    def f1_score(self, predictions, targets, class_index: Optional[int] = None):
        """Per-class F1 as a list, or the one of ``class_index``."""
        hist = self._hist(predictions, targets)
        tp = np.diag(hist)
        fp = hist.sum(axis=0) - tp
        fn = hist.sum(axis=1) - tp
        f1 = 2 * tp / (2 * tp + fp + fn + 1e-7)
        if class_index is not None:
            return float(f1[class_index])
        return f1.tolist()
