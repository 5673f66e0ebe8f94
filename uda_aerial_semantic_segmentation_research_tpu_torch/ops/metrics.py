"""Segmentation metrics computed on the device.

Counterpart of ``confusion_matrix``, ``iou_from_hist`` and
``accuracy_from_hist`` in the JAX package's ``ops/metrics.py``.  The JAX
function builds the histogram as a one-hot matrix product because a
scatter-add serializes on the TPU; on the GPU it is an integer scatter-add,
exact at any pixel count, spread over ``_ROWS`` private histograms so that
a dominant class does not pile every atomic onto one address.  Nothing here
reads a value back to the host.
"""

from __future__ import annotations

from typing import Optional

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
