"""Task losses of the PyTorch port.

Counterpart of the JAX package's ``ops/losses.py``.  Ported so far:
``softmax_cross_entropy``; the other losses follow with the phases that
use them.  Reductions accumulate in float32 whatever the input dtype;
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
