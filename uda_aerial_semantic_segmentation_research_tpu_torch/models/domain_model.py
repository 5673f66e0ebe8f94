"""``DomainAdaptationModel``: the segmentation model and an optional
discriminator in one ``nn.Module``.

Counterpart of the JAX package's ``models/domain_model.py``.  Because both
models are submodules, ``parameters()`` spans both, which is what phase 3's
single Adam over segmentation and discriminator parameters needs.
``state_dict`` / ``load_state_dict`` speak the JAX package's layout:
``segmentation_model/params/...``, ``segmentation_model/batch_stats/...``,
``discriminator/...`` (``models.convert``), numpy arrays, so a checkpoint of
either package loads in the other.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from uda_aerial_semantic_segmentation_research_tpu_torch.models.convert import (
    from_jax_state_dict,
    to_jax_state_dict,
)

_PREFIXES = ("segmentation_model/", "discriminator/")


class DomainAdaptationModel(nn.Module):
    def __init__(self, segmentation_model: nn.Module,
                 discriminator: Optional[nn.Module] = None):
        super().__init__()
        self.segmentation_model = segmentation_model
        self.discriminator = discriminator

    def forward(self, x, domain_adaptation: bool = False, return_logits: bool = False):
        """``seg_pred``, or ``(seg_pred, domain_pred)`` with
        ``domain_adaptation`` and a discriminator; both models run in this
        module's mode."""
        seg_pred = self.segmentation_model(x)
        if domain_adaptation and self.discriminator is not None:
            return seg_pred, self.discriminator(x, return_logits=return_logits)
        return seg_pred

    @torch.no_grad()
    def get_features(self, x):
        """The encoder's deepest feature map (NHWC), eval mode, as the JAX
        ``module.encode(..., train=False)[-1]``."""
        seg = self.segmentation_model
        encoder = getattr(seg, "encoder", None)
        if encoder is None:
            return None
        was_training = seg.training
        seg.eval()
        try:
            return encoder(x)[-1]
        finally:
            seg.train(was_training)

    def state_dict(self, *args, **kwargs) -> Dict[str, np.ndarray]:
        out = {f"segmentation_model/{k}": v
               for k, v in to_jax_state_dict(self.segmentation_model).items()}
        if self.discriminator is not None:
            out.update({f"discriminator/{k}": v
                        for k, v in to_jax_state_dict(self.discriminator).items()})
        return out

    def load_state_dict(self, state, strict: bool = True, assign: bool = False):
        for prefix, module in zip(_PREFIXES, (self.segmentation_model, self.discriminator)):
            part = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
            if module is not None and (part or prefix == _PREFIXES[0]):
                module.load_state_dict(from_jax_state_dict(part), strict=strict)
        return self
