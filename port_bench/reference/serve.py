"""The plain reference of serving: normalize, eval-mode forward with the
running statistics, and the judgement of served labels against it."""

from __future__ import annotations

import torch

from port_bench.reference.augment import dequantize, normalize

ROWS = 8       # tiles a block of the reference's forward


@torch.no_grad()
def logits(net, weights: dict, images, quant=None):
    """float32 logits (B, H, W, classes) of uint8 NHWC ``images`` (a tensor
    on the device) through ``net`` (an architecture's ``Net`` bound to its
    configuration), computed ``ROWS`` tiles at a time: eval mode treats
    every tile alone, so the blocks change nothing."""
    model = net(weights, train=False, quant=quant)
    return torch.cat([model(normalize(dequantize(images[i:i + ROWS])))
                      for i in range(0, images.shape[0], ROWS)])


@torch.no_grad()
def widest_gap(ref_logits, labels) -> float:
    """The widest gap by which a served label's reference logit lies below
    the reference's best logit of its pixel (0 where they agree; infinite
    for a label that is no class)."""
    labels = torch.as_tensor(labels, device=ref_logits.device).long()
    if labels.shape != ref_logits.shape[:-1] or bool(
            ((labels < 0) | (labels >= ref_logits.shape[-1])).any()):
        return float("inf")
    best = ref_logits.amax(dim=-1)
    served = ref_logits.gather(-1, labels.unsqueeze(-1)).squeeze(-1)
    return float((best - served).max())
