"""The plain reference of a phase-1 train step: augmentation, train-mode
forward, cross-entropy, gradients and Adam, in float32.

``follow`` runs the first steps of a run from the seed's weights on the
same uint8 batches and augmentation generators as the program, and reads
what the comparison needs: each step's loss, every leaf's first gradient,
and every leaf's change after the last step.
"""

from __future__ import annotations

import torch

from port_bench.reference import trainable
from port_bench.reference.augment import augment

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def cross_entropy(logits, labels):
    """Mean over pixels of ``-log softmax(logits)[label]`` (float32)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long().unsqueeze(-1)).mean()


class Adam:
    """Adam with bias corrections (Kingma and Ba), ``torch.optim.Adam``'s
    arithmetic, on a dict of leaves."""

    def __init__(self, params: dict, lr: float):
        self.params, self.lr, self.t = params, lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: dict):
        self.t += 1
        b1, b2 = BETAS
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / c2 ** 0.5).add_(ADAM_EPS)
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)


def follow(net, weights: dict, batches, generators, lr: float, quant=None,
           remat: bool = True) -> dict:
    """Train steps of the model ``net(p, train, quant, remat, stats)`` (an
    architecture's ``Net`` bound to its configuration) from ``weights``
    (left as they are): step ``i`` augments
    ``batches[i]`` (uint8 images, integer masks, on the device) with draws
    from ``generators[i]``.  Returns ``loss`` (a float a step),
    ``grad1`` and ``change`` (leaf name -> float32 norm: the first step's
    gradient, and the parameters' change after the last step), and
    ``stats1`` (BatchNorm name -> the first step's batch mean and biased
    variance, tensors)."""
    params = {k: v.detach().clone().float().requires_grad_(True)
              for k, v in weights.items() if trainable(k)}
    buffers = {k: v for k, v in weights.items() if not trainable(k)}
    opt = Adam(params, lr)
    losses, grad1, stats1 = [], None, {}
    for (images, masks), gen in zip(batches, generators):
        with torch.no_grad():
            x, m = augment(gen, images, masks)
        model = net({**params, **buffers}, train=True, quant=quant, remat=remat,
                    stats=stats1 if grad1 is None else None)
        loss = cross_entropy(model(x), m)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        losses.append(float(loss.detach()))
        if grad1 is None:
            grad1 = {k: float(g.norm()) for k, g in grads.items()}
        opt.step(grads)
        del x, m, loss, grads
    change = {k: float((params[k].detach() - weights[k].float()).norm()) for k in params}
    return {"loss": losses, "grad1": grad1, "change": change, "stats1": stats1}
