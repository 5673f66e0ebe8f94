"""Training state of the PyTorch port: model, optimizer, step counter.

Counterpart of ``adam`` and ``TrainState`` in the JAX package's
``training/state.py``.  There the state is an immutable pytree threaded
through pure steps; here it owns an ``nn.Module`` and a
``torch.optim.Adam`` that a step updates in place.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Adam:
    """What ``adam`` returns: the optimizer's recipe, before it has parameters."""

    learning_rate: float
    clip_norm: Optional[float] = None

    def init(self, params) -> torch.optim.Adam:
        return torch.optim.Adam(params, lr=self.learning_rate, betas=(0.9, 0.999),
                                eps=1e-8)


def adam(learning_rate: float, clip_norm: Optional[float] = None) -> Adam:
    """Adam with ``torch.optim.Adam``'s defaults (the arithmetic of the JAX
    package's ``optax.adam``), with an optional global-norm gradient clip."""
    return Adam(learning_rate, clip_norm)


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place to a global L2 norm of at most ``max_norm``
    and return the norm before clipping.

    The arithmetic of ``optax.clip_by_global_norm``: gradients are left
    untouched while ``norm < max_norm`` and become ``(g / norm) * max_norm``
    otherwise (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``
    instead).  The branch is a ``torch.where`` on the device: nothing is
    read back to the host.
    """
    grads = list(grads)
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    below = norm < max_norm
    torch._foreach_div_(grads, torch.where(below, torch.ones_like(norm), norm))
    torch._foreach_mul_(grads, torch.where(below, torch.ones_like(norm),
                                           torch.full_like(norm, max_norm)))
    return norm


class TrainState:
    """One model's optimization state: ``model``, ``optimizer``, integer
    ``step`` and the optional ``clip_norm`` of its ``adam`` recipe."""

    def __init__(self, model: torch.nn.Module, tx: Adam):
        self.model = model
        self.optimizer = tx.init(model.parameters())
        self.clip_norm = tx.clip_norm
        self.step = 0

    def apply_gradients(self) -> "TrainState":
        """One optimizer update from the gradients that ``backward`` left
        on the parameters (clipped first when ``clip_norm`` is set)."""
        if self.clip_norm is not None:
            clip_by_global_norm_([p.grad for p in self.model.parameters()
                                  if p.grad is not None], self.clip_norm)
        self.optimizer.step()
        self.step += 1
        return self
