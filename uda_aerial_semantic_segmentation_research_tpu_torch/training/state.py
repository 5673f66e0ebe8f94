"""Training state of the PyTorch port: model, optimizer, step counter.

Counterpart of ``adam``, ``TrainState`` and ``AdversarialState`` in the JAX
package's ``training/state.py``.  There the state is an immutable pytree
threaded through pure steps; here it owns an ``nn.Module`` and a
``torch.optim.Adam`` that a step updates in place.

A state built with ``skip_nonfinite=True`` (phase 3's) can drop an update
on the device, as the JAX step's ``jnp.where(finite, new, old)`` does: its
Adam is ``fused`` (its kernel skips every write when the ``found_inf``
tensor it is handed is 1, and the step count's +1 is taken back), and its
``step`` counter is a device tensor that advances by ``finite``.  Nothing is
read back to the host.

A state built with ``capturable=True`` can be captured into a CUDA graph
(``training.steps.make_scan_driver``): its Adam is ``torch.optim.Adam``'s
``capturable`` one (foreach or, with ``skip_nonfinite``, fused), which keeps
its step count on the device and computes the bias corrections there in
float32 instead of on the host in float64, and its ``step`` counter is a
device tensor advanced on the device.  Such a state lives on the card.  The
default stays ``capturable=False``, whose updates are the ones the port has
always made.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from uda_aerial_semantic_segmentation_research_tpu_torch.parallel import distributed as dist


@dataclasses.dataclass(frozen=True)
class Adam:
    """What ``adam`` returns: the optimizer's recipe, before it has parameters."""

    learning_rate: float
    clip_norm: Optional[float] = None

    def init(self, params, fused: bool = False, capturable: bool = False) -> torch.optim.Adam:
        return torch.optim.Adam(params, lr=self.learning_rate, betas=(0.9, 0.999),
                                eps=1e-8, fused=fused or None, capturable=capturable)


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
    """One model's optimization state: ``model``, ``optimizer``, ``step``
    and the optional ``clip_norm`` of its ``adam`` recipe.  ``step`` is an
    int, or with ``skip_nonfinite`` or ``capturable`` an int64 tensor on the
    model's device."""

    def __init__(self, model: torch.nn.Module, tx: Adam, skip_nonfinite: bool = False,
                 capturable: bool = False):
        device = next(model.parameters()).device
        if capturable and device.type != "cuda":
            raise ValueError(f"a capturable state lives on the card, not on {device}")
        self.model = model
        self.skip_nonfinite = skip_nonfinite
        self.capturable = capturable
        self.optimizer = tx.init(model.parameters(), fused=skip_nonfinite,
                                 capturable=capturable)
        self.clip_norm = tx.clip_norm
        self.step = (torch.zeros((), dtype=torch.int64, device=device)
                     if skip_nonfinite or capturable else 0)

    def apply_gradients(self, finite: Optional[torch.Tensor] = None) -> "TrainState":
        """One optimizer update from the gradients that ``backward`` left
        on the parameters (clipped first when ``clip_norm`` is set).

        ``finite`` (a bool device tensor; ``skip_nonfinite`` states only):
        where it is false the parameters, the Adam moments and count, and
        ``step`` stay bit-identical.  Under a process group it must be the
        same on every process (the steps take it from the global loss).

        Under a process group (``parallel.distributed``) the gradients are
        first averaged over the processes, in a few flat buckets, so that
        the clip and the update see the global batch's gradient and every
        process makes the same update."""
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        dist.average_gradients(grads)
        if self.clip_norm is not None:
            clip_by_global_norm_(grads, self.clip_norm)
        if finite is None:
            if self.skip_nonfinite:
                raise ValueError("a skip_nonfinite state needs the finite flag")
            self.optimizer.step()
            if isinstance(self.step, torch.Tensor):
                self.step.add_(1)
            else:
                self.step += 1
            return self
        if not self.skip_nonfinite:
            raise ValueError("only a skip_nonfinite state can skip an update")
        self.optimizer.found_inf = (~finite).float()
        try:
            self.optimizer.step()
        finally:
            del self.optimizer.found_inf
        self.step.add_(finite.long())
        return self


class AdversarialState:
    """Phase 2: the segmentation ("generator") state and the
    discriminator's, each a ``TrainState`` with its own Adam."""

    def __init__(self, seg: TrainState, disc: TrainState):
        self.seg = seg
        self.disc = disc
