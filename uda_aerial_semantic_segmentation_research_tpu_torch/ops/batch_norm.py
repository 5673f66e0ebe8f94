"""BatchNorm with the flax formula, eval and train mode.

Counterpart of the JAX package's ``ops/lane_bn.py::BatchNorm``:

    y = ((x.f32 - mean) * (rsqrt(var + 1e-5) * scale) + bias).to(dtype)

Eval mode uses the running statistics.  Train mode (``bn_train``, the
contract of ``lane_bn._bn_train``) takes the batch statistics from the raw
input upcast to float32 -- ``mean = sum(x)/n``, biased ``var = max(0,
sum(x*x)/n - mean^2)`` -- with the per-channel sums coming from the
``ops.channel_sums`` kernels, forward (sum x, sum x*x) and backward
(sum dy, sum dy*x); the per-channel FMAs around them are plain tensor ops.
The running statistics move as ``ra = 0.9 * ra + 0.1 * batch`` for the mean
and the BIASED variance (``nn.BatchNorm2d`` stores the unbiased one), and
no gradient flows into them.

Parameters are named ``scale``/``bias`` and buffers ``mean``/``var``, as
in the JAX checkpoint tree.

A forward that runs again for the same update -- the recompute of a
``checkpoint`` region in the backward, or a pass whose statistics the step
discards -- runs under ``frozen_statistics()``: train mode still normalizes
with the batch statistics, but the running buffers stay as they are, so
they end a step bit-identical to the same step without the second forward
(flax's ``nn.remat`` threads the statistics of the first forward only).

Under a process group (``parallel.distributed``; one process per device,
each with its rows of the global batch) the statistics are the global
batch's, as under the JAX package's mesh: the forward's ``(sum x, sum x*x)``
are all-reduced and divided by the global count, and the backward
all-reduces ``(sum dy, sum dy*x)`` for the input gradient.  The scale and
bias gradients come from this process's own sums: the gradient average over
the processes adds the others' (from the reduced sums they would be N times
too large).  Every process runs the same BatchNorms in the same order, so
the collectives pair up, the recomputes under ``frozen_statistics()``
included.  Without a process group nothing changes.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.utils.checkpoint
from torch import nn

from uda_aerial_semantic_segmentation_research_tpu_torch.ops.channel_sums import (
    channel_dual_sums,
    channel_sums,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.parallel import distributed as dist
from uda_aerial_semantic_segmentation_research_tpu_torch.utils.dtypes import to_f32
from uda_aerial_semantic_segmentation_research_tpu_torch.utils.profiling import annotate

EPS = 1e-5       # flax / torch default, as every BatchNorm of the JAX package
MOMENTUM = 0.9   # flax convention (torch's 0.1), as every BatchNorm of the JAX package


_FROZEN = threading.local()   # per thread: a recompute runs in autograd's worker thread


@contextlib.contextmanager
def frozen_statistics():
    """Train-mode ``BatchNorm`` forwards inside leave their running buffers
    as they are (they still normalize with the batch statistics)."""
    before = statistics_frozen()
    _FROZEN.on = True
    try:
        yield
    finally:
        _FROZEN.on = before


def statistics_frozen() -> bool:
    return getattr(_FROZEN, "on", False)


def checkpoint(fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant) instead of saved; the
    recompute runs under ``frozen_statistics()``.  With gradients off it is
    ``fn(*args)``: nothing would be saved."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(), frozen_statistics()))


def _per_channel(v, ndim):
    return v.view((1, -1) + (1,) * (ndim - 2))


class _BNTrain(torch.autograd.Function):
    """Train-mode BatchNorm over dim 1: ``(x, scale, bias) -> (y, mean, var)``.

    ``mean``/``var`` exist for the running-statistics update only and are
    non-differentiable by contract.  ``x`` must be channels_last in memory
    (its channel-last view contiguous); the incoming gradient is brought
    to that layout if autograd hands it over in another one.
    """

    @staticmethod
    def forward(ctx, x, scale, bias, out_dtype):
        n = x.numel() // x.shape[1]
        s, q = channel_sums(x.movedim(1, -1))
        if dist.is_initialized():
            # the global batch's statistics: every process holds as many rows
            s, q = dist.all_reduce_(torch.cat([s, q]), "bn_forward").chunk(2)
            n *= dist.process_count()
        mean = s / n
        var = torch.clamp_min(q / n - mean * mean, 0.0)
        inv = torch.rsqrt(var + EPS)
        mul = inv * scale
        y = ((to_f32(x) - _per_channel(mean, x.dim())) * _per_channel(mul, x.dim())
             + _per_channel(bias, x.dim())).to(out_dtype)
        ctx.save_for_backward(x, mean, inv, scale)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        with annotate("uda.bn.train_backward"):
            x, mean, inv, scale = ctx.saved_tensors
            n = x.numel() // x.shape[1]
            dy_last = dy.movedim(1, -1)
            if not dy_last.is_contiguous():
                dy_last = dy_last.contiguous()
                dy = dy_last.movedim(-1, 1)
            sd, sdx = channel_dual_sums(dy_last, x.movedim(1, -1))
            centred = sdx - mean * sd
            # this process's share of the parameter gradients: the gradient
            # average over the processes adds the others' shares
            dscale = centred * inv         # sum(dy * xhat)
            dbias = sd
            if dist.is_initialized():
                # dx sees the global batch's sums (the statistics were global)
                sd, sdx = dist.all_reduce_(torch.cat([sd, sdx]), "bn_backward").chunk(2)
                centred = sdx - mean * sd
                n *= dist.process_count()
            # dx = a*dy + cx*x + d: the BN input gradient with the two sums
            # substituted analytically
            a = inv * scale
            cx = -a * inv * inv * centred / n
            d = cx * (-mean) - a * sd / n
            dx = (_per_channel(a, x.dim()) * to_f32(dy) + _per_channel(cx, x.dim()) * to_f32(x)
                  + _per_channel(d, x.dim())).to(x.dtype)
            return dx, dscale, dbias, None


def bn_train(x, scale, bias, out_dtype):
    """``(y, batch mean, biased batch var)`` of train-mode BatchNorm over
    dim 1 of ``x``; see ``_BNTrain``."""
    return _BNTrain.apply(x, scale, bias, out_dtype)


class BatchNorm(nn.Module):
    """Per-channel BatchNorm over dim 1 of an NCHW (channels_last) tensor."""

    def __init__(self, features: int, zero_scale: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        init = torch.zeros if zero_scale else torch.ones
        self.scale = nn.Parameter(init(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def folded(self):
        """(mul, bias) of the eval-mode affine: y = (x - mean) * mul + bias."""
        return torch.rsqrt(self.var + EPS) * self.scale, self.bias

    def forward(self, x):
        if x.dim() < 2 or x.shape[1] != self.scale.numel():
            raise ValueError(f"BatchNorm({self.scale.numel()}) got input "
                             f"{tuple(x.shape)}")
        if self.training:
            with annotate("uda.bn.train"):
                y, mean, var = bn_train(x, self.scale, self.bias, self.dtype)
                if statistics_frozen():
                    return y
                with torch.no_grad():
                    self.mean.copy_(MOMENTUM * self.mean + (1.0 - MOMENTUM) * mean)
                    self.var.copy_(MOMENTUM * self.var + (1.0 - MOMENTUM) * var)
                return y
        with annotate("uda.bn.eval"):
            mul, bias = self.folded()
            y = ((x.float() - _per_channel(self.mean, x.dim())) * _per_channel(mul, x.dim())
                 + _per_channel(bias, x.dim()))
            return y.to(self.dtype)
