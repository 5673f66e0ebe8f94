"""Fused mean softmax cross-entropy, forward and backward kernels.

Counterpart of the JAX package's ``ops/pallas_ops.py::fused_cross_entropy``
(the Pallas kernels ``_ce_fwd_kernel`` / ``_ce_bwd_kernel`` under a custom
VJP).  The kernels are hand-written CUDA (``csrc/fused_cross_entropy.cu``)
and read the channel-last rows ``(N, C)`` as they lie: the TPU version's
``(C, N)`` transpose, its padding to 4096 columns and the ``pad * log(C)``
correction are layout costs of that machine and do not exist here.

    loss    = mean_i( logsumexp(x_i) - x_i[label_i] )
    dlogits = g * (softmax(x_i) - onehot(label_i)) / N     in the logits' dtype

A label outside ``[0, C)`` has an all-zero one-hot, as in the JAX kernel: it
adds its ``logsumexp`` to the sum and gets the plain softmax as gradient.
(``ops.losses.softmax_cross_entropy`` gives such a pixel a zero loss; the two
agree wherever every label is a class.)

``fused_cross_entropy`` is a ``torch.autograd.Function`` underneath.  For
CUDA logits both passes launch their kernel or raise; for CPU logits they
compute the plain PyTorch versions (``fused_cross_entropy_reference`` and
``fused_cross_entropy_grad_reference``).  ``fused_cross_entropy.launches``
counts the kernel launches, forward and backward alike.

Under CUDA graph capture both passes launch on the capture stream (the
current one); their only host-side set-up is loading the library, which
raises if it would first happen during a capture.  The forward's partial
sums are allocated per call, in the graph's pool when captured.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from uda_aerial_semantic_segmentation_research_tpu_torch.utils.dtypes import to_f32

MAX_CLASSES = 64
_LABEL_KINDS = {torch.uint8: 0, torch.int32: 1, torch.int64: 2}


def _onehot(labels, c, dtype):
    """(N,) int -> (N, C) one-hot; a label outside [0, C) gives a zero row."""
    classes = torch.arange(c, device=labels.device)
    return (labels.long().unsqueeze(-1) == classes).to(dtype)


def fused_cross_entropy_reference(logits, labels):
    """Plain PyTorch version of the forward kernel (same arithmetic)."""
    x = to_f32(logits).reshape(-1, logits.shape[-1])
    picked = (x * _onehot(labels.reshape(-1), x.shape[1], x.dtype)).sum(-1)
    return (torch.logsumexp(x, dim=-1) - picked).sum() / x.shape[0]


def fused_cross_entropy_grad_reference(logits, labels, g):
    """Plain PyTorch version of the backward kernel: ``g`` is the loss's
    cotangent (a scalar tensor); returns dlogits in the logits' dtype."""
    x = to_f32(logits).reshape(-1, logits.shape[-1])
    p = torch.softmax(x, dim=-1)
    dx = (p - _onehot(labels.reshape(-1), x.shape[1], x.dtype)) * (to_f32(g) / x.shape[0])
    return dx.to(logits.dtype).reshape(logits.shape)


@functools.cache
def _library():
    """The built kernel library with its C signatures declared."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops._build import (
        load_library,
    )

    lib = load_library("fused_cross_entropy")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fused_cross_entropy_max_blocks.argtypes = []
    lib.fused_cross_entropy_max_blocks.restype = i32
    lib.fused_cross_entropy_forward.argtypes = [ptr] * 4 + [i32, i32, i64, i32, ptr]
    lib.fused_cross_entropy_forward.restype = i32
    lib.fused_cross_entropy_backward.argtypes = [ptr] * 4 + [i32, i32, i64, i32, ptr]
    lib.fused_cross_entropy_backward.restype = i32
    return lib


def _check(logits, labels):
    if logits.dim() < 1 or tuple(labels.shape) != tuple(logits.shape[:-1]):
        raise ValueError(f"expected logits (..., C) and labels (...), got "
                         f"{tuple(logits.shape)} and {tuple(labels.shape)}")
    if logits.numel() == 0:
        raise ValueError(f"fused_cross_entropy of empty logits {tuple(logits.shape)}")
    if labels.dtype not in _LABEL_KINDS:
        raise TypeError(f"labels must be uint8, int32 or int64, not {labels.dtype}")
    if labels.device != logits.device:
        raise ValueError("logits and labels must be on one device")


def _check_cuda(logits, labels):
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_cross_entropy takes float32 or bfloat16 logits, "
                        f"not {logits.dtype}")
    if not logits.is_contiguous() or not labels.is_contiguous():
        raise ValueError("fused_cross_entropy needs contiguous logits and labels")
    if logits.shape[-1] > MAX_CLASSES:
        raise ValueError(f"fused_cross_entropy takes up to {MAX_CLASSES} classes, "
                         f"got {logits.shape[-1]}")


def _kernel_args(logits, labels):
    c = logits.shape[-1]
    return (int(logits.dtype == torch.bfloat16), _LABEL_KINDS[labels.dtype],
            logits.numel() // c, c, torch.cuda.current_stream().cuda_stream)


class _FusedCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, labels):
        ctx.save_for_backward(logits, labels)
        if logits.device.type == "cpu":
            return fused_cross_entropy_reference(logits, labels)
        _check_cuda(logits, labels)
        lib = _library()
        partials = torch.empty(lib.fused_cross_entropy_max_blocks(),
                               dtype=torch.float32, device=logits.device)
        out = torch.empty((), dtype=torch.float32, device=logits.device)
        with torch.cuda.device(logits.device):
            err = lib.fused_cross_entropy_forward(
                logits.data_ptr(), labels.data_ptr(), partials.data_ptr(),
                out.data_ptr(), *_kernel_args(logits, labels))
        if err:
            raise RuntimeError(f"fused_cross_entropy forward launch failed: CUDA error {err}")
        fused_cross_entropy.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        logits, labels = ctx.saved_tensors
        if logits.device.type == "cpu":
            return fused_cross_entropy_grad_reference(logits, labels, g), None
        g32 = g.to(torch.float32).contiguous()
        dx = torch.empty_like(logits)
        with torch.cuda.device(logits.device):
            err = _library().fused_cross_entropy_backward(
                logits.data_ptr(), labels.data_ptr(), g32.data_ptr(), dx.data_ptr(),
                *_kernel_args(logits, labels))
        if err:
            raise RuntimeError(f"fused_cross_entropy backward launch failed: CUDA error {err}")
        fused_cross_entropy.launches += 1
        return dx, None


def fused_cross_entropy(logits, labels):
    """Mean softmax CE over channel-last logits, without class weights.

    ``logits``: (..., C) float; ``labels``: (...) uint8/int32/int64.
    Differentiable in ``logits``.  CUDA logits (float32 or bfloat16,
    contiguous, C <= 64) launch the kernels or raise; CPU logits run the
    plain versions.
    """
    _check(logits, labels)
    if logits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_cross_entropy runs on cuda or cpu tensors, not {logits.device}")
    return _FusedCE.apply(logits, labels)


fused_cross_entropy.launches = 0
