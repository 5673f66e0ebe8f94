"""Per-channel float32 sums of a channel-last activation.

Counterpart of the JAX package's ``ops/pallas_moments.py::lane_sums`` and
``lane_dual_sums`` (the Pallas kernels ``_sums_kernel`` / ``_dual_kernel``)
folded to channels by ``ops/lane_bn.py::_fold``:

- ``channel_sums(x)``          -> (2, C): (sum x,  sum x*x)   BatchNorm forward
- ``channel_dual_sums(dy, x)`` -> (2, C): (sum dy, sum dy*x)  BatchNorm backward

The kernels are hand-written CUDA (``csrc/channel_sums.cu``).  The TPU
version's flat ``(M, 128)`` lane view and its divisibility rule are lane
tricks and are not carried over: any channel count and any row count are
taken.  The result is deterministic (per-block partial sums folded in a
fixed order, no float atomics).

Each function launches the kernel for a CUDA tensor and raises on what the
kernel does not take; for a CPU tensor it computes the plain PyTorch version
(``channel_sums_reference`` / ``channel_dual_sums_reference``).  The
``launches`` attribute of each function counts its kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from uda_aerial_semantic_segmentation_research_tpu_torch.utils.dtypes import to_f32

_DTYPES = (torch.float32, torch.bfloat16)


def channel_sums_reference(x):
    """Plain PyTorch version: ``x`` (..., C) -> (2, C) (sum x, sum x*x),
    accumulated in float32."""
    x32 = to_f32(x).reshape(-1, x.shape[-1])
    return torch.stack([x32.sum(0), (x32 * x32).sum(0)])


def channel_dual_sums_reference(dy, x):
    """Plain PyTorch version: (..., C) x 2 -> (2, C) (sum dy, sum dy*x),
    accumulated in float32."""
    d32 = to_f32(dy).reshape(-1, dy.shape[-1])
    x32 = to_f32(x).reshape(-1, x.shape[-1])
    return torch.stack([d32.sum(0), (d32 * x32).sum(0)])


@functools.cache
def _library():
    """The built kernel library with its C signatures declared."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops._build import (
        load_library,
    )

    lib = load_library("channel_sums")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.channel_sums_max_blocks.argtypes = []
    lib.channel_sums_max_blocks.restype = i32
    lib.channel_sums_launch.argtypes = [ptr] * 4 + [i32, i32, ctypes.c_longlong, i32, ptr]
    lib.channel_sums_launch.restype = i32
    return lib


def _check(name, *tensors):
    first = tensors[0]
    for t in tensors:
        if t.dim() < 2:
            raise ValueError(f"{name} takes (..., C) tensors of rank >= 2, got "
                             f"{tuple(t.shape)}")
        if t.shape != first.shape or t.device != first.device:
            raise ValueError(f"{name}: shapes and devices must agree, got "
                             f"{tuple(first.shape)} on {first.device} and "
                             f"{tuple(t.shape)} on {t.device}")
        if t.numel() == 0:
            raise ValueError(f"{name} cannot reduce an empty tensor {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous channel-last tensors; the "
                             "NHWC view of a channels_last activation is one")


def _launch(fn, a, b):
    for t in (a, b):
        if t is not None and t.dtype not in _DTYPES:
            raise TypeError(f"{fn.__name__} takes float32 or bfloat16, not {t.dtype}")
    if a.shape[-1] > 2 ** 20:
        raise ValueError(f"{fn.__name__} cannot launch on {a.shape[-1]} channels")
    lib = _library()
    c = a.shape[-1]
    m = a.numel() // c
    partials = torch.empty((lib.channel_sums_max_blocks(), 2, c),
                           dtype=torch.float32, device=a.device)
    out = torch.empty((2, c), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = lib.channel_sums_launch(
            a.data_ptr(), None if b is None else b.data_ptr(), partials.data_ptr(),
            out.data_ptr(), int(a.dtype == torch.bfloat16),
            int(b is not None and b.dtype == torch.bfloat16), m, c,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: CUDA error {err}")
    fn.launches += 1
    return out


def channel_sums(x):
    """``x`` (..., C) contiguous -> (2, C) float32 (sum x, sum x*x) over all
    leading dims.  A CUDA tensor (float32 or bfloat16) launches the kernel
    or raises; a CPU tensor runs ``channel_sums_reference``."""
    _check("channel_sums", x)
    if x.device.type == "cpu":
        return channel_sums_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"channel_sums runs on cuda or cpu tensors, not {x.device}")
    return _launch(channel_sums, x, None)


def channel_dual_sums(dy, x):
    """``dy``, ``x`` (..., C) contiguous -> (2, C) float32 (sum dy, sum dy*x).
    CUDA tensors (float32 or bfloat16, the two may differ) launch the kernel
    or raise; CPU tensors run ``channel_dual_sums_reference``."""
    _check("channel_dual_sums", dy, x)
    if x.device.type == "cpu":
        return channel_dual_sums_reference(dy, x)
    if x.device.type != "cuda":
        raise ValueError(f"channel_dual_sums runs on cuda or cpu tensors, not {x.device}")
    return _launch(channel_dual_sums, dy, x)


channel_sums.launches = 0
channel_dual_sums.launches = 0
