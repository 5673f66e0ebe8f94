"""Fused [BN-affine + ReLU ->] conv3x3-SAME [-> output moments].

Counterpart of the JAX package's ``ops/pallas_conv.py::packed_conv_bn_relu``
(the Pallas kernel ``_conv_kernel``).  The kernels are hand-written CUDA
(``csrc/conv_bn_relu.cu``): bfloat16 runs a tensor-core implicit GEMM
(persistent blocks, TMA halo ring, ldmatrix + mma.sync), float32 a
CUDA-core direct convolution that stays exact to 1e-4.  The TPU version's
2x2 space-to-depth packing, ``-shift/scale`` border ring and one-row halo
BlockSpec were Mosaic workarounds and are not carried over -- the CUDA
kernels pad the post-ReLU activation with exact zeros.

``conv_bn_relu`` launches the kernel for a CUDA tensor and raises on what
the kernel does not take; for a CPU tensor it computes the plain PyTorch
version ``conv_bn_relu_reference``.  ``conv_bn_relu.launches`` counts the
kernel launches.

Under CUDA graph capture the launch goes to the capture stream (the current
one); the tensor maps are encoded on the host into the kernel's parameters,
which the graph keeps.  What is set up once and cached -- the library and
``_bf16_blocks``' attribute and occupancy query for a shape -- raises if it
would first happen during a capture; run the shape once before.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from uda_aerial_semantic_segmentation_research_tpu_torch.utils.device import (
    refuse_under_capture,
)

MAX_CHANNELS = 32
_GRID_LIMIT = 65535
_F32_TILE_H = 8  # output rows per float32 thread block (F_TH in csrc/conv_bn_relu.cu)
_BF16_TILE = (8, 32)  # output rows x columns per bfloat16 tile (TH, TW there)


def conv_bn_relu_reference(x, k3, scale=None, shift=None, *, moments=False):
    """Plain PyTorch version of the kernel (same arithmetic).

    ``x`` (B, H, W, Cin) NHWC; ``k3`` (3, 3, Cin, Cout) HWIO.  With
    ``scale``/``shift`` (Cin,) computes ``conv3x3(relu(scale*x + shift))``,
    the activation rounded to ``x.dtype`` and the conv accumulated in f32;
    otherwise ``conv3x3(x)``.  Returns y (B, H, W, Cout) in ``x.dtype``,
    or ``(y, moments)`` with moments (2, Cout) f32 = per-channel
    (sum, sum of squares) of the f32 conv output over (B, H, W).
    """
    a = x.float()
    if scale is not None:
        a = torch.relu(a * scale.float() + shift.float()).to(x.dtype).float()
    w = k3.to(x.dtype).float().permute(3, 2, 0, 1)          # HWIO -> OIHW
    y32 = F.conv2d(a.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
    y = y32.to(x.dtype)
    if moments:
        return y, torch.stack([y32.sum((0, 1, 2)), (y32 * y32).sum((0, 1, 2))])
    return y


@functools.cache
def _library():
    """The built kernel library with its C signatures declared (every
    pointer and the stream as c_void_p, so none is cut to 32 bits)."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops._build import (
        load_library,
    )

    lib = load_library("conv_bn_relu")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.conv_bn_relu_f32_launch.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
    lib.conv_bn_relu_f32_launch.restype = i32
    lib.conv_bn_relu_bf16_launch.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
    lib.conv_bn_relu_bf16_launch.restype = i32
    lib.conv_bn_relu_f32_num_blocks.argtypes = [i32] * 3
    lib.conv_bn_relu_f32_num_blocks.restype = ctypes.c_longlong
    lib.conv_bn_relu_bf16_num_blocks.argtypes = [i32] * 5
    lib.conv_bn_relu_bf16_num_blocks.restype = ctypes.c_longlong
    lib.conv_bn_relu_fold_moments.argtypes = [ptr, ptr, ctypes.c_longlong, i32, ptr]
    lib.conv_bn_relu_fold_moments.restype = i32
    return lib


def _check(x, k3, scale, shift):
    if x.dim() != 4 or k3.dim() != 4:
        raise ValueError(f"expected x (B,H,W,Cin) and k3 (3,3,Cin,Cout), got "
                         f"{tuple(x.shape)} and {tuple(k3.shape)}")
    b, h, w, cin = x.shape
    if tuple(k3.shape[:3]) != (3, 3, cin):
        raise ValueError(f"k3 {tuple(k3.shape)} does not match Cin={cin}")
    if (scale is None) != (shift is None):
        raise ValueError("pass both scale and shift, or neither")
    if scale is not None and (tuple(scale.shape) != (cin,)
                              or tuple(shift.shape) != (cin,)):
        raise ValueError(f"scale/shift must have shape ({cin},)")


def conv_bn_relu(x, k3, scale=None, shift=None, *, moments=False):
    """Fused [BN-affine + ReLU ->] conv3x3-SAME [-> output moments].

    Same contract as ``conv_bn_relu_reference``.  A CUDA tensor launches
    the kernel (float32 or bfloat16, contiguous NHWC, Cin and Cout <= 32)
    or raises; a CPU tensor runs the reference.
    """
    _check(x, k3, scale, shift)
    if x.device.type == "cpu":
        return conv_bn_relu_reference(x, k3, scale, shift, moments=moments)
    if x.device.type != "cuda":
        raise ValueError(f"conv_bn_relu runs on cuda or cpu tensors, not {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv_bn_relu takes float32 or bfloat16, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("conv_bn_relu needs a contiguous NHWC tensor")
    b, h, w, cin = x.shape
    cout = k3.shape[3]
    if not (1 <= cin <= MAX_CHANNELS and 1 <= cout <= MAX_CHANNELS):
        raise ValueError(f"conv_bn_relu takes 1..{MAX_CHANNELS} channels, "
                         f"got Cin={cin} Cout={cout}")
    bf16 = x.dtype == torch.bfloat16
    if bf16:  # tiles are counted in int32
        th, tw = _BF16_TILE
        fits = b * -(-h // th) * -(-w // tw) < 2 ** 31
    else:     # one block per (image, tile row, tile column)
        fits = b <= _GRID_LIMIT and -(-h // _F32_TILE_H) <= _GRID_LIMIT
    if b * h * w == 0 or not fits:
        raise ValueError(f"conv_bn_relu cannot launch on shape {tuple(x.shape)}")
    for t in (k3, scale, shift):
        if t is not None and t.device != x.device:
            raise ValueError("all conv_bn_relu arguments must be on one device")

    lib = _library()
    # weights rounded to the working dtype (as the Pallas kernel's km), kept
    # f32; the bf16 kernel rounds them itself
    wf = (k3.to(torch.float32, memory_format=torch.contiguous_format) if bf16
          else k3.to(x.dtype).float().contiguous())
    sc = sh = None
    if scale is not None:
        sc = scale.float().contiguous()
        sh = shift.float().contiguous()
    y = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        n_blk = (_bf16_blocks(lib, x.device.index, b, h, w, cin, cout) if bf16
                 else lib.conv_bn_relu_f32_num_blocks(b, h, w))
        partials = (torch.empty((n_blk, 2, cout), dtype=torch.float32, device=x.device)
                    if moments else None)
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (x.data_ptr(), wf.data_ptr(),
                None if sc is None else sc.data_ptr(),
                None if sh is None else sh.data_ptr(),
                y.data_ptr(), None if partials is None else partials.data_ptr())
        if bf16:
            err = lib.conv_bn_relu_bf16_launch(*ptrs, b, h, w, cin, cout, n_blk, stream)
        else:
            err = lib.conv_bn_relu_f32_launch(*ptrs, b, h, w, cin, cout, stream)
        if err:
            raise RuntimeError(f"conv_bn_relu kernel launch failed: CUDA error {err}")
        conv_bn_relu.launches += 1
        if not moments:
            return y
        mom = torch.empty((2, cout), dtype=torch.float32, device=x.device)
        err = lib.conv_bn_relu_fold_moments(partials.data_ptr(), mom.data_ptr(),
                                            n_blk, cout, stream)
        if err:
            raise RuntimeError(f"conv_bn_relu moments fold failed: CUDA error {err}")
    return y, mom


@functools.lru_cache(maxsize=64)
def _bf16_blocks(lib, device_index, b, h, w, cin, cout):
    """Persistent blocks of a bfloat16 launch on this device (the rows of its
    moments scratch); the launch uses exactly this grid.  Never during CUDA
    graph capture."""
    refuse_under_capture("conv_bn_relu's attribute and occupancy query")
    n = lib.conv_bn_relu_bf16_num_blocks(b, h, w, cin, cout)
    if n <= 0:
        raise RuntimeError(f"conv_bn_relu cannot size its grid: CUDA error {-n}")
    return n


conv_bn_relu.launches = 0
