"""Per-image dihedral transform fused with the uint8 dequantization.

Counterpart of the JAX package's ``ops/pallas_ops.py::dihedral_normalize``
and ``flags_from_abc`` (the Pallas kernels ``_dihedral_norm_kernel`` and
``_dihedral_mask_kernel``).  The kernel is hand-written CUDA
(``csrc/dihedral_normalize.cu``): the TPU version's permutation matmuls,
channel-planar layout, f32 mask round trip and ``precision`` argument were
Mosaic workarounds and are not carried over -- on the card the transform is
index arithmetic, so the values are moved bit for bit.

Flag bits per image: bit 0 transpose, bit 1 flip width, bit 2 flip height,
applied in that order (``apply_dihedral``).  The dequantization is one
float32 division ``x / 255`` -- what the JAX package's plain path
(``ops/augment.py``: ``x.astype(f32) / 255.0`` then ``_apply_dihedral``)
computes, so the port equals that path exactly; the Pallas kernel multiplies
by ``1/255`` instead and differs by at most one float32 ulp.

``dihedral_normalize`` launches the kernel (one launch for images and
masks) for CUDA tensors and raises on what the kernel does not take; for
CPU tensors it computes the plain PyTorch version
``dihedral_normalize_reference``.  ``dihedral_normalize.launches`` counts
the kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config

MAX_CHANNELS = 8
_GRID_LIMIT = 65535
_TILE = 32  # pixels per tile side (TILE in csrc/dihedral_normalize.cu)
_MASK_KINDS = {torch.uint8: 0, torch.int32: 1, torch.int64: 2}


def flags_from_abc(a, b, c):
    """Pack the (transpose, flip_x, flip_y) booleans into the kernel bitmask."""
    return a.to(torch.int32) + 2 * b.to(torch.int32) + 4 * c.to(torch.int32)


def abc_from_flags(flags):
    """Unpack the kernel bitmask into (transpose, flip_x, flip_y) booleans."""
    return (flags & 1) != 0, (flags & 2) != 0, (flags & 4) != 0


def apply_dihedral(x, m, a, b, c):
    """Per-image dihedral elements as dense ops with per-image selects:
    transpose, then reverse width, then reverse height, gated by the (B,)
    booleans ``a``, ``b``, ``c``.  ``x`` (B, S, S, C); ``m`` (B, S, S) or None."""
    ga, gb, gc = (g.view(-1, 1, 1, 1) for g in (a, b, c))
    x = torch.where(ga, x.transpose(1, 2), x)
    x = torch.where(gb, x.flip(2), x)
    x = torch.where(gc, x.flip(1), x)
    if m is not None:
        ga, gb, gc = (g.view(-1, 1, 1) for g in (a, b, c))
        m = torch.where(ga, m.transpose(1, 2), m)
        m = torch.where(gb, m.flip(2), m)
        m = torch.where(gc, m.flip(1), m)
    return x, m


def imagenet_stats(device):
    """(mean, std) of the ImageNet normalization as float32 (C,) tensors."""
    mean = torch.tensor(Config.NORMALIZE_MEAN, dtype=torch.float32, device=device)
    std = torch.tensor(Config.NORMALIZE_STD, dtype=torch.float32, device=device)
    return mean, std


def dequantize(images):
    """uint8 -> float32 ``x / 255`` as one IEEE division.  The divisor is a
    tensor on the images' device: dividing a CUDA tensor by a Python number
    multiplies by the rounded reciprocal instead, one ulp off for some x."""
    return images.float() / torch.full((), 255.0, device=images.device)


def dihedral_normalize_reference(images, flags, masks=None, *, normalize=False):
    """Plain PyTorch version of the kernel (same arithmetic): uint8
    (B, S, S, C) -> float32 ``x / 255`` [``(x - mean) / std``] under the
    per-image dihedral element; masks -> int32 under the same element."""
    x = dequantize(images)
    m = None if masks is None else masks.to(torch.int32)
    x, m = apply_dihedral(x, m, *abc_from_flags(flags))
    if normalize:
        mean, std = imagenet_stats(images.device)
        x = (x - mean) / std
    return x, m


@functools.cache
def _library():
    """The built kernel library with its C signatures declared."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops._build import (
        load_library,
    )

    lib = load_library("dihedral_normalize")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dihedral_normalize_launch.argtypes = [ptr] * 5 + [i32] * 5 + [f32] * 6 + [ptr]
    lib.dihedral_normalize_launch.restype = i32
    return lib


def _check(images, flags, masks, normalize):
    if images.dim() != 4:
        raise ValueError(f"expected images (B,H,W,C), got {tuple(images.shape)}")
    b, h, w, c = images.shape
    if h != w:
        raise ValueError("dihedral kernel requires square tiles")
    if images.dtype != torch.uint8:
        raise TypeError(f"dihedral_normalize takes uint8 images, not {images.dtype}")
    if tuple(flags.shape) != (b,) or flags.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"flags must be int ({b},), got {flags.dtype} "
                         f"{tuple(flags.shape)}")
    if normalize and c != len(Config.NORMALIZE_MEAN):
        raise ValueError(f"normalize needs {len(Config.NORMALIZE_MEAN)} channels, "
                         f"got {c}")
    if masks is not None:
        if tuple(masks.shape) != (b, h, w):
            raise ValueError(f"masks {tuple(masks.shape)} do not match images "
                             f"{tuple(images.shape)}")
        if masks.dtype not in _MASK_KINDS:
            raise TypeError(f"masks must be uint8, int32 or int64, not {masks.dtype}")
    for t in (flags, masks):
        if t is not None and t.device != images.device:
            raise ValueError("all dihedral_normalize arguments must be on one device")


def dihedral_normalize(images, flags, masks=None, *, normalize: bool = False):
    """Fused per-image dihedral + dequant (+ ImageNet normalize).

    ``images`` uint8 (B, S, S, C) square tiles; ``flags`` int (B,) bitmask
    (bit 0 transpose, bit 1 flip width, bit 2 flip height; higher bits are
    ignored); ``masks`` optional uint8/int32/int64 (B, S, S) transformed with
    the same gates.  Returns (float32 images, int32 masks or None).  CUDA
    tensors launch the kernel (contiguous, C <= 8) or raise; CPU tensors run
    ``dihedral_normalize_reference``.
    """
    _check(images, flags, masks, normalize)
    if images.device.type == "cpu":
        return dihedral_normalize_reference(images, flags, masks, normalize=normalize)
    if images.device.type != "cuda":
        raise ValueError("dihedral_normalize runs on cuda or cpu tensors, not "
                         f"{images.device}")
    b, s, _, c = images.shape
    if not images.is_contiguous() or (masks is not None and not masks.is_contiguous()):
        raise ValueError("dihedral_normalize needs contiguous images and masks")
    if not (1 <= c <= MAX_CHANNELS):
        raise ValueError(f"dihedral_normalize takes 1..{MAX_CHANNELS} channels, got {c}")
    if b == 0 or s == 0 or b > _GRID_LIMIT or -(-s // _TILE) > _GRID_LIMIT:
        raise ValueError(f"dihedral_normalize cannot launch on {tuple(images.shape)}")

    lib = _library()
    flags32 = flags.to(torch.int32).contiguous()
    out = torch.empty(images.shape, dtype=torch.float32, device=images.device)
    out_masks = (None if masks is None else
                 torch.empty(masks.shape, dtype=torch.int32, device=images.device))
    with torch.cuda.device(images.device):
        err = lib.dihedral_normalize_launch(
            images.data_ptr(), flags32.data_ptr(), out.data_ptr(),
            None if masks is None else masks.data_ptr(),
            None if masks is None else out_masks.data_ptr(),
            0 if masks is None else _MASK_KINDS[masks.dtype], b, s, c, int(normalize),
            *Config.NORMALIZE_MEAN, *Config.NORMALIZE_STD,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"dihedral_normalize kernel launch failed: CUDA error {err}")
    dihedral_normalize.launches += 1
    return out, out_masks


dihedral_normalize.launches = 0
