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
masks, sized by ``plan``: the bulk path for the train step's shapes, the
generic path for the rest) for CUDA tensors and raises on what the kernel
does not take; for
CPU tensors it computes the plain PyTorch version
``dihedral_normalize_reference``.  ``dihedral_normalize.launches`` counts
the kernel launches.

Under CUDA graph capture the launch goes to the capture stream (the current
one).  What is set up once and cached -- the library, ``_device_sms``'
shared-memory attribute, ``imagenet_stats``' device constants -- raises if
it would first happen during a capture; run the work once before.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
from uda_aerial_semantic_segmentation_research_tpu_torch.utils.device import (
    refuse_under_capture,
)

MAX_CHANNELS = 8
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


@functools.lru_cache(maxsize=None)
def imagenet_stats(device: torch.device):
    """(mean, std) of the ImageNet normalization as float32 (C,) tensors on
    ``device``, made there by fills (no copy from the host, so no wait on
    it) once per device, as normal tensors even when first asked for under
    ``inference_mode``; callers only read them.  A CUDA device's pair is
    never first made during CUDA graph capture (it would live in the graph's
    pool)."""
    if device.type == "cuda":
        refuse_under_capture("making imagenet_stats' device constants")

    def const(values):
        t = torch.empty(len(values), dtype=torch.float32, device=device)
        for i, v in enumerate(values):
            t[i] = v
        return t

    with torch.inference_mode(False), torch.no_grad():
        return const(Config.NORMALIZE_MEAN), const(Config.NORMALIZE_STD)


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


# the launch plan; the kernel checks it (csrc/dihedral_normalize.cu head note)
TILE_ROWS = 64             # bulk kernel: most output rows of a unit
TILE_COLS = 256            # bulk kernel: most output columns of a unit
STAGES = 2                 # bulk kernel: units in flight a block
WAVES = 2                  # bulk kernel: blocks per SM (an SM holds one at a time)
RING_OFFSET = 3200         # bulk kernel: shared bytes before the ring (barriers, tables)
SMEM_LIMIT = 232448        # shared bytes a block may opt into on an H100 (227 KB)
GENERIC_BLOCKS_PER_SM = 8  # generic kernel: blocks of 256 threads an SM
_MAX_UNITS = 2 ** 31 - 1


class Plan(NamedTuple):
    bulk: bool     # bulk kernel (bulk copies, vector stores); else the generic kernel
    grid: int
    smem: int      # dynamic shared bytes (bulk kernel)
    rows: int      # bulk kernel: a unit is rows x cols output pixels
    cols: int
    stages: int


def _skewed_offset(r: int, chunks: int) -> int:
    """Byte offset of staged row r of a transposed unit whose rows are
    ``chunks`` 16-byte chunks: 16 bytes of skew every 4 rows (``t_off`` in
    the kernel)."""
    return 16 * (r * chunks + r // 4)


def _area_bytes(rows: int, cols: int, ch: int) -> int:
    """Bytes of a stage's image (ch=3) or mask (ch=1) area: a unit's source
    bytes staged dense (untransposed) or as ``cols`` skewed rows
    (transposed), rounded up to 128 (``area_bytes`` in the kernel)."""
    chunks = rows * ch // 16
    skewed = _skewed_offset(cols - 1, chunks) + 16 * chunks
    return -(-max(rows * cols * ch, skewed) // 128) * 128


@functools.lru_cache(maxsize=256)
def plan(b: int, s: int, c: int, mask_kind: int, aligned: bool, sms: int) -> Plan:
    """Launch of one call on (b, s, s, c) uint8 images with masks of
    ``mask_kind`` (-1 none, 0 uint8, 1 int32, 2 int64) on a card with ``sms``
    SMs; ``aligned``: the image and mask pointers are 16-byte aligned.

    Bulk path for c == 3, no masks or uint8 masks, s a multiple of 16 (a
    source row is a whole number of 16-byte vectors) and aligned pointers:
    units of up to ``TILE_ROWS`` x ``TILE_COLS`` output pixels, ``STAGES`` of
    them in flight a block, and ``WAVES`` blocks per SM, which holds one at
    a time (never more blocks than units), so that blocks that drew
    slower units (transposed ones) are evened out by the hardware handing
    the next block to the SM that is free.  Otherwise the generic path: one
    block an output row, at most ``GENERIC_BLOCKS_PER_SM`` blocks an SM.
    """
    if not (c == 3 and mask_kind in (-1, 0) and s % 16 == 0 and aligned):
        return Plan(False, max(1, min(b * s, sms * GENERIC_BLOCKS_PER_SM)), 0, 0, 0, 0)
    rows, cols = min(TILE_ROWS, s), min(TILE_COLS, s)
    stage = _area_bytes(rows, cols, 3) + (_area_bytes(rows, cols, 1) if mask_kind == 0 else 0)
    units = b * -(-s // rows) * -(-s // cols)
    grid = max(1, min(units, WAVES * sms))
    return Plan(True, grid, RING_OFFSET + STAGES * stage, rows, cols, STAGES)


@functools.cache
def _library():
    """The built kernel library with its C signatures declared."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops._build import (
        load_library,
    )

    lib = load_library("dihedral_normalize")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dihedral_normalize_prepare.argtypes = []
    lib.dihedral_normalize_prepare.restype = i32
    lib.dihedral_normalize_launch.argtypes = (
        [ptr, ptr, i32, ptr, ptr, ptr] + [i32] * 5 + [f32] * 6 + [i32] * 6 + [ptr])
    lib.dihedral_normalize_launch.restype = i32
    return lib


@functools.cache
def _device_sms(index: int) -> int:
    """SMs of the current device, ``index``; also lets the bulk kernel use the
    device's shared memory there, which every bulk launch needs.  Never
    during CUDA graph capture."""
    refuse_under_capture("dihedral_normalize's shared-memory attribute")
    sms = _library().dihedral_normalize_prepare()
    if sms < 0:
        raise RuntimeError(f"dihedral_normalize cannot prepare its kernel on cuda:{index} "
                           f"(CUDA error {-sms})")
    return sms


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

    ``images`` uint8 (B, S, S, C) square tiles; ``flags`` int32/int64 (B,)
    bitmask (bit 0 transpose, bit 1 flip width, bit 2 flip height; higher
    bits are ignored); ``masks`` optional uint8/int32/int64 (B, S, S)
    transformed with the same gates.  Returns (float32 images, int32 masks or
    None).  CUDA tensors launch the kernel (contiguous images and masks,
    C <= 8; one device kernel a call) or raise; CPU tensors run
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
    if b == 0 or s == 0 or b * s > _MAX_UNITS:
        raise ValueError(f"dihedral_normalize cannot launch on {tuple(images.shape)}")
    device = images.device
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return _launch(images, flags, masks, normalize)
    return _launch(images, flags, masks, normalize)


def _launch(images, flags, masks, normalize):
    b, s, _, c = images.shape
    device = images.device
    mask_kind = -1 if masks is None else _MASK_KINDS[masks.dtype]
    img_ptr, mask_ptr = images.data_ptr(), None if masks is None else masks.data_ptr()
    p = plan(b, s, c, mask_kind, img_ptr % 16 == 0 and (mask_ptr is None or mask_ptr % 16 == 0),
             _device_sms(device.index))
    out = torch.empty(images.shape, dtype=torch.float32, device=device)
    out_masks = (None if masks is None else
                 torch.empty(masks.shape, dtype=torch.int32, device=device))
    # int64 flags are read through their low word, in place: no conversion kernel
    words = flags.element_size() // 4
    err = _library().dihedral_normalize_launch(
        img_ptr, flags.data_ptr(), flags.stride(0) * words, out.data_ptr(), mask_ptr,
        None if masks is None else out_masks.data_ptr(), mask_kind, b, s, c, int(normalize),
        *Config.NORMALIZE_MEAN, *Config.NORMALIZE_STD, int(p.bulk), p.grid, p.rows, p.cols,
        p.stages, p.smem, torch._C._cuda_getCurrentRawStream(device.index))
    if err:
        raise RuntimeError(f"dihedral_normalize kernel launch failed: CUDA error {err}")
    dihedral_normalize.launches += 1
    return out, out_masks


dihedral_normalize.launches = 0
