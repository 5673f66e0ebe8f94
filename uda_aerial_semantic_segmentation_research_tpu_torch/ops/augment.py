"""Batched on-device data augmentation, NHWC.

Counterpart of the JAX package's ``ops/augment.py``.  Ported so far: the
configuration (``AugmentConfig`` with the same fields, ``WEAK``, ``STRONG``,
``NONE``), the dihedral stage (``_sample_dihedral``, ``_apply_dihedral``, the
``ops.dihedral`` kernel as its front-end for uint8 batches), the ImageNet
normalization and ``augment_batch`` around them.  The shift-scale-rotate and
distortion warps and the photometric stages (noise, blurs, colour OneOf,
HSV) are not ported yet: ``augment_batch`` raises ``NotImplementedError``
for a configuration that asks for one of them, it never skips a stage
silently.  A dihedral-only pipeline is
``dataclasses.replace(WEAK, **{p: 0.0 for p in UNPORTED_STAGES})``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from uda_aerial_semantic_segmentation_research_tpu_torch.ops.dihedral import (
    apply_dihedral as _apply_dihedral,
    dequantize,
    dihedral_normalize,
    flags_from_abc,
    imagenet_stats,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# probabilities of the stages that are not ported yet
UNPORTED_STAGES = ("p_ssr", "p_distort", "p_noise", "p_blur", "p_color", "p_hsv")


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Probabilities/magnitudes for one augmentation pipeline (hashable).

    Field for field the JAX package's ``AugmentConfig``.  ``pallas_dihedral``
    is kept so that a configuration moves between the packages unchanged;
    the port reads nothing from it (a uint8 batch always takes the dihedral
    kernel on the card).
    """

    # geometric
    p_rot90: float = 0.5
    p_flip: float = 0.5
    p_transpose: float = 0.5
    p_ssr: float = 0.2
    shift_limit: float = 0.0625
    scale_limit: float = 0.2
    rotate_limit: float = 45.0
    # photometric
    p_noise: float = 0.2
    noise_std: Tuple[float, float] = (10.0 ** 0.5 / 255.0, 50.0 ** 0.5 / 255.0)
    p_blur: float = 0.2
    blur_size: int = 3
    blur_weights: Tuple[float, float, float] = (0.5, 0.25, 0.25)
    p_color: float = 0.3
    brightness_limit: float = 0.2
    contrast_limit: float = 0.2
    sharpen_alpha: Tuple[float, float] = (0.2, 0.5)
    sharpen_lightness: Tuple[float, float] = (0.5, 1.0)
    emboss_alpha: Tuple[float, float] = (0.2, 0.5)
    emboss_strength: Tuple[float, float] = (0.2, 0.7)
    clahe_clip: float = 2.0
    clahe_tiles: int = 8
    p_hsv: float = 0.3
    hue_shift: float = 20.0 / 180.0
    sat_shift: float = 30.0 / 255.0
    val_shift: float = 20.0 / 255.0
    # distortions: OneOf {optical, grid, elastic}
    p_distort: float = 0.2
    distort_weights: Tuple[float, float, float] = (3 / 7, 1 / 7, 3 / 7)
    optical_limit: float = 0.05
    grid_steps: int = 5
    grid_limit: float = 0.3
    elastic_alpha: float = 1.0
    elastic_sigma: int = 50
    warp_groups: int = 4
    pallas_dihedral: str = "auto"
    # pixel-data dtype of the pipeline's intermediate math; the final
    # normalize runs in float32
    compute_dtype: str = "float32"

    @property
    def has_geometric(self) -> bool:
        return (self.p_rot90 > 0 or self.p_flip > 0 or self.p_transpose > 0
                or self.p_ssr > 0 or self.p_distort > 0)


# weak pipeline of the reference (training)
WEAK = AugmentConfig(compute_dtype="bfloat16")

# strong pipeline of the reference (unsupervised views)
STRONG = AugmentConfig(
    compute_dtype="bfloat16",
    p_rot90=0.7, p_flip=0.7, p_transpose=0.7,
    p_ssr=0.5, shift_limit=0.1, scale_limit=0.3, rotate_limit=60.0,
    p_noise=0.4, noise_std=(20.0 ** 0.5 / 255.0, 80.0 ** 0.5 / 255.0),
    p_blur=0.4, blur_size=5, blur_weights=(0.4, 0.3, 0.3),
    p_color=0.5, brightness_limit=0.3, contrast_limit=0.3, clahe_clip=4.0,
    p_hsv=0.4, hue_shift=20.0 / 180.0, sat_shift=30.0 / 255.0,
    val_shift=20.0 / 255.0,
    p_distort=0.4, distort_weights=(1 / 3, 1 / 3, 1 / 3),
    optical_limit=0.08, grid_limit=0.4, elastic_alpha=1.5,
)

# validation pipeline: normalize only
NONE = AugmentConfig(
    p_rot90=0.0, p_flip=0.0, p_transpose=0.0, p_ssr=0.0,
    p_noise=0.0, p_blur=0.0, p_color=0.0, p_hsv=0.0, p_distort=0.0,
)


def require_ported(cfg: AugmentConfig) -> None:
    """Raise NotImplementedError if ``cfg`` asks for a stage not ported yet."""
    asked = [p for p in UNPORTED_STAGES if getattr(cfg, p) > 0]
    if asked:
        raise NotImplementedError(
            f"augmentation stages not ported yet: {', '.join(asked)} > 0; only the "
            "dihedral stage and the normalization are (set these probabilities to 0)")


# Forward 2x2 matrices of the dihedral pieces on centred (x, y) coordinates.
_ROT90 = (((1, 0), (0, 1)), ((0, -1), (1, 0)), ((-1, 0), (0, -1)), ((0, 1), (-1, 0)))
# flip codes: 0 = none, 1 = horizontal (x), 2 = vertical (y), 3 = both
_FLIP = (((1, 0), (0, 1)), ((-1, 0), (0, 1)), ((1, 0), (0, -1)), ((-1, 0), (0, -1)))
_TRANSPOSE = (((1, 0), (0, 1)), ((0, 1), (1, 0)))


def _sample_dihedral(generator: torch.Generator, n: int, cfg: AugmentConfig):
    """Per-image dihedral element as (transpose?, flip_x?, flip_y?) booleans,
    drawn from ``generator`` on the generator's device.

    Mirrors the reference's sequence RandomRotate90(p) -> Flip(p) ->
    Transpose(p): the composed group element is an integer matrix product,
    decoded into its unique ``F_y^c F_x^b T^a`` factorization.  The JAX
    function draws from another random stream, so the two agree in
    distribution, not draw by draw.
    """
    dev = generator.device
    u = lambda: torch.rand(n, generator=generator, device=dev)
    r = lambda hi: torch.randint(0, hi, (n,), generator=generator, device=dev)
    zero = torch.zeros(n, dtype=torch.int64, device=dev)

    kk_rot = torch.where(u() < cfg.p_rot90, r(4), zero)
    fcode = torch.where(u() < cfg.p_flip, r(3) + 1, zero)
    tcode = (u() < cfg.p_transpose).long()
    # float matrices with entries 0 and +-1: the products are exact
    mats = [torch.tensor(t, dtype=torch.float32, device=dev)[code]
            for t, code in ((_TRANSPOSE, tcode), (_FLIP, fcode), (_ROT90, kk_rot))]
    m = mats[0] @ mats[1] @ mats[2]

    a = m[:, 0, 0] == 0                                      # transpose part
    b = torch.where(a, m[:, 0, 1] < 0, m[:, 0, 0] < 0)       # flip x (width)
    c = torch.where(a, m[:, 1, 0] < 0, m[:, 1, 1] < 0)       # flip y (height)
    return a, b, c


def _dequantize(images: torch.Tensor) -> torch.Tensor:
    """uint8/float -> float32 (integers divided by 255)."""
    return images.float() if images.dtype.is_floating_point else dequantize(images)


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """uint8/float NHWC -> normalized float32 NHWC (integers divided by 255)."""
    mean, std = imagenet_stats(images.device)
    return (_dequantize(images) - mean) / std


def denormalize_images(images: torch.Tensor) -> torch.Tensor:
    """Inverse of ``normalize_images`` -> float32 in [0, 1]."""
    mean, std = imagenet_stats(images.device)
    return torch.clamp(images * std + mean, 0.0, 1.0)


def augment_batch(generator: Optional[torch.Generator], images, masks=None, *,
                  cfg: AugmentConfig = WEAK, normalize: bool = True, abc=None):
    """Augment a uint8/float NHWC batch (and aligned int masks) on device.

    Returns (images float32 normalized NHWC, masks int32 NHW or None).  The
    dihedral elements are drawn from ``generator`` (a ``torch.Generator`` on
    the images' device, owned by the caller: two calls draw different
    elements, the same seed repeats a run) unless ``abc`` gives the (B,)
    booleans (transpose, flip_x, flip_y) explicitly.

    Order of the JAX function: dihedral kernel on the raw uint8 batch with
    ``normalize=False`` -> cast to ``cfg.compute_dtype`` -> (warps and
    photometric stages, not ported: ``NotImplementedError``) -> float32 ->
    ImageNet normalize.  A float batch takes the plain dihedral ops.
    """
    if images.dim() != 4 or images.shape[1] != images.shape[2]:
        raise ValueError("on-device augmentation requires square NHWC tiles "
                         f"(got {tuple(images.shape)}); resize in the data pipeline")
    require_ported(cfg)
    compute_dtype = _DTYPES[cfg.compute_dtype]
    has_dihedral = cfg.p_rot90 > 0 or cfg.p_flip > 0 or cfg.p_transpose > 0

    if has_dihedral:
        if abc is None:
            if generator is None:
                raise ValueError("augment_batch needs a generator or explicit abc")
            abc = _sample_dihedral(generator, images.shape[0], cfg)
        abc = tuple(t.to(images.device) for t in abc)
        if images.dtype == torch.uint8:
            x, m = dihedral_normalize(images, flags_from_abc(*abc), masks,
                                      normalize=False)
            x = x.to(compute_dtype)
        else:
            m = None if masks is None else masks.to(torch.int32)
            x, m = _apply_dihedral(_dequantize(images).to(compute_dtype), m, *abc)
    else:
        x = _dequantize(images).to(compute_dtype)
        m = None if masks is None else masks.to(torch.int32)

    x = x.float()
    if normalize:
        mean, std = imagenet_stats(images.device)
        x = (x - mean) / std
    return x, m
