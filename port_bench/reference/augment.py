"""The training augmentation of the plain reference: a frozen copy.

A copy, made once, of the functions of the port's ``ops/augment.py`` that
its ``WEAK`` pipeline runs on a uint8 batch with masks (the dihedral
element, the shift-scale-rotate and distortion warps, noise, the blur,
colour and HSV OneOfs), and of the samplers that draw their parameters
from a ``torch.Generator``.  The samplers are kept call for call, so that a
generator seeded as the trainer seeds its own gives the reference the same
draws as the program.  What differs from the program's path:

- the pixel math runs in float32 (the program runs it in ``WEAK``'s
  bfloat16), and the dihedral element is applied with dense ops (the
  program uses its ``dihedral_normalize`` kernel);
- nothing here imports the program: the copy stays as it was when the
  benchmark was written, whatever later changes the program makes.

``augment(generator, images, masks)`` is the entry point: uint8 NHWC
images and integer NHW masks in, normalized float32 NHWC images and int32
masks out.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Probabilities and magnitudes of one pipeline, field for field the
    program's ``AugmentConfig`` (``pallas_dihedral`` is read by nothing)."""

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


class SSRDraws(NamedTuple):
    do: torch.Tensor                      # (B,) bool: the image is warped
    prio: Optional[torch.Tensor]          # (B,) compaction priorities; None: no compaction
    shift: torch.Tensor                   # (kg, 2) fractions of the width / height
    scale: torch.Tensor                   # (kg,) 1 + U(-scale_limit, scale_limit)
    angle: torch.Tensor                   # (kg,) radians


class DistortDraws(NamedTuple):
    do: torch.Tensor                      # (B,) bool
    prio: Optional[torch.Tensor]          # (B,)
    which: torch.Tensor                   # (kg,) int: 0 optical, 1 grid, 2 elastic
    k2: torch.Tensor                      # (kg,) radial coefficient
    grid: torch.Tensor                    # (kg, steps+1, steps+1, 2) pixels
    elastic: torch.Tensor                 # (kg, esz, esz, 2) pixels


class WarpDraws(NamedTuple):
    ssr: Optional[SSRDraws]               # None when p_ssr == 0
    distort: Optional[DistortDraws]       # None when p_distort == 0


class NoiseDraws(NamedTuple):
    do: torch.Tensor                      # (B,) bool
    prio: Optional[torch.Tensor]          # (B,)
    std: torch.Tensor                     # (m,) per subset slot
    noise: torch.Tensor                   # (m, H, W, C) standard normal, pixel dtype


class BlurDraws(NamedTuple):
    do: torch.Tensor                      # (B,) bool
    prio: Optional[torch.Tensor]          # (B,)
    choice: torch.Tensor                  # (B,) OneOf uniform {motion, median, box}
    direction: torch.Tensor               # (B,) int in [0, 4)


class ColorDraws(NamedTuple):
    do: torch.Tensor                      # (B,) bool
    choice: torch.Tensor                  # (B,) OneOf uniform
    brightness: torch.Tensor              # (B,)
    contrast: torch.Tensor                # (B,) 1 + U(-limit, limit)
    se_prio: Optional[torch.Tensor]       # (B,) sharpen/emboss compaction
    sharpen_alpha: torch.Tensor           # (m_se,) per subset slot
    sharpen_lightness: torch.Tensor
    emboss_alpha: torch.Tensor
    emboss_strength: torch.Tensor
    clahe_prio: Optional[torch.Tensor]    # (B,); None also when CLAHE is off
    clahe_clip: Optional[torch.Tensor]    # (m_cl,) per subset slot; None when CLAHE is off


class HSVDraws(NamedTuple):
    do: torch.Tensor                      # (B,) bool
    prio: Optional[torch.Tensor]          # (B,)
    hue: torch.Tensor                     # (m,) per subset slot
    sat: torch.Tensor
    val: torch.Tensor


class PhotometricDraws(NamedTuple):
    noise: Optional[NoiseDraws]           # each None when its probability is 0
    blur: Optional[BlurDraws]
    color: Optional[ColorDraws]
    hsv: Optional[HSVDraws]


class AugmentDraws(NamedTuple):
    warp: WarpDraws
    photometric: PhotometricDraws


def _sample_dihedral(generator: torch.Generator, n: int, cfg: AugmentConfig):
    """Per-image dihedral element as (transpose?, flip_x?, flip_y?) booleans,
    drawn from ``generator`` on the generator's device.

    Mirrors the reference's sequence RandomRotate90(p) -> Flip(p) ->
    Transpose(p): the composed group element is an integer matrix product
    ``T @ F @ R`` (built from the codes by arithmetic, so no table is copied
    to the device), decoded into its unique ``F_y^c F_x^b T^a``
    factorization.  The JAX function draws from another random stream, so
    the two agree in distribution, not draw by draw.
    """
    dev = generator.device
    u = lambda: torch.rand(n, generator=generator, device=dev)
    r = lambda hi: torch.randint(0, hi, (n,), generator=generator, device=dev)
    zero = torch.zeros(n, dtype=torch.int64, device=dev)

    kk_rot = torch.where(u() < cfg.p_rot90, r(4), zero)
    fcode = torch.where(u() < cfg.p_flip, r(3) + 1, zero)
    tcode = (u() < cfg.p_transpose).long()

    def mat(a, b, c, d):
        return torch.stack([torch.stack([a, b], -1), torch.stack([c, d], -1)], -2).float()

    # rotation by k quarter turns: cos = 1, 0, -1, 0; sin = 0, 1, 0, -1
    cos = (1 - kk_rot) * (kk_rot % 2 == 0)
    sin = (2 - kk_rot) * (kk_rot % 2 == 1)
    rot = mat(cos, -sin, sin, cos)
    # flip codes: 0 none, 1 x, 2 y, 3 both
    flip = mat(1 - 2 * (fcode & 1), zero, zero, 1 - 2 * ((fcode >> 1) & 1))
    trans = mat(1 - tcode, tcode, tcode, 1 - tcode)
    m = trans @ flip @ rot                                   # entries 0 and +-1: exact

    a = m[:, 0, 0] == 0                                      # transpose part
    b = torch.where(a, m[:, 0, 1] < 0, m[:, 0, 0] < 0)       # flip x (width)
    c = torch.where(a, m[:, 1, 0] < 0, m[:, 1, 1] < 0)       # flip y (height)
    return a, b, c


def _n_groups(n: int, requested: int) -> int:
    """Largest divisor of ``n`` that is <= ``requested``."""
    g = max(min(requested, n), 1)
    while n % g:
        g -= 1
    return g


def _subset_budget(n: int, p: float) -> int:
    """Static mean + 3 sigma whole-image budget for a per-image Bernoulli(p)
    selection, rounded up to a multiple of 4; the whole batch when n <= 8.
    P(binomial(n, p) > budget) ~ 1e-3."""
    if n <= 8:
        return n
    return min(n, int(4 * math.ceil(
        (n * p + 3.0 * math.sqrt(n * p * (1.0 - p))) / 4.0)))


def _compact_select(prio, want, budget: int):
    """Indices of at most ``budget`` images from the ``want`` mask: selected
    images first in the order of their priority ``prio`` (B,) in [0, 1), a
    random drop beyond the budget.  Stable, like ``jnp.argsort``."""
    p = torch.where(want, prio, torch.full_like(prio, 2.0))
    return torch.argsort(p, stable=True)[:budget]


def _compact_apply(prio, x, want, budget: int, fn):
    """Apply ``fn`` to at most ``budget`` of the images selected by ``want``.

    Gathers whole images, applies ``fn`` to the (budget, H, W, C) subset and
    writes it back (``index_copy`` on unique indices).  Returns (out,
    served): ``out[i] == fn(x)[i]`` where served, ``x[i]`` elsewhere;
    ``served == want`` unless more than ``budget`` images were selected.
    Without priorities (``prio`` None: per-row draws, ``rows_of_draws``)
    every image of ``want`` is served.
    """
    n = x.shape[0]
    if budget >= n or prio is None:
        full = fn(x)
        return torch.where(want.view(-1, 1, 1, 1), full, x), want
    idx = _compact_select(prio, want, budget)
    sub = x.index_select(0, idx)
    kept = torch.where(want.index_select(0, idx).view(-1, 1, 1, 1), fn(sub).to(x.dtype), sub)
    served = torch.zeros_like(want).index_fill(0, idx, True) & want
    return x.index_copy(0, idx, kept), served


def _reflect_index(idx, n: int):
    """Reflect-101 boundary indexing (cv2.BORDER_REFLECT_101); ``remainder``
    is a floor mod, non-negative for a positive period."""
    period = 2 * (n - 1)
    r = torch.remainder(idx, period)
    return torch.where(r < n, r, period - r)


def _identity_grid(h: int, w: int, device=None):
    """(yy, xx) float32 (h, w) pixel coordinates, ``indexing="ij"``."""
    return torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device),
                          indexing="ij")


def _grid_sample_grouped(x, m, sx, sy, gate):
    """Sample the batch at per-GROUP (sx, sy) grids, per-image gated.

    ``sx``/``sy`` are float32 (K, H, W) with K dividing the batch; image i
    belongs to group ``i // (B // K)``.  Image bilinear (the four reflect-101
    corners blended in the pixel dtype, in the JAX function's order), mask
    nearest (the corner chosen by ``fx < 0.5``, ``fy < 0.5``); ``gate`` (B,)
    selects the images that take the warp.
    """
    n, h, w, ch = x.shape
    kg = sx.shape[0]
    g = n // kg
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0).reshape(kg, 1, h * w)
    fy = (sy - y0).reshape(kg, 1, h * w)
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    cols = (_reflect_index(x0i, w), _reflect_index(x0i + 1, w))
    rows = (_reflect_index(y0i, h) * w, _reflect_index(y0i + 1, h) * w)
    corners = [(rows[i] + cols[j]).reshape(kg, 1, h * w) for i in (0, 1) for j in (0, 1)]

    flat = x.reshape(kg, g, h * w, ch)
    g00, g01, g10, g11 = (torch.gather(flat, 2, c.unsqueeze(-1).expand(kg, g, h * w, ch))
                          for c in corners)
    fxd, fyd = fx.unsqueeze(-1).to(x.dtype), fy.unsqueeze(-1).to(x.dtype)
    out = (g00 * (1 - fxd) * (1 - fyd) + g01 * fxd * (1 - fyd)
           + g10 * (1 - fxd) * fyd + g11 * fxd * fyd)
    x = torch.where(gate.view(n, 1, 1, 1), out.reshape(n, h, w, ch), x)

    if m is not None:
        mflat = m.reshape(kg, g, h * w)
        m00, m01, m10, m11 = (torch.gather(mflat, 2, c.expand(kg, g, h * w)) for c in corners)
        left, top = fx < 0.5, fy < 0.5
        near = torch.where(top, torch.where(left, m00, m01), torch.where(left, m10, m11))
        m = torch.where(gate.view(n, 1, 1), near.reshape(n, h, w), m)
    return x, m


def _warp_kg(n_sub: int, che: int, requested: int) -> int:
    """Group count for a warped sub-batch, i.e. how many independent
    magnitude draws the batch gets.  The JAX function clamps large
    sub-batches so its gather rows keep >= 128 lanes; the clamp sets the
    distribution of the magnitudes, so it is kept as it is.  At <= 32
    images, or for an explicit ``requested >= n_sub``, no clamp."""
    if n_sub <= 32 or requested >= n_sub:
        return _n_groups(n_sub, requested)
    return _n_groups(n_sub, min(requested, max(1, (n_sub * che) // 128)))


def _ssr_coords(d: SSRDraws, h: int, w: int):
    """Source coordinates (sx, sy), float32 (kg, h, w), of the
    shift-scale-rotate draws: rotation and scale about the centre, then the
    shift."""
    cos = torch.cos(d.angle)[:, None, None]
    sin = torch.sin(d.angle)[:, None, None]
    inv_s = (1.0 / d.scale)[:, None, None]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = _identity_grid(h, w, d.scale.device)
    ox = xx[None] - cx - d.shift[:, 0, None, None] * w
    oy = yy[None] - cy - d.shift[:, 1, None, None] * h
    sx = (cos * ox + sin * oy) * inv_s + cx
    sy = ((-sin) * ox + cos * oy) * inv_s + cy
    return sx, sy


def _ssr_warp_grouped(x, m, do, d: SSRDraws):
    """Shift-scale-rotate with per-group magnitudes (``d`` holds kg draws);
    each image applies its group's warp where ``do``."""
    sx, sy = _ssr_coords(d, x.shape[1], x.shape[2])
    return _grid_sample_grouped(x, m, sx, sy, do)


def _resize_bilinear(field, h: int, w: int):
    """(K, a, b, 2) -> (K, h, w, 2) bilinear upsampling: the JAX function's
    ``jax.image.resize(..., "bilinear")`` (half-pixel centres, edges clamped;
    it only upsamples here, so no antialiasing)."""
    up = F.interpolate(field.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                       align_corners=False, antialias=False)
    return up.permute(0, 2, 3, 1)


def _distort_coords(d: DistortDraws, h: int, w: int):
    """Source coordinates (sx, sy) of the distortion draws: identity grid
    plus the displacement field of each group's OneOf member (optical:
    radial ``r * k2 * (r/R)^2``; grid: jittered control points upsampled;
    elastic: low-resolution noise upsampled)."""
    yy, xx = _identity_grid(h, w, d.k2.device)
    k2 = d.k2[:, None, None]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    rx, ry = (xx - cx) / cx, (yy - cy) / cy
    r2 = (rx * rx + ry * ry)[None]
    opt_dx = (xx - cx)[None] * k2 * r2
    opt_dy = (yy - cy)[None] * k2 * r2
    gfield = _resize_bilinear(d.grid, h, w)
    efield = _resize_bilinear(d.elastic, h, w)
    sel = d.which[:, None, None]
    dx = torch.where(sel == 0, opt_dx, torch.where(sel == 1, gfield[..., 0], efield[..., 0]))
    dy = torch.where(sel == 0, opt_dy, torch.where(sel == 1, gfield[..., 1], efield[..., 1]))
    return xx[None] + dx, yy[None] + dy


def _distort_warp_grouped(x, m, do, d: DistortDraws):
    """OneOf {optical, grid, elastic} distortion with per-group fields; each
    image applies its group's field where ``do``."""
    sx, sy = _distort_coords(d, x.shape[1], x.shape[2])
    return _grid_sample_grouped(x, m, sx, sy, do)


def _warp_family(prio, x, m, do, warp_fn, budget: int):
    """One warp family on its own compacted subset: gather at most
    ``budget`` of the ``do`` images, warp the subset, write it back.
    Over-budget images skip their warp (P ~ 1e-3 at the 3-sigma budget)."""
    n = x.shape[0]
    if budget >= n or prio is None:
        return warp_fn(x, m, do)
    idx = _compact_select(prio, do, budget)
    xs = x.index_select(0, idx)
    ms = m.index_select(0, idx) if m is not None else None
    xs, ms = warp_fn(xs, ms, do.index_select(0, idx))
    x = x.index_copy(0, idx, xs)
    if m is not None:
        m = m.index_copy(0, idx, ms)
    return x, m


def _warp_stage(x, m, draws: WarpDraws, cfg: AugmentConfig):
    """SSR + distortion warps, each on its own compacted image subset (the
    subset of each family is gathered, warped and written back)."""
    n = x.shape[0]
    if cfg.p_ssr > 0:
        d = draws.ssr
        x, m = _warp_family(d.prio, x, m, d.do,
                            lambda xs, ms, do: _ssr_warp_grouped(xs, ms, do, d),
                            _subset_budget(n, cfg.p_ssr))
    if cfg.p_distort > 0:
        d = draws.distort
        x, m = _warp_family(d.prio, x, m, d.do,
                            lambda xs, ms, do: _distort_warp_grouped(xs, ms, do, d),
                            _subset_budget(n, cfg.p_distort))
    return x, m


def _pad_hw(x, pads, mode: str):
    """Pad an NHWC batch's height and width: ``pads`` is F.pad's
    (left, right, top, bottom); ``"replicate"`` is numpy's ``"edge"``,
    ``"reflect"`` is reflect-101 in both libraries."""
    return F.pad(x.permute(0, 3, 1, 2), pads, mode=mode).permute(0, 2, 3, 1)


def _box_blur(x, size: int):
    """Separable box blur (n, h, w, c): two k-term shifted sums with edge
    padding, rows first."""
    h, w = x.shape[1], x.shape[2]
    r = size // 2
    y = _pad_hw(x, (0, 0, r, r), "replicate")
    y = sum(y[:, i:i + h] for i in range(size)) / size
    y = _pad_hw(y, (r, r, 0, 0), "replicate")
    return sum(y[:, :, i:i + w] for i in range(size)) / size


def _conv3x3_per_image(x, kern):
    """Per-image 3x3 cross-correlation via 9 shifted adds; ``kern`` (B, 3, 3)
    per-image kernels applied to every channel (cv2.filter2D semantics,
    BORDER_REFLECT_101)."""
    h, w = x.shape[1], x.shape[2]
    y = _pad_hw(x, (1, 1, 1, 1), "reflect")
    out = torch.zeros_like(x)
    for dy in range(3):
        for dx in range(3):
            out = out + kern[:, dy, dx].view(-1, 1, 1, 1) * y[:, dy:dy + h, dx:dx + w]
    return out


def _sharpen_kernel(alpha, lightness):
    """imgaug/albumentations Sharpen kernel per image:
    ``(1 - alpha) * I + alpha * [[-1,-1,-1], [-1, 8+l, -1], [-1,-1,-1]]``."""
    n = alpha.shape[0]
    eye = torch.zeros((n, 3, 3), device=alpha.device)
    eye[:, 1, 1] = 1.0
    eff = torch.full((n, 3, 3), -1.0, device=alpha.device)
    eff[:, 1, 1] = 8.0 + lightness
    return (1.0 - alpha)[:, None, None] * eye + alpha[:, None, None] * eff


def _emboss_kernel(alpha, strength):
    """imgaug/albumentations Emboss kernel per image:
    ``(1 - alpha) * I + alpha * [[-1-s, -s, 0], [-s, 1, s], [0, s, 1+s]]``."""
    n = alpha.shape[0]
    eye = torch.zeros((n, 3, 3), device=alpha.device)
    eye[:, 1, 1] = 1.0
    s = strength
    z = torch.zeros_like(s)
    eff = torch.stack([
        torch.stack([-1.0 - s, -s, z], dim=-1),
        torch.stack([-s, torch.ones_like(s), s], dim=-1),
        torch.stack([z, s, 1.0 + s], dim=-1),
    ], dim=1)
    return (1.0 - alpha)[:, None, None] * eye + alpha[:, None, None] * eff


def _sort2(a, b):
    return torch.minimum(a, b), torch.maximum(a, b)


def _median3(x):
    """Exact 3x3 median filter via the 19-exchange sorting network; edge
    replicate border (cv2.medianBlur semantics)."""
    h, w = x.shape[1], x.shape[2]
    y = _pad_hw(x, (1, 1, 1, 1), "replicate")
    p = [y[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]
    for i, j in ((1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2), (4, 5), (7, 8),
                 (0, 3), (5, 8), (4, 7), (3, 6), (1, 4), (2, 5), (4, 7), (4, 2), (6, 4),
                 (4, 2)):
        p[i], p[j] = _sort2(p[i], p[j])
    return p[4]


def _median_blur(x, size: int):
    """Median blur: exact 3x3; 5x5 as the iterated 3x3, as in the JAX
    function."""
    y = _median3(x)
    if size >= 5:
        y = _median3(y)
    return y


def _motion_blur(x, size: int, direction):
    """Directional blur of length ``size`` along a per-image direction in
    {0, 45, 90, 135} degrees (integer-pixel rays, reflect-101 border);
    ``direction`` (B,) int in [0, 4)."""
    h, w = x.shape[1], x.shape[2]
    r = size // 2
    y = _pad_hw(x, (r, r, r, r), "reflect")
    sums = []
    for ddy, ddx in ((0, 1), (1, 1), (1, 0), (1, -1)):
        acc = 0.0
        for i in range(size):
            o = i - r
            dy, dx = r + o * ddy, r + o * ddx
            acc = acc + y[:, dy:dy + h, dx:dx + w]
        sums.append(acc / size)
    d = direction.view(-1, 1, 1, 1)
    return torch.where(d == 0, sums[0],
                       torch.where(d == 1, sums[1], torch.where(d == 2, sums[2], sums[3])))


def _srgb_to_linear(c):
    return torch.where(c > 0.04045, torch.pow((c + 0.055) / 1.055, 2.4), c / 12.92)


def _linear_to_srgb(c):
    return torch.where(c > 0.0031308,
                       1.055 * torch.pow(torch.clamp_min(c, 1e-12), 1.0 / 2.4) - 0.055,
                       12.92 * c)


def _rgb_to_lab(rgb):
    """sRGB [0,1] -> CIE LAB (D65), cv2 semantics (L in [0,100]).  The cube
    root is ``pow(t, 1/3)`` on its branch (t > 0.008856)."""
    c = _srgb_to_linear(torch.clamp(rgb, 0.0, 1.0))
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    x = (0.412453 * r + 0.357580 * g + 0.180423 * b) / 0.950456
    y = 0.212671 * r + 0.715160 * g + 0.072169 * b
    z = (0.019334 * r + 0.119193 * g + 0.950227 * b) / 1.088754

    def f(t):
        return torch.where(t > 0.008856, torch.pow(torch.clamp_min(t, 0.008856), 1.0 / 3.0),
                           7.787 * t + 16.0 / 116.0)

    fx, fy, fz = f(x), f(y), f(z)
    return 116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)


def _lab_to_rgb(L, a, b):
    fy = (L + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0

    def finv(t):
        return torch.where(t > 0.206897, t * t * t, (t - 16.0 / 116.0) / 7.787)

    x = finv(fx) * 0.950456
    y = finv(fy)
    z = finv(fz) * 1.088754
    r = 3.240479 * x - 1.537150 * y - 0.498535 * z
    g = -0.969256 * x + 1.875992 * y + 0.041556 * z
    bl = 0.055648 * x - 0.204043 * y + 1.057311 * z
    return torch.clamp(_linear_to_srgb(torch.stack([r, g, bl], dim=-1)), 0.0, 1.0)


def _rgb_to_hsv(rgb):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.amax(rgb, dim=-1)
    minc = torch.amin(rgb, dim=-1)
    v = maxc
    delta = maxc - minc
    zero = torch.zeros_like(maxc)
    s = torch.where(maxc > 0, delta / torch.clamp_min(maxc, 1e-12), zero)
    safe = torch.clamp_min(delta, 1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta == 0, zero, (h / 6.0) % 1.0)
    return torch.stack([h, s, v], dim=-1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.to(torch.int32) % 6

    def select(*vals):                      # jnp.select over i == 0 .. 5
        out = vals[5]
        for k in (4, 3, 2, 1, 0):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


def _clahe_lut(l_u8, clip, tiles: int):
    """Per-tile clipped-equalization LUTs.

    ``l_u8``: (N, H, W) integers in [0, 255]; ``clip``: (N,) float32 clip
    limits (cv2 clipLimit).  Returns (N, tiles*tiles, 256) float32 LUTs
    (integer values).  The histogram is an integer ``scatter_add_``.
    """
    n, h, w = l_u8.shape
    th, tw = h // tiles, w // tiles
    area = th * tw
    tiled = l_u8.reshape(n, tiles, th, tiles, tw).permute(0, 1, 3, 2, 4)
    tiled = tiled.reshape(n, tiles * tiles, area).to(torch.int64)
    hist = torch.zeros((n, tiles * tiles, 256), dtype=torch.int32, device=l_u8.device)
    hist.scatter_add_(2, tiled, torch.ones_like(tiled, dtype=torch.int32))
    hist = hist.float()                                      # exact: <= 2^24
    limit = torch.clamp_min(torch.floor(clip * area / 256.0), 1.0)[:, None, None]
    clipped = torch.minimum(hist, limit)
    excess = torch.sum(hist - clipped, dim=-1, keepdim=True)
    # cv2's integer redistribution: floor(excess/256) to every bin, then the
    # residual dropped one per bin at stride max(256 // residual, 1) from bin 0
    batch = torch.floor(excess / 256.0)
    residual = excess - batch * 256.0
    step = torch.clamp_min(torch.floor(256.0 / torch.clamp_min(residual, 1.0)), 1.0)
    bins = torch.arange(256, dtype=torch.float32, device=l_u8.device)
    gets_one = ((torch.remainder(bins, step) == 0)
                & (torch.floor(bins / step) < residual)).float()
    redist = clipped + batch + gets_one
    cdf = torch.cumsum(redist, dim=-1)
    return torch.round(cdf * (255.0 / area))


def _clahe_blend_tables(h: int, w: int, tiles: int, device):
    """Per pixel: the four corner tiles of the cv2 bilinear blend (clamped at
    the borders) as (h, w, 4) int64, and their weights (h, w, 4) float32.
    cv2 uses the raw pixel coordinate (``y / th - 0.5``), so with the
    half-tile shift ``p = y + th // 2`` the fraction is ``(p % th) / th``.
    Built on the device from ``arange`` (no copy from the host)."""
    def axis(size, t):
        p = torch.arange(size, device=device) + t // 2
        cell = torch.div(p, t, rounding_mode="floor")
        frac = torch.remainder(p, t).to(torch.float64) / t
        return (cell - 1).clamp(0, tiles - 1), cell.clamp(0, tiles - 1), frac

    y0, y1, wy = axis(h, h // tiles)
    x0, x1, wx = axis(w, w // tiles)
    idx = torch.stack([y0[:, None] * tiles + x0[None], y0[:, None] * tiles + x1[None],
                       y1[:, None] * tiles + x0[None], y1[:, None] * tiles + x1[None]], dim=-1)
    # float64 outer products rounded once to float32, as the JAX function's
    # numpy weights
    wgt = torch.stack([torch.outer(1 - wy, 1 - wx), torch.outer(1 - wy, wx),
                       torch.outer(wy, 1 - wx), torch.outer(wy, wx)], dim=-1)
    return idx, wgt.float()


def _clahe_apply(l_u8, lut, tiles: int):
    """Bilinear 4-tile LUT blend -> new L values (float32, [0, 255]): each
    pixel gathers its value's entry from its four corner tiles' LUTs
    (exact: integers <= 255) and sums them with static weights."""
    n, h, w = l_u8.shape
    idx, wgt = _clahe_blend_tables(h, w, tiles, l_u8.device)
    flat = (idx[None] * 256 + l_u8.to(torch.int64)[..., None]).reshape(n, -1)
    vals = torch.gather(lut.reshape(n, -1), 1, flat).reshape(n, h, w, 4)
    prod = vals * wgt
    return ((prod[..., 0] + prod[..., 1]) + prod[..., 2]) + prod[..., 3]


def _clahe_impl(x, clip, tiles: int):
    L, a, b = _rgb_to_lab(x)
    l_u8 = torch.clamp(torch.round(L * (255.0 / 100.0)), 0, 255).to(torch.int32)
    lut = _clahe_lut(l_u8, clip, tiles)
    newl = _clahe_apply(l_u8, lut, tiles)
    return _lab_to_rgb(newl * (100.0 / 255.0), a, b)


def _clahe_rgb(x, clip, tiles: int = 8):
    """CLAHE on the LAB L channel of an RGB [0,1] float32 batch (cv2
    semantics).  The JAX function scans over chunks of 8 images to bound
    its one-hot tensors; here the histogram and the blend take
    O(N * (H * W + tiles^2 * 256)) memory, so the batch goes at once."""
    return _clahe_impl(x, clip, tiles)


def _clahe_ok(h: int, w: int, tiles: int) -> bool:
    """CLAHE needs tile-divisible dims and even tiles (half-tile cells)."""
    return (tiles > 0 and h % tiles == 0 and w % tiles == 0
            and (h // tiles) % 2 == 0 and (w // tiles) % 2 == 0)


def _gate(d):
    return d.view(-1, 1, 1, 1)


def _par(a, dt):
    return a.to(dt).view(-1, 1, 1, 1)


def _use_clahe(cfg: AugmentConfig, h: int, w: int) -> bool:
    return cfg.clahe_clip > 1.0 and _clahe_ok(h, w, cfg.clahe_tiles)


def _se_range(use_clahe: bool):
    """[lo, hi) of the OneOf uniform that picks sharpen/emboss."""
    return (0.25, 0.75) if use_clahe else (0.0, 2.0 / 3.0)


def _noise_stage(x, d: NoiseDraws, cfg: AugmentConfig):
    """Gaussian noise on the compacted noise subset; std per subset slot."""
    def noise_fn(sub):
        return torch.clamp(sub + d.noise * _par(d.std, x.dtype), 0.0, 1.0)

    out, _ = _compact_apply(d.prio, x, d.do, _subset_budget(x.shape[0], cfg.p_noise), noise_fn)
    return out


def _blur_stage(x, d: BlurDraws, cfg: AugmentConfig):
    """OneOf {motion, median, box} with the reference's member weights, all
    three members computed on the compacted blur subset only."""
    n = x.shape[0]
    w0, w1, _ = cfg.blur_weights
    size = cfg.blur_size

    def blur(sub, uw, direction):
        uw = _gate(uw)
        return torch.where(uw < w0, _motion_blur(sub, size, direction),
                           torch.where(uw < w0 + w1, _median_blur(sub, size),
                                       _box_blur(sub, size)))

    budget = _subset_budget(n, cfg.p_blur)
    if budget >= n or d.prio is None:
        return torch.where(_gate(d.do), blur(x, d.choice, d.direction), x)
    # the OneOf choice and the direction follow the gathered images
    idx = _compact_select(d.prio, d.do, budget)
    sub = x.index_select(0, idx)
    blurred = blur(sub, d.choice.index_select(0, idx), d.direction.index_select(0, idx))
    served = _gate(d.do.index_select(0, idx))
    return x.index_copy(0, idx, torch.where(served, blurred, sub))


def _color_stage(x, d: ColorDraws, cfg: AugmentConfig):
    """OneOf {CLAHE, sharpen, emboss, brightness/contrast}, uniform member
    weights; without CLAHE its slot goes to the other three.  CLAHE and the
    two per-image 3x3 convolutions run on compacted subsets of the images
    that draw them, brightness/contrast on the whole batch."""
    n, h, w = x.shape[0], x.shape[1], x.shape[2]
    dt = x.dtype
    uw = d.choice
    bc = torch.clamp((x - 0.5) * _par(d.contrast, dt) + 0.5 + _par(d.brightness, dt), 0.0, 1.0)
    use_clahe = _use_clahe(cfg, h, w)
    se_lo, se_hi = _se_range(use_clahe)
    se_mid = (se_lo + se_hi) / 2.0
    want_se = d.do & (uw >= se_lo) & (uw < se_hi)

    def se_members(sub):
        sharp = torch.clamp(_conv3x3_per_image(
            sub, _sharpen_kernel(d.sharpen_alpha, d.sharpen_lightness).to(dt)), 0.0, 1.0)
        emb = torch.clamp(_conv3x3_per_image(
            sub, _emboss_kernel(d.emboss_alpha, d.emboss_strength).to(dt)), 0.0, 1.0)
        return sharp, emb

    budget_se = _subset_budget(n, cfg.p_color * (se_hi - se_lo))
    if budget_se >= n or d.se_prio is None:
        sharp, emb = se_members(x)
        se = torch.where(_gate(uw < se_mid), sharp, emb)
    else:
        idx = _compact_select(d.se_prio, want_se, budget_se)
        sub = x.index_select(0, idx)
        sharp_s, emb_s = se_members(sub)
        se_sub = torch.where(_gate(uw.index_select(0, idx) < se_mid), sharp_s, emb_s)
        se = x.index_copy(0, idx, torch.where(_gate(want_se.index_select(0, idx)), se_sub, sub))

    if use_clahe:
        def clahe_fn(sub):
            return _clahe_rgb(torch.clamp(sub, 0.0, 1.0).float(), d.clahe_clip,
                              cfg.clahe_tiles).to(dt)

        cl, _ = _compact_apply(d.clahe_prio, x, d.do & (uw < 0.25),
                               _subset_budget(n, cfg.p_color * 0.25), clahe_fn)
        chosen = torch.where(_gate(uw < 0.25), cl, torch.where(_gate(uw < 0.75), se, bc))
    else:
        chosen = torch.where(_gate(uw < 2.0 / 3.0), se, bc)
    return torch.where(_gate(d.do), chosen, x)


def _hsv_stage(x, d: HSVDraws, cfg: AugmentConfig):
    """Hue / saturation / value shifts on the compacted HSV subset, shifts
    per subset slot."""
    dt = x.dtype

    def hsv_fn(sub):
        hsv = _rgb_to_hsv(torch.clamp(sub, 0.0, 1.0))
        p3 = lambda a: a.to(dt).view(-1, 1, 1)
        hsv = torch.stack([
            (hsv[..., 0] + p3(d.hue)) % 1.0,
            torch.clamp(hsv[..., 1] + p3(d.sat), 0.0, 1.0),
            torch.clamp(hsv[..., 2] + p3(d.val), 0.0, 1.0),
        ], dim=-1)
        return _hsv_to_rgb(hsv).to(dt)

    out, _ = _compact_apply(d.prio, x, d.do, _subset_budget(x.shape[0], cfg.p_hsv), hsv_fn)
    return out


def _photometric_batch(x, draws: PhotometricDraws, cfg: AugmentConfig):
    """All photometric stages in the JAX function's order (noise, blur,
    colour, HSV), each per-image gated; masks are untouched.  Runs in
    ``x.dtype``; per-image parameters are cast to it."""
    if cfg.p_noise > 0:
        x = _noise_stage(x, draws.noise, cfg)
    if cfg.p_blur > 0:
        x = _blur_stage(x, draws.blur, cfg)
    if cfg.p_color > 0:
        x = _color_stage(x, draws.color, cfg)
    if cfg.p_hsv > 0:
        x = _hsv_stage(x, draws.hsv, cfg)
    return x


def _slots(n: int, p: float) -> int:
    """Images a compacted stage works on: its budget, or the whole batch."""
    return min(_subset_budget(n, p), n)


def sample_warp_params(generator: torch.Generator, shape, cfg: AugmentConfig,
                       has_masks: bool) -> WarpDraws:
    """Warp draws for a batch of ``shape`` (B, H, W, C), on the generator's
    device.  Order: SSR gate, priorities (if compacted), shift, scale,
    angle; distortion gate, priorities, OneOf member, optical k2, grid
    control points, elastic field.  The group count follows the JAX
    function (``_warp_kg`` of the sub-batch; a mask rides as a 4th channel
    there)."""
    n, h = shape[0], shape[1]
    dev = generator.device
    che = 4 if has_masks else 3
    u = lambda *s: torch.rand(s, generator=generator, device=dev)
    uni = lambda s, lo, hi: u(*s) * (hi - lo) + lo

    def gate_prio(p):
        do = u(n) < p
        return do, (u(n) if _subset_budget(n, p) < n else None)

    ssr = distort = None
    if cfg.p_ssr > 0:
        do, prio = gate_prio(cfg.p_ssr)
        kg = _warp_kg(_slots(n, cfg.p_ssr), che, cfg.warp_groups)
        shift = uni((kg, 2), -cfg.shift_limit, cfg.shift_limit)
        scale = 1.0 + uni((kg,), -cfg.scale_limit, cfg.scale_limit)
        angle = torch.deg2rad(uni((kg,), -cfg.rotate_limit, cfg.rotate_limit))
        ssr = SSRDraws(do, prio, shift, scale, angle)
    if cfg.p_distort > 0:
        do, prio = gate_prio(cfg.p_distort)
        kg = _warp_kg(_slots(n, cfg.p_distort), che, cfg.warp_groups)
        dw0, dw1, _ = cfg.distort_weights
        uw = u(kg)
        which = torch.where(uw < dw0, 0, torch.where(uw < dw0 + dw1, 1, 2))
        k2 = uni((kg,), -cfg.optical_limit, cfg.optical_limit)
        gsz = cfg.grid_steps + 1
        cell = max(h // cfg.grid_steps, 1)
        grid = uni((kg, gsz, gsz, 2), -cfg.grid_limit, cfg.grid_limit) * cell
        esz = max(h // max(cfg.elastic_sigma // 8, 1), 2)
        elastic = uni((kg, esz, esz, 2), -1.0, 1.0) * (cfg.elastic_alpha * h / 100.0)
        distort = DistortDraws(do, prio, which, k2, grid, elastic)
    return WarpDraws(ssr, distort)


def sample_photometric_params(generator: torch.Generator, shape,
                              cfg: AugmentConfig) -> PhotometricDraws:
    """Photometric draws for a batch of ``shape`` (B, H, W, C), on the
    generator's device.  Order: noise (gate, priorities, std, normal noise
    in the compute dtype), blur (gate, OneOf, direction, priorities),
    colour (gate, OneOf, brightness, contrast, sharpen/emboss priorities
    and their four parameters, CLAHE priorities and clip), HSV (gate,
    priorities, hue, saturation, value).  Priorities are drawn only where
    the stage compacts; subset-slot parameters at the subset's size."""
    n, h, w = shape[0], shape[1], shape[2]
    dev = generator.device
    u = lambda *s: torch.rand(s, generator=generator, device=dev)
    uni = lambda s, lo, hi: u(*s) * (hi - lo) + lo
    prio = lambda p: u(n) if _subset_budget(n, p) < n else None

    noise = blur = color = hsv = None
    if cfg.p_noise > 0:
        do, pr = u(n) < cfg.p_noise, prio(cfg.p_noise)
        m = _slots(n, cfg.p_noise)
        std = uni((m,), *cfg.noise_std)
        normal = torch.randn((m, *shape[1:]), generator=generator, device=dev,
                             dtype=_DTYPES[cfg.compute_dtype])
        noise = NoiseDraws(do, pr, std, normal)
    if cfg.p_blur > 0:
        do, choice = u(n) < cfg.p_blur, u(n)
        direction = torch.randint(0, 4, (n,), generator=generator, device=dev)
        blur = BlurDraws(do, prio(cfg.p_blur), choice, direction)
    if cfg.p_color > 0:
        do, choice = u(n) < cfg.p_color, u(n)
        brightness = uni((n,), -cfg.brightness_limit, cfg.brightness_limit)
        contrast = 1.0 + uni((n,), -cfg.contrast_limit, cfg.contrast_limit)
        use_clahe = _use_clahe(cfg, h, w)
        se_lo, se_hi = _se_range(use_clahe)
        p_se = cfg.p_color * (se_hi - se_lo)
        se_prio, m = prio(p_se), _slots(n, p_se)
        se = [uni((m,), *r) for r in (cfg.sharpen_alpha, cfg.sharpen_lightness,
                                      cfg.emboss_alpha, cfg.emboss_strength)]
        clahe_prio = clahe_clip = None
        if use_clahe:
            p_cl = cfg.p_color * 0.25
            clahe_prio = prio(p_cl)
            clahe_clip = uni((_slots(n, p_cl),), 1.0, cfg.clahe_clip)
        color = ColorDraws(do, choice, brightness, contrast, se_prio, *se, clahe_prio,
                           clahe_clip)
    if cfg.p_hsv > 0:
        do, pr = u(n) < cfg.p_hsv, prio(cfg.p_hsv)
        m = _slots(n, cfg.p_hsv)
        hsv = HSVDraws(do, pr, uni((m,), -cfg.hue_shift, cfg.hue_shift),
                       uni((m,), -cfg.sat_shift, cfg.sat_shift),
                       uni((m,), -cfg.val_shift, cfg.val_shift))
    return PhotometricDraws(noise, blur, color, hsv)


def sample_params(generator: torch.Generator, shape, cfg: AugmentConfig,
                  has_masks: bool) -> AugmentDraws:
    """Warp draws, then photometric draws (the order ``augment_batch`` uses
    after its dihedral draws)."""
    return AugmentDraws(sample_warp_params(generator, shape, cfg, has_masks),
                        sample_photometric_params(generator, shape, cfg))



# the reference's weak (training) pipeline; its compute_dtype only sets the
# dtype in which the noise is drawn, as the program draws it
WEAK = AugmentConfig(compute_dtype="bfloat16")


def apply_dihedral(x, m, a, b, c):
    """Transpose, then reverse the width, then the height, gated per image."""
    ga, gb, gc = (g.view(-1, 1, 1, 1) for g in (a, b, c))
    x = torch.where(ga, x.transpose(1, 2), x)
    x = torch.where(gb, x.flip(2), x)
    x = torch.where(gc, x.flip(1), x)
    ga, gb, gc = (g.view(-1, 1, 1) for g in (a, b, c))
    m = torch.where(ga, m.transpose(1, 2), m)
    m = torch.where(gb, m.flip(2), m)
    m = torch.where(gc, m.flip(1), m)
    return x, m


def normalize(x):
    """float32 [0, 1] NHWC -> ImageNet-normalized float32."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def dequantize(images):
    """uint8 -> float32 ``x / 255`` as one division by a tensor."""
    return images.float() / torch.full((), 255.0, device=images.device)


def augment(generator: torch.Generator, images, masks, cfg: AugmentConfig = WEAK):
    """The weak pipeline on a uint8 (B, S, S, 3) batch and its masks, in
    float32; draws in the program's order: dihedral, warps, photometric."""
    n = images.shape[0]
    abc = _sample_dihedral(generator, n, cfg)
    x, m = apply_dihedral(dequantize(images), masks.to(torch.int32), *abc)
    params = sample_params(generator, tuple(images.shape), cfg, True)
    x, m = _warp_stage(x, m, params.warp, cfg)
    x = _photometric_batch(x, params.photometric, cfg)
    return normalize(x), m
