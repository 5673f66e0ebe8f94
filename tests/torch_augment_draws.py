"""The JAX augmentation's own draws, rebuilt from its key for the port.

Each function repeats the ``jax.random.split`` and ``uniform`` / ``normal``
/ ``randint`` calls of the JAX function it names, on the same key, and
returns the port's draws NamedTuple (``ops.augment``) holding the same
values.  Given those draws the port's stage functions compute what the JAX
functions compute, so the two are compared stage by stage and whole, not
only in distribution.  Shared by the port's augmentation and train step
tests, with the conversions and the tie rule they use.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from uda_aerial_semantic_segmentation_research_tpu.ops import augment as J
from uda_aerial_semantic_segmentation_research_tpu_torch.ops import augment as P


def to_torch(a):
    """A JAX array as a torch tensor of the same values (bf16 kept bf16)."""
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def to_numpy(a):
    """A JAX array or a torch tensor as a numpy array (bf16 as float32)."""
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = jnp.asarray(a)
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def near_tie(s, tie=1e-4):
    """Where a sampling coordinate (numpy) lies within ``tie`` px of a
    nearest-neighbour tie: its fraction at 0.5 or at a whole number, where a
    coordinate one float32 ulp away can pick another corner."""
    f = s - np.floor(s)
    return (np.abs(f - 0.5) < tie) | (f < tie) | (f > 1 - tie)


def _uniform(key, shape, lo=0.0, hi=1.0):
    return jax.random.uniform(key, shape, minval=lo, maxval=hi)


def _prio(key, n, p):
    """``_compact_select``'s priorities, drawn only where the stage compacts."""
    return to_torch(_uniform(key, (n,))) if J._subset_budget(n, p) < n else None


def ssr_draws(k_ssr, n_sub, che, cfg, do, prio):
    """``_ssr_warp_grouped(k_ssr, ...)`` on a sub-batch of ``n_sub`` images."""
    kg = J._warp_kg(n_sub, che, cfg.warp_groups)
    k = jax.random.split(k_ssr, 4)
    shift = _uniform(k[1], (kg, 2), -cfg.shift_limit, cfg.shift_limit)
    scale = 1.0 + _uniform(k[2], (kg,), -cfg.scale_limit, cfg.scale_limit)
    ang = jnp.deg2rad(_uniform(k[3], (kg,), -cfg.rotate_limit, cfg.rotate_limit))
    return P.SSRDraws(do, prio, to_torch(shift), to_torch(scale), to_torch(ang))


def distort_draws(k_dis, n_sub, h, che, cfg, do, prio):
    """``_distort_warp_grouped(k_dis, ...)`` on a sub-batch of ``n_sub``
    images of height ``h``."""
    kg = J._warp_kg(n_sub, che, cfg.warp_groups)
    k = jax.random.split(k_dis, 5)
    dw0, dw1, _ = cfg.distort_weights
    u_which = _uniform(k[1], (kg,))
    which = jnp.where(u_which < dw0, 0, jnp.where(u_which < dw0 + dw1, 1, 2))
    k2 = _uniform(k[2], (kg,), -cfg.optical_limit, cfg.optical_limit)
    gsz = cfg.grid_steps + 1
    cell = max(h // cfg.grid_steps, 1)
    grid = _uniform(k[3], (kg, gsz, gsz, 2), -cfg.grid_limit, cfg.grid_limit) * cell
    esz = max(h // max(cfg.elastic_sigma // 8, 1), 2)
    elastic = _uniform(k[4], (kg, esz, esz, 2), -1.0, 1.0) * (cfg.elastic_alpha * h / 100.0)
    return P.DistortDraws(do, prio, to_torch(which).long(), to_torch(k2), to_torch(grid),
                          to_torch(elastic))


def warp_draws(key, shape, cfg, has_masks):
    """``_warp_stage(key, x, m, cfg)`` on a batch of ``shape``."""
    n, h = shape[0], shape[1]
    che = 4 if has_masks else 3
    k_ssr, k_dis, k_g1, k_g2, k_p1, k_p2 = jax.random.split(key, 6)
    ssr = distort = None
    if cfg.p_ssr > 0:
        do = to_torch(_uniform(k_g1, (n,)) < cfg.p_ssr)
        n_sub = min(J._subset_budget(n, cfg.p_ssr), n)
        ssr = ssr_draws(k_ssr, n_sub, che, cfg, do, _prio(k_p1, n, cfg.p_ssr))
    if cfg.p_distort > 0:
        do = to_torch(_uniform(k_g2, (n,)) < cfg.p_distort)
        n_sub = min(J._subset_budget(n, cfg.p_distort), n)
        distort = distort_draws(k_dis, n_sub, h, che, cfg, do,
                                _prio(k_p2, n, cfg.p_distort))
    return P.WarpDraws(ssr, distort)


def photometric_draws(key, shape, dtype, cfg):
    """``_photometric_batch(key, x, cfg)`` on a batch of ``shape`` in
    ``dtype`` (a JAX dtype: the noise is drawn in it)."""
    n, h, w = shape[0], shape[1], shape[2]
    k = jax.random.split(key, 22)
    u = lambda kk: _uniform(kk, (n,))
    slots = lambda p: min(J._subset_budget(n, p), n)
    noise = blur = color = hsv = None
    if cfg.p_noise > 0:
        m = slots(cfg.p_noise)
        noise = P.NoiseDraws(
            to_torch(u(k[0]) < cfg.p_noise), _prio(k[20], n, cfg.p_noise),
            to_torch(_uniform(k[1], (m,), *cfg.noise_std)),
            to_torch(jax.random.normal(k[2], (m, *shape[1:]), dtype=dtype)))
    if cfg.p_blur > 0:
        blur = P.BlurDraws(to_torch(u(k[3]) < cfg.p_blur), _prio(k[16], n, cfg.p_blur),
                           to_torch(u(k[4])),
                           to_torch(jax.random.randint(k[5], (n,), 0, 4)).long())
    if cfg.p_color > 0:
        use_clahe = cfg.clahe_clip > 1.0 and J._clahe_ok(h, w, cfg.clahe_tiles)
        se_lo, se_hi = (0.25, 0.75) if use_clahe else (0.0, 2.0 / 3.0)
        p_se = cfg.p_color * (se_hi - se_lo)
        m_se = slots(p_se)
        se = [to_torch(_uniform(kk, (m_se,), *r)) for kk, r in (
            (k[8], cfg.sharpen_alpha), (k[9], cfg.sharpen_lightness),
            (k[10], cfg.emboss_alpha), (k[11], cfg.emboss_strength))]
        clahe_prio = clahe_clip = None
        if use_clahe:
            p_cl = cfg.p_color * 0.25
            clahe_prio = _prio(k[18], n, p_cl)
            clahe_clip = to_torch(_uniform(k[17], (slots(p_cl),), 1.0, cfg.clahe_clip))
        color = P.ColorDraws(
            to_torch(u(k[6]) < cfg.p_color), to_torch(u(k[7])),
            to_torch(_uniform(k[12], (n,), -cfg.brightness_limit, cfg.brightness_limit)),
            to_torch(1.0 + _uniform(k[13], (n,), -cfg.contrast_limit, cfg.contrast_limit)),
            _prio(k[19], n, p_se), *se, clahe_prio, clahe_clip)
    if cfg.p_hsv > 0:
        m = slots(cfg.p_hsv)
        khsv = jax.random.split(k[15], 3)
        hsv = P.HSVDraws(to_torch(u(k[14]) < cfg.p_hsv), _prio(k[21], n, cfg.p_hsv),
                         to_torch(_uniform(khsv[0], (m,), -cfg.hue_shift, cfg.hue_shift)),
                         to_torch(_uniform(khsv[1], (m,), -cfg.sat_shift, cfg.sat_shift)),
                         to_torch(_uniform(khsv[2], (m,), -cfg.val_shift, cfg.val_shift)))
    return P.PhotometricDraws(noise, blur, color, hsv)


def augment_draws(key, shape, cfg, has_masks):
    """``augment_batch(key, images, masks, cfg=cfg)``: (abc, params) for the
    port's ``augment_batch(..., abc=, params=)``."""
    n = shape[0]
    k_dih, k_ssr, k_photo = jax.random.split(key, 3)
    abc = tuple(to_torch(t) for t in J._sample_dihedral(k_dih, n, cfg))
    params = P.AugmentDraws(warp_draws(k_ssr, shape, cfg, has_masks),
                            photometric_draws(k_photo, shape, jnp.dtype(cfg.compute_dtype),
                                              cfg))
    return abc, params
