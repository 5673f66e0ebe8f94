"""The port's augmentation stages and ``augment_batch`` against the JAX
package (CPU), and the port's own draws in distribution.

The JAX functions run jitted on a key; the port is handed the draws that
key gives (``tests/torch_augment_draws.py`` repeats the JAX function's
``jax.random`` calls), so stage by stage and whole the two compute the same
thing.  Sizes: 6 images (no compaction: budgets are the whole batch at
B <= 8) and 12 or 24 images (B > 8: a stage gathers its subset where its
budget is below the batch), 32-64
px tiles that ``clahe_tiles`` = 8 divides into even tiles.

Tolerances, and why:
- float32 images: 1e-4 absolute (stages composed: one-ulp ``cos`` / ``pow``
  differences carried through blurs and the sharpen kernel's gain of ~10);
- bfloat16 images: both libraries round every operation to bfloat16, so
  nearly every value is equal; a pixel whose float32 warp coordinate is an
  ulp apart can round to the neighbouring bfloat16 (2^-8), and the later
  3x3 filters spread and scale that (sharpen: up to ~10x, so 2^-4), at
  most 1% of the values may differ at all;
- masks: exact, apart from pixels that are a nearest-neighbour tie (within
  1e-4 px of 0.5 or a whole number) in some warp group's coordinates;
- a CLAHE'd image: the same, given that ``round(L * 255 / 100)`` agrees (it
  did for every image here; see ``tests/test_torch_augment_functions.py``
  for the tie rule).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_adversarial import few_torch_threads  # noqa: F401  (autouse)
from tests.torch_augment_draws import (
    augment_draws,
    near_tie,
    photometric_draws,
    ssr_draws,
    to_numpy,
    to_torch,
    warp_draws,
)
from uda_aerial_semantic_segmentation_research_tpu.ops import augment as J
from uda_aerial_semantic_segmentation_research_tpu_torch.ops import augment as P

F32_TOL = 1e-4
BF16_TOL = 2.0 ** -4
BF16_SHARE = 0.01
TIE = 1e-4


def _cfgs(name, dtype, **overrides):
    return (dataclasses.replace(getattr(J, name), compute_dtype=dtype, **overrides),
            dataclasses.replace(getattr(P, name), compute_dtype=dtype, **overrides))


def _data(n, size, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, size, size, 3)).astype(np.float32),
            rng.integers(0, 23, (n, size, size)).astype(np.int32))


def _assert_images_close(got, ref, dtype):
    got, ref = to_numpy(got), to_numpy(ref)
    assert got.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=F32_TOL)
    else:
        diff = np.abs(got - ref)
        assert diff.max() <= BF16_TOL, diff.max()
        # 1e-6: float32 rounding of the normalize and its inverse
        assert (diff > 1e-6).mean() <= BF16_SHARE, (diff > 1e-6).mean()


def _tie_map(warp, h, w):
    """(h, w): pixels that are a nearest-neighbour tie in some group's
    coordinates of either warp family."""
    ties = np.zeros((h, w), bool)
    for d, coords in ((warp.ssr, P._ssr_coords), (warp.distort, P._distort_coords)):
        if d is None:
            continue
        for s in coords(d, h, w):
            ties |= near_tie(s.numpy(), TIE).any(0)
    return ties


def _assert_masks_match(got, ref, warp):
    got, ref = np.asarray(got), np.asarray(ref)
    off = (got != ref).any(0)
    assert not (off & ~_tie_map(warp, *got.shape[1:])).any(), off.sum()


# ---------------------------------------------------------------------------
# the warp stage
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [6, 12])
@pytest.mark.parametrize("name", ["WEAK", "STRONG"])
def test_warp_stage_matches_jax(name, n, dtype):
    jcfg, pcfg = _cfgs(name, dtype)
    x, m = _data(n, 64, seed=n)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    key = jax.random.key(n + 1)
    ref_x, ref_m = jax.jit(lambda k, a, b: J._warp_stage(k, a, b, jcfg))(
        key, jx, jnp.asarray(m))
    draws = warp_draws(key, x.shape, jcfg, has_masks=True)
    assert (draws.ssr.prio is None) == (P._subset_budget(n, pcfg.p_ssr) >= n)
    got_x, got_m = P._warp_stage(to_torch(jx), torch.from_numpy(m), draws, pcfg)
    _assert_images_close(got_x, ref_x, dtype)
    _assert_masks_match(got_m, ref_m, draws)
    warped = (draws.ssr.do | draws.distort.do).numpy()
    assert warped.any() and ((got_m.numpy() != m).any((1, 2)) <= warped).all()


@pytest.mark.parametrize("n", [6, 12])
def test_warp_stage_without_masks_matches_jax(n):
    """No masks: the JAX function's group count sees 3 channels, not 4."""
    jcfg, pcfg = _cfgs("STRONG", "float32")
    x, _ = _data(n, 32, seed=3)
    key = jax.random.key(20 + n)
    ref_x, ref_m = J._warp_stage(key, jnp.asarray(x), None, jcfg)
    got_x, got_m = P._warp_stage(torch.from_numpy(x), None,
                                 warp_draws(key, x.shape, jcfg, has_masks=False), pcfg)
    assert ref_m is None and got_m is None
    _assert_images_close(got_x, ref_x, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_warp_family_over_budget_matches_jax(dtype):
    """More images want the warp than the budget holds: the lowest
    priorities are warped, the rest skip it, in both packages."""
    jcfg, _ = _cfgs("STRONG", dtype, warp_groups=2)
    n, budget = 12, 4
    x, m = _data(n, 32, seed=4)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    k_prio, k_ssr = jax.random.split(jax.random.key(9))
    do = np.ones(n, bool)
    ref_x, ref_m = J._warp_family(
        k_prio, jx, jnp.asarray(m), jnp.asarray(do),
        lambda xs, ms, d: J._ssr_warp_grouped(k_ssr, xs, ms, d, jcfg), budget)
    d = ssr_draws(k_ssr, budget, 4, jcfg, None, None)
    prio = to_torch(jax.random.uniform(k_prio, (n,)))
    got_x, got_m = P._warp_family(prio, to_torch(jx), torch.from_numpy(m), torch.from_numpy(do),
                                  lambda xs, ms, g: P._ssr_warp_grouped(xs, ms, g, d), budget)
    _assert_images_close(got_x, ref_x, dtype)
    _assert_masks_match(got_m, ref_m, P.WarpDraws(d, None))
    changed = (got_m.numpy() != m).any((1, 2))
    assert changed.sum() == budget                      # the rest skipped the warp
    np.testing.assert_array_equal(np.sort(np.flatnonzero(changed)),
                                  np.sort(np.argsort(prio.numpy(), kind="stable")[:budget]))


# ---------------------------------------------------------------------------
# the photometric stages
# ---------------------------------------------------------------------------
def _photometric_case(jcfg, pcfg, n, size, dtype, seed):
    x, _ = _data(n, size, seed=seed)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    key = jax.random.key(100 + seed)
    ref = jax.jit(lambda k, a: J._photometric_batch(k, a, jcfg))(key, jx)
    draws = photometric_draws(key, x.shape, jnp.dtype(dtype), jcfg)
    got = P._photometric_batch(to_torch(jx), draws, pcfg)
    assert got.dtype == to_torch(jx).dtype
    _assert_images_close(got, ref, dtype)
    return draws, to_numpy(got), to_numpy(jx)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [6, 12])
@pytest.mark.parametrize("name", ["WEAK", "STRONG"])
def test_photometric_batch_matches_jax(name, n, dtype):
    jcfg, pcfg = _cfgs(name, dtype)
    draws, got, x = _photometric_case(jcfg, pcfg, n, 64, dtype, seed=n)
    assert (draws.noise.prio is None) == (P._subset_budget(n, pcfg.p_noise) >= n)
    # an image no stage selected is returned as it came
    hit = sum(d.do.numpy() for d in draws).astype(bool)
    np.testing.assert_array_equal(got[~hit], x[~hit])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [12, 24])
def test_photometric_members_all_fire_and_match_jax(n, dtype):
    """Every stage at probability 1 (n=12: only CLAHE's subset is smaller
    than the batch) or 0.5 (n=24: every stage compacts): the draws reach
    every OneOf member (CLAHE, sharpen, emboss, brightness/contrast;
    motion, median, box)."""
    p = 1.0 if n == 12 else 0.5
    jcfg, pcfg = _cfgs("STRONG", dtype, p_noise=p, p_blur=p, p_color=p, p_hsv=p)
    draws, _, _ = _photometric_case(jcfg, pcfg, n, 32, dtype, seed=7)
    color, blur = draws.color, draws.blur
    picked = color.choice[color.do].numpy()
    assert all(((picked >= lo) & (picked < lo + 0.25)).any() for lo in (0, 0.25, 0.5, 0.75))
    picked = blur.choice[blur.do].numpy()
    assert all(((picked >= lo) & (picked < hi)).any() for lo, hi in ((0, 0.4), (0.4, 0.7),
                                                                     (0.7, 1.0)))
    assert (color.clahe_prio is None) == (P._subset_budget(n, 0.25 * p) >= n)
    assert (draws.noise.prio is None) == (n == 12)


def test_photometric_batch_without_clahe_matches_jax():
    """CLAHE off (clip <= 1, or tiles that do not divide): its OneOf slot
    goes to sharpen / emboss / brightness-contrast in both packages."""
    for overrides in ({"clahe_clip": 1.0}, {"clahe_tiles": 5}):
        jcfg, pcfg = _cfgs("STRONG", "float32", p_color=1.0, **overrides)
        draws, _, _ = _photometric_case(jcfg, pcfg, 6, 32, "float32", seed=8)
        assert draws.color.clahe_clip is None


# ---------------------------------------------------------------------------
# augment_batch as a whole
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_masks", [True, False])
@pytest.mark.parametrize("kind", ["uint8", "float32"])
@pytest.mark.parametrize("name", ["WEAK", "STRONG", "NONE"])
def test_augment_batch_matches_jax(name, kind, with_masks):
    n, size = 12, 32
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    if kind == "float32":
        images = images.astype(np.float32) / 255.0
    masks = rng.integers(0, 23, (n, size, size)).astype(np.uint8) if with_masks else None
    jcfg, pcfg = getattr(J, name), getattr(P, name)
    key = jax.random.key(42)
    ref_x, ref_m = J.augment_batch(key, jnp.asarray(images),
                                   None if masks is None else jnp.asarray(masks), cfg=jcfg)
    abc, params = augment_draws(key, images.shape, jcfg, with_masks)
    got_x, got_m = P.augment_batch(None, torch.from_numpy(images),
                                   None if masks is None else torch.from_numpy(masks),
                                   cfg=pcfg, abc=abc, params=params)
    assert got_x.dtype == torch.float32 and tuple(got_x.shape) == images.shape
    # normalized: divide the bf16 tolerance by the smallest std
    tol_dtype = pcfg.compute_dtype
    ref_raw = np.asarray(J.denormalize_images(ref_x))
    got_raw = P.denormalize_images(got_x)
    _assert_images_close(got_raw, ref_raw, tol_dtype)
    if name == "NONE":
        np.testing.assert_allclose(got_x.numpy(), np.asarray(ref_x), rtol=0, atol=1e-6)
    if with_masks:
        assert got_m.dtype == torch.int32
        _assert_masks_match(got_m, ref_m, params.warp)
    else:
        assert got_m is None and ref_m is None


@pytest.mark.parametrize("name", ["WEAK", "STRONG"])
def test_augment_batch_draws_from_the_generator_in_a_fixed_order(name):
    """The generator's draws: dihedral elements first, then
    ``sample_params``; the same seed repeats the batch, the next call
    differs."""
    cfg = getattr(P, name)
    images = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (10, 32, 32, 3),
                                                                dtype=np.uint8))
    masks = torch.zeros((10, 32, 32), dtype=torch.uint8)
    gen = torch.Generator().manual_seed(5)
    x1, m1 = P.augment_batch(gen, images, masks, cfg=cfg)
    x2, _ = P.augment_batch(gen, images, masks, cfg=cfg)
    assert not torch.equal(x1, x2)
    replay = torch.Generator().manual_seed(5)
    abc = P._sample_dihedral(replay, 10, cfg)
    params = P.sample_params(replay, tuple(images.shape), cfg, has_masks=True)
    x3, m3 = P.augment_batch(None, images, masks, cfg=cfg, abc=abc, params=params)
    assert torch.equal(x1, x3) and torch.equal(m1, m3)
    with pytest.raises(ValueError, match="generator"):
        P.augment_batch(None, images, masks, cfg=cfg, abc=abc)


# ---------------------------------------------------------------------------
# the port's own draws, in distribution
# ---------------------------------------------------------------------------
def _within_binomial(hits, n, p):
    sd = np.sqrt(n * p * (1 - p))
    assert abs(hits - n * p) <= 5 * sd + 1, (hits, n * p, sd)


@pytest.mark.parametrize("name", ["WEAK", "STRONG"])
def test_sampled_stage_hit_rates_are_binomial(name):
    """Per-stage gates and OneOf members of ``sample_params`` over 4,000
    images hit at their configured rates (5 sigma)."""
    cfg = getattr(P, name)
    n = 4000
    d = P.sample_params(torch.Generator().manual_seed(0), (n, 64, 64, 3), cfg, True)
    w, ph = d.warp, d.photometric
    for draws, p in ((w.ssr, cfg.p_ssr), (w.distort, cfg.p_distort), (ph.noise, cfg.p_noise),
                     (ph.blur, cfg.p_blur), (ph.color, cfg.p_color), (ph.hsv, cfg.p_hsv)):
        _within_binomial(int(draws.do.sum()), n, p)
    for lo, hi in ((0, 0.25), (0.25, 0.5), (0.5, 0.75), (0.75, 1.0)):
        _within_binomial(int(((ph.color.choice >= lo) & (ph.color.choice < hi)).sum()), n, 0.25)
    for k in range(4):
        _within_binomial(int((ph.blur.direction == k).sum()), n, 0.25)
    # per subset slot parameters lie in their ranges
    lo, hi = cfg.noise_std
    assert lo <= ph.noise.std.min() and ph.noise.std.max() < hi
    assert 1.0 <= ph.color.clahe_clip.min() and ph.color.clahe_clip.max() < cfg.clahe_clip
    assert ph.noise.noise.dtype == torch.bfloat16
    assert abs(float(ph.noise.noise.float().std()) - 1.0) < 0.01


def test_warp_magnitudes_are_drawn_per_group():
    """B=32 at WEAK: 16-image subsets (the budget), 4 groups of 4 images;
    a batch of one repeated image, all warped, comes out equal within a
    group and different across groups."""
    cfg = P.WEAK
    n = 32
    gen = torch.Generator().manual_seed(1)
    d = P.sample_warp_params(gen, (n, 32, 32, 3), cfg, has_masks=True)
    assert P._subset_budget(n, cfg.p_ssr) == 16
    assert d.ssr.shift.shape == (4, 2) and d.distort.which.shape == (4,)
    x = torch.from_numpy(np.random.default_rng(0).random((16, 32, 32, 3)).astype(np.float32))
    x = x[:1].expand(16, -1, -1, -1)
    out, _ = P._ssr_warp_grouped(x, None, torch.ones(16, dtype=torch.bool), d.ssr)
    groups = out.reshape(4, 4, -1)
    assert all(torch.equal(g[0], g[i]) for g in groups for i in range(4))
    assert not torch.equal(groups[0, 0], groups[1, 0])
    # large batches: the group count keeps the JAX function's lane clamp
    d = P.sample_warp_params(gen, (256, 16, 16, 3), cfg, has_masks=True)
    budget = P._subset_budget(256, cfg.p_ssr)
    assert d.ssr.shift.shape[0] == P._warp_kg(budget, 4, cfg.warp_groups) == J._warp_kg(
        budget, 4, cfg.warp_groups)


# ---------------------------------------------------------------------------
# pipeline objects
# ---------------------------------------------------------------------------
def test_pipeline_objects_run_per_item_on_the_cpu():
    image = np.random.default_rng(3).integers(0, 256, (32, 32, 3), dtype=np.uint8)
    mask = np.random.default_rng(4).integers(0, 23, (32, 32)).astype(np.uint8)
    for get, cfg in ((P.get_training_augmentation, P.WEAK),
                     (P.get_strong_augmentation, P.STRONG),
                     (P.get_validation_augmentation, P.NONE)):
        aug = get(seed=3, device="cpu")
        assert aug.cfg == cfg
        out = aug(image=image, mask=mask)
        assert out["image"].shape == (32, 32, 3) and out["image"].dtype == np.float32
        assert out["mask"].shape == (32, 32) and out["mask"].dtype == np.int32
        again = aug(image=image, mask=mask)                     # the counter moved on
        replay = get(seed=3, device="cpu")(image=image, mask=mask)
        np.testing.assert_array_equal(out["image"], replay["image"])
        if cfg is P.NONE:
            np.testing.assert_array_equal(again["image"], out["image"])
            ref = P.normalize_images(torch.from_numpy(image)[None])[0].numpy()
            np.testing.assert_array_equal(out["image"], ref)
        else:
            assert not np.array_equal(again["image"], out["image"])
        assert aug(image=image)["mask"] is None
        np.testing.assert_array_equal(P.apply_augmentation(image, get(seed=3, device="cpu")),
                                      out["image"])
    with pytest.raises(ValueError, match="image"):
        P.get_training_augmentation(device="cpu")()
    batched = P.get_training_augmentation(device="cpu").batched(
        torch.Generator().manual_seed(0), torch.from_numpy(image)[None].repeat(2, 1, 1, 1))
    assert tuple(batched[0].shape) == (2, 32, 32, 3) and batched[1] is None


def test_per_item_call_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("the default device is present here; this checks a CPU-only host")
    with pytest.raises(RuntimeError, match="CUDA"):
        P.get_training_augmentation()(image=np.zeros((8, 8, 3), np.uint8))
