"""The port's augmentation functions against their JAX counterparts (CPU).

Each function of the port's ``ops/augment.py`` is held against the JAX
function of the same name on the same seeded numpy inputs, in float32 and
(where the pipeline runs it in the pixel dtype) in bfloat16.  Where the JAX
function draws from a key, the test rebuilds its draws from that key
(``tests/torch_augment_draws.py``) and hands them to the port.

Tolerances, and why:
- integer results (budgets, group counts, indices, reflect-101, the CLAHE
  histogram LUTs, masks, the median network, min/max): exact;
- float32 pixels: 1e-5 absolute (values in [0, 1]; the two libraries'
  ``cos`` / ``pow`` / ``exp`` differ by an ulp);
- bfloat16 pixels: both libraries round every operation to bfloat16 (XLA on
  the CPU does so too), so the results are the same except where a float32
  coordinate or transcendental one ulp apart rounds to the neighbouring
  bfloat16: one bfloat16 ulp of a value in [0, 1], 2^-8;
- warped masks: exact, apart from pixels whose sampling coordinate lies
  within 1e-4 px of a nearest-neighbour tie (``fx`` or ``fy`` at 0.5 or a
  whole number), where a one-ulp coordinate may pick the other corner;
- LAB: 1e-4 (``cbrt`` is ``pow(t, 1/3)`` in the port, one float32 ulp off
  on ~1.5% of inputs);
- CLAHE's new L channel: 1e-4 on L in [0, 255] (a sum of four products in
  another order); whole CLAHE on RGB: 1e-4, given the same ``round(L *
  255 / 100)`` levels (the test checks that the two libraries' levels
  agree, or differ by one only at a tie within 1e-3 of a half level);
- CLAHE against ``cv2.createCLAHE`` as the JAX package's own tests hold it:
  exact after rounding when clipped, within one level unclipped.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_adversarial import few_torch_threads  # noqa: F401  (autouse)
from tests.torch_augment_draws import (
    distort_draws,
    near_tie,
    ssr_draws,
    to_numpy,
    to_torch,
)
from uda_aerial_semantic_segmentation_research_tpu.ops import augment as J
from uda_aerial_semantic_segmentation_research_tpu_torch.ops import augment as P

F32_TOL = 1e-5
BF16_TOL = 2.0 ** -8
TIE = 1e-4
DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


def _pair(x, dtype):
    """The same float32 numpy values in ``dtype`` for both libraries."""
    j = jnp.asarray(x).astype(jnp.dtype(dtype))
    return j, to_torch(j)


def _images(n=6, size=32, seed=0):
    return np.random.default_rng(seed).random((n, size, size, 3)).astype(np.float32)


def _masks(n=6, size=32, seed=1):
    return np.random.default_rng(seed).integers(0, 23, (n, size, size)).astype(np.int32)


def _close(port, ref, tol):
    np.testing.assert_allclose(to_numpy(port), to_numpy(ref), rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# budgets and compaction
# ---------------------------------------------------------------------------
def test_static_budgets_and_group_counts_match_jax():
    for n in range(1, 70):
        for r in (1, 2, 3, 4, 8, 16, 128):
            assert P._n_groups(n, r) == J._n_groups(n, r)
        for p in (0.05, 0.2, 0.3 * 0.5, 0.4, 0.5, 1.0):
            assert P._subset_budget(n, p) == J._subset_budget(n, p)
    for n_sub in (1, 6, 8, 16, 32, 33, 48, 64, 96, 128):
        for che in (3, 4):
            for r in (1, 4, 8, 64, 128):
                assert P._warp_kg(n_sub, che, r) == J._warp_kg(n_sub, che, r)
    for h in (8, 16, 24, 32, 64, 512):
        for tiles in (0, 2, 4, 8):
            assert P._clahe_ok(h, h, tiles) == J._clahe_ok(h, h, tiles)


@pytest.mark.parametrize("n,budget", [(12, 4), (12, 8), (20, 12), (6, 6)])
def test_compact_select_matches_jax(n, budget):
    """The same priorities give the same indices, ties among the unselected
    images (all 2.0) broken by position as in the stable ``jnp.argsort``."""
    for seed in range(5):
        key = jax.random.key(seed)
        want = jax.random.uniform(jax.random.fold_in(key, 1), (n,)) < 0.4
        prio = jax.random.uniform(key, (n,))
        ref = J._compact_select(key, want, budget)
        got = P._compact_select(to_torch(prio), to_torch(want), budget)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,budget", [(12, 4), (6, 6)])
def test_compact_apply_matches_jax(n, budget, dtype):
    x = _images(n)
    jx, px = _pair(x, dtype)
    key = jax.random.key(7)
    want = jax.random.uniform(jax.random.key(8), (n,)) < 0.5
    fn = lambda a: a * 2 - 0.25
    ref, ref_served = J._compact_apply(key, jx, want, budget, fn)
    prio = to_torch(jax.random.uniform(key, (n,)))
    got, served = P._compact_apply(prio, px, to_torch(want), budget, fn)
    assert got.dtype == px.dtype
    np.testing.assert_array_equal(served.numpy(), np.asarray(ref_served))
    np.testing.assert_array_equal(to_numpy(got), to_numpy(ref))


# ---------------------------------------------------------------------------
# the warp sampler
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [2, 5, 16])
def test_reflect_index_matches_jax(n):
    idx = np.arange(-3 * n, 3 * n + 1, dtype=np.int32)
    ref = J._reflect_index(jnp.asarray(idx), n)
    got = P._reflect_index(torch.from_numpy(idx).long(), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_identity_grid_matches_jax():
    for ref, got in zip(J._identity_grid(5, 7), P._identity_grid(5, 7)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kg", [1, 2, 6])
def test_grid_sample_grouped_matches_jax(kg, dtype):
    """Explicit coordinates (the same float32 values on both sides, running
    past every border): images within the dtype's tolerance, masks exact."""
    n, s = 6, 24
    rng = np.random.default_rng(kg)
    x, m = _images(n, s), _masks(n, s)
    sx = rng.uniform(-s, 2 * s, (kg, s, s)).astype(np.float32)
    sy = rng.uniform(-s, 2 * s, (kg, s, s)).astype(np.float32)
    gate = np.array([True, False, True, True, False, True])
    jx, px = _pair(x, dtype)
    ref_x, ref_m = J._grid_sample_grouped(jx, jnp.asarray(m), jnp.asarray(sx), jnp.asarray(sy),
                                          jnp.asarray(gate))
    got_x, got_m = P._grid_sample_grouped(px, torch.from_numpy(m), torch.from_numpy(sx),
                                          torch.from_numpy(sy), torch.from_numpy(gate))
    assert got_x.dtype == px.dtype and got_m.dtype == torch.int32
    _close(got_x, ref_x, _tol(dtype))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
    np.testing.assert_array_equal(to_numpy(got_x)[~gate], x.astype(np.float32)[~gate]
                                  if dtype == "float32" else to_numpy(px)[~gate])
    # without masks
    ref_x, _ = J._grid_sample_grouped(jx, None, jnp.asarray(sx), jnp.asarray(sy),
                                      jnp.asarray(gate))
    got_x, none = P._grid_sample_grouped(px, None, torch.from_numpy(sx), torch.from_numpy(sy),
                                         torch.from_numpy(gate))
    assert none is None
    _close(got_x, ref_x, _tol(dtype))


def _assert_masks_match(got, ref, sx, sy):
    """Masks equal except at tie pixels of the group's coordinates."""
    kg = sx.shape[0]
    n = got.shape[0]
    ties = np.repeat(near_tie(sx, TIE) | near_tie(sy, TIE), n // kg, axis=0)
    diff = got != ref
    assert not (diff & ~ties).any(), f"{diff.sum()} mask pixels differ, {ties.sum()} ties"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [4, 6])
def test_ssr_warp_grouped_matches_jax(n, dtype):
    cfg = dataclasses.replace(J.STRONG, warp_groups=2)
    x, m = _images(n), _masks(n)
    jx, px = _pair(x, dtype)
    key = jax.random.key(3)
    do = np.arange(n) % 3 != 1
    ref_x, ref_m = J._ssr_warp_grouped(key, jx, jnp.asarray(m), jnp.asarray(do), cfg)
    d = ssr_draws(key, n, 4, cfg, torch.from_numpy(do), None)
    assert d.shift.shape == (2, 2)
    got_x, got_m = P._ssr_warp_grouped(px, torch.from_numpy(m), torch.from_numpy(do), d)
    _close(got_x, ref_x, _tol(dtype))
    sx, sy = (t.numpy() for t in P._ssr_coords(d, 32, 32))
    _assert_masks_match(got_m.numpy(), np.asarray(ref_m), sx, sy)
    assert (got_m.numpy() != m).any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("member", ["optical", "grid", "elastic", "mixed"])
def test_distort_warp_grouped_matches_jax(member, dtype):
    weights = {"optical": (1.0, 0.0, 0.0), "grid": (0.0, 1.0, 0.0),
               "elastic": (0.0, 0.0, 1.0), "mixed": (1 / 3, 1 / 3, 1 / 3)}[member]
    cfg = dataclasses.replace(J.STRONG, distort_weights=weights)
    n = 6
    x, m = _images(n), _masks(n)
    jx, px = _pair(x, dtype)
    key = jax.random.key(11)
    do = np.ones(n, bool)
    ref_x, ref_m = J._distort_warp_grouped(key, jx, jnp.asarray(m), jnp.asarray(do), cfg)
    d = distort_draws(key, n, 32, 4, cfg, torch.from_numpy(do), None)
    if member != "mixed":
        assert set(d.which.tolist()) == {("optical", "grid", "elastic").index(member)}
    else:
        assert len(set(d.which.tolist())) > 1
    got_x, got_m = P._distort_warp_grouped(px, torch.from_numpy(m), torch.from_numpy(do), d)
    _close(got_x, ref_x, _tol(dtype))
    sx, sy = (t.numpy() for t in P._distort_coords(d, 32, 32))
    _assert_masks_match(got_m.numpy(), np.asarray(ref_m), sx, sy)


@pytest.mark.parametrize("low,size", [(6, 32), (6, 64), (10, 64), (3, 17), (85, 512)])
def test_bilinear_upsampling_is_jax_image_resize(low, size):
    """``F.interpolate(bilinear, align_corners=False, antialias=False)`` on
    an NCHW view equals ``jax.image.resize(..., "bilinear")`` when
    upsampling, the edges included (both clamp the half-pixel coordinate to
    the first and last sample)."""
    field = np.random.default_rng(low).normal(size=(2, low, low, 2)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(field), (2, size, size, 2), "bilinear"))
    got = P._resize_bilinear(torch.from_numpy(field), size, size).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    # the edges: every output pixel within half an input pixel of the border
    # takes the border sample's row / column alone
    edge = max(1, size // (2 * low))
    for sl in (np.s_[:, :edge], np.s_[:, -edge:], np.s_[:, :, :edge], np.s_[:, :, -edge:]):
        np.testing.assert_allclose(got[sl], ref[sl], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[:, 0, 0], field[:, 0, 0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[:, -1, -1], field[:, -1, -1], rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# blurs and per-image 3x3 filters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("size", [3, 5])
def test_box_median_and_motion_blurs_match_jax(size, dtype):
    x = _images(4, 16)
    jx, px = _pair(x, dtype)
    _close(P._box_blur(px, size), J._box_blur(jx, size), _tol(dtype))
    # min/max only: exact in any dtype
    np.testing.assert_array_equal(to_numpy(P._median_blur(px, size)),
                                  to_numpy(J._median_blur(jx, size)))
    np.testing.assert_array_equal(to_numpy(P._median3(px)), to_numpy(J._median3(jx)))
    direction = np.array([0, 1, 2, 3])
    _close(P._motion_blur(px, size, torch.from_numpy(direction)),
           J._motion_blur(jx, size, jnp.asarray(direction)), _tol(dtype))


def test_sort2_orders_elementwise():
    a, b = np.array([3.0, -1.0, 2.0]), np.array([1.0, 5.0, 2.0])
    for got, ref in zip(P._sort2(torch.from_numpy(a), torch.from_numpy(b)),
                        J._sort2(jnp.asarray(a), jnp.asarray(b))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_sharpen_and_emboss_kernels_match_jax():
    rng = np.random.default_rng(5)
    alpha, other = (rng.random(7).astype(np.float32) for _ in range(2))
    for pf, jf in ((P._sharpen_kernel, J._sharpen_kernel), (P._emboss_kernel, J._emboss_kernel)):
        got = pf(torch.from_numpy(alpha), torch.from_numpy(other))
        ref = jf(jnp.asarray(alpha), jnp.asarray(other))
        assert got.shape == (7, 3, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_conv3x3_per_image_matches_jax(dtype):
    x = _images(4, 16)
    jx, px = _pair(x, dtype)
    rng = np.random.default_rng(6)
    kern = J._sharpen_kernel(jnp.asarray(rng.random(4).astype(np.float32)),
                             jnp.asarray(rng.random(4).astype(np.float32)))
    jk = kern.astype(jnp.dtype(dtype))
    _close(P._conv3x3_per_image(px, to_torch(jk)), J._conv3x3_per_image(jx, jk),
           _tol(dtype) * (1 if dtype == "float32" else 16))   # bf16: values up to ~16


# ---------------------------------------------------------------------------
# colour spaces
# ---------------------------------------------------------------------------
def test_srgb_and_lab_conversions_match_jax():
    rgb = _images(2, 16)
    c = jnp.asarray(rgb)
    np.testing.assert_allclose(P._srgb_to_linear(torch.from_numpy(rgb)).numpy(),
                               np.asarray(J._srgb_to_linear(c)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(P._linear_to_srgb(torch.from_numpy(rgb)).numpy(),
                               np.asarray(J._linear_to_srgb(c)), rtol=0, atol=1e-6)
    got = P._rgb_to_lab(torch.from_numpy(rgb))
    ref = J._rgb_to_lab(c)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-4)
    back = P._lab_to_rgb(*(to_torch(r) for r in ref))
    np.testing.assert_allclose(back.numpy(), np.asarray(J._lab_to_rgb(*ref)), rtol=0, atol=1e-5)
    np.testing.assert_allclose(back.numpy(), rgb, rtol=0, atol=2e-3)     # round trip


@pytest.mark.parametrize("dtype", DTYPES)
def test_hsv_conversions_match_jax(dtype):
    rgb = _images(2, 16)
    rgb[0, :4] = rgb[0, :4, :, :1]          # grey pixels: delta == 0
    jx, px = _pair(rgb, dtype)
    _close(P._rgb_to_hsv(px), J._rgb_to_hsv(jx), _tol(dtype))
    hsv = J._rgb_to_hsv(jx)
    shifted = hsv.at[..., 0].set((hsv[..., 0] + 0.93) % 1.0)   # every sector
    _close(P._hsv_to_rgb(to_torch(shifted)), J._hsv_to_rgb(shifted), _tol(dtype))


# ---------------------------------------------------------------------------
# CLAHE
# ---------------------------------------------------------------------------
def _levels(size=64, n=3, seed=2):
    rng = np.random.default_rng(seed)
    base = np.linspace(40, 200, size)[None, :] + np.linspace(0, 40, size)[:, None]
    return np.stack([(base + rng.normal(0, 8 * (i + 1), (size, size))).clip(0, 255)
                     for i in range(n)]).astype(np.int32)


@pytest.mark.parametrize("tiles", [4, 8])
def test_clahe_lut_and_blend_match_jax(tiles):
    l_u8 = _levels()
    clip = np.array([1.0, 2.0, 4.0], np.float32)
    ref_lut = J._clahe_lut(jnp.asarray(l_u8), jnp.asarray(clip), tiles)
    lut = P._clahe_lut(torch.from_numpy(l_u8), torch.from_numpy(clip), tiles)
    assert lut.shape == (3, tiles * tiles, 256)
    np.testing.assert_array_equal(lut.numpy(), np.asarray(ref_lut))
    ref = J._clahe_apply(jnp.asarray(l_u8), ref_lut, tiles)
    got = P._clahe_apply(torch.from_numpy(l_u8), lut, tiles)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


def test_clahe_rgb_matches_jax():
    """Whole CLAHE on RGB (LAB, LUTs, blend, back to RGB) against the JAX
    function's chunked scan."""
    x = _images(4, 32, seed=9)
    clip = np.array([1.5, 2.0, 3.0, 4.0], np.float32)
    ref = J._clahe_rgb(jnp.asarray(x), jnp.asarray(clip), 8, chunk=2)
    L_ref = np.asarray(J._rgb_to_lab(jnp.asarray(x))[0]) * (255.0 / 100.0)
    L_got = P._rgb_to_lab(torch.from_numpy(x))[0].numpy() * (255.0 / 100.0)
    off = np.round(L_ref) != np.round(L_got)
    # the levels agree, or sit on a tie that a one-ulp L decides
    assert np.all(np.abs(L_ref[off] - np.floor(L_ref[off]) - 0.5) < 1e-3)
    got = P._clahe_rgb(torch.from_numpy(x), torch.from_numpy(clip), 8)
    same = ~off.reshape(4, -1).any(1)
    assert same.sum() >= 3
    np.testing.assert_allclose(got.numpy()[same], np.asarray(ref)[same], rtol=0, atol=1e-4)


def test_clahe_matches_cv2_unclipped():
    cv2 = pytest.importorskip("cv2")
    l_u8 = np.random.default_rng(0).integers(0, 256, (1, 64, 64)).astype(np.int32)
    lut = P._clahe_lut(torch.from_numpy(l_u8), torch.tensor([1e6]), 8)
    got = P._clahe_apply(torch.from_numpy(l_u8), lut, 8).numpy()[0]
    ref = cv2.createCLAHE(clipLimit=1e6, tileGridSize=(8, 8)).apply(l_u8[0].astype(np.uint8))
    # cv2 rounds the interpolated value; allow the half-level boundary
    assert np.abs(np.round(got) - ref.astype(np.float64)).max() <= 1.0
    assert np.abs(got - ref).mean() < 0.51


@pytest.mark.parametrize("size", [256, 64])
@pytest.mark.parametrize("clip", [2.0, 4.0])
def test_clahe_matches_cv2_clipped(size, clip):
    """Clipped: the integer clip limit, the per-256 redistribution and the
    strided residual drop replicate cv2 bin for bin."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(size)
    base = np.linspace(60, 190, size)[None, :] + np.linspace(0, 30, size)[:, None]
    l_u8 = (base + rng.normal(0, 6, (size, size))).clip(0, 255).astype(np.int32)[None]
    lut = P._clahe_lut(torch.from_numpy(l_u8), torch.tensor([clip]), 8)
    got = P._clahe_apply(torch.from_numpy(l_u8), lut, 8).numpy()[0]
    ref = cv2.createCLAHE(clipLimit=clip, tileGridSize=(8, 8)).apply(l_u8[0].astype(np.uint8))
    np.testing.assert_array_equal(np.round(got), ref.astype(np.float64))


def test_lab_matches_cv2():
    cv2 = pytest.importorskip("cv2")
    rgb = np.random.default_rng(4).random((8, 8, 3)).astype(np.float32)
    L, a, b = P._rgb_to_lab(torch.from_numpy(rgb))
    ref = cv2.cvtColor(rgb, cv2.COLOR_RGB2LAB)
    for got, k in ((L, 0), (a, 1), (b, 2)):
        np.testing.assert_allclose(got.numpy(), ref[..., k], atol=0.5)
