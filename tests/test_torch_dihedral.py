"""The port's dihedral front-end and ``augment_batch`` against the JAX
package (CPU), and the CUDA kernel against its plain version (card).

Which JAX path the port equals, and how closely:
- images vs ``_apply_dihedral`` of ``x.astype(f32) / 255.0`` (the JAX
  package's plain path, what its ``augment_batch`` runs off the TPU):
  bit-exact -- both divide by 255 in float32 and then only move values;
- images vs the Pallas kernel ``dihedral_normalize(interpret=True,
  precision=HIGHEST)``, which multiplies by ``1/255`` instead: within one
  float32 ulp of a value in [0, 1] (atol 1.2e-7), or 1e-6 after the
  ImageNet normalization's division by ~0.22;
- masks: equal exactly against both.

JAX is imported inside the tests that need it, so the GPU test runs on a
machine without JAX: ``python -m pytest --noconftest -m gpu
tests/test_torch_dihedral.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from uda_aerial_semantic_segmentation_research_tpu_torch.ops import augment, dihedral
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.dihedral import (
    abc_from_flags,
    dihedral_normalize,
    dihedral_normalize_reference,
    flags_from_abc,
)

ALL_FLAGS = np.arange(8, dtype=np.int32)
MEAN = np.asarray((0.485, 0.456, 0.406), np.float32)
STD = np.asarray((0.229, 0.224, 0.225), np.float32)
# every stage after the dihedral one switched off
DIHEDRAL_ONLY = dict(p_ssr=0.0, p_distort=0.0, p_noise=0.0, p_blur=0.0, p_color=0.0,
                     p_hsv=0.0)


def _batch(size=16, seed=0, b=8):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (b, size, size, 3)).astype(np.uint8)
    masks = rng.integers(0, 23, (b, size, size)).astype(np.int32)
    return images, masks


def _abc(flags):
    return (flags & 1) != 0, (flags & 2) != 0, (flags & 4) != 0


# ---------------------------------------------------------------------------
# dihedral_normalize
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("with_masks", [False, True])
def test_dihedral_matches_jax_for_all_eight_elements(with_masks, normalize):
    import jax
    import jax.numpy as jnp

    from uda_aerial_semantic_segmentation_research_tpu.ops.augment import _apply_dihedral
    from uda_aerial_semantic_segmentation_research_tpu.ops.pallas_ops import (
        dihedral_normalize as jax_dihedral_normalize,
    )

    images, masks = _batch()
    x, m = dihedral_normalize(torch.from_numpy(images), torch.from_numpy(ALL_FLAGS),
                              torch.from_numpy(masks) if with_masks else None,
                              normalize=normalize)
    assert x.dtype == torch.float32 and tuple(x.shape) == images.shape
    assert (m is None) == (not with_masks)

    # the plain JAX path: exact
    a, b, c = (jnp.asarray(g) for g in _abc(ALL_FLAGS))
    x_ref, m_ref = _apply_dihedral(jnp.asarray(images).astype(jnp.float32) / 255.0,
                                   jnp.asarray(masks) if with_masks else None, a, b, c)
    if normalize:
        x_ref = (x_ref - MEAN) / STD
    np.testing.assert_array_equal(x.numpy(), np.asarray(x_ref))

    # the Pallas kernel (interpret mode, exact relocation): one ulp of x/255
    x_pl, m_pl = jax_dihedral_normalize(
        jnp.asarray(images), jnp.asarray(ALL_FLAGS),
        jnp.asarray(masks) if with_masks else None, normalize=normalize,
        interpret=True, precision=jax.lax.Precision.HIGHEST)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_pl), rtol=0,
                               atol=1e-6 if normalize else 1.2e-7)
    if with_masks:
        assert m.dtype == torch.int32
        np.testing.assert_array_equal(m.numpy(), np.asarray(m_ref))
        np.testing.assert_array_equal(m.numpy(), np.asarray(m_pl))


def test_each_flag_bit_is_the_named_array_op():
    images, masks = _batch(size=6, b=3)
    flags = torch.tensor([1, 2, 4], dtype=torch.int32)
    x, m = dihedral_normalize(torch.from_numpy(images), flags, torch.from_numpy(masks))
    ref = images.astype(np.float32) / np.float32(255.0)
    np.testing.assert_array_equal(x[0].numpy(), ref[0].transpose(1, 0, 2))
    np.testing.assert_array_equal(x[1].numpy(), ref[1][:, ::-1])
    np.testing.assert_array_equal(x[2].numpy(), ref[2][::-1])
    np.testing.assert_array_equal(m[0].numpy(), masks[0].T)
    np.testing.assert_array_equal(m[1].numpy(), masks[1][:, ::-1])
    np.testing.assert_array_equal(m[2].numpy(), masks[2][::-1])


def test_flags_round_trip_and_match_jax():
    import jax.numpy as jnp

    from uda_aerial_semantic_segmentation_research_tpu.ops.pallas_ops import (
        flags_from_abc as jax_flags_from_abc,
    )

    a, b, c = _abc(ALL_FLAGS)
    got = flags_from_abc(*(torch.from_numpy(g) for g in (a, b, c)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ALL_FLAGS)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_flags_from_abc(*(jnp.asarray(g) for g in (a, b, c)))))
    for g, back in zip((a, b, c), abc_from_flags(got)):
        np.testing.assert_array_equal(back.numpy(), g)


@pytest.mark.parametrize("mask_dtype", [torch.uint8, torch.int32, torch.int64])
def test_masks_of_any_integer_type_come_out_int32(mask_dtype):
    images, masks = _batch(size=8)
    _, m = dihedral_normalize(torch.from_numpy(images), torch.from_numpy(ALL_FLAGS),
                              torch.from_numpy(masks).to(mask_dtype))
    _, m_ref = dihedral_normalize(torch.from_numpy(images), torch.from_numpy(ALL_FLAGS),
                                  torch.from_numpy(masks))
    assert m.dtype == torch.int32 and torch.equal(m, m_ref)


@pytest.mark.parametrize("bad", ["non_square", "float_images", "flags_shape",
                                 "masks_shape", "float_masks", "normalize_channels",
                                 "meta_device"])
def test_dihedral_rejects_what_it_cannot_take(bad):
    images, masks = (torch.from_numpy(a) for a in _batch(size=8))
    flags = torch.from_numpy(ALL_FLAGS)
    kw = dict(normalize=False)
    error = ValueError
    if bad == "non_square":
        images = images[:, :, :6]
        masks = masks[:, :, :6]
    elif bad == "float_images":
        images, error = images.float(), TypeError
    elif bad == "flags_shape":
        flags = flags[:3]
    elif bad == "masks_shape":
        masks = masks[:, :4]
    elif bad == "float_masks":
        masks, error = masks.float(), TypeError
    elif bad == "normalize_channels":
        images, kw = images[..., :2], dict(normalize=True)
    else:
        images, masks, flags = images.to("meta"), masks.to("meta"), flags.to("meta")
    with pytest.raises(error):
        dihedral_normalize(images, flags, masks, **kw)


def test_cpu_wrapper_routes_to_the_plain_version():
    images, masks = (torch.from_numpy(a) for a in _batch(size=8))
    flags = torch.from_numpy(ALL_FLAGS)
    before = dihedral_normalize.launches
    x, m = dihedral_normalize(images, flags, masks, normalize=True)
    x_ref, m_ref = dihedral_normalize_reference(images, flags, masks, normalize=True)
    assert torch.equal(x, x_ref) and torch.equal(m, m_ref)
    assert dihedral_normalize.launches == before


# ---------------------------------------------------------------------------
# _sample_dihedral
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["WEAK", "STRONG"])
def test_sample_dihedral_has_the_distribution_of_the_jax_function(name):
    """The two random streams cannot match; the 8-bin histogram of the
    drawn group elements must, per bin within 0.02 over 20,000 draws."""
    import jax

    from uda_aerial_semantic_segmentation_research_tpu.ops import augment as jax_augment

    n = 20000
    a, b, c = jax_augment._sample_dihedral(jax.random.key(0), n, getattr(jax_augment, name))
    ref = np.bincount(np.asarray(a) + 2 * np.asarray(b) + 4 * np.asarray(c), minlength=8) / n
    gen = torch.Generator().manual_seed(0)
    abc = augment._sample_dihedral(gen, n, getattr(augment, name))
    assert all(t.dtype == torch.bool and tuple(t.shape) == (n,) for t in abc)
    got = np.bincount(flags_from_abc(*abc).numpy(), minlength=8) / n
    np.testing.assert_allclose(got, ref, atol=0.02)
    # the caller's generator moves on: a second call draws other elements
    again = augment._sample_dihedral(gen, n, getattr(augment, name))
    assert not all(torch.equal(x, y) for x, y in zip(abc, again))
    repeat = augment._sample_dihedral(torch.Generator().manual_seed(0), n,
                                      getattr(augment, name))
    assert all(torch.equal(x, y) for x, y in zip(abc, repeat))


# ---------------------------------------------------------------------------
# augment_batch
# ---------------------------------------------------------------------------
def test_augment_config_has_the_fields_and_constants_of_the_jax_package():
    from uda_aerial_semantic_segmentation_research_tpu.ops import augment as jax_augment

    for name in ("WEAK", "STRONG", "NONE"):
        assert (dataclasses.asdict(getattr(augment, name))
                == dataclasses.asdict(getattr(jax_augment, name)))
    assert augment.WEAK.has_geometric and not augment.NONE.has_geometric


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_augment_batch_with_explicit_elements_matches_jax(compute_dtype):
    """What the JAX ``augment_batch`` computes on the CPU, composed from its
    importable parts: ``_apply_dihedral`` on ``(u8 / 255).astype(compute
    dtype)``, then float32 and the ImageNet normalize.  Exact in float32;
    in bfloat16 the values are bf16-rounded identically, then normalized in
    float32 (1e-6 for the division)."""
    import jax.numpy as jnp

    from uda_aerial_semantic_segmentation_research_tpu.ops import augment as jax_augment

    images, masks = _batch()
    a, b, c = _abc(ALL_FLAGS)
    x_ref = (jnp.asarray(images).astype(jnp.float32) / 255.0).astype(jnp.dtype(compute_dtype))
    x_ref, m_ref = jax_augment._apply_dihedral(
        x_ref, jnp.asarray(masks), *(jnp.asarray(g) for g in (a, b, c)))
    x_ref = (x_ref.astype(jnp.float32) - jax_augment.IMAGENET_MEAN) / jax_augment.IMAGENET_STD

    cfg = dataclasses.replace(augment.WEAK, compute_dtype=compute_dtype, **DIHEDRAL_ONLY)
    x, m = augment.augment_batch(None, torch.from_numpy(images),
                                 torch.from_numpy(masks).to(torch.uint8), cfg=cfg,
                                 abc=tuple(torch.from_numpy(g) for g in (a, b, c)))
    assert x.dtype == torch.float32 and m.dtype == torch.int32
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_ref))


def test_augment_batch_matches_the_jitted_jax_function_without_random_stages():
    """All probabilities zero: the jitted JAX ``augment_batch`` itself."""
    import jax
    import jax.numpy as jnp

    from uda_aerial_semantic_segmentation_research_tpu.ops import augment as jax_augment

    images, masks = _batch()
    x_ref, m_ref = jax_augment.augment_batch(jax.random.key(0), jnp.asarray(images),
                                             jnp.asarray(masks), cfg=jax_augment.NONE)
    x, m = augment.augment_batch(None, torch.from_numpy(images), torch.from_numpy(masks),
                                 cfg=augment.NONE)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_ref))
    torch.testing.assert_close(x, augment.normalize_images(torch.from_numpy(images)),
                               rtol=0, atol=0)


def test_augment_batch_draws_from_the_callers_generator():
    images, masks = (torch.from_numpy(a) for a in _batch(b=64))
    cfg = dataclasses.replace(augment.WEAK, **DIHEDRAL_ONLY)
    gen = torch.Generator().manual_seed(3)
    x1, m1 = augment.augment_batch(gen, images, masks, cfg=cfg)
    x2, _ = augment.augment_batch(gen, images, masks, cfg=cfg)
    x3, m3 = augment.augment_batch(torch.Generator().manual_seed(3), images, masks, cfg=cfg)
    assert not torch.equal(x1, x2)
    assert torch.equal(x1, x3) and torch.equal(m1, m3)
    x_raw, _ = augment.augment_batch(torch.Generator().manual_seed(3), images, masks,
                                     cfg=cfg, normalize=False)
    assert 0.0 <= x_raw.min() and x_raw.max() <= 1.0
    # a float batch takes the plain dihedral ops and is not divided by 255
    xf, _ = augment.augment_batch(torch.Generator().manual_seed(3), images.float() / 255.0,
                                  masks, cfg=dataclasses.replace(cfg, compute_dtype="float32"),
                                  normalize=False)
    x32, _ = augment.augment_batch(torch.Generator().manual_seed(3), images, masks,
                                   cfg=dataclasses.replace(cfg, compute_dtype="float32"),
                                   normalize=False)
    assert torch.equal(xf, x32)


def _blocks(b=8, size=32, block=8):
    """Masks of 8x8 blocks of labels 0..22 and images whose three channels
    encode the label (8 * label), so that a pixel's image value names its
    mask label."""
    rng = np.random.default_rng(4)
    labels = rng.integers(0, 23, (b, size // block, size // block))
    masks = np.repeat(np.repeat(labels, block, 1), block, 2).astype(np.uint8)
    images = np.repeat((8 * masks)[..., None], 3, -1).astype(np.uint8)
    return torch.from_numpy(images), torch.from_numpy(masks)


@pytest.mark.parametrize("case", ["WEAK", "STRONG", "p_ssr", "p_distort", "p_noise",
                                  "p_blur", "p_color", "p_hsv"])
def test_augment_batch_raises_for_a_stage_that_is_not_ported(case):
    """Every stage runs (the name is kept from when the stages after the
    dihedral one raised): the generator's draws are replayable, the stage
    changes exactly the images its gates select (against the dihedral-only
    result with the same elements), and images and masks stay aligned (the
    label-encoding images, sent through the same geometric draws, decode
    to the returned masks)."""
    images, masks = _blocks()
    cfg = (getattr(augment, case) if case in ("WEAK", "STRONG")
           else dataclasses.replace(augment.NONE, **{case: 0.5}))
    n, shape = images.shape[0], tuple(images.shape)
    x, m = augment.augment_batch(torch.Generator().manual_seed(0), images, masks, cfg=cfg,
                                 normalize=False)
    replay = torch.Generator().manual_seed(0)
    abc = (augment._sample_dihedral(replay, n, cfg) if cfg.p_rot90 > 0
           else tuple(torch.zeros(n, dtype=torch.bool) for _ in range(3)))
    params = augment.sample_params(replay, shape, cfg, has_masks=True)
    x2, m2 = augment.augment_batch(None, images, masks, cfg=cfg, normalize=False, abc=abc,
                                   params=params)
    assert torch.equal(x, x2) and torch.equal(m, m2)

    gates = [d.do for d in (*params.warp, *params.photometric) if d is not None]
    selected = torch.stack(gates).any(0)
    assert selected.any()
    plain = dataclasses.replace(cfg, **DIHEDRAL_ONLY)
    base, base_m = augment.augment_batch(None, images, masks, cfg=plain, normalize=False,
                                         abc=abc)
    changed = (x != base).flatten(1).any(1)
    assert changed[selected].any() and not changed[~selected].any()
    warped = torch.zeros(n, dtype=torch.bool)
    for d in params.warp:
        if d is not None:
            warped |= d.do
    assert not (m != base_m).flatten(1).any(1)[~warped].any()

    geometric = dataclasses.replace(cfg, p_noise=0.0, p_blur=0.0, p_color=0.0, p_hsv=0.0,
                                    compute_dtype="float32")
    xe, me = augment.augment_batch(None, images, masks, cfg=geometric, normalize=False,
                                   abc=abc, params=params)
    assert torch.equal(me, m)
    decoded = torch.round(xe[..., 0] * 255.0 / 8.0).to(torch.int32)
    assert (decoded == me).float().mean() > 0.9


def test_augment_batch_rejects_non_square_tiles_and_a_missing_generator():
    images, masks = (torch.from_numpy(a) for a in _batch(size=8))
    cfg = dataclasses.replace(augment.WEAK, **DIHEDRAL_ONLY)
    with pytest.raises(ValueError, match="square"):
        augment.augment_batch(torch.Generator(), images[:, :6], masks[:, :6], cfg=cfg)
    with pytest.raises(ValueError, match="generator"):
        augment.augment_batch(None, images, masks, cfg=cfg)


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# the launch plan (host only)
# ---------------------------------------------------------------------------
H100_SMS = 132


@pytest.mark.parametrize("masks", [-1, 0])
@pytest.mark.parametrize("b", [1, 32, 128])
def test_plan_takes_the_bulk_path_at_the_train_step_shapes(b, masks):
    p = dihedral.plan(b, 512, 3, masks, True, H100_SMS)
    assert p.bulk and (p.rows, p.cols) == (64, 256) and p.stages == 2
    assert p.smem <= dihedral.SMEM_LIMIT
    # two waves of the blocks the SMs hold at once, never more than the units
    units = b * (512 // 64) * (512 // 256)
    assert p.grid == min(units, 2 * H100_SMS)
    if b == 128:
        assert units > p.stages * p.grid     # blocks reuse their stages


@pytest.mark.parametrize("case", [
    (32, 512, 3, 0, False),   # unaligned pointer
    (8, 50, 3, 0, True),      # pitch of 150 bytes: not a whole number of 16-byte vectors
    (8, 100, 3, -1, True),    # S not a multiple of 16
    (4, 512, 1, 0, True), (4, 512, 2, 0, True), (4, 512, 4, 0, True),
    (4, 512, 5, -1, True), (4, 512, 8, 0, True),   # C other than 3
    (32, 512, 3, 1, True), (32, 512, 3, 2, True),  # int32 / int64 masks
])
def test_plan_sends_what_the_bulk_kernel_cannot_take_to_the_generic_path(case):
    b, s, c, masks, aligned = case
    p = dihedral.plan(b, s, c, masks, aligned, H100_SMS)
    assert not p.bulk and p.smem == 0
    assert 1 <= p.grid <= min(b * s, dihedral.GENERIC_BLOCKS_PER_SM * H100_SMS)


@pytest.mark.parametrize("s", [16, 32, 48, 80, 496, 512, 528, 1024, 1040, 4096])
@pytest.mark.parametrize("masks", [-1, 0])
def test_plan_fits_shared_memory_and_never_outgrows_the_work(s, masks):
    for b in (1, 3, 33):
        p = dihedral.plan(b, s, 3, masks, True, H100_SMS)
        assert p.bulk and p.rows % 16 == 0 and p.cols % 16 == 0
        assert p.rows <= s and p.cols <= s
        assert p.smem <= dihedral.SMEM_LIMIT
        units = b * -(-s // p.rows) * -(-s // p.cols)
        assert 1 <= p.grid <= units


def test_plan_launches_for_the_smallest_tiles():
    """S = 1 and a single unit still launch one block; the generic path
    takes one block an output row."""
    for b, s, c, grid in ((1, 1, 3, 1), (1, 1, 1, 1), (1, 7, 8, 7), (1, 16, 3, 1)):
        p = dihedral.plan(b, s, c, 0, True, H100_SMS)
        assert p.grid == grid and p.bulk == (s == 16)


def test_stage_layout_holds_a_unit_either_way():
    """The bytes a stage reserves hold a unit's source bytes staged densely
    (untransposed) and in skewed rows (transposed), rows 16-byte aligned and
    apart, for every unit an image cut into tiles can give."""
    for rows, cols in ((16, 16), (64, 256), (48, 48), (64, 80), (32, 512)):
        for ch in (3, 1):
            area = dihedral._area_bytes(rows, cols, ch)
            assert area % 128 == 0 and area >= rows * cols * ch
            for rr in range(16, rows + 1, 16):      # a band cut by the image's edge
                chunks = rr * ch // 16
                offs = [dihedral._skewed_offset(r, chunks) for r in range(cols)]
                assert all(o % 16 == 0 for o in offs)
                assert all(b - a >= rr * ch for a, b in zip(offs, offs[1:]))
                assert offs[-1] + rr * ch <= area


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------
# (B, S, C): every C of 1-5 and 8, every S of the edges, B of 1 and 33; the
# bulk path at S = 16, 48, 80 (a 16-row band, an 80-column unit), 512, 1040
# (a 16-column unit), and at B = 70 (blocks of four units or more, which
# reuse their stages)
GPU_CASES = [(1, 1, 1), (33, 7, 2), (2, 16, 3), (3, 33, 4), (33, 50, 3), (4, 100, 5),
             (33, 129, 8), (3, 48, 3), (5, 80, 3), (1, 512, 3), (33, 512, 3), (70, 512, 3),
             (2, 1040, 3)]
GPU_FLAGS = {"mixed": range(8), "untransposed": (0, 2, 4, 6), "transposed": (1, 3, 5, 7)}


@pytest.mark.gpu
def test_kernel_matches_plain_version_on_gpu():
    """Bit-exact images and masks against the plain version on both paths:
    C = 1..5 and 8, S from 1 to 1040 (on and off the 16-pixel grid, units cut
    by the image's edge), B = 1 and 33, an aligned and an unaligned (offset
    1) image view, int32 and int64 flags (high bits set), every mask kind and
    none, ``normalize`` both ways, batches of every element, of none
    transposed and of all transposed; two launches bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    for b, size, ch in GPU_CASES:
        n = b * size * size * ch
        base = torch.from_numpy(rng.integers(0, 256, n + 1).astype(np.uint8)).cuda()
        masks = torch.from_numpy(rng.integers(0, 255, (b, size, size)).astype(np.int32)).cuda()
        for unaligned in (False, True):
            images = (base[1:] if unaligned else base[:n]).view(b, size, size, ch)
            for cls, pick in GPU_FLAGS.items():
                flags = torch.from_numpy(
                    rng.choice(np.asarray(pick, np.int32), b)).cuda()
                wide = flags.long() + (torch.arange(b, device="cuda") % 7 << 3) + (3 << 33)
                for fl in (flags, wide):
                    for normalize in (False, True) if ch == 3 else (False,):
                        for mk in (None, torch.uint8, torch.int32, torch.int64):
                            mt = None if mk is None else masks.to(mk)
                            before = dihedral_normalize.launches
                            x, m = dihedral_normalize(images, fl, mt, normalize=normalize)
                            x2, m2 = dihedral_normalize(images, fl, mt, normalize=normalize)
                            torch.cuda.synchronize()
                            assert dihedral_normalize.launches == before + 2
                            where = (b, size, ch, unaligned, cls, fl.dtype, normalize, mk)
                            x_ref, m_ref = dihedral_normalize_reference(
                                images, fl, mt, normalize=normalize)
                            assert torch.equal(x, x_ref), where
                            assert torch.equal(x, x2), where
                            if mk is None:
                                assert m is None and m_ref is None
                            else:
                                assert torch.equal(m, m_ref) and torch.equal(m, m2), where
    with pytest.raises(ValueError):
        dihedral_normalize(images.permute(0, 2, 1, 3), flags)        # not contiguous
    with pytest.raises(ValueError):
        dihedral_normalize(torch.zeros(1, 4, 4, 9, dtype=torch.uint8, device="cuda"),
                           flags[:1])
