"""The port's per-channel sums and train-mode BatchNorm against the JAX
package (CPU), and the CUDA kernels against their plain versions (card).

Tolerances, all float32 with sums taken in another order on each side:
- sums: 1e-5 relative (plus 1e-4 absolute for sums that cancel to ~0);
- BatchNorm values, running statistics and gradients: 1e-5;
- on the card: kernel vs plain version 1e-5 relative to sum|terms|.

JAX is imported inside the tests that need it, so the GPU tests run on a
machine without JAX: ``python -m pytest --noconftest -m gpu
tests/test_torch_channel_sums.py``.
"""

import numpy as np
import pytest
import torch

from uda_aerial_semantic_segmentation_research_tpu_torch.ops.batch_norm import (
    EPS,
    BatchNorm,
    bn_train,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.channel_sums import (
    CLUSTER_SIZES,
    FOLD_BYTES,
    GENERIC_MIN_ROWS,
    MIN_BLOCK_BYTES,
    THREADS,
    bulk_consumers,
    channel_dual_sums,
    channel_dual_sums_reference,
    channel_sums,
    channel_sums_reference,
    plan,
)

RTOL = 1e-5


def _pair(c, rows=1024, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed + c)
    x = (rng.normal(size=(rows, c)) * 2.0 + 0.5).astype(dtype)
    dy = rng.normal(size=(rows, c)).astype(dtype)
    return dy, x


# ---------------------------------------------------------------------------
# sums
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("c", [16, 64, 128, 256])
def test_channel_sums_match_pallas_lane_sums(c):
    """Plain versions vs ``lane_sums`` / ``lane_dual_sums`` (interpret mode)
    on the flat lane view, folded to channels by ``lane_bn._fold``."""
    import jax.numpy as jnp

    from uda_aerial_semantic_segmentation_research_tpu.ops.lane_bn import _fold
    from uda_aerial_semantic_segmentation_research_tpu.ops.pallas_moments import (
        lane_dual_sums,
        lane_sums,
    )

    dy, x = _pair(c)
    lanes = max(128, c)
    s, q = lane_sums(jnp.asarray(x).reshape(-1, lanes), interpret=True)
    sd, sdx = lane_dual_sums(jnp.asarray(dy).reshape(-1, lanes),
                             jnp.asarray(x).reshape(-1, lanes), interpret=True)
    got = channel_sums(torch.from_numpy(x)).numpy()
    got_dual = channel_dual_sums(torch.from_numpy(dy), torch.from_numpy(x)).numpy()
    assert got.shape == got_dual.shape == (2, c) and got.dtype == np.float32
    np.testing.assert_allclose(got[0], np.asarray(_fold(s, c)), rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(got[1], np.asarray(_fold(q, c)), rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(got_dual[0], np.asarray(_fold(sd, c)), rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(got_dual[1], np.asarray(_fold(sdx, c)), rtol=RTOL, atol=1e-4)


def test_channel_sums_take_a_shape_the_lane_fold_rejects():
    """C=24 over 3*7*5 rows: the TPU fold refuses it, the port takes it."""
    import jax.numpy as jnp

    from uda_aerial_semantic_segmentation_research_tpu.ops.lane_bn import _foldable

    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 7, 5, 24)).astype(np.float32)
    dy = rng.normal(size=(3, 7, 5, 24)).astype(np.float32)
    assert not _foldable(jnp.asarray(x), 24)
    x64, dy64 = x.astype(np.float64), dy.astype(np.float64)
    got = channel_sums(torch.from_numpy(x)).numpy()
    got_dual = channel_dual_sums(torch.from_numpy(dy), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got[0], x64.sum((0, 1, 2)), rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(got[1], (x64 * x64).sum((0, 1, 2)), rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(got_dual[0], dy64.sum((0, 1, 2)), rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(got_dual[1], (dy64 * x64).sum((0, 1, 2)), rtol=RTOL, atol=1e-4)


def test_channel_sums_bf16_accumulate_in_f32():
    dy, x = _pair(16, rows=4096)
    xb, dyb = torch.from_numpy(x).bfloat16(), torch.from_numpy(dy).bfloat16()
    got = channel_sums(xb)
    assert got.dtype == torch.float32
    x64 = xb.double()
    torch.testing.assert_close(got[0].double(), x64.sum(0), rtol=RTOL, atol=1e-3)
    torch.testing.assert_close(got[1].double(), (x64 * x64).sum(0), rtol=RTOL, atol=1e-3)
    mixed = channel_dual_sums(dyb, torch.from_numpy(x))       # bf16 dy, f32 x
    torch.testing.assert_close(mixed[1].double(),
                               (dyb.double() * torch.from_numpy(x).double()).sum(0),
                               rtol=RTOL, atol=1e-3)


def test_cpu_wrappers_route_to_the_plain_versions():
    dy, x = (torch.from_numpy(a) for a in _pair(32, rows=64))
    before = channel_sums.launches, channel_dual_sums.launches
    assert torch.equal(channel_sums(x), channel_sums_reference(x))
    assert torch.equal(channel_dual_sums(dy, x), channel_dual_sums_reference(dy, x))
    assert (channel_sums.launches, channel_dual_sums.launches) == before


@pytest.mark.parametrize("bad", ["non_contiguous", "rank", "empty", "shape", "meta_device"])
def test_wrappers_reject_what_they_cannot_take(bad):
    x = torch.zeros(2, 4, 4, 8)
    dy = torch.zeros(2, 4, 4, 8)
    if bad == "non_contiguous":
        x = torch.zeros(2, 8, 4, 4).permute(0, 2, 3, 1)    # NCHW memory, NHWC view
    elif bad == "rank":
        x = dy = torch.zeros(8)
    elif bad == "empty":
        x = dy = torch.zeros(0, 8)
    elif bad == "shape":
        dy = torch.zeros(2, 4, 4, 4)
    else:
        x, dy = x.to("meta"), dy.to("meta")
    with pytest.raises(ValueError):
        channel_dual_sums(dy, x)
    if bad != "shape":
        with pytest.raises(ValueError):
            channel_sums(x)


def test_nhwc_view_of_channels_last_is_taken_without_a_copy():
    x = torch.randn(2, 8, 4, 4, generator=torch.Generator().manual_seed(0))
    x = x.contiguous(memory_format=torch.channels_last)
    got = channel_sums(x.permute(0, 2, 3, 1))
    torch.testing.assert_close(got[0], x.sum((0, 2, 3)), rtol=RTOL, atol=1e-5)


# ---------------------------------------------------------------------------
# train-mode BatchNorm
# ---------------------------------------------------------------------------
def _bn_case(c, dtype, seed=0, shape=(4, 8, 8)):
    rng = np.random.RandomState(seed + c)
    x = (rng.randn(*shape, c) * 2.0 + 0.5).astype(np.float32)        # NHWC
    scale = (rng.rand(c) + 0.5).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    return x, scale, bias


def _jax_bn(x, scale, bias, x_dtype, norm_dtype, lane):
    """y, new batch_stats, and d(sum(sin(y)*y))/d(x, scale, bias) of the JAX
    ``lane_bn.BatchNorm`` in train mode."""
    import jax
    import jax.numpy as jnp

    from uda_aerial_semantic_segmentation_research_tpu.ops.lane_bn import (
        BatchNorm as JaxBatchNorm,
    )

    c = x.shape[-1]
    mod = JaxBatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                       dtype=norm_dtype, param_dtype=jnp.float32, lane=lane)
    stats = {"mean": jnp.full((c,), 0.3), "var": jnp.full((c,), 2.0)}
    xj = jnp.asarray(x).astype(x_dtype)

    def loss(params, xj):
        y, upd = mod.apply({"params": params, "batch_stats": stats}, xj,
                           mutable=["batch_stats"])
        y32 = y.astype(jnp.float32)
        return jnp.sum(jnp.sin(y32) * y32), (y, upd["batch_stats"])

    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    (_, (y, bs)), (dp, dx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, xj)
    f32 = lambda a: np.asarray(a.astype(jnp.float32))
    return f32(y), f32(bs["mean"]), f32(bs["var"]), f32(dx), f32(dp["scale"]), f32(dp["bias"])


def _port_bn(x, scale, bias, x_dtype, norm_dtype):
    c = x.shape[-1]
    bn = BatchNorm(c, dtype=norm_dtype).train()
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.mean.fill_(0.3)
        bn.var.fill_(2.0)
    xt = torch.from_numpy(x).to(x_dtype).permute(0, 3, 1, 2).requires_grad_()  # channels_last
    y = bn(xt)
    y32 = y.float()
    (torch.sin(y32) * y32).sum().backward()
    nhwc = lambda t: t.detach().float().permute(0, 2, 3, 1).numpy()
    return (nhwc(y), bn.mean.numpy(), bn.var.numpy(), nhwc(xt.grad),
            bn.scale.grad.numpy(), bn.bias.grad.numpy())


@pytest.mark.parametrize("lane", ["auto", False])
@pytest.mark.parametrize("c", [16, 64, 24])
def test_train_batch_norm_matches_jax_f32(c, lane):
    """y, running statistics and gradients vs ``lane_bn.BatchNorm`` on its
    folded path (default) and its fallback (``lane=False``); C=24 takes the
    fallback on the JAX side either way."""
    import jax.numpy as jnp

    x, scale, bias = _bn_case(c, np.float32)
    ref = _jax_bn(x, scale, bias, jnp.float32, jnp.float32, lane)
    got = _port_bn(x, scale, bias, torch.float32, torch.float32)
    for g, r, name in zip(got, ref, ("y", "mean", "var", "dx", "dscale", "dbias")):
        scale_of = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5 * scale_of, err_msg=name)


def test_train_batch_norm_bf16_norm_takes_stats_from_the_raw_f32_input():
    """f32 input into a bf16 BatchNorm: statistics from the raw input upcast
    to f32 (1e-5), output one bf16 rounding of the f32 result."""
    import jax.numpy as jnp

    x, scale, bias = _bn_case(16, np.float32, seed=3)
    ref = _jax_bn(x, scale, bias, jnp.float32, jnp.bfloat16, "auto")
    got = _port_bn(x, scale, bias, torch.float32, torch.bfloat16)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[0], ref[0], rtol=1 / 128, atol=1e-2)   # one bf16 ulp


def test_train_batch_norm_bf16_input():
    """bf16 input and bf16 output: statistics in f32 from the bf16 values."""
    import jax.numpy as jnp

    x, scale, bias = _bn_case(64, np.float32, seed=5)
    ref = _jax_bn(x, scale, bias, jnp.bfloat16, jnp.bfloat16, "auto")
    got = _port_bn(x, scale, bias, torch.bfloat16, torch.bfloat16)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[0], ref[0], rtol=1 / 128, atol=2e-2)
    np.testing.assert_allclose(got[3], ref[3], rtol=1 / 64, atol=2e-2)    # dx in bf16
    np.testing.assert_allclose(got[4], ref[4], rtol=2e-3, atol=2e-2)
    np.testing.assert_allclose(got[5], ref[5], rtol=2e-3, atol=2e-2)


def test_running_statistics_take_the_biased_variance_and_no_gradient():
    x, scale, bias = _bn_case(8, np.float32, seed=7, shape=(2, 3, 3))
    bn = BatchNorm(8, dtype=torch.float32).train()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    bn(xt)
    flat = torch.from_numpy(x).reshape(-1, 8)
    torch.testing.assert_close(bn.mean, 0.1 * flat.mean(0), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(bn.var, 0.9 + 0.1 * flat.var(0, unbiased=False),
                               rtol=1e-5, atol=1e-6)
    assert not bn.mean.requires_grad and not bn.var.requires_grad
    y, mean, var = bn_train(xt.requires_grad_(), bn.scale, bn.bias, torch.float32)
    assert y.requires_grad and not mean.requires_grad and not var.requires_grad


def test_bn_train_gradients_match_finite_differences():
    """float64 through the plain versions: the hand-written backward of
    ``bn_train`` against finite differences."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 3, 3, dtype=torch.float64, generator=gen)
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_()
    scale = (torch.rand(5, dtype=torch.float64, generator=gen) + 0.5).requires_grad_()
    bias = torch.randn(5, dtype=torch.float64, generator=gen).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda x, s, b: bn_train(x, s, b, torch.float64)[0], (x, scale, bias),
        eps=1e-6, atol=1e-5)


def test_train_batch_norm_rejects_an_input_that_is_not_channels_last():
    bn = BatchNorm(4, dtype=torch.float32).train()
    with pytest.raises(ValueError, match="contiguous"):
        bn(torch.zeros(2, 4, 3, 3))


def test_eval_batch_norm_is_unchanged_by_train_support():
    bn = BatchNorm(4, dtype=torch.float32).eval()
    with torch.no_grad():
        bn.mean.fill_(0.5)
        bn.var.fill_(4.0)
    x = torch.ones(1, 4, 2, 2)
    torch.testing.assert_close(bn(x), torch.full_like(x, 0.5 / (4.0 + EPS) ** 0.5))
    assert torch.all(bn.mean == 0.5)


# ---------------------------------------------------------------------------
# the launch plan (grid and scratch sized to the data)
# ---------------------------------------------------------------------------
# BatchNorm inputs of the B=32 resnet34 U-Net train step at 512 px (NHWC)
TRAIN_STEP_SHAPES = [(32, 16, 16, 512), (32, 32, 32, 256), (32, 64, 64, 128),
                     (32, 128, 128, 64), (32, 256, 256, 32), (32, 256, 256, 64),
                     (32, 512, 512, 16)]
H100_SMS = 132
# the most clusters of 1, 2, 4, 8 blocks an H100 could run at one block per SM
H100_CLUSTERS = tuple(H100_SMS // k for k in CLUSTER_SIZES)


@pytest.mark.parametrize("shape", TRAIN_STEP_SHAPES)
@pytest.mark.parametrize("elts", [(2, 0), (4, 0), (2, 2), (4, 2)],
                         ids=["sums_bf16", "sums_f32", "dual_bf16", "dual_f32_bf16"])
def test_plan_sizes_grid_and_partials_to_the_train_step_shapes(shape, elts):
    """Every BatchNorm input of the step takes the bulk path in one wave at
    one block per SM, every row covered; the partial rows stay under 1% of
    the input bytes and the last block reads at most FOLD_BYTES of them."""
    m, c = int(np.prod(shape[:-1])), shape[-1]
    p = plan(m, c, *elts, True, H100_CLUSTERS, H100_SMS)
    assert p.cluster in CLUSTER_SIZES
    assert p.blocks % p.cluster == 0 and p.blocks <= H100_SMS
    assert p.partial_rows == p.blocks // p.cluster
    assert p.rows_per_block * p.blocks >= m > p.rows_per_block * (p.blocks - 1)
    input_bytes = m * c * sum(elts)
    assert p.partial_rows * 2 * c * 4 <= min(FOLD_BYTES, 0.01 * input_bytes)
    assert input_bytes // p.blocks >= MIN_BLOCK_BYTES
    # the inputs are large enough for every cluster the card runs at once
    assert p.partial_rows == H100_CLUSTERS[CLUSTER_SIZES.index(p.cluster)]


def test_plan_takes_the_smallest_cluster_that_keeps_the_fold_small():
    """Few channels: no cluster, all 132 SMs; 512 channels: clusters of 8."""
    clusters = {c: plan(32 * 16 * 16 * 512 // c, c, 2, 0, True, H100_CLUSTERS,
                        H100_SMS).cluster for c in (16, 32, 64, 128, 256, 512)}
    assert clusters == {16: 1, 32: 1, 64: 2, 128: 4, 256: 8, 512: 8}
    # a card that cannot run a cluster size falls back to the next one
    assert plan(1 << 20, 16, 2, 0, True, (0, 66, 33, 16), H100_SMS).cluster == 2


# BatchNorm inputs of the B=32 mobilenet_v2 U-Net train step at 512 px whose
# rows are not a power of two of 16-byte vectors in bf16 (NHWC shape:
# BatchNorms; 42 of its 62), and DeepLabV3Plus's low_project at resnet34
MOBILENET_UNET_SHAPES = {(32, 128, 128, 24): 2, (32, 256, 256, 96): 1, (32, 128, 128, 96): 1,
                         (32, 32, 32, 96): 3, (32, 128, 128, 144): 3, (32, 64, 64, 144): 1,
                         (32, 16, 16, 160): 3, (32, 64, 64, 192): 5, (32, 32, 32, 192): 1,
                         (32, 16, 16, 320): 1, (32, 32, 32, 384): 8, (32, 32, 32, 576): 5,
                         (32, 16, 16, 576): 1, (32, 16, 16, 960): 6, (32, 16, 16, 1280): 1}
DEEPLAB_LOW_PROJECT_SHAPE = (32, 128, 128, 48)
WIDENED_SHAPES = sorted(MOBILENET_UNET_SHAPES) + [DEEPLAB_LOW_PROJECT_SHAPE]


def _assert_bulk_plan(p, m, c, elts):
    """A bulk plan of one wave whose rows cover the input, and a consumer
    count that keeps each thread on one channel group."""
    g = c * max(elts) // 16
    assert p.cluster in CLUSTER_SIZES
    assert p.blocks % p.cluster == 0 and p.blocks <= H100_SMS
    assert p.partial_rows == p.blocks // p.cluster
    assert p.rows_per_block * p.blocks >= m
    t = bulk_consumers(g)
    assert t % g == 0 and g <= t <= THREADS and THREADS - t < g


@pytest.mark.parametrize("shape", WIDENED_SHAPES,
                         ids=["x".join(map(str, s)) for s in WIDENED_SHAPES])
@pytest.mark.parametrize("elts", [(2, 0), (2, 2)], ids=["sums_bf16", "dual_bf16"])
def test_plan_sends_the_mobilenet_and_deeplab_inputs_to_the_bulk_path(shape, elts):
    """Rows of 3 to 160 vectors (C = 24 .. 1280 in bf16) take the bulk path;
    the partial rows stay under 1% of the input bytes and the last block
    reads at most FOLD_BYTES of them, as at the resnet34 step's shapes."""
    m, c = int(np.prod(shape[:-1])), shape[-1]
    p = plan(m, c, *elts, True, H100_CLUSTERS, H100_SMS)
    _assert_bulk_plan(p, m, c, elts)
    input_bytes = m * c * sum(elts)
    assert p.partial_rows * 2 * c * 4 <= min(FOLD_BYTES, 0.01 * input_bytes)
    assert input_bytes // p.blocks >= MIN_BLOCK_BYTES


@pytest.mark.parametrize("name,encoder,widened", [
    ("Unet", "mobilenet_v2", 42), ("DeepLabV3Plus", "resnet34", 1)])
def test_plan_sends_every_bf16_batch_norm_input_of_the_model_to_the_bulk_path(
        name, encoder, widened):
    """Each train-mode BatchNorm input of the model (its module tree, one
    forward at 64 px) takes the bulk path in bf16, forward and dual; the
    rows that hold no power of two of vectors are the census above."""
    import collections

    from uda_aerial_semantic_segmentation_research_tpu_torch.models import create_model

    model = create_model(name, encoder, encoder_weights=None, classes=3, seed=0,
                         dtype=torch.float32, device="cpu").train()
    channels = []
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.register_forward_pre_hook(lambda mod, inp: channels.append(inp[0].shape[1]))
    with torch.no_grad():
        model(torch.zeros(1, 64, 64, 3))
    assert len(channels) == sum(isinstance(m, BatchNorm) for m in model.modules())
    for c in channels:
        for elts in ((2, 0), (2, 2)):
            assert plan(4096, c, *elts, True, H100_CLUSTERS, H100_SMS).cluster > 0, c
    odd = collections.Counter(c for c in channels if THREADS % (c // 8))
    census = collections.Counter()
    for shape, n in MOBILENET_UNET_SHAPES.items() if name == "Unet" else [
            (DEEPLAB_LOW_PROJECT_SHAPE, 1)]:
        census[shape[-1]] += n
    assert odd == census and sum(odd.values()) == widened


@pytest.mark.parametrize("case", [
    dict(m=6, c=24, elts=(2, 0)),         # bf16 row of 48 bytes: 3 vectors
    dict(m=6, c=48, elts=(4, 0)),         # 12 vectors a row: no power of two
    dict(m=6, c=24, elts=(2, 4)),         # bf16 rows of 48, f32 of 96 bytes: 6 vectors
    dict(m=1, c=8, elts=(2, 2)),          # one vector a row
    dict(m=9, c=1280, elts=(2, 0)),       # 160 vectors: 160 consumers
    dict(m=9, c=2048, elts=(2, 2)),       # 256 vectors, the most
    dict(m=9, c=1024, elts=(4, 2)),       # 256 vectors of the f32 operand
    dict(m=100000, c=40, elts=(2, 2)),    # 5 vectors, many rows
], ids=["c24_bf16", "c48_f32", "mixed_c24", "c8_bf16", "c1280_bf16", "c2048_bf16",
        "mixed_c1024", "c40_many_rows"])
def test_plan_takes_any_row_of_up_to_256_vectors_on_the_bulk_path(case):
    p = plan(case["m"], case["c"], *case["elts"], True, H100_CLUSTERS, H100_SMS)
    _assert_bulk_plan(p, case["m"], case["c"], case["elts"])


@pytest.mark.parametrize("case", [
    dict(m=6, c=12, elts=(4, 2), aligned=True),       # f32 rows of 48, bf16 of 24 bytes
    dict(m=6, c=16, elts=(4, 0), aligned=False),      # a view 4 bytes off
    dict(m=6, c=24, elts=(2, 2), aligned=False),      # a bf16 view 2 bytes off
    dict(m=6, c=20, elts=(2, 0), aligned=True),       # bf16 row of 40 bytes
    dict(m=6, c=4096, elts=(2, 0), aligned=True),     # 512 vectors a row > 256 threads
    dict(m=6, c=1028, elts=(4, 0), aligned=True),     # 257 vectors a row
    dict(m=6, c=2050, elts=(4, 0), aligned=True),     # f32 row of 8200 bytes
    dict(m=100000, c=3, elts=(4, 4), aligned=True),
], ids=["mixed_c12", "unaligned", "unaligned_bf16", "c20_bf16", "c4096_bf16", "c1028_f32",
        "c2050_f32", "c3_many_rows"])
def test_plan_sends_what_the_bulk_kernel_cannot_take_to_the_generic_path(case):
    p = plan(case["m"], case["c"], *case["elts"], case["aligned"], H100_CLUSTERS, H100_SMS)
    assert p.cluster == 0
    assert p.partial_rows == p.blocks <= H100_SMS
    assert p.rows_per_block * p.blocks >= case["m"]
    assert p.blocks == 1 or p.rows_per_block >= GENERIC_MIN_ROWS


# vectors a row of every class the bulk path takes: the powers of two, and
# the mobilenet_v2 / DeepLabV3Plus rows in bf16 (C / 8)
VECTOR_CLASSES = [1, 2, 4, 8, 16, 32, 64, 128, 256, 3, 6, 12, 18, 20, 24, 40, 48, 72, 120, 160]


@pytest.mark.parametrize("g", VECTOR_CLASSES)
def test_bulk_consumer_layout_reads_each_vector_once_on_one_channel_group(g):
    """A numpy model of the bulk kernel's consumer loop and epilogue: over
    stages of ``STAGE_BYTES / (16 g)`` rows (and a ragged last one), consumer
    t reads vectors t, t + T', ... of each stage; every vector is read
    exactly once, each consumer's channel group (vector index mod g) never
    changes, and the epilogue's holders (after the shuffles where g is a
    power of two below 32) count every consumer of a group exactly once."""
    t_prime = bulk_consumers(g)
    stage_rows = 32768 // (16 * g)
    group_of = np.full(THREADS, -1)
    for rows in (stage_rows, max(1, stage_rows // 3)):       # a full and a ragged stage
        n_vec = rows * g
        reads = np.zeros(n_vec, dtype=int)
        for t in range(THREADS):
            if t >= t_prime:
                continue                                    # loads nothing
            v = np.arange(t, n_vec, t_prime)
            reads[v] += 1
            if v.size:
                assert np.all(v % g == v[0] % g)
                assert group_of[t] in (-1, v[0] % g)
                group_of[t] = v[0] % g
        assert np.all(reads == 1)
    consumers = np.arange(t_prime)
    # whose sums each thread holds after the shuffle fold
    held = [{t} for t in range(THREADS)]
    shuffled = g < 32 and t_prime == THREADS
    if shuffled:
        off = 16
        while off >= g:
            held = [held[t] | held[t ^ off] if t // 32 == (t ^ off) // 32 else None
                    for t in range(THREADS)]
            off //= 2
    step = 32 if shuffled else g
    for grp in range(g):
        holders = range(grp, t_prime, step)
        counted = [t for h in holders for t in held[h]]
        assert sorted(counted) == list(consumers[consumers % g == grp])


def test_plan_shrinks_the_grid_for_small_inputs():
    """One block for a tiny input (M=1), more as the input grows, never more
    than the card runs at once."""
    assert plan(1, 16, 2, 0, True, H100_CLUSTERS, H100_SMS) == (1, 1, 1, 1)
    sizes = [plan(m, 64, 2, 0, True, H100_CLUSTERS, H100_SMS).blocks
             for m in (1, 4096, 16384, 65536, 1 << 20)]
    assert sizes == sorted(sizes) and sizes[0] == 2 and sizes[-1] == H100_SMS


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------
def _assert_sums_close(got, ref, terms):
    """|got - ref| <= 1e-5 * sum|terms| per channel (f32 sums, other order)."""
    bound = 1e-5 * terms + 1e-6
    assert torch.all((got - ref).abs() <= bound), (got - ref).abs().max().item()


def _check_on_gpu(gen, shape, dt_x, dt_dy):
    """Kernel vs float64 sums, two launches bit-identical, one count each."""
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dt_x)
    dy = torch.randn(shape, generator=gen, device="cuda").to(dt_dy)
    before = channel_sums.launches, channel_dual_sums.launches
    got = channel_sums(x)
    got_dual = channel_dual_sums(dy, x)
    again, dual_again = channel_sums(x), channel_dual_sums(dy, x)
    torch.cuda.synchronize()
    assert channel_sums.launches == before[0] + 2
    assert channel_dual_sums.launches == before[1] + 2
    assert torch.equal(got, again) and torch.equal(got_dual, dual_again)   # deterministic
    x64, dy64 = x.double().reshape(-1, shape[-1]), dy.double().reshape(-1, shape[-1])
    _assert_sums_close(got[0], x64.sum(0).float(), x64.abs().sum(0).float())
    _assert_sums_close(got[1], (x64 * x64).sum(0).float(), (x64 * x64).sum(0).float())
    _assert_sums_close(got_dual[0], dy64.sum(0).float(), dy64.abs().sum(0).float())
    _assert_sums_close(got_dual[1], (dy64 * x64).sum(0).float(),
                       (dy64 * x64).abs().sum(0).float())


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    # the bulk path (C=16..512, M=1, ragged rows; rows of 3 to 160 vectors:
    # C = 24 .. 1280 in bf16, 12 .. 640 in f32, with many rows at 3 and
    # 160) and the generic one (C=3, 1000, 4096; f32 above C=1024), all four
    # dtype pairs
    shapes = [(2, 16, 16, 16), (3, 7, 5, 16), (2, 8, 8, 64), (1, 4, 4, 512), (5, 3, 2048),
              (3, 7, 5, 24), (4, 9, 3), (2, 1000), (1, 1, 1, 8), (70000, 32), (1, 16),
              (1, 24), (1, 512), (7, 48), (9, 4096), (5, 9, 96), (2, 3, 11, 144),
              (4, 5, 160), (3, 4, 192), (2, 5, 320), (1, 3, 7, 384), (2, 6, 576), (3, 960),
              (2, 5, 1280), (70001, 24), (1000, 1280), (20, 40, 40)]
    for shape in shapes:
        for dt_x, dt_dy in ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                            (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)):
            _check_on_gpu(gen, shape, dt_x, dt_dy)
    # every BatchNorm input of the B=32 train step in bf16, one in f32, and
    # the mixed dual form at one; the mobilenet_v2 U-Net's and DeepLabV3Plus's
    # bulk-path inputs of the new row classes at B=4
    for shape in TRAIN_STEP_SHAPES:
        _check_on_gpu(gen, shape, torch.bfloat16, torch.bfloat16)
    for shape in WIDENED_SHAPES:
        _check_on_gpu(gen, (4, *shape[1:]), torch.bfloat16, torch.bfloat16)
    _check_on_gpu(gen, (32, 128, 128, 64), torch.float32, torch.float32)
    _check_on_gpu(gen, (32, 64, 64, 128), torch.bfloat16, torch.float32)
    # unaligned views (f32 4 bytes off, bf16 2 bytes off) take the generic
    # path and still agree
    base = torch.randn(4 * 33 * 16 + 1, generator=gen, device="cuda")
    for view in (base[1:].view(4, 33, 16), base.bfloat16()[1:].view(4, 33, 16)):
        _assert_sums_close(channel_sums(view)[0], view.double().sum((0, 1)).float(),
                           view.double().abs().sum((0, 1)).float())
    with pytest.raises(ValueError):
        channel_sums(torch.zeros(2, 8, 4, 4, device="cuda").permute(0, 2, 3, 1))
    with pytest.raises(TypeError):
        channel_sums(torch.zeros(4, 8, device="cuda", dtype=torch.float16))


@pytest.mark.gpu
def test_kernels_rearm_their_counter_and_keep_streams_apart_on_gpu():
    """1,000 calls in a row give the same bits (the last block re-arms the
    ticket counter), and calls on two streams at once (one counter each)
    agree with the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(32, 32, 32, 256, generator=gen, device="cuda").bfloat16()
    dy = torch.randn(32, 32, 32, 256, generator=gen, device="cuda").bfloat16()
    first, first_dual = channel_sums(x), channel_dual_sums(dy, x)
    runs = [(channel_sums(x), channel_dual_sums(dy, x)) for _ in range(500)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, first) and torch.equal(b, first_dual) for a, b in runs)
    x2 = torch.randn(8, 64, 64, 128, generator=gen, device="cuda").bfloat16()
    streams = [torch.cuda.Stream() for _ in range(2)]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(50):
        with torch.cuda.stream(streams[0]):
            outs[0].append(channel_sums(x))
        with torch.cuda.stream(streams[1]):
            outs[1].append(channel_dual_sums(x2, x2))
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[0][0]) for o in outs[0])
    assert all(torch.equal(o, outs[1][0]) for o in outs[1])
    torch.testing.assert_close(outs[0][0], channel_sums_reference(x), rtol=1e-5, atol=1e-2)
    torch.testing.assert_close(outs[1][0], channel_dual_sums_reference(x2, x2),
                               rtol=1e-5, atol=1e-2)


@pytest.mark.gpu
def test_train_batch_norm_on_gpu_matches_cpu():
    """bn_train on the card (kernels) vs on the CPU (plain versions), f32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, scale, bias = _bn_case(32, np.float32, shape=(4, 16, 16))
    outs = {}
    for dev in ("cpu", "cuda"):
        xt = torch.from_numpy(x).to(dev).permute(0, 3, 1, 2).requires_grad_()
        s = torch.from_numpy(scale).to(dev).requires_grad_()
        b = torch.from_numpy(bias).to(dev).requires_grad_()
        y, mean, var = bn_train(xt, s, b, torch.float32)
        (torch.sin(y) * y).sum().backward()
        outs[dev] = [t.detach().cpu() for t in (y, mean, var, xt.grad, s.grad, b.grad)]
    for got, ref in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
