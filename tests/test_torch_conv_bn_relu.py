"""The conv_bn_relu kernel's plain version against the JAX Pallas kernel,
and the wrapper's routing.

``conv_bn_relu_reference`` is held against the JAX package's
``ops/pallas_conv.py::packed_conv_bn_relu`` in interpret mode, at the
shapes of tests/test_pallas.py, with tolerance 1e-4 for y and 1e-3 for
the moments (float32, sums in another order).  The CUDA kernel itself
runs only on the card: ``test_kernel_matches_reference_on_gpu`` holds it
against the plain version there and skips on a host without CUDA.

JAX is imported inside the tests that need it, so the GPU test runs on a
machine without JAX: ``python -m pytest --noconftest -m gpu
tests/test_torch_conv_bn_relu.py``.
"""

import numpy as np
import pytest
import torch

from uda_aerial_semantic_segmentation_research_tpu_torch.ops.conv_bn_relu import (
    conv_bn_relu,
    conv_bn_relu_reference,
)

RNG_SEED = 0


def _inputs(b, s, ci, co, seed=RNG_SEED, w=None):
    rng = np.random.default_rng(seed)
    w = s if w is None else w
    x = rng.normal(size=(b, s, w, ci)).astype(np.float32)
    k3 = (0.1 * rng.normal(size=(3, 3, ci, co))).astype(np.float32)
    scale = (1.0 + 0.1 * rng.normal(size=(ci,))).astype(np.float32)
    shift = (0.1 * rng.normal(size=(ci,))).astype(np.float32)
    return x, k3, scale, shift


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_reference_matches_pallas_affine_moments():
    import jax.numpy as jnp

    from uda_aerial_semantic_segmentation_research_tpu.ops.pallas_conv import (
        packed_conv_bn_relu,
    )

    x, k3, scale, shift = _inputs(2, 16, 8, 8)
    y_j, (s_j, ss_j) = packed_conv_bn_relu(
        jnp.asarray(x), jnp.asarray(k3), jnp.asarray(scale), jnp.asarray(shift),
        moments=True, interpret=True)
    y, m = conv_bn_relu_reference(*_t(x, k3, scale, shift), moments=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(m[0].numpy(), np.asarray(s_j), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(m[1].numpy(), np.asarray(ss_j), atol=1e-3, rtol=1e-3)


def test_reference_matches_pallas_no_affine():
    import jax.numpy as jnp

    from uda_aerial_semantic_segmentation_research_tpu.ops.pallas_conv import (
        packed_conv_bn_relu,
    )

    x, k3, _, _ = _inputs(1, 8, 4, 4)
    y_j = packed_conv_bn_relu(jnp.asarray(x), jnp.asarray(k3), interpret=True)
    y = conv_bn_relu_reference(*_t(x, k3))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=1e-4, rtol=1e-4)


def test_reference_zero_and_negative_scale_pads_with_zeros():
    """Zero and negative scales: the pad ring is zero AFTER the ReLU
    (JAX conv-SAME on the post-ReLU activation)."""
    import jax
    import jax.numpy as jnp

    x, k3, scale, shift = _inputs(2, 10, 6, 5, w=14)
    scale[0], scale[1], shift[0] = 0.0, -0.7, 0.3
    act = jnp.maximum(jnp.asarray(x) * scale + shift, 0.0)
    ref = jax.lax.conv_general_dilated(act, jnp.asarray(k3), (1, 1), "SAME",
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"))
    y = conv_bn_relu_reference(*_t(x, k3, scale, shift))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_reference_bf16_rounds_activation_and_weights():
    x, k3, scale, shift = _inputs(1, 8, 4, 4, seed=1)
    xb = torch.from_numpy(x).bfloat16()
    y, m = conv_bn_relu_reference(xb, *_t(k3, scale, shift), moments=True)
    assert y.dtype == torch.bfloat16 and m.dtype == torch.float32
    act = torch.relu(xb.float() * torch.from_numpy(scale) + torch.from_numpy(shift))
    act = act.bfloat16().float().permute(0, 3, 1, 2)
    w = torch.from_numpy(k3).bfloat16().float().permute(3, 2, 0, 1)
    y32 = torch.nn.functional.conv2d(act, w, padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(y, y32.bfloat16(), atol=0, rtol=0)
    torch.testing.assert_close(m[0], y32.sum((0, 1, 2)), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("moments", [False, True])
def test_cpu_wrapper_routes_to_reference(moments):
    x, k3, scale, shift = _t(*_inputs(2, 8, 8, 8))
    before = conv_bn_relu.launches
    out = conv_bn_relu(x, k3, scale, shift, moments=moments)
    ref = conv_bn_relu_reference(x, k3, scale, shift, moments=moments)
    assert conv_bn_relu.launches == before
    if moments:
        torch.testing.assert_close(out[0], ref[0], atol=0, rtol=0)
        torch.testing.assert_close(out[1], ref[1], atol=0, rtol=0)
    else:
        torch.testing.assert_close(out, ref, atol=0, rtol=0)


@pytest.mark.parametrize("bad", ["k3_shape", "scale_only", "scale_shape",
                                 "meta_device", "rank"])
def test_wrapper_rejects_what_it_cannot_take(bad):
    x, k3, scale, shift = _t(*_inputs(1, 4, 4, 4))
    args = dict(x=x, k3=k3, scale=scale, shift=shift)
    if bad == "k3_shape":
        args["k3"] = torch.zeros(3, 3, 5, 4)
    elif bad == "scale_only":
        args["shift"] = None
    elif bad == "scale_shape":
        args["scale"] = torch.ones(3)
    elif bad == "meta_device":
        args = {k: v.to("meta") for k, v in args.items()}
    else:
        args["x"] = x[0]
    with pytest.raises(ValueError):
        conv_bn_relu(args["x"], args["k3"], args["scale"], args["shift"])


def test_build_without_nvcc_raises(monkeypatch):
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


def test_library_hash_covers_headers_and_flags(monkeypatch, tmp_path):
    """An edited header or nvcc flag gives another library file name, so a
    stale build is never loaded."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops import _build

    src = tmp_path / "k.cu"
    src.write_text("// kernel")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    first = _build._digest(src)
    assert _build._digest(src) == first
    (tmp_path / "common.cuh").write_text("// header")
    with_header = _build._digest(src)
    (tmp_path / "common.cuh").write_text("// header, edited")
    edited = _build._digest(src)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-lineinfo"])
    flagged = _build._digest(src)
    assert len({first, with_header, edited, flagged}) == 4


# (B, H, W, Cin, Cout) on the card.  The bfloat16 kernel tiles 8 x 32 output
# pixels and pads K = Cin to 16 or 32 and N = Cout to a multiple of 8: Cin 3
# and 24 and Cout 20 are padded; W = 50, 9, 100 and 70 are not multiples of 32;
# H = 7, 33, 18 and 9 are no multiples of 8 (7, 33 and 9 odd); B=1 at both serving
# shapes.
GPU_CASES = [(2, 16, 16, 8, 8), (2, 18, 50, 24, 20), (1, 32, 64, 32, 32),
             (3, 7, 9, 3, 16), (2, 33, 100, 16, 16), (1, 9, 70, 32, 8),
             (1, 256, 256, 32, 32), (1, 512, 512, 16, 16)]


def _gpu_inputs(case, dtype, affine):
    b, h, w, ci, co = case
    x, k3, scale, shift = _inputs(b, h, ci, co, w=w)
    # zero and negative BN scale; a zero scale with a positive shift makes
    # the activation relu(shift) > 0 inside the image, which must not leak
    # into the pad ring
    scale[0], scale[-1], shift[0] = 0.0, -0.5, 0.3
    xt, kt, st, sh = (t.cuda() for t in _t(x, k3, scale, shift))
    return (xt.to(dtype), kt) + ((st, sh) if affine else (None, None))


@pytest.mark.gpu
def test_kernel_matches_reference_on_gpu():
    """The CUDA kernels vs their plain version on the card (f32 with TF32
    off: 1e-4; bf16: 1e-2, one bf16 ulp; moments: 1e-3 * sum|y|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for case in GPU_CASES:
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            for affine in (True, False):
                xt, kt, st, sh = _gpu_inputs(case, dtype, affine)
                before = conv_bn_relu.launches
                y, m = conv_bn_relu(xt, kt, st, sh, moments=True)
                torch.cuda.synchronize()
                assert conv_bn_relu.launches == before + 1
                yr, mr = conv_bn_relu_reference(xt, kt, st, sh, moments=True)
                torch.testing.assert_close(y.float(), yr.float(), atol=tol, rtol=tol,
                                           msg=lambda m: f"{case} {dtype} {affine}: {m}")
                bound = 1e-3 * yr.float().abs().sum((0, 1, 2))
                assert torch.all((m - mr).abs() <= bound + 1e-6), (case, dtype, affine)
    # x 2 bytes off a 16-byte boundary: no TMA, the per-element halo load
    xt, kt, st, sh = _gpu_inputs((2, 20, 40, 32, 32), torch.bfloat16, True)
    xo = torch.empty(xt.numel() + 1, dtype=xt.dtype, device="cuda")[1:].view(xt.shape)
    xo.copy_(xt)
    assert xo.is_contiguous() and xo.data_ptr() % 16 != 0
    y, m = conv_bn_relu(xo, kt, st, sh, moments=True)
    yr, mr = conv_bn_relu_reference(xt, kt, st, sh, moments=True)
    torch.testing.assert_close(y.float(), yr.float(), atol=1e-2, rtol=1e-2)
    assert torch.all((m - mr).abs() <= 1e-3 * yr.float().abs().sum((0, 1, 2)) + 1e-6)


@pytest.mark.gpu
def test_kernel_is_deterministic_on_gpu():
    """Two launches with moments give the same bits: per-block partials
    folded in a fixed order, no float atomics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for case in [(2, 18, 50, 24, 20), (4, 256, 256, 32, 32), (2, 512, 512, 16, 16)]:
        for dtype in (torch.float32, torch.bfloat16):
            xt, kt, st, sh = _gpu_inputs(case, dtype, True)
            y1, m1 = conv_bn_relu(xt, kt, st, sh, moments=True)
            y2, m2 = conv_bn_relu(xt, kt, st, sh, moments=True)
            torch.cuda.synchronize()
            assert torch.equal(y1, y2) and torch.equal(m1, m2), (case, dtype)
