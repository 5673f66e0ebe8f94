"""The port's cross-entropy (plain and fused) and metrics against the JAX
package (CPU), and the fused CUDA kernels against their plain versions
(card).

Tolerances: losses and gradients 1e-5 (float32, sums in another order; the
gradient entries are ~1/N so their comparison is relative); confusion
matrices exact; IoU and accuracy 1e-6.  The JAX ``fused_cross_entropy`` runs
its Pallas kernels in interpret mode off the TPU by itself.

JAX is imported inside the tests that need it, so the GPU test runs on a
machine without JAX: ``python -m pytest --noconftest -m gpu
tests/test_torch_fused_ce.py``.
"""

import numpy as np
import pytest
import torch

from uda_aerial_semantic_segmentation_research_tpu_torch.ops.fused_ce import (
    fused_cross_entropy,
    fused_cross_entropy_grad_reference,
    fused_cross_entropy_reference,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.losses import (
    softmax_cross_entropy,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.metrics import (
    accuracy_from_hist,
    confusion_matrix,
    iou_from_hist,
)

TOL = 1e-5
CLASSES = 7


def _case(shape=(2, 24, 24), c=CLASSES, seed=0):
    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.normal(size=shape + (c,))).astype(np.float32)
    labels = rng.integers(0, c, shape).astype(np.int32)
    return logits, labels


# ---------------------------------------------------------------------------
# softmax_cross_entropy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_softmax_cross_entropy_matches_jax(reduction, weights):
    import jax
    import jax.numpy as jnp

    from uda_aerial_semantic_segmentation_research_tpu.ops.losses import (
        softmax_cross_entropy as jax_ce,
    )

    logits, labels = _case()
    w = np.linspace(0.5, 2.0, CLASSES).astype(np.float32) if weights else None
    ref = jax_ce(jnp.asarray(logits), jnp.asarray(labels), w, reduction)
    x = torch.from_numpy(logits).requires_grad_()
    got = softmax_cross_entropy(x, torch.from_numpy(labels), w, reduction)
    scale = max(1.0, float(np.abs(np.asarray(ref)).max()))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL * scale)
    g_ref = jax.grad(lambda x: jnp.sum(jax_ce(x, jnp.asarray(labels), w, reduction)))(
        jnp.asarray(logits))
    got.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_ref), rtol=TOL,
                               atol=TOL * float(np.abs(np.asarray(g_ref)).max()))


def test_softmax_cross_entropy_label_outside_the_classes_costs_nothing():
    import jax.numpy as jnp

    from uda_aerial_semantic_segmentation_research_tpu.ops.losses import (
        softmax_cross_entropy as jax_ce,
    )

    logits, labels = _case((3, 5))
    labels[0, 0], labels[1, 2] = -1, CLASSES
    ref = jax_ce(jnp.asarray(logits), jnp.asarray(labels), None, "none")
    got = softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                reduction="none")
    assert got[0, 0] == 0 and got[1, 2] == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("ignore", [255, -1, -9])
def test_weighted_cross_entropy_indexes_the_weights_like_jax(ignore):
    """A label outside [0, C) with class weights: JAX's ``w[labels]`` counts
    a negative label from the end and clamps the index, so the pixel adds a
    zero loss and a weight to the divisor; the port does the same instead
    of raising.  Pinned: C=5, one label 255, JAX gives 1.9137."""
    import jax.numpy as jnp

    from uda_aerial_semantic_segmentation_research_tpu.ops.losses import (
        softmax_cross_entropy as jax_ce,
    )

    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 4, 4, 5)).astype(np.float32)
    labels = rng.integers(0, 5, (2, 4, 4)).astype(np.int32)
    labels[0, 0, 0] = ignore
    w = np.arange(1, 6).astype(np.float32)
    ref = float(jax_ce(jnp.asarray(logits), jnp.asarray(labels), w))
    got = softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), w).item()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    if ignore == 255:
        np.testing.assert_allclose(got, 1.9137, atol=5e-5)
    per_pixel = softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), w,
                                      reduction="none")
    assert per_pixel[0, 0, 0] == 0


def test_softmax_cross_entropy_accumulates_bf16_logits_in_f32():
    logits, labels = _case()
    xb = torch.from_numpy(logits).bfloat16()
    got = softmax_cross_entropy(xb, torch.from_numpy(labels).to(torch.uint8))
    assert got.dtype == torch.float32
    ref = softmax_cross_entropy(xb.float(), torch.from_numpy(labels))
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# fused_cross_entropy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(2, 24, 24), (3000,), (4096,), (1, 16, 16)])
def test_fused_cross_entropy_matches_jax(shape):
    """Value and dlogits vs the JAX kernel pair (interpret mode) and vs the
    JAX ``softmax_cross_entropy``; N = 3000 is no multiple of the TPU
    kernel's 4096-column tile."""
    import jax
    import jax.numpy as jnp

    from uda_aerial_semantic_segmentation_research_tpu.ops.losses import (
        softmax_cross_entropy as jax_ce,
    )
    from uda_aerial_semantic_segmentation_research_tpu.ops.pallas_ops import (
        fused_cross_entropy as jax_fused_ce,
    )

    logits, labels = _case(shape)
    lj, yj = jnp.asarray(logits), jnp.asarray(labels)
    ref, g_ref = jax.value_and_grad(lambda x: 2.0 * jax_fused_ce(x, yj))(lj)
    x = torch.from_numpy(logits).requires_grad_()
    got = 2.0 * fused_cross_entropy(x, torch.from_numpy(labels))
    got.backward()
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(ref), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.item(), 2.0 * float(jax_ce(lj, yj)), rtol=TOL, atol=TOL)
    g_ref = np.asarray(g_ref)
    assert x.grad.dtype == torch.float32 and tuple(x.grad.shape) == logits.shape
    np.testing.assert_allclose(x.grad.numpy(), g_ref, rtol=TOL,
                               atol=TOL * float(np.abs(g_ref).max()))


def test_fused_cross_entropy_label_minus_one_adds_its_logsumexp():
    """A label outside [0, C) has an all-zero one-hot, as in the JAX kernel:
    the pixel adds its logsumexp and gets the plain softmax as gradient."""
    import jax
    import jax.numpy as jnp

    from uda_aerial_semantic_segmentation_research_tpu.ops.pallas_ops import (
        fused_cross_entropy as jax_fused_ce,
    )

    logits, labels = _case((500,))
    labels[::7] = -1
    labels[3] = CLASSES
    ref, g_ref = jax.value_and_grad(lambda x: jax_fused_ce(x, jnp.asarray(labels)))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = fused_cross_entropy(x, torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=TOL, atol=TOL)
    g_ref = np.asarray(g_ref)
    np.testing.assert_allclose(x.grad.numpy(), g_ref, rtol=TOL,
                               atol=TOL * float(np.abs(g_ref).max()))
    np.testing.assert_allclose(x.grad[0].numpy() * 500,
                               torch.softmax(torch.from_numpy(logits[0]), -1).numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("label_dtype", [torch.uint8, torch.int32, torch.int64])
def test_fused_cross_entropy_label_types_and_bf16(label_dtype):
    logits, labels = _case()
    lt = torch.from_numpy(labels).to(label_dtype)
    ref = fused_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    torch.testing.assert_close(fused_cross_entropy(torch.from_numpy(logits), lt), ref,
                               rtol=0, atol=0)
    xb = torch.from_numpy(logits).bfloat16().requires_grad_()
    loss = fused_cross_entropy(xb, lt)
    loss.backward()
    assert loss.dtype == torch.float32 and xb.grad.dtype == torch.bfloat16
    torch.testing.assert_close(loss, fused_cross_entropy(xb.detach().float(), lt),
                               rtol=0, atol=0)


def test_fused_cross_entropy_gradient_matches_finite_differences():
    """float64 through the plain versions: the hand-written backward of the
    ``autograd.Function`` against finite differences."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(6, 5, dtype=torch.float64, generator=gen).requires_grad_()
    labels = torch.tensor([0, 4, 2, -1, 1, 3])
    assert torch.autograd.gradcheck(lambda x: fused_cross_entropy(x, labels), (x,),
                                    eps=1e-6, atol=1e-6)


def test_cpu_wrapper_routes_to_the_plain_versions():
    logits, labels = (torch.from_numpy(a) for a in _case())
    before = fused_cross_entropy.launches
    x = logits.clone().requires_grad_()
    loss = fused_cross_entropy(x, labels)
    loss.backward()
    assert torch.equal(loss.detach(), fused_cross_entropy_reference(logits, labels))
    assert torch.equal(x.grad, fused_cross_entropy_grad_reference(logits, labels,
                                                                  torch.ones(())))
    assert fused_cross_entropy.launches == before


@pytest.mark.parametrize("bad", ["labels_shape", "float_labels", "empty", "meta_device"])
def test_fused_cross_entropy_rejects_what_it_cannot_take(bad):
    logits, labels = (torch.from_numpy(a) for a in _case((4, 4)))
    error = ValueError
    if bad == "labels_shape":
        labels = labels[:3]
    elif bad == "float_labels":
        labels, error = labels.float(), TypeError
    elif bad == "empty":
        logits, labels = logits[:0], labels[:0]
    else:
        logits, labels = logits.to("meta"), labels.to("meta")
    with pytest.raises(error):
        fused_cross_entropy(logits, labels)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ignore_index", [None, 2])
def test_confusion_matrix_and_scores_match_jax(ignore_index):
    import jax.numpy as jnp

    from uda_aerial_semantic_segmentation_research_tpu.ops import metrics as jax_metrics

    rng = np.random.default_rng(0)
    pred = rng.integers(0, CLASSES, (3, 17, 19)).astype(np.int32)
    true = rng.integers(-1, CLASSES + 2, (3, 17, 19)).astype(np.int32)   # out-of-range too
    ref = jax_metrics.confusion_matrix(jnp.asarray(pred), jnp.asarray(true), CLASSES,
                                       ignore_index)
    got = confusion_matrix(torch.from_numpy(pred), torch.from_numpy(true), CLASSES,
                           ignore_index)
    assert got.dtype == torch.int32 and tuple(got.shape) == (CLASSES, CLASSES)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    kept = (true >= 0) & (true < CLASSES) & (true != (-5 if ignore_index is None
                                                       else ignore_index))
    assert got.sum().item() == kept.sum()
    assert got[1, 3].item() == ((true == 1) & (pred == 3)).sum()       # rows = true

    iou_ref, miou_ref = jax_metrics.iou_from_hist(ref)
    iou, miou = iou_from_hist(got)
    np.testing.assert_allclose(iou.numpy(), np.asarray(iou_ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(miou.item(), float(miou_ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(accuracy_from_hist(got).item(),
                               float(jax_metrics.accuracy_from_hist(ref)),
                               rtol=1e-6, atol=1e-6)


def test_confusion_matrix_takes_uint8_masks_and_absent_classes():
    import jax.numpy as jnp

    from uda_aerial_semantic_segmentation_research_tpu.ops import metrics as jax_metrics

    pred = np.asarray([0, 0, 1, 1, 5], np.int64)
    true = np.asarray([0, 1, 1, 1, 5], np.uint8)
    got = confusion_matrix(torch.from_numpy(pred), torch.from_numpy(true), CLASSES)
    ref = jax_metrics.confusion_matrix(jnp.asarray(pred), jnp.asarray(true), CLASSES)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    iou, miou = iou_from_hist(got)
    iou_ref, miou_ref = jax_metrics.iou_from_hist(ref)
    np.testing.assert_allclose(iou.numpy(), np.asarray(iou_ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(miou.item(), float(miou_ref), rtol=1e-6)   # 3 classes present
    empty = torch.zeros(CLASSES, CLASSES, dtype=torch.int32)
    assert accuracy_from_hist(empty).item() == 0.0 and iou_from_hist(empty)[1].item() == 0.0


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_kernels_match_plain_versions_on_gpu():
    """Forward within 1e-5 relative, dlogits within 1e-5 of the largest entry
    (f32) or one bf16 ulp (bf16); N with and without a ragged last tile;
    labels outside the classes; every label type; C from 1 to 64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, c in ((128 * 40, 23), (3000, 7), (1, 5), (257, 1), (100000, 64), (300001, 23)):
        for dtype in (torch.float32, torch.bfloat16):
            for label_dtype in (torch.uint8, torch.int32, torch.int64):
                logits = (3 * torch.randn(n, c, generator=gen, device="cuda")).to(dtype)
                labels = torch.randint(0, c, (n,), generator=gen, device="cuda")
                if label_dtype != torch.uint8:
                    labels[::11] = -1
                labels[n // 2] = c
                labels = labels.to(label_dtype)
                x = logits.clone().requires_grad_()
                before = fused_cross_entropy.launches
                loss = fused_cross_entropy(x, labels)
                (3.0 * loss).backward()
                again = fused_cross_entropy(logits, labels)
                torch.cuda.synchronize()
                assert fused_cross_entropy.launches == before + 3
                assert torch.equal(loss.detach(), again)            # deterministic
                ref = fused_cross_entropy_reference(logits, labels)
                g_ref = fused_cross_entropy_grad_reference(
                    logits, labels, torch.tensor(3.0, device="cuda"))
                torch.testing.assert_close(loss.detach(), ref, rtol=1e-5, atol=1e-5)
                assert x.grad.dtype == dtype
                peak = g_ref.float().abs().max().item()
                tol = 1e-5 if dtype == torch.float32 else 1 / 128
                torch.testing.assert_close(x.grad.float(), g_ref.float(), rtol=tol,
                                           atol=tol * peak)
    with pytest.raises(ValueError):
        fused_cross_entropy(torch.zeros(4, 65, device="cuda"),
                            torch.zeros(4, dtype=torch.int64, device="cuda"))
    with pytest.raises(ValueError):
        fused_cross_entropy(torch.zeros(7, 4, device="cuda").t(),
                            torch.zeros(4, dtype=torch.int64, device="cuda"))
    with pytest.raises(TypeError):
        fused_cross_entropy(torch.zeros(4, 7, device="cuda", dtype=torch.float16),
                            torch.zeros(4, dtype=torch.int64, device="cuda"))


@pytest.mark.gpu
def test_confusion_matrix_counts_exactly_at_33_million_pixels_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n = 128 * 512 * 512
    gen = torch.Generator(device="cuda").manual_seed(0)
    true = torch.randint(0, 23, (n,), generator=gen, device="cuda", dtype=torch.int32)
    true[: n // 2] = 4                                  # a dominant class, > 2^24 in one cell
    pred = true.clone()
    pred[::3] = 7
    hist = confusion_matrix(pred, true, 23)
    assert hist.sum().item() == n
    assert hist[4, 7].item() == ((true == 4) & (pred == 7)).sum().item()
    assert hist[4, 4].item() == ((true == 4) & (pred == 4)).sum().item() > 2 ** 23
