"""The port's fused decoder convolutions (``ops/upsample_conv.py``) and the
U-Net's ``fused_decoder`` option against the JAX package (CPU, float32).

- ``upsample2x_conv3x3`` and ``upsample2x_conv3x3_dilated`` against the JAX
  functions and against the naive ``conv3x3(nearest_up2(x))``: within 1e-5
  of the largest output value (float32 sums in another order);
- ``Unet(fused_decoder=True | (3, 4) | "dilated")`` against the JAX ``Unet``
  with the same value on the same weights (the weights, inputs, helpers and
  tolerances of ``tests/test_torch_architectures.py``): eval logits 2e-4;
  train-mode logits against the port's naive U-Net in float64 (JAX's miss
  under 1e-3, the port's at most 2e-4 or twice JAX's), the loss 1e-5
  relative, the BatchNorm buffers 1e-5 relative + 2e-5 absolute, and the CE
  gradients by the whole-network rule.  ``"dilated"`` runs at 128 px: below
  that both packages keep the naive schedule (the JAX program traces to the
  naive one's jaxpr, the port's logits and gradients are the naive ones bit
  for bit);
- the remat modes with a fused schedule against none: logits and buffers
  bit-identical, gradients within 1e-6 of each tensor's largest entry;
- ``"auto"`` resolves to the naive schedule off the TPU, in both packages.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax.traverse_util import flatten_dict

from tests.test_torch_adversarial import few_torch_threads  # noqa: F401  (autouse)
from tests.test_torch_architectures import STATS_TOL, run_compiled
from tests.test_torch_models import TOL, jax_variables, random_arrays
from uda_aerial_semantic_segmentation_research_tpu.models.unet import Unet as JaxUnet
from uda_aerial_semantic_segmentation_research_tpu.ops import upsample_conv as jax_up
from uda_aerial_semantic_segmentation_research_tpu.ops.losses import (
    softmax_cross_entropy as jax_ce,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
    Unet,
    create_model,
    create_unet,
    from_jax_state_dict,
    to_jax_state_dict,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.models.unet import (
    resolve_fused_decoder,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops import upsample_conv
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.losses import (
    softmax_cross_entropy,
)

CLASSES, EVAL_BATCH, TRAIN_BATCH = 7, 2, 4
FN_TOL = 1e-5
# case -> (fused_decoder, image size)
CASES = {
    "all": (True, 64),
    "blocks_3_4": ((3, 4), 64),
    "dilated": ("dilated", 128),
}


# ---------------------------------------------------------------------------
# the two functions
# ---------------------------------------------------------------------------
def _naive(x, kernel):
    return F.conv2d(F.interpolate(x, scale_factor=2, mode="nearest"), kernel, padding=1)


@pytest.mark.parametrize("fn", ["upsample2x_conv3x3", "upsample2x_conv3x3_dilated"])
@pytest.mark.parametrize("shape", [(2, 7, 5, 6, 5), (1, 8, 8, 16, 16), (3, 1, 9, 4, 3)])
def test_fused_upsample_conv_matches_jax_and_the_naive_conv(fn, shape):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    k = rng.normal(size=(3, 3, cin, cout)).astype(np.float32)       # HWIO, as in JAX
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    kt = torch.from_numpy(k).permute(3, 2, 0, 1)                    # OIHW
    got = getattr(upsample_conv, fn)(xt, kt)
    assert got.shape == (b, cout, 2 * h, 2 * w) and got.dtype == torch.float32
    assert got.is_contiguous(memory_format=torch.channels_last)
    naive = _naive(xt, kt)
    theirs = np.asarray(getattr(jax_up, fn)(jnp.asarray(x), jnp.asarray(k)))
    scale = np.abs(theirs).max()
    ours = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=FN_TOL * scale)
    np.testing.assert_allclose(got.numpy(), naive.numpy(), rtol=0, atol=FN_TOL * scale)


def test_phase_and_dilated_kernels_are_the_jax_ones():
    k = np.random.default_rng(5).normal(size=(3, 3, 4, 6)).astype(np.float32)
    kt = torch.from_numpy(k).permute(3, 2, 0, 1)
    theirs = jax_up._phase_kernels(jnp.asarray(k))
    ours = upsample_conv._phase_kernels(kt)
    assert set(ours) == set(theirs)
    for rs, v in theirs.items():
        np.testing.assert_array_equal(ours[rs].permute(2, 3, 1, 0).numpy(), np.asarray(v))
    k4 = np.einsum("it,js,ijco->tsco", jax_up._FOLD, jax_up._FOLD, k)
    np.testing.assert_allclose(upsample_conv.dilated_kernel(kt).permute(2, 3, 1, 0).numpy(),
                               k4, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the U-Net
# ---------------------------------------------------------------------------
@functools.cache
def weights():
    shapes = {k: v.shape for k, v in to_jax_state_dict(
        Unet("resnet18", classes=CLASSES, dtype=torch.float32)).items()}
    return random_arrays(shapes, seed=61)


def inputs(size):
    rng = np.random.default_rng(size)
    x = rng.normal(size=(TRAIN_BATCH, size, size, 3)).astype(np.float32)
    labels = rng.integers(0, CLASSES, (TRAIN_BATCH, size, size)).astype(np.int32)
    return x, labels


@functools.cache
def port_unet(fused_decoder, dtype=torch.float32):
    model = Unet("resnet18", classes=CLASSES, dtype=dtype, fused_decoder=fused_decoder)
    model.load_state_dict(from_jax_state_dict(weights()), strict=True)
    model = model.to(memory_format=torch.channels_last).eval()
    return model.to(torch.float64) if dtype == torch.float64 else model


@functools.cache
def jax_run(case):
    """The JAX U-Net with the case's ``fused_decoder``: eval logits, then the
    train-mode logits, updated buffers, CE loss and its gradients, from one
    jitted program."""
    fused, size = CASES[case]
    module = JaxUnet("resnet18", classes=CLASSES, dtype=jnp.float32, fused_decoder=fused)
    variables = jax_variables(weights())
    x, labels = inputs(size)

    def run(params):
        eval_logits = module.apply({**variables, "params": params}, x[:EVAL_BATCH])

        def loss_fn(p):
            logits, upd = module.apply({**variables, "params": p}, x, train=True,
                                       mutable=["batch_stats"])
            return jax_ce(logits, labels), (logits, upd)

        return eval_logits, jax.value_and_grad(loss_fn, has_aux=True)(params)

    eval_logits, ((loss, (logits, upd)), grads) = run_compiled(run, variables["params"])

    def flat_of(coll, tree):
        return {"/".join((coll,) + k): np.asarray(v) for k, v in flatten_dict(tree).items()}

    return (np.asarray(eval_logits), np.asarray(logits),
            flat_of("batch_stats", upd["batch_stats"]), float(loss), flat_of("params", grads))


def port_train(model, size):
    x, labels = inputs(size)
    logits = model(torch.from_numpy(x))
    loss = softmax_cross_entropy(logits, torch.from_numpy(labels).long())
    loss.backward()
    return (logits.detach().numpy(), loss.item(), to_jax_state_dict(model),
            to_jax_state_dict(model, grads=True))


@functools.cache
def port_run(case):
    fused, size = CASES[case]
    x, _ = inputs(size)
    with torch.no_grad():
        eval_logits = port_unet(fused)(torch.from_numpy(x[:EVAL_BATCH])).numpy()
    return (eval_logits,) + port_train(copy.deepcopy(port_unet(fused)).train(), size)


def exact_train_logits(size):
    """The naive U-Net's train-mode logits in float64 (the exact answer)."""
    model = copy.deepcopy(port_unet(False, torch.float64)).train()
    with torch.no_grad():
        return model(torch.from_numpy(inputs(size)[0]).double()).numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_fused_decoder_unet_matches_jax(case):
    ref_eval, ref_logits, ref_stats, ref_loss, ref_grads = jax_run(case)
    eval_logits, logits, loss, state, grads = port_run(case)
    np.testing.assert_allclose(eval_logits, ref_eval, atol=TOL, rtol=TOL)

    exact = exact_train_logits(CASES[case][1])
    jax_miss, port_miss = (np.abs(a - exact).max() for a in (ref_logits, logits))
    assert jax_miss < 1e-3 and port_miss <= max(TOL, 2 * jax_miss), (jax_miss, port_miss)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    assert set(ref_stats) == {k for k in state if k.startswith("batch_stats/")}
    for k, v in ref_stats.items():
        np.testing.assert_allclose(state[k], v, rtol=STATS_TOL[0], atol=STATS_TOL[1], err_msg=k)

    assert set(grads) == set(ref_grads)
    keys = sorted(ref_grads)
    flat = lambda g: np.concatenate([g[k].ravel() for k in keys])  # noqa: E731
    rel_l2 = np.linalg.norm(flat(grads) - flat(ref_grads)) / np.linalg.norm(flat(ref_grads))
    head = "params/segmentation_head/kernel"
    head_err = np.abs(grads[head] - ref_grads[head]).max() / np.abs(ref_grads[head]).max()
    assert rel_l2 <= 3e-2 and head_err <= 1e-4, (rel_l2, head_err)
    largest = max(np.linalg.norm(g) for g in ref_grads.values())
    for k in keys:
        err = np.linalg.norm(grads[k] - ref_grads[k]) / max(np.linalg.norm(ref_grads[k]),
                                                            1e-6 * largest)
        assert err <= 0.1, (k, err)


def test_dilated_below_128_px_is_the_naive_schedule():
    variables = jax_variables(weights())
    x, _ = inputs(64)
    jaxprs = [str(jax.make_jaxpr(lambda v, x, fused=fused: JaxUnet(
        "resnet18", classes=CLASSES, dtype=jnp.float32, fused_decoder=fused).apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, x)) for fused in (False, "dilated")]
    assert jaxprs[0] == jaxprs[1]
    assert port_unet("dilated").decoder.block_schedules(64) == [None] * 5
    naive = port_train(copy.deepcopy(port_unet(False)).train(), 64)
    dilated = port_train(copy.deepcopy(port_unet("dilated")).train(), 64)
    np.testing.assert_array_equal(dilated[0], naive[0])
    for k, g in naive[3].items():
        np.testing.assert_array_equal(dilated[3][k], g, err_msg=k)


@pytest.mark.parametrize("case", ["all", "dilated"])
def test_fused_schedules_run_their_blocks(case, monkeypatch):
    """The schedule each block runs: every block fused (``"dilated"`` only
    from 128 px on), only blocks 3 and 4 for ``(3, 4)``, none for ``False``."""
    fused, size = CASES[case]
    model = port_unet(fused)
    impl = "dilated" if fused == "dilated" else "phase"
    assert model.decoder.block_schedules(size) == [impl] * 5
    assert model.decoder.block_schedules(64) == ([None] * 5 if impl == "dilated"
                                                 else [impl] * 5)
    assert port_unet((3, 4)).decoder.block_schedules(size) == [None, None, None, "phase",
                                                                "phase"]
    called = []
    real = upsample_conv.upsample2x_conv3x3_dilated if impl == "dilated" else \
        upsample_conv.upsample2x_conv3x3
    from uda_aerial_semantic_segmentation_research_tpu_torch.models import unet as unet_mod
    monkeypatch.setitem(unet_mod._UP_CONVS, impl,
                        lambda *a: called.append(1) or real(*a))
    with torch.no_grad():
        model(torch.zeros((1, size, size, 3)))
    assert len(called) == 5


@pytest.mark.parametrize("remat", [True, "convs"])
@pytest.mark.parametrize("fused", [True, "dilated"])
def test_remat_with_a_fused_decoder_is_exact(fused, remat):
    size = 128 if fused == "dilated" else 64
    base = copy.deepcopy(port_unet(fused)).train()
    other = copy.deepcopy(port_unet(fused)).train().clone(remat=remat)
    a, b = port_train(base, size), port_train(other, size)
    np.testing.assert_array_equal(b[0], a[0])
    for k, v in a[2].items():
        np.testing.assert_array_equal(b[2][k], v, err_msg=k)
    for k, g in a[3].items():
        assert np.abs(b[3][k] - g).max() <= 1e-6 * np.abs(g).max(), k


def test_auto_resolves_to_the_naive_schedule_off_the_tpu():
    assert jax.default_backend() == "cpu"
    assert resolve_fused_decoder("auto") is False
    model = create_unet("resnet18", classes=CLASSES, dtype=torch.float32, device="cpu")
    assert model.fused_decoder == "auto" and model.decoder.fused is False
    assert model.decoder.block_schedules(512) == [None] * 5
    made = create_model("Unet", "resnet18", classes=CLASSES, dtype=torch.float32, device="cpu",
                        fused_decoder="dilated")
    assert made.decoder.fused == "dilated"
    # the JAX Unet resolves "auto" to its naive schedule here
    bound = JaxUnet("resnet18", classes=CLASSES, dtype=jnp.float32).bind(
        jax_variables(weights()))
    assert bound.fused_decoder == "auto" and bound.decoder.fused is False
    x = inputs(64)[0][:1]
    with torch.no_grad():
        ours = port_unet("auto")(torch.from_numpy(x)).numpy()
        plain = port_unet(False)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(ours, plain)
    for bad in ("phase", 3, (True,), None):
        with pytest.raises(ValueError, match="fused_decoder"):
            resolve_fused_decoder(bad)
