"""The port's other ``create_model`` families (``models/architectures.py``),
its MobileNetV2 encoder and their weight bridge, against the JAX package
(CPU, float32 unless stated).  This file: the resize semantics, eval mode
and the ``encode`` pyramid, the bridge, and everything of the mobilenet_v2
U-Net (its train mode and gradients too, and its remat modes).  The
seven families' train mode and gradients, and ``train_model`` with a
non-U-Net ``Config.MODEL_NAME``, are in
``tests/test_torch_architectures_grad.py``, which uses the helpers here;
the split keeps each file under a minute.

Identical weights (numpy, seeded; through ``from_jax_state_dict``) and
inputs go through both packages.  Size: resnet18, 7 classes; each size
runs every branch that 512 px runs: PSPNet at 128 px (a 4x4 bottleneck:
bins 1 and 2 downsample, 4 is the identity, 8 upsamples), PAN at 256 px
(an 8x8 bottleneck: all three FPA levels), the rest and the mobilenet_v2
U-Net at 64 px.  Eval mode at B=2; train mode at B=4, because the 1x1
pooled BatchNorms (PSP bin 1, ASPP pooling, PAN's attention norms) at B=2
normalize two values a channel (``ROADMAP.md`` C).  The JAX side of a
train-mode case is one jitted program: the train-mode forward (logits and
updated ``batch_stats``) and the gradient of the mean softmax CE.

Tolerances, and why:
- ``_upsample_to`` against ``jax.image.resize``: 1e-6 (float32, the two
  libraries' weights normalized in another order: a few ulps);
- eval logits and the ``encode`` pyramid: 2e-4 (the repo's torch-parity
  tolerance, ``tests/test_torch_models.py``: float32 sums in another order
  through the whole network);
- train-mode logits: against the port run in float64 (the exact answer),
  JAX's float32 logits must miss by under 1e-3 and the port's by at most
  the repo's 2e-4 or twice JAX's miss.  A train-mode BatchNorm at these
  sizes normalizes few values a channel, so float32 noise is amplified:
  JAX's own miss reaches 2.7e-4 (PAN) and 6e-4 (the mobilenet_v2 U-Net)
  here, and no direct float32 comparison holds 2e-4
  (``tests/test_torch_uda.py`` holds resnet50 at 32 px the same way);
- the loss 1e-5 relative; BatchNorm buffers after one train-mode forward
  1e-5 relative + 2e-5 absolute (``tests/test_torch_uda.py``: 0.1 times a
  batch statistic of activations held to the 2e-4 of the logits);
- gradients, the whole-network rule: a ReLU unit whose pre-activation is
  within float32 noise of zero is on in one package and off in the other
  (``tests/test_torch_train_step.py``) and reroutes the gradient through
  that one pixel, which moved single entries of a tensor by up to 0.3 of
  its largest against the float64 gradients, in either package.  So: over
  all parameters ``||dg|| <= 3e-2 * ||g||``, per tensor ``||dg|| <= 0.1 *
  ||g||`` (measured at most 0.04), and the head's kernel, which sees every
  pixel, ``max|dg| <= 1e-4 * max|g|``.  A tensor whose gradient is zero but
  for float noise (a conv bias in front of a BatchNorm, the PAB key's bias
  under the softmax) is held against 1e-6 of the network's largest norm
  instead of its own;
- the bridge: exact (a round trip of float32 arrays);
- remat against none, on the same weights and batch: logits and buffers
  bit-identical, gradients within 1e-6 of each tensor's largest entry (the
  recompute repeats the same float32 operations; ``tests/test_torch_remat.py``).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from tests.test_torch_adversarial import few_torch_threads  # noqa: F401  (autouse)
from tests.test_torch_models import TOL, jax_variables, random_arrays
from uda_aerial_semantic_segmentation_research_tpu.models import (
    architectures as jax_arch,
)
from uda_aerial_semantic_segmentation_research_tpu.models import resnet as jax_resnet
from uda_aerial_semantic_segmentation_research_tpu.models.unet import Unet as JaxUnet
from uda_aerial_semantic_segmentation_research_tpu.ops.losses import (
    softmax_cross_entropy as jax_ce,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
    ARCHITECTURES,
    Unet,
    architectures,
    build_encoder,
    encoder_out_channels,
    from_jax_state_dict,
    to_jax_state_dict,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.losses import (
    softmax_cross_entropy,
)

CLASSES, EVAL_BATCH, TRAIN_BATCH = 7, 2, 4
# BatchNorm buffers after one train-mode forward, relative and absolute
# (tests/test_torch_uda.py: 0.1 times a batch statistic of activations held
# to the 2e-4 of the logits)
STATS_TOL = (1e-5, 2e-5)
# case -> (model name, encoder, image size)
CASES = {
    "FPN": ("FPN", "resnet18", 64),
    "PSPNet": ("PSPNet", "resnet18", 128),
    "Linknet": ("Linknet", "resnet18", 64),
    "UnetPlusPlus": ("UnetPlusPlus", "resnet18", 64),
    "DeepLabV3Plus": ("DeepLabV3Plus", "resnet18", 64),
    "PAN": ("PAN", "resnet18", 256),
    "MAnet": ("MAnet", "resnet18", 64),
    "Unet-mobilenet_v2": ("Unet", "mobilenet_v2", 64),
}


def jax_module(name, encoder):
    cls = JaxUnet if name == "Unet" else getattr(jax_arch, name)
    return cls(encoder_name=encoder, classes=CLASSES, dtype=jnp.float32)


def run_compiled(fn, *args):
    """``fn(*args)`` as one XLA program compiled without LLVM's optimizations:
    a third of the compile time at these sizes, the same float32 arithmetic
    to rounding."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def inputs(seed, size, batch):
    return np.random.default_rng(seed).normal(size=(batch, size, size, 3)).astype(np.float32)


@functools.cache
def case_weights(case):
    """(JAX module, flat random variables) of one case, built once.  The
    tree's keys and shapes are read off the port's model, which holds the
    JAX tree key for key (``test_bridge_round_trips_every_key``); a JAX
    apply raises on a missing or misshapen parameter."""
    name, encoder, _ = CASES[case]
    cls = Unet if name == "Unet" else ARCHITECTURES[name]
    shapes = {k: v.shape for k, v in to_jax_state_dict(
        cls(encoder_name=encoder, classes=CLASSES, dtype=torch.float32)).items()}
    return jax_module(name, encoder), random_arrays(shapes, seed=40 + list(CASES).index(case))


@functools.cache
def _port_model(case, dtype=torch.float32):
    """The model ``create_model`` builds (its class, channels_last, eval mode)
    on the case's weights; the seeded initialization is skipped, as the
    weights are loaded over it (``create_model`` itself:
    ``tests/test_torch_architectures_grad.py``, ``tests/test_torch_trainer.py``)."""
    name, encoder, _ = CASES[case]
    cls = Unet if name == "Unet" else ARCHITECTURES[name]
    model = cls(encoder_name=encoder, classes=CLASSES, dtype=dtype)
    model.load_state_dict(from_jax_state_dict(case_weights(case)[1]), strict=True)
    model = model.to(memory_format=torch.channels_last).eval()
    return model.to(torch.float64) if dtype == torch.float64 else model


def port_model(case, dtype=torch.float32):
    """A fresh copy of the port's model on the case's weights (eval mode)."""
    return copy.deepcopy(_port_model(case, dtype))


@functools.cache
def jax_outputs(case):
    """The JAX eval logits and ``encode`` pyramid of one case, from one
    jitted program."""
    module, flat = case_weights(case)
    x = inputs(1, CASES[case][2], EVAL_BATCH)

    def run(variables, x):
        return module.apply(variables, x), module.apply(variables, x, method=module.encode)

    logits, pyramid = run_compiled(run, jax_variables(flat), x)
    return x, np.asarray(logits), [np.asarray(f) for f in pyramid]


def batch(case):
    """The train-mode batch of a case: B=4 images and labels."""
    size = CASES[case][2]
    labels = np.random.default_rng(7).integers(0, CLASSES, (TRAIN_BATCH, size, size))
    return inputs(2, size, TRAIN_BATCH), labels.astype(np.int32)


@functools.cache
def jax_train_run(case):
    """The JAX train-mode logits, updated buffers, CE loss and its gradients
    of one case, from one jitted program."""
    module, flat = case_weights(case)
    x, labels = batch(case)
    variables = jax_variables(flat)

    def loss_fn(params):
        logits, upd = module.apply({**variables, "params": params}, x, train=True,
                                   mutable=["batch_stats"])
        return jax_ce(logits, labels), (logits, upd)

    (loss, (logits, upd)), grads = run_compiled(jax.value_and_grad(loss_fn, has_aux=True),
                                                variables["params"])

    def flat_of(coll, tree):
        return {"/".join((coll,) + k): np.asarray(v) for k, v in flatten_dict(tree).items()}

    return (np.asarray(logits), flat_of("batch_stats", upd["batch_stats"]), float(loss),
            flat_of("params", grads))


@functools.cache
def port_train_run(case):
    """The port's train-mode logits, CE loss, updated state and gradients."""
    model = port_model(case).train()
    x, labels = batch(case)
    logits = model(torch.from_numpy(x))
    loss = softmax_cross_entropy(logits, torch.from_numpy(labels).long())
    loss.backward()
    return (logits.detach().numpy(), loss.item(), to_jax_state_dict(model),
            to_jax_state_dict(model, grads=True))


def exact_logits(case):
    """The port's train-mode logits in float64: the exact answer that both
    packages' float32 logits are held against."""
    model = port_model(case, torch.float64).train()
    with torch.no_grad():
        return model(torch.from_numpy(batch(case)[0]).double()).double().numpy()


def check_train_mode(case):
    """Train-mode logits (float64 witness), loss and every buffer (module
    docstring)."""
    logits_ref, stats_ref, loss_ref, _ = jax_train_run(case)
    logits, loss, state, _ = port_train_run(case)
    exact = exact_logits(case)
    jax_miss, port_miss = (np.abs(a - exact).max() for a in (logits_ref, logits))
    assert jax_miss < 1e-3 and port_miss <= max(TOL, 2 * jax_miss), (jax_miss, port_miss)
    np.testing.assert_allclose(loss, loss_ref, rtol=1e-5)
    flat = case_weights(case)[1]
    assert set(stats_ref) == {k for k in state if k.startswith("batch_stats/")}
    for k, v in stats_ref.items():
        np.testing.assert_allclose(state[k], v, rtol=STATS_TOL[0], atol=STATS_TOL[1], err_msg=k)
        assert not np.array_equal(v, flat[k]), k            # every buffer moved


def check_gradients(case):
    """The CE gradients by the whole-network rule (module docstring)."""
    got, ref = port_train_run(case)[3], jax_train_run(case)[3]
    assert set(got) == set(ref)
    keys = sorted(ref)
    flat = lambda g: np.concatenate([g[k].ravel() for k in keys])  # noqa: E731
    rel_l2 = np.linalg.norm(flat(got) - flat(ref)) / np.linalg.norm(flat(ref))
    head = ("params/segmentation_head/kernel" if CASES[case][0] == "Unet"
            else "params/head/kernel")
    head_err = np.abs(got[head] - ref[head]).max() / np.abs(ref[head]).max()
    assert rel_l2 <= 3e-2 and head_err <= 1e-4, (rel_l2, head_err)
    largest = max(np.linalg.norm(g) for g in ref.values())
    for k in keys:
        err = np.linalg.norm(got[k] - ref[k]) / max(np.linalg.norm(ref[k]), 1e-6 * largest)
        assert err <= 0.1, (k, err)


# ---------------------------------------------------------------------------
# the resize semantics
# ---------------------------------------------------------------------------
RATIOS = [(16, 1), (16, 2), (16, 4), (16, 8), (1, 16), (2, 16), (4, 16), (8, 16),
          (8, 16), (4, 128), (2, 1), (3, 7), (7, 3)]


@pytest.mark.parametrize("method", ["nearest", "linear", "bilinear"])
@pytest.mark.parametrize("hin,hout", sorted(set(RATIOS)))
def test_upsample_to_matches_jax_resize(hin, hout, method):
    a = np.random.default_rng(hin * 100 + hout).normal(size=(2, hin, hin + 1, 5))
    a = a.astype(np.float32)
    wout = hout + 1 if hout > 1 else hout
    ref = np.asarray(jax.image.resize(a, (2, hout, wout, 5), method=method))
    x = torch.from_numpy(a).permute(0, 3, 1, 2)
    got = architectures._upsample_to(x, hout, wout, method)
    assert got.shape == (2, 5, hout, wout) and got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("hin,hout", [(16, 1), (16, 2), (16, 8), (4, 16), (128, 512)])
def test_bilinear_resize_in_bfloat16_is_within_one_rounding_of_jax(hin, hout):
    """The port resizes bf16 in float32 arithmetic and rounds once (the
    antialiased downsampling explicitly, bilinear upsampling inside the
    kernel); the JAX bf16 resize rounds its weights and both contractions
    to bf16.  They agree within two bf16 ulps of the largest value
    (2**-6 of it); the port is the closer to the float32 resize."""
    a = np.random.default_rng(hout).normal(size=(2, hin, hin, 3)).astype(np.float32)
    xb = jnp.asarray(a).astype(jnp.bfloat16)
    ref = np.asarray(jax.image.resize(xb, (2, hout, hout, 3), "linear").astype(jnp.float32))
    exact = np.asarray(jax.image.resize(xb.astype(jnp.float32), (2, hout, hout, 3), "linear"))
    x = torch.from_numpy(np.array(xb.astype(jnp.float32))).permute(0, 3, 1, 2)
    got = architectures._upsample_to(x.to(torch.bfloat16), hout, hout, "bilinear")
    assert got.dtype == torch.bfloat16
    got = got.float().permute(0, 2, 3, 1).numpy()
    assert np.abs(got - ref).max() <= 2.0 ** -6 * np.abs(exact).max()
    assert np.abs(got - exact).max() <= np.abs(ref - exact).max()


def test_resize_and_concat_keep_channels_last():
    x = torch.randn(2, 6, 8, 8).contiguous(memory_format=torch.channels_last)
    pooled = x.mean((2, 3), keepdim=True).expand(-1, -1, 8, 8)
    for y in (architectures._upsample_to(x, 2, 2, "linear"),
              architectures._upsample_to(x, 16, 16, "bilinear"),
              architectures._upsample_to(x, 16, 16, "nearest"),
              architectures._cat([x, pooled, x])):
        assert y.permute(0, 2, 3, 1).is_contiguous()
    torch.testing.assert_close(architectures._cat([x, pooled]), torch.cat([x, pooled], 1),
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the families and the mobilenet_v2 U-Net on the same weights
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", list(CASES))
def test_eval_logits_and_encode_pyramid_match_jax(case):
    x, logits_ref, pyramid_ref = jax_outputs(case)
    model = port_model(case)
    with torch.no_grad():
        logits = model(torch.from_numpy(x))
        pyramid = model.encode(torch.from_numpy(x))
    size = CASES[case][2]
    assert logits.shape == (EVAL_BATCH, size, size, CLASSES) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), logits_ref, rtol=TOL, atol=TOL)
    assert len(pyramid) == len(pyramid_ref) == 6
    channels = encoder_out_channels(CASES[case][1])
    for level, (got, ref) in enumerate(zip(pyramid, pyramid_ref)):
        assert got.shape[1] == channels[level]
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=TOL, atol=TOL,
                                   err_msg=f"level {level}")


@pytest.mark.parametrize("case", list(CASES))
def test_bridge_round_trips_every_key(case):
    """The JAX module's tree (``eval_shape`` of its init at the case's size)
    is the port's key for key and shape for shape; a JAX tree loads
    (``strict=True``) and comes back unchanged."""
    module, flat = case_weights(case)
    size = CASES[case][2]
    shapes = jax.eval_shape(module.init, jax.random.key(0), jnp.zeros((1, size, size, 3)))
    assert {"/".join(k): v.shape for k, v in flatten_dict(shapes).items()} == {
        k: v.shape for k, v in flat.items()}
    back = to_jax_state_dict(port_model(case))
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_mobilenet_v2_encoder_tree_and_shapes():
    """``build_encoder("mobilenet_v2")``: the JAX encoder's parameter tree
    (``ir0`` with two conv/norm pairs, the rest with three; depthwise
    kernels ``(3, 3, 1, C)`` <-> ``(C, 1, 3, 3)``) and its pyramid widths
    and sizes, with the stride-2 convs padded k // 2 on both sides."""
    enc = build_encoder("mobilenet_v2", dtype=torch.float32)
    jax_enc = jax_resnet.build_encoder("mobilenet_v2", 3, jnp.float32)
    sample = jnp.zeros((1, 40, 40, 3), jnp.float32)
    shapes = jax.eval_shape(jax_enc.init, jax.random.key(0), sample)
    flat_shapes = {"/".join(k): v.shape for k, v in flatten_dict(shapes).items()}
    ours = {k: v.shape for k, v in to_jax_state_dict(enc).items()}
    assert ours == flat_shapes
    assert ours["params/ir0/Conv_0/kernel"] == (3, 3, 1, 32)
    assert ours["params/stage4_block0/Conv_1/kernel"] == (3, 3, 1, 576)
    feats = enc(torch.zeros(1, 40, 40, 3))
    assert [f.shape[-1] for f in feats] == [3, 16, 24, 32, 96, 1280]
    assert [f.shape[1] for f in feats] == [40, 20, 10, 5, 3, 2]


def test_mobilenet_v2_unet_train_mode_matches_jax():
    check_train_mode("Unet-mobilenet_v2")


def test_mobilenet_v2_unet_gradients_match_jax():
    check_gradients("Unet-mobilenet_v2")


def _train_pass(model, x, labels):
    logits = model(torch.from_numpy(x))
    softmax_cross_entropy(logits, torch.from_numpy(labels).long()).backward()
    return logits.detach(), to_jax_state_dict(model, grads=True), to_jax_state_dict(model)


@pytest.mark.parametrize("remat", [True, "encoder", "convs", "encoder_convs"])
def test_mobilenet_v2_remat_gives_the_logits_and_gradients_of_none(remat):
    """Train mode, B=4, against ``remat=False`` (module docstring)."""
    ref = port_model("Unet-mobilenet_v2").train()
    model = Unet("mobilenet_v2", classes=CLASSES, dtype=torch.float32, remat=remat)
    model.load_state_dict(ref.state_dict(), strict=True)
    model = model.to(memory_format=torch.channels_last).train()
    x, labels = batch("Unet-mobilenet_v2")
    (logits_ref, grads_ref, state_ref), (logits, grads, state) = (
        _train_pass(m, x, labels) for m in (ref, model))
    torch.testing.assert_close(logits, logits_ref, rtol=0, atol=0)
    for k, g in grads_ref.items():
        np.testing.assert_allclose(grads[k], g, rtol=0, atol=1e-6 * np.abs(g).max(), err_msg=k)
    for k, v in state_ref.items():
        if k.startswith("batch_stats/"):
            np.testing.assert_array_equal(state[k], v, err_msg=k)


def test_mobilenet_v2_rejects_a_stage_remat():
    """As the JAX encoder: a stage set raises, at construction and in a
    clone's forward."""
    with pytest.raises(ValueError, match="ResNet-only"):
        build_encoder("mobilenet_v2", dtype=torch.float32, remat="stage1")
    with pytest.raises(ValueError, match="ResNet-only"):
        Unet("mobilenet_v2", classes=CLASSES, dtype=torch.float32, remat="stage1")
    model = Unet("mobilenet_v2", classes=CLASSES, dtype=torch.float32).clone(remat="stage12")
    with pytest.raises(ValueError, match="ResNet-only"):
        model(torch.zeros(1, 32, 32, 3))
