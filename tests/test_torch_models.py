"""Parity of the PyTorch port's models against the JAX package (CPU).

The same weights -- drawn with numpy from a seed, BatchNorm statistics
randomized with negative and zero scales so the eval-mode fold is
exercised -- go into the JAX modules and, through the weight bridge
``models.convert.from_jax_state_dict``, into the port's modules.  The
tolerance 2e-4 is the repo's torch-parity tolerance
(tests/test_pretrained_parity.py): float32 on both sides, sums in
another order.
"""

import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from uda_aerial_semantic_segmentation_research_tpu.models.resnet import (
    build_encoder as jax_build_encoder,
)
from uda_aerial_semantic_segmentation_research_tpu.models.unet import Unet as JaxUnet
from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
    build_encoder,
    create_unet,
    from_jax_state_dict,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.batch_norm import (
    BatchNorm,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.conv_bn_relu import (
    conv_bn_relu,
)

SIZE, CLASSES, BATCH = 32, 7, 2
TOL = 2e-4
PORT = "uda_aerial_semantic_segmentation_research_tpu_torch"


def random_variables(module, sample, seed):
    """Flat ``{'params/...': ndarray}`` for ``module`` with random values.

    Conv kernels are lecun-scaled normals; BatchNorm scales are drawn in
    [0.5, 1.5) with random signs and a zero in channel 0, biases and
    means small normals, variances in [0.5, 1.5).
    """
    shapes = jax.eval_shape(module.init, jax.random.key(0), sample)
    return random_arrays({k: s.shape for k, s in flatten_dict(shapes, sep="/").items()}, seed)


def random_arrays(shapes, seed):
    """``random_variables``'s values for a flat ``{key: shape}`` tree."""
    rng = np.random.default_rng(seed)
    flat = {}
    for key, shape in shapes.items():
        leaf = key.rsplit("/", 1)[-1]
        if leaf == "kernel":
            v = rng.normal(size=shape) * math.sqrt(1.0 / math.prod(shape[:-1]))
        elif leaf == "scale":
            v = rng.uniform(0.5, 1.5, shape) * rng.choice([-1.0, 1.0], shape)
            v[0] = 0.0
        elif leaf == "var":
            v = rng.uniform(0.5, 1.5, shape)
        else:  # bias, mean
            v = 0.1 * rng.normal(size=shape)
        flat[key] = v.astype(np.float32)
    return flat


def jax_variables(flat):
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})


def images(seed=0, batch=BATCH, size=SIZE):
    return np.random.default_rng(seed).integers(0, 255, (batch, size, size, 3)).astype(np.uint8)


def normalized(seed=0):
    mean = np.asarray((0.485, 0.456, 0.406), np.float32)
    std = np.asarray((0.229, 0.224, 0.225), np.float32)
    return ((images(seed).astype(np.float32) / 255.0 - mean) / std).astype(np.float32)


def port_unet(flat, fused_eval=True, encoder="resnet18"):
    model = create_unet(encoder, classes=CLASSES, dtype=torch.float32,
                        device="cpu", fused_eval=fused_eval)
    model.load_state_dict(from_jax_state_dict(flat), strict=True)
    return model


@pytest.fixture(scope="module")
def unet_case():
    """Random weights, one input, and the logits of both JAX variants."""
    x = normalized(1)
    fused = JaxUnet("resnet18", classes=CLASSES, dtype=jnp.float32,
                    packed_decoder=True, pallas_eval=True)
    plain = JaxUnet("resnet18", classes=CLASSES, dtype=jnp.float32)
    flat = random_variables(plain, jnp.asarray(x), seed=3)
    v = jax_variables(flat)
    ref_fused = np.asarray(jax.jit(lambda v, x: fused.apply(v, x, train=False))(v, x))
    ref_plain = np.asarray(jax.jit(lambda v, x: plain.apply(v, x, train=False))(v, x))
    return flat, x, ref_fused, ref_plain


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["resnet18", "resnet34"])
def test_encoder_pyramid_matches_jax(name):
    x = normalized(2)
    jenc = jax_build_encoder(name, dtype=jnp.float32)
    flat = random_variables(jenc, jnp.asarray(x), seed=5)
    ref = jax.jit(lambda v, x: jenc.apply(v, x, train=False))(jax_variables(flat), x)
    enc = build_encoder(name, dtype=torch.float32).to(memory_format=torch.channels_last)
    enc.load_state_dict(from_jax_state_dict(flat), strict=True)
    with torch.no_grad():
        out = enc.eval()(torch.from_numpy(x))
    assert len(out) == len(ref) == 6
    for o, r in zip(out, ref):
        assert tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# whole Unet
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fused_eval", [True, False])
def test_unet_logits_match_jax(unet_case, fused_eval):
    """Port logits vs JAX ``Unet(packed_decoder=True, pallas_eval=True)``
    (Pallas kernel in interpret mode) and vs the plain JAX ``Unet``."""
    flat, x, ref_fused, ref_plain = unet_case
    with torch.no_grad():
        out = port_unet(flat, fused_eval)(torch.from_numpy(x)).numpy()
    assert out.shape == (BATCH, SIZE, SIZE, CLASSES) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref_fused, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(out, ref_plain, atol=TOL, rtol=TOL)


def test_fused_eval_routes_two_blocks_through_the_wrapper(unet_case, monkeypatch):
    """fused_eval calls conv_bn_relu in decoder blocks 3 and 4 only;
    on CPU tensors that is the plain version, so no kernel launches."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.models import unet

    calls = []

    def spy(x, k3, scale=None, shift=None, **kw):
        calls.append(tuple(x.shape))
        return conv_bn_relu(x, k3, scale, shift, **kw)

    monkeypatch.setattr(unet, "conv_bn_relu", spy)
    flat, x, _, _ = unet_case
    launches = conv_bn_relu.launches
    with torch.no_grad():
        port_unet(flat, True)(torch.from_numpy(x))
    assert calls == [(BATCH, SIZE // 2, SIZE // 2, 32), (BATCH, SIZE, SIZE, 16)]
    assert conv_bn_relu.launches == launches


def test_zero_bn_scale_fold_matches_unfused(unet_case):
    """A decoder norm1 with an all-zero scale folds through the 1e-12
    clamp to the same logits as the unfused BatchNorm."""
    flat, x, _, _ = unet_case
    flat = dict(flat)
    for i in (3, 4):
        key = f"params/decoder/block{i}/norm1/scale"
        flat[key] = np.zeros_like(flat[key])
    with torch.no_grad():
        a = port_unet(flat, True)(torch.from_numpy(x)).numpy()
        b = port_unet(flat, False)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("activation", ["softmax", "sigmoid"])
def test_unet_activation(unet_case, activation):
    flat, x, _, ref_plain = unet_case
    model = create_unet("resnet18", classes=CLASSES, activation=activation,
                        dtype=torch.float32, device="cpu", fused_eval=True)
    model.load_state_dict(from_jax_state_dict(flat), strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    ref = (jax.nn.softmax(ref_plain, axis=-1) if activation == "softmax"
           else jax.nn.sigmoid(ref_plain))
    np.testing.assert_allclose(out, np.asarray(ref), atol=TOL, rtol=TOL)


def test_create_unet_is_seeded_and_in_eval_mode():
    a = create_unet("resnet18", classes=CLASSES, seed=4, dtype=torch.float32, device="cpu")
    b = create_unet("resnet18", classes=CLASSES, seed=4, dtype=torch.float32, device="cpu")
    c = create_unet("resnet18", classes=CLASSES, seed=5, dtype=torch.float32, device="cpu")
    assert not a.training
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["encoder.stem_conv.weight"], sc["encoder.stem_conv.weight"])
    # the last norm of each residual block starts at zero scale, as in JAX
    assert torch.all(sa["encoder.stage1_block0.bn2.scale"] == 0)


# ---------------------------------------------------------------------------
# weight bridge
# ---------------------------------------------------------------------------
def test_converter_fills_every_key(unet_case):
    flat, _, _, _ = unet_case
    sd = from_jax_state_dict(flat)
    model = create_unet("resnet18", classes=CLASSES, dtype=torch.float32, device="cpu")
    assert len(sd) == len(flat) == len(model.state_dict()) == 152
    result = model.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    k = flat["params/decoder/block4/conv2/kernel"]
    np.testing.assert_array_equal(sd["decoder.block4.conv2.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))


@pytest.mark.parametrize("change", ["unknown_leaf", "unknown_collection", "missing_var"])
def test_converter_raises_on_leftover_or_missing(unet_case, change):
    flat = dict(unet_case[0])
    if change == "unknown_leaf":
        flat["params/decoder/block0/conv1/extra"] = np.zeros(3, np.float32)
    elif change == "unknown_collection":
        flat["opt_state/decoder/block0/conv1/kernel"] = np.zeros((3, 3, 1, 1), np.float32)
    else:
        del flat["batch_stats/decoder/block0/norm1/var"]
    with pytest.raises(ValueError):
        from_jax_state_dict(flat)


def test_batch_norm_train_mode_raises():
    """Train mode is ported: it raises no NotImplementedError any more, only
    on what it cannot take -- a channel mismatch, or an input whose
    channel-last view is not contiguous (the sums kernel would have to copy)."""
    bn = BatchNorm(4, dtype=torch.float32)
    assert bn.training
    y = bn(torch.ones(2, 4, 2, 2).contiguous(memory_format=torch.channels_last))
    assert tuple(y.shape) == (2, 4, 2, 2) and torch.all(y == 0)
    with pytest.raises(ValueError):
        bn(torch.zeros(1, 3, 2, 2))
    with pytest.raises(ValueError):
        bn(torch.zeros(2, 4, 2, 2))


def test_create_unet_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_unet("resnet18", classes=CLASSES)


# ---------------------------------------------------------------------------
# the port imports no JAX
# ---------------------------------------------------------------------------
def test_port_imports_no_jax_in_a_fresh_process():
    root = Path(__file__).resolve().parents[1]
    modules = sorted(".".join(f.relative_to(root).with_suffix("").parts)
                     for f in (root / PORT).rglob("*.py") if f.name != "__init__.py")
    assert f"{PORT}.training.steps" in modules and f"{PORT}.ops.fused_ce" in modules
    code = (f"import sys, {', '.join(modules)}; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'flax', 'optax', "
            "'uda_aerial_semantic_segmentation_research_tpu')); "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_port_source_names_no_jax_package():
    root = Path(__file__).resolve().parents[1] / PORT
    files = list(root.rglob("*.py")) + [root.parent / "chip_smoke.py"]
    jax_pkg = "uda_aerial_semantic_segmentation_research_tpu"
    for f in files:
        text = f.read_text()
        for needle in (f"{jax_pkg}.", f"{jax_pkg} import", "import jax",
                       "from jax", "import flax", "from flax", "import optax"):
            assert needle not in text, f"{f.name} contains {needle!r}"
