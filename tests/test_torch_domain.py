"""The port's domain-adaptation pieces against the JAX package (CPU): the
losses and metrics of phases 2 and 3, the discriminator, its weight bridge
and factory, ``DomainAdaptationModel``, and the target-domain data.

Tolerances, and why:
- losses: 1e-6 (float32 on both sides, sums in another order), and the
  torch goldens of ``tests/test_losses.py`` (``F.binary_cross_entropy_with_logits``,
  ``F.kl_div``) to the same 1e-6 / 1e-4 as there;
- ``DomainAdaptationMetrics``: equal dicts (both accumulate float32 numpy);
- discriminator, float32: logits and BatchNorm buffers 1e-5, parameter
  gradients of the BCE 1e-5 of each tensor's largest entry (a conv net of
  four layers, no ReLU unit at a tie: measured 3.6e-7 on the logits) --
  of the network's largest entry, since the conv biases in front of a
  BatchNorm have an exact zero gradient that both return as noise;
  bfloat16: 1e-2 on logits of ~0.1 (every activation is rounded to bf16,
  and the two libraries round sums taken in another order: measured
  2e-3);
- data: identical files and arrays.
"""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax.traverse_util import flatten_dict

from tests.test_torch_adversarial import few_torch_threads  # noqa: F401  (autouse)
from tests.test_torch_models import jax_variables, random_variables
from uda_aerial_semantic_segmentation_research_tpu.config import Config as JaxConfig
from uda_aerial_semantic_segmentation_research_tpu.data import native as jax_native
from uda_aerial_semantic_segmentation_research_tpu.data.create_sample_holyrood import (
    create_sample_holyrood as jax_create_sample_holyrood,
)
from uda_aerial_semantic_segmentation_research_tpu.data.setup_test_data import (
    setup_test_data as jax_setup_test_data,
)
from uda_aerial_semantic_segmentation_research_tpu.data.target_dataset import (
    TargetDataset as JaxTargetDataset,
)
from uda_aerial_semantic_segmentation_research_tpu.models.bundle import ModelBundle
from uda_aerial_semantic_segmentation_research_tpu.models.discriminator import (
    DomainDiscriminator as JaxDiscriminator,
)
from uda_aerial_semantic_segmentation_research_tpu.models.domain_model import (
    DomainAdaptationModel as JaxDomainAdaptationModel,
)
from uda_aerial_semantic_segmentation_research_tpu.models.unet import Unet as JaxUnet
from uda_aerial_semantic_segmentation_research_tpu.ops import losses as jax_losses
from uda_aerial_semantic_segmentation_research_tpu.ops import metrics as jax_metrics
from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
from uda_aerial_semantic_segmentation_research_tpu_torch.data import native
from uda_aerial_semantic_segmentation_research_tpu_torch.data.create_sample_holyrood import (
    create_sample_holyrood,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.data.setup_test_data import (
    setup_test_data,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.data.target_dataset import (
    TargetDataset,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
    DomainAdaptationModel,
    DomainDiscriminator,
    create_discriminator,
    create_unet,
    from_jax_state_dict,
    to_jax_state_dict,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops import losses, metrics

B, H, W, C = 2, 8, 8, 5
SIZE, CLASSES = 64, 7


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(4, 1), (7,), (3, 2, 5)])
def test_sigmoid_bce_matches_jax_and_torch(shape):
    rng = _rng(len(shape))
    x = (rng.normal(size=shape) * 4).astype(np.float32)
    y = rng.integers(0, 2, shape).astype(np.float32)
    ours = losses.sigmoid_bce_with_logits(_t(x), _t(y))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.item(), float(jax_losses.sigmoid_bce_with_logits(
        jnp.asarray(x), jnp.asarray(y))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ours.item(), F.binary_cross_entropy_with_logits(
        _t(x), _t(y)).item(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("lambda_adv", [0.001, 0.5])
def test_adversarial_loss_matches_jax(lambda_adv):
    rng = _rng(3)
    s, t = (rng.normal(size=(6, 1)).astype(np.float32) * 3 for _ in range(2))
    ours, theirs = losses.AdversarialLoss(lambda_adv), jax_losses.AdversarialLoss(lambda_adv)
    np.testing.assert_allclose(ours.discriminator_loss(_t(s), _t(t)).item(),
                               float(theirs.discriminator_loss(jnp.asarray(s), jnp.asarray(t))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ours.generator_loss(_t(t)).item(),
                               float(theirs.generator_loss(jnp.asarray(t))), rtol=1e-6,
                               atol=1e-9)
    # labels: a perfect discriminator has a near-zero loss, the generator pushes to 1
    big, small = torch.full((4, 1), 10.0), torch.full((4, 1), -10.0)
    assert ours.discriminator_loss(big, small) < 1e-3 < 5.0 < ours.discriminator_loss(small, big)
    np.testing.assert_allclose(ours.generator_loss(small).item(), lambda_adv
                               * F.binary_cross_entropy_with_logits(small, torch.ones(4, 1)).item(),
                               rtol=1e-6)


@pytest.mark.parametrize("temperature", [0.5, 1.0])
def test_consistency_loss_and_similarity_match_jax(temperature):
    rng = _rng(4)
    p1, p2 = (rng.normal(size=(B, H, W, C)).astype(np.float32) * 2 for _ in range(2))
    ours = losses.ConsistencyLoss(temperature)
    theirs = jax_losses.ConsistencyLoss(temperature)
    got = ours(_t(p1), _t(p2)).item()
    np.testing.assert_allclose(got, float(theirs(jnp.asarray(p1), jnp.asarray(p2))),
                               rtol=1e-6, atol=1e-6)
    t1, t2 = _t(p1) / temperature, _t(p2) / temperature
    golden = (F.kl_div(F.log_softmax(t1, -1), F.softmax(t2, -1), reduction="batchmean")
              + F.kl_div(F.log_softmax(t2, -1), F.softmax(t1, -1), reduction="batchmean")) / 2
    assert abs(got - golden.item()) < 1e-4
    assert abs(ours(_t(p1), _t(p1)).item()) < 1e-6
    sim = ours.get_similarity_matrix(_t(p1), _t(p2))
    assert sim.shape == (B, H, W)
    np.testing.assert_allclose(sim.numpy(), np.asarray(theirs.get_similarity_matrix(
        jnp.asarray(p1), jnp.asarray(p2))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("supervised", [False, True])
@pytest.mark.parametrize("epoch", [0, 1, 40, 80])
def test_fine_tuning_loss_matches_jax(epoch, supervised):
    rng = _rng(epoch + 10 * supervised)
    p1, p2 = (rng.normal(size=(B, H, W, C)).astype(np.float32) for _ in range(2))
    d = rng.normal(size=(B, 1)).astype(np.float32)
    kw, jkw = {}, {}
    if supervised:
        sp = rng.normal(size=(B, H, W, C)).astype(np.float32)
        st = rng.integers(0, C, (B, H, W))
        kw = dict(supervised_pred=_t(sp), supervised_target=_t(st))
        jkw = dict(supervised_pred=jnp.asarray(sp), supervised_target=jnp.asarray(st))
    ours = losses.FineTuningLoss(rampup_length=40)(_t(p1), _t(p2), _t(d), epoch, **kw)
    theirs = jax_losses.FineTuningLoss(rampup_length=40)(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(d), jnp.float32(epoch), **jkw)
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        assert ours[k].dtype == torch.float32 and ours[k].shape == ()
        np.testing.assert_allclose(ours[k].item(), float(v), rtol=1e-6, atol=1e-6, err_msg=k)
    assert all(not ours[k].requires_grad for k in ours if k != "total")
    if epoch == 0 and not supervised:
        assert ours["total"].item() == 0.0


def test_fine_tuning_rampup_and_detached_components():
    ft = losses.FineTuningLoss(rampup_length=40)
    for e in (0, 1, 7, 20, 39, 40, 60, 2.5):
        r = ft.rampup(e)
        assert r.dtype == torch.float32
        assert r.item() == float(jax_losses.FineTuningLoss(rampup_length=40).rampup(e))
    p = torch.randn(B, H, W, C, requires_grad=True)
    out = ft(p, p.detach() + 1, torch.zeros(B, 1, requires_grad=True), 20)
    out["total"].backward()
    assert p.grad is not None and out["consistency"].grad_fn is None


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
def test_binary_entropy_matches_jax():
    p = np.concatenate([np.linspace(-0.1, 1.1, 31), [0.0, 1.0, 0.5]]).astype(np.float32)
    np.testing.assert_allclose(metrics.binary_entropy(_t(p)).numpy(),
                               np.asarray(jax_metrics.binary_entropy(jnp.asarray(p))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("with_features", [False, True])
def test_domain_adaptation_metrics_match_jax(with_features):
    rng = _rng(5)
    ours, theirs = metrics.DomainAdaptationMetrics(), jax_metrics.DomainAdaptationMetrics()
    for i in range(4):
        sp = rng.random((3, 1)).astype(np.float32)
        tp = rng.random((3,)).astype(np.float32)
        if i == 2:
            sp[0], tp[0] = 0.5, 0.5                        # the thresholds' edges
        feats = {}
        if with_features:
            feats = dict(source_features=rng.normal(size=(3, 4, 4, 8)).astype(np.float32),
                         target_features=rng.normal(size=(3, 4, 4, 8)).astype(np.float32))
        # the port reads tensors (on any device) and numpy alike
        ours.update(_t(sp) if i % 2 else sp, tp, **{k: _t(v) for k, v in feats.items()})
        theirs.update(jnp.asarray(sp), jnp.asarray(tp), **feats)
    assert ours.get_metrics() == theirs.get_metrics()
    assert ours.get_confusion_metrics() == theirs.get_confusion_metrics()
    assert (ours.get_confusion_metrics()["feature_alignment"] != 0) == with_features
    ours.reset()
    assert ours.get_metrics() == {"source_domain_acc": 0.0, "target_domain_acc": 0.0,
                                  "domain_confusion": 0.0}


# ---------------------------------------------------------------------------
# the discriminator
# ---------------------------------------------------------------------------
def _disc_flat(seed=1):
    return random_variables(JaxDiscriminator(dtype=jnp.float32),
                            jnp.zeros((B, SIZE, SIZE, 3)), seed=seed)


def _port_disc(flat, dtype=torch.float32):
    disc = create_discriminator(dtype=dtype, device="cpu")
    disc.load_state_dict(from_jax_state_dict(flat), strict=True)
    return disc


def _inputs(seed=0, batch=4):
    return _rng(seed).normal(size=(batch, SIZE, SIZE, 3)).astype(np.float32)


@pytest.mark.parametrize("return_logits", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_discriminator_eval_forward_matches_jax(dtype, return_logits):
    flat, x = _disc_flat(), _inputs()
    theirs = np.asarray(JaxDiscriminator(dtype=jnp.dtype(dtype)).apply(
        jax_variables(flat), jnp.asarray(x), train=False, return_logits=return_logits))
    disc = _port_disc(flat, getattr(torch, dtype)).eval()
    with torch.no_grad():
        ours = disc(_t(x), return_logits=return_logits)
    assert ours.dtype == torch.float32 and ours.shape == (4, 1)
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=tol, atol=tol)
    if not return_logits:
        assert (ours >= 0).all() and (ours <= 1).all()


def test_discriminator_train_forward_statistics_and_gradients_match_jax():
    flat, x = _disc_flat(2), _inputs(1)
    labels = np.asarray([[1.0], [0.0], [1.0], [0.0]], np.float32)
    module = JaxDiscriminator(dtype=jnp.float32)
    variables = jax_variables(flat)

    def loss_fn(params):
        logits, mut = module.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                   jnp.asarray(x), train=True, return_logits=True,
                                   mutable=["batch_stats"])
        return jax_losses.sigmoid_bce_with_logits(logits, jnp.asarray(labels)), (logits, mut)

    (jloss, (jlogits, jmut)), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])
    disc = _port_disc(flat).train()
    logits = disc(_t(x), return_logits=True)
    loss = losses.sigmoid_bce_with_logits(logits, _t(labels))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    port = to_jax_state_dict(disc)
    for k, v in flatten_dict(jmut["batch_stats"], sep="/").items():
        np.testing.assert_allclose(port[f"batch_stats/{k}"], np.asarray(v), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
        assert not np.array_equal(port[f"batch_stats/{k}"], flat[f"batch_stats/{k}"])
    grads = to_jax_state_dict(disc, grads=True)
    jflat = {f"params/{k}": np.asarray(v) for k, v in flatten_dict(jgrads, sep="/").items()}
    assert set(grads) == set(jflat)
    largest = max(np.abs(v).max() for v in jflat.values())
    for k, v in jflat.items():
        np.testing.assert_allclose(grads[k], v, rtol=0, atol=1e-5 * largest, err_msg=k)
    # the conv biases in front of a BatchNorm have an exact zero gradient:
    # both libraries return float32 noise around it
    assert np.abs(jflat["params/conv3/bias"]).max() < 1e-6 * largest


def test_discriminator_weight_bridge_and_factory():
    flat = _disc_flat()
    disc = _port_disc(flat)
    back = to_jax_state_dict(disc)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert back["params/classifier/kernel"].shape == (512, 1)
    # seeded, eval mode, float32 parameters, channels_last convolutions
    a, b = (create_discriminator(seed=1, device="cpu", image_size=512) for _ in range(2))
    c = create_discriminator(seed=2, device="cpu")
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k])
    assert not torch.equal(a.conv2.weight, c.conv2.weight)
    assert not a.training and a.dtype == Config.compute_dtype()
    assert all(p.dtype == torch.float32 for p in a.parameters())
    assert a.conv3.weight.is_contiguous(memory_format=torch.channels_last)
    # lecun-normal kernels (truncated at 2 sigma), zero biases, unit BatchNorm scales
    fan_in = 4 * 4 * 128
    std = a.conv3.weight.std().item()
    assert abs(std - (1 / fan_in) ** 0.5) < 0.05 * (1 / fan_in) ** 0.5
    assert a.conv3.weight.abs().max() <= 2 * (1 / fan_in) ** 0.5 / 0.8796 + 1e-6
    assert not a.classifier.bias.any() and torch.equal(a.norm2.scale, torch.ones(128))


def test_discriminator_requires_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_discriminator()
    assert isinstance(create_discriminator(device="cpu"), DomainDiscriminator)


# ---------------------------------------------------------------------------
# DomainAdaptationModel
# ---------------------------------------------------------------------------
def test_domain_adaptation_model_matches_jax():
    seg_module = JaxUnet("resnet18", classes=CLASSES, dtype=jnp.float32)
    seg_flat = random_variables(seg_module, jnp.zeros((B, SIZE, SIZE, 3)), seed=3)
    disc_flat = _disc_flat(4)
    jax_model = JaxDomainAdaptationModel(
        ModelBundle(seg_module, jax_variables(seg_flat)),
        ModelBundle(JaxDiscriminator(dtype=jnp.float32), jax_variables(disc_flat)))
    seg = create_unet("resnet18", classes=CLASSES, dtype=torch.float32, device="cpu")
    seg.load_state_dict(from_jax_state_dict(seg_flat))
    model = DomainAdaptationModel(seg, _port_disc(disc_flat)).eval()

    # parameters() spans both models, as phase 3's single Adam needs
    assert len(list(model.parameters())) == (len(list(seg.parameters()))
                                             + len(list(model.discriminator.parameters())))
    theirs, ours = jax_model.state_dict(), model.state_dict()
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k], v, err_msg=k)

    x = _inputs(2, batch=B)
    with torch.no_grad():
        seg_pred, domain_pred = model(_t(x), domain_adaptation=True)
        assert model(_t(x)).shape == seg_pred.shape == (B, SIZE, SIZE, CLASSES)
    jseg, jdom = jax_model(jnp.asarray(x), domain_adaptation=True)
    np.testing.assert_allclose(seg_pred.numpy(), np.asarray(jseg), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(domain_pred.numpy(), np.asarray(jdom), rtol=1e-5, atol=1e-5)
    feats = model.get_features(_t(x))
    np.testing.assert_allclose(feats.numpy(), np.asarray(jax_model.get_features(jnp.asarray(x))),
                               rtol=2e-4, atol=2e-4)
    assert feats.shape == (B, SIZE // 32, SIZE // 32, 512) and not model.training

    # load_state_dict takes the JAX layout; a model without a discriminator
    # takes the segmentation part only
    other = DomainAdaptationModel(
        create_unet("resnet18", classes=CLASSES, seed=5, dtype=torch.float32, device="cpu"),
        create_discriminator(seed=6, dtype=torch.float32, device="cpu"))
    other.load_state_dict(theirs)
    for k, v in other.state_dict().items():
        np.testing.assert_array_equal(v, theirs[k], err_msg=k)
    alone = DomainAdaptationModel(
        create_unet("resnet18", classes=CLASSES, seed=5, dtype=torch.float32, device="cpu"))
    alone.load_state_dict(theirs)
    assert set(alone.state_dict()) == {k for k in theirs if k.startswith("segmentation_model/")}
    assert alone(_t(x)).shape == (B, SIZE, SIZE, CLASSES)


# ---------------------------------------------------------------------------
# the target-domain data
# ---------------------------------------------------------------------------
def _patch_paths(mp, cls, root):
    mp.setattr(cls, "DATA_DIR", str(root / "data"))
    mp.setattr(cls, "SAMPLE_DATA_DIR", str(root / "data" / "sample" / "semantic_drone"))
    mp.setattr(cls, "SAMPLE_HOLYROOD_DIR", str(root / "data" / "sample" / "holyrood"))
    mp.setattr(cls, "TARGET_DATA_DIR", str(root / "data" / "target" / "holyrood"))
    mp.setattr(cls, "NUM_CLASSES", 23)


@pytest.fixture(scope="module")
def target_fixtures(tmp_path_factory):
    """The same ``setup_test_data`` call in both packages: (JAX root, port root)."""
    roots = {}
    for name, cls, setup in (("jax", JaxConfig, jax_setup_test_data),
                             ("port", Config, setup_test_data)):
        root = tmp_path_factory.mktemp(f"target_{name}")
        with pytest.MonkeyPatch.context() as mp:
            _patch_paths(mp, cls, root)
            setup(num_source=3, num_holyrood=4, image_size=48, seed=42, force=True)
        roots[name] = root / "data"
    return roots["jax"], roots["port"]


def test_setup_test_data_writes_the_jax_target_fixtures(target_fixtures):
    jroot, proot = target_fixtures
    files = sorted(p.relative_to(jroot) for p in jroot.rglob("*") if p.is_file())
    assert len(files) == 2 * 3 + 2 + 2 * 4          # tiles, masks, two CSVs, two target sets
    assert files == sorted(p.relative_to(proot) for p in proot.rglob("*") if p.is_file())
    assert Path("target/holyrood/DJI_0003.jpg") in files
    for f in files:
        assert (jroot / f).read_bytes() == (proot / f).read_bytes(), f


@pytest.mark.parametrize("decoder,size", [("native", (32, 32)), ("native", (40, 24)),
                                          ("cv2", (32, 32)), ("cv2", None)])
def test_target_dataset_matches_jax(target_fixtures, monkeypatch, decoder, size):
    if decoder == "cv2":
        monkeypatch.setattr(jax_native, "_load", lambda: None)
        monkeypatch.setattr(native, "_load", lambda: None)
    else:
        assert native.available() and jax_native.available()
    images_dir = str(target_fixtures[1] / "target" / "holyrood")
    ours = TargetDataset(images_dir, target_size=size, verbose=False)
    theirs = JaxTargetDataset(images_dir, target_size=size, verbose=False)
    assert ours.images == theirs.images and len(ours) == len(theirs) == 4
    for i in range(len(ours)):
        a, b = ours.load_raw(i), theirs.load_raw(i)
        assert a.dtype == np.uint8 and a.shape == b.shape
        assert a.shape == ((48, 48, 3) if size is None else (size[1], size[0], 3))
        np.testing.assert_array_equal(a, b)
    flipped = TargetDataset(images_dir, target_size=size, verbose=False,
                            transform=lambda image: {"image": image[::-1]})
    np.testing.assert_array_equal(flipped[1], ours[1][::-1])


def test_create_sample_holyrood_matches_jax(target_fixtures, tmp_path):
    src = target_fixtures[1] / "target" / "holyrood"
    n = create_sample_holyrood(str(src), str(tmp_path / "port"), num_samples=3)
    m = jax_create_sample_holyrood(str(src), str(tmp_path / "jax"), num_samples=3)
    assert n == m == 3
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert create_sample_holyrood(str(src), str(tmp_path / "port"), num_samples=3) == 3
