"""The port's U-Net ``remat`` modes and bf16 ``logits_dtype`` (CPU, float32).

Every remat mode recomputes activations in the backward instead of saving
them; it must compute what ``remat=False`` computes.  Held here on the same
weights (numpy, seeded, through ``from_jax_state_dict``) and the same batch,
resnet18 U-Net, 64 px, 7 classes, B=2, one train step of
``make_supervised_train_step`` (no augmentation, ``adam(1e-3)``):

- logits before the step: bit-identical (the forward is the same code);
- gradients: within 1e-6 of each tensor's largest entry (the recompute
  repeats the same float32 operations in the same order on the CPU, so
  they are expected equal; measured: 0);
- BatchNorm buffers after the step: bit-identical (a recompute moves no
  statistics: ``ops.batch_norm.frozen_statistics``);
- the kernels' census: one ``channel_sums`` per BatchNorm forward plus one
  per BatchNorm that the mode recomputes, one ``channel_dual_sums`` per
  BatchNorm (counted on the plain versions the CPU runs).

``logits_dtype=bfloat16`` is held against the JAX ``Unet(logits_dtype=
jnp.bfloat16)`` on the same weights: float32 compute in both, so the logits
agree to the repo's 2e-4 before the cast, and after it to 2e-4 plus one
bf16 ulp (at most 2**-7 of the value: where the two float32 values straddle
a rounding boundary, each package rounds to another neighbour; measured on
0.13% of the values).
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_adversarial import few_torch_threads  # noqa: F401  (autouse)
from tests.test_torch_models import TOL, jax_variables, random_variables
from uda_aerial_semantic_segmentation_research_tpu.models import resnet as jax_resnet
from uda_aerial_semantic_segmentation_research_tpu.models.unet import Unet as JaxUnet
from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
    Unet,
    create_model,
    create_unet,
    from_jax_state_dict,
    to_jax_state_dict,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.models import resnet
from uda_aerial_semantic_segmentation_research_tpu_torch.models.unet import resolve_remat
from uda_aerial_semantic_segmentation_research_tpu_torch.ops import augment
from uda_aerial_semantic_segmentation_research_tpu_torch.ops import batch_norm as bn_mod
from uda_aerial_semantic_segmentation_research_tpu_torch.training import steps
from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import (
    TrainState,
    adam,
)

SIZE, CLASSES, BATCH = 64, 7, 2
MODES = [True, "encoder", "decoder", "convs", "encoder_convs", "decoder_convs", "stage1",
         "stage24"]
# resnet18: the stem and 8 blocks (2 BatchNorms each, 3 with a downsample) in
# the encoder, 5 blocks of 2 in the decoder
STAGE_BNS = {1: 4, 2: 5, 3: 5, 4: 5}
DECODER_BNS = 10


def _recomputed(mode):
    """The BatchNorms that ``mode`` runs again in the backward."""
    enc, dec = resolve_remat(mode)
    stages = resnet._remat_stage_set(enc)
    n = sum(STAGE_BNS[s] for s in stages) if stages else (sum(STAGE_BNS.values()) if enc
                                                           else 0)
    return n + (DECODER_BNS if dec else 0)


def _normalized(seed):
    """A seeded (B, 64, 64, 3) batch, ImageNet-normalized in float32."""
    images = np.random.default_rng(seed).integers(0, 256, (BATCH, SIZE, SIZE, 3),
                                                  dtype=np.uint8)
    return augment.normalize_images(torch.from_numpy(images)).numpy()


@pytest.fixture(scope="module")
def weights():
    module = JaxUnet("resnet18", classes=CLASSES, dtype=jnp.float32)
    return random_variables(module, jnp.zeros((BATCH, SIZE, SIZE, 3)), seed=31)


def _step(flat, remat, counts):
    model = create_unet("resnet18", classes=CLASSES, dtype=torch.float32, device="cpu",
                        remat=remat)
    model.load_state_dict(from_jax_state_dict(flat), strict=True)
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    masks = rng.integers(0, CLASSES, (BATCH, SIZE, SIZE)).astype(np.uint8)
    model.train()
    with torch.no_grad():
        logits = model(augment.normalize_images(torch.from_numpy(images)))
    # the forward above moved the buffers: start the step from the weights again
    model.load_state_dict(from_jax_state_dict(flat), strict=True)
    state = TrainState(model, adam(1e-3))
    counts.clear()
    steps.make_supervised_train_step(model, CLASSES, aug_cfg=augment.NONE)(
        state, None, images, masks)
    return (logits, {k: p.grad.clone() for k, p in model.named_parameters()},
            {k: b.clone() for k, b in model.named_buffers()}, dict(counts))


@pytest.fixture(scope="module")
def runs(weights):
    counts = {}
    real = {name: getattr(bn_mod, name) for name in ("channel_sums", "channel_dual_sums")}

    def counting(name):
        def run(*a, **k):
            counts[name] = counts.get(name, 0) + 1
            return real[name](*a, **k)
        return run

    with pytest.MonkeyPatch.context() as mp:
        for name in real:
            mp.setattr(bn_mod, name, counting(name))
        return {mode: _step(weights, mode, counts) for mode in [False] + MODES}


@pytest.mark.parametrize("mode", MODES)
def test_remat_mode_matches_no_remat(runs, mode):
    (logits, grads, buffers, counts), (ref_logits, ref_grads, ref_buffers, ref_counts) = (
        runs[mode], runs[False])
    assert torch.equal(logits, ref_logits)
    assert set(grads) == set(ref_grads)
    for k, g in grads.items():
        scale = ref_grads[k].abs().max()
        assert (g - ref_grads[k]).abs().max() <= 1e-6 * scale, k
    assert set(buffers) == set(ref_buffers)
    for k, b in buffers.items():
        assert torch.equal(b, ref_buffers[k]), k
    n_bn = ref_counts["channel_sums"]
    assert n_bn == 1 + sum(STAGE_BNS.values()) + DECODER_BNS == ref_counts["channel_dual_sums"]
    assert counts == {"channel_sums": n_bn + _recomputed(mode), "channel_dual_sums": n_bn}


def test_remat_changes_no_parameter_name(weights):
    """A checkpoint is the same in every mode: the weight bridge maps the same
    keys, and a clone shares the parameters and buffers it was made from."""
    base = create_unet("resnet18", classes=CLASSES, dtype=torch.float32, device="cpu")
    keys = set(to_jax_state_dict(base))
    for mode in MODES:
        model = create_unet("resnet18", classes=CLASSES, dtype=torch.float32, device="cpu",
                            remat=mode)
        assert set(to_jax_state_dict(model)) == keys, mode
        clone = base.clone(remat=mode)
        assert all(a is b for a, b in zip(clone.parameters(), base.parameters()))
        assert all(a is b for a, b in zip(clone.buffers(), base.buffers()))
        assert (clone.remat, base.remat, base.encoder.remat, base.decoder.remat) == (
            mode, False, False, False)
        assert (clone.encoder.remat, clone.decoder.remat) == resolve_remat(mode)


@pytest.mark.parametrize("spec", ["stage1", "stage12", "stage1234", "stage", "stage5",
                                  "stage0", "stagex", "encoder", "convs", True, False])
def test_remat_stage_spec_as_jax(spec):
    """``_remat_stage_set`` returns what the JAX function returns and raises
    where it raises; a bad spec fails at construction, in the U-Net and in a
    clone."""
    try:
        expected = jax_resnet._remat_stage_set(spec)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:12]):
            resnet._remat_stage_set(spec)
        with pytest.raises(ValueError):
            Unet("resnet18", classes=CLASSES, dtype=torch.float32, remat=spec)
        with pytest.raises(ValueError):
            Unet("resnet18", classes=CLASSES, dtype=torch.float32).clone(remat=spec)
        return
    assert resnet._remat_stage_set(spec) == expected


@pytest.mark.parametrize("train", [False, True])
def test_bf16_logits_match_jax(weights, train):
    x = _normalized(1)
    module = JaxUnet("resnet18", classes=CLASSES, dtype=jnp.float32,
                     logits_dtype=jnp.bfloat16)
    v = jax_variables(weights)
    if train:
        theirs, _ = module.apply(v, x, train=True, mutable=["batch_stats"])
    else:
        theirs = module.apply(v, x, train=False)
    assert theirs.dtype == jnp.bfloat16
    theirs = np.asarray(theirs.astype(jnp.float32))
    model = create_unet("resnet18", classes=CLASSES, dtype=torch.float32, device="cpu",
                        logits_dtype=torch.bfloat16)
    model.load_state_dict(from_jax_state_dict(weights), strict=True)
    model.train(train)
    with torch.no_grad():
        ours = model(torch.from_numpy(x))
        decoded = model.decode(model.encode(torch.from_numpy(x)))
    assert ours.dtype == decoded.dtype == torch.bfloat16 and torch.equal(ours, decoded)
    ours = ours.float().numpy()
    np.testing.assert_allclose(ours, theirs, rtol=2 ** -7, atol=TOL)


def test_clone_leaves_the_model_as_it_was(weights):
    """The trainer's clone (encoder remat, bf16 logits) shares the weights;
    the model keeps its float32 logits and its eval forward."""
    model = create_unet("resnet18", classes=CLASSES, dtype=torch.float32, device="cpu")
    model.load_state_dict(from_jax_state_dict(weights), strict=True)
    x = torch.from_numpy(_normalized(2))
    with torch.no_grad():
        before = model(x)
    clone = model.clone(remat="encoder", logits_dtype=torch.bfloat16)
    with torch.no_grad():
        cloned, after = clone(x), model(x)
    assert after.dtype == torch.float32 and torch.equal(after, before)
    assert cloned.dtype == torch.bfloat16 and torch.equal(cloned, before.to(torch.bfloat16))
    assert model.logits_dtype == torch.float32 and model.remat is False
    with pytest.raises(TypeError):
        model.clone(dtype=torch.bfloat16)


def test_frozen_statistics_leave_the_buffers():
    """Inside ``frozen_statistics`` a train-mode BatchNorm normalizes with the
    batch statistics and moves nothing; the flag is per thread and restored,
    also after an exception."""
    norm = bn_mod.BatchNorm(4, dtype=torch.float32).train()
    x = torch.randn(3, 4, 5, 5, generator=torch.Generator().manual_seed(0)).to(
        memory_format=torch.channels_last)
    with bn_mod.frozen_statistics():
        frozen = norm(x)
        assert bn_mod.statistics_frozen()
    assert torch.equal(norm.mean, torch.zeros(4)) and torch.equal(norm.var, torch.ones(4))
    assert torch.equal(frozen, norm(x)) and not torch.equal(norm.mean, torch.zeros(4))
    with pytest.raises(RuntimeError):
        with bn_mod.frozen_statistics():
            raise RuntimeError
    assert not bn_mod.statistics_frozen()


def test_factories_pass_the_options_through():
    for model in (create_unet("resnet18", classes=CLASSES, device="cpu", remat="encoder",
                              logits_dtype=torch.bfloat16),
                  create_model("Unet", "resnet18", classes=CLASSES, device="cpu",
                               remat="encoder", logits_dtype=torch.bfloat16)):
        assert model.remat == "encoder" and model.logits_dtype == torch.bfloat16
        assert model.encoder.remat is True and model.decoder.remat is False
        with torch.no_grad():
            assert model(torch.zeros(1, 32, 32, 3)).dtype == torch.bfloat16
    plain = create_unet("resnet18", classes=CLASSES, device="cpu")
    assert plain.remat is False and plain.logits_dtype == torch.float32
    same = copy.deepcopy(plain).clone()
    assert same.remat is False and same.logits_dtype == torch.float32
