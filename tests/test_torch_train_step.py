"""The port's train-mode model, supervised train step, eval step and
optimizer state against the JAX package (CPU, float32).

Identical weights (numpy, seeded; through ``from_jax_state_dict``) and
identical uint8 batches go through both packages; where the augmentation
draws, the port is fed the draws that the JAX step makes from
``fold_in(key, step)`` (``tests/torch_augment_draws.py``: the dihedral
elements and every later stage's parameters).  The ``weak`` cases build
both steps with the default augmentation, ``WEAK`` (all stages, bfloat16
pixel math; ``_run`` says what their gradients are held against).  Size:
resnet18, 64 px, 7 classes, batch 2.

Tolerances, and why:
- loss, IoU, accuracy: 1e-5 -- float32 on both sides, sums in another
  order.  ``hist`` may differ only by pixels whose two best JAX logits lie
  within 1e-3 of each other (their argmax is decided by float32 noise; the
  confusion matrix itself is held exactly in tests/test_torch_fused_ce.py).
- BatchNorm buffers: 1e-5 after the first step, 1e-4 after the second.
- gradients.  The components are held to 1e-5 in their own files.  Through
  the whole network the gradient is NOT a smooth function of float32
  rounding: a ReLU unit whose pre-activation is within noise of zero is on
  in one package and off in the other, and in a layer that sees n samples
  per channel that reroutes up to 1/n of the channel's gradient (n = 8 in
  the deepest stage here).  Measured: the port in float32 against itself in
  float64 differs by up to 1.7e-2 of a tensor's largest entry, with 3 of
  ~2M units flipped.  So: per tensor ``max|dg| <= 0.1 * max|g|``, over all
  parameters ``||dg|| <= 3e-2 * ||g||`` (measured here: 1e-2 and 3.5e-3), and the head's kernel, which sees
  every pixel, ``1e-4``.  After the second step (whose parameters already
  differ by Adam's sign noise, below) only ``||dg|| <= 0.1 * ||g||`` and
  ``1e-3`` for the head.
- updated parameters.  The first Adam update is ``lr * g / (|g| + 1e-8)``:
  ``+-lr`` whatever ``|g|``, so an entry whose gradient is noise around zero
  moves by ``+lr`` in one package and ``-lr`` in the other.  After the first
  step, every entry whose JAX gradient is at least 1% of its tensor's
  largest (64% of all entries) is held to ``0.02 * lr`` plus one float32
  ulp of the largest weights (1.2e-7; a flipped sign would be 2e-6); every entry to the
  trivial ``2.5 * lr`` per step; after the second step at most 10% of the
  entries may be off by more than ``0.1 * lr``.  No parameter tensor is
  excluded.  ``lr`` is 1e-6 so that the second step starts from nearly the
  same weights; the optimizer's arithmetic over several updates is held to
  1e-6 against optax without a model in between.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from tests.test_torch_adversarial import few_torch_threads  # noqa: F401  (autouse)
from tests.test_torch_models import jax_variables, random_variables
from tests.torch_augment_draws import augment_draws
from uda_aerial_semantic_segmentation_research_tpu.models.unet import Unet as JaxUnet
from uda_aerial_semantic_segmentation_research_tpu.ops import augment as jax_augment
from uda_aerial_semantic_segmentation_research_tpu.ops.losses import (
    softmax_cross_entropy as jax_ce,
)
from uda_aerial_semantic_segmentation_research_tpu.ops.pallas_ops import (
    fused_cross_entropy as jax_fused_ce,
)
from uda_aerial_semantic_segmentation_research_tpu.training import state as jax_state
from uda_aerial_semantic_segmentation_research_tpu.training import steps as jax_steps
from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
    create_unet,
    from_jax_state_dict,
    to_jax_state_dict,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops import augment
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.batch_norm import BatchNorm
from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import (
    TrainState,
    adam,
    clip_by_global_norm_,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.training.steps import (
    make_eval_step,
    make_supervised_train_step,
)

SIZE, CLASSES, BATCH, STEPS = 64, 7, 2, 2
LR = 1e-6
CLIP = 0.05          # below the gradients' global norm, so the clip acts
SCALAR_TOL = 1e-5
MARGIN = 1e-3        # two best logits closer than this: the argmax is noise
ULP = 1.2e-7         # float32 spacing of a weight in [1, 2), the largest here
SIGNIFICANT = 1e-2   # share of a tensor's largest gradient above which Adam's sign is safe
NO_STAGES = dict(p_ssr=0.0, p_distort=0.0, p_noise=0.0, p_blur=0.0, p_color=0.0,
                 p_hsv=0.0)
# name -> (augmentation, fused_ce, clip_norm)
CASES = {
    "no_aug": ("none", False, None),
    "dihedral": ("dihedral", False, None),
    "dihedral_fused": ("dihedral", True, None),
    "dihedral_clip": ("dihedral", False, CLIP),
    "dihedral_fused_clip": ("dihedral", True, CLIP),
    "weak": ("weak", False, None),
    "weak_fused_clip": ("weak", True, CLIP),
}


def _configs(kind):
    if kind == "none":
        return jax_augment.NONE, augment.NONE
    if kind == "weak":
        return jax_augment.WEAK, augment.WEAK
    return (dataclasses.replace(jax_augment.WEAK, compute_dtype="float32", **NO_STAGES),
            dataclasses.replace(augment.WEAK, compute_dtype="float32", **NO_STAGES))


def _batches():
    rng = np.random.default_rng(0)
    return [(rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8),
             rng.integers(0, CLASSES, (BATCH, SIZE, SIZE)).astype(np.uint8))
            for _ in range(STEPS)]


@functools.cache
def _weights():
    module = JaxUnet("resnet18", classes=CLASSES, dtype=jnp.float32)
    flat = random_variables(module, jnp.zeros((BATCH, SIZE, SIZE, 3), jnp.float32), seed=3)
    return module, flat


def _flat(tree):
    # copies: the JAX step donates its state, and a view would be overwritten
    return {"/".join(k): np.array(v) for k, v in flatten_dict(tree).items()}


def _port_model(flat, fused_eval=False):
    model = create_unet("resnet18", classes=CLASSES, dtype=torch.float32, device="cpu",
                        fused_eval=fused_eval)
    model.load_state_dict(from_jax_state_dict(flat), strict=True)
    return model


def _jax_state(flat, tx):
    variables = jax_variables(flat)
    return jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                                batch_stats=variables["batch_stats"],
                                opt_state=tx.init(variables["params"]), tx=tx)


@functools.cache
def _run(name):
    """Two steps of both packages; per step the metrics, the gradients
    (the optimizer's input: clipped where the case clips), the updated
    parameters and the BatchNorm buffers.

    The metrics are the JAX step's with its own augmentation.  For the
    ``weak`` kind (the default WEAK, bfloat16 pixel math) the two
    augmentations differ in a few values by one bfloat16 rounding (a warp
    coordinate one float32 ulp apart: ``tests/test_torch_augment_pipeline.py``),
    which at this batch of 2 moves the gradients by ~10% in relative L2
    (ReLU units flip in the 2x2 deepest stage).  So there the gradients,
    parameters and buffers are held against a second JAX chain: the JAX
    step with ``aug_cfg=NONE`` on the port's augmented batch (as float32 in
    [0, 1]; NONE only normalizes it, as the port's step does), and the two
    augmented batches against each other."""
    kind, fused, clip = CASES[name]
    jcfg, pcfg = _configs(kind)
    module, flat = _weights()
    tx = jax_state.adam(LR, clip)
    jstate = _jax_state(flat, tx)
    # the weak cases take the factories' default augmentation
    aug = {} if kind == "weak" else {"aug_cfg": jcfg}
    jstep = jax_steps.make_supervised_train_step(module, CLASSES, fused_ce=fused, **aug)
    on_port_batch = kind == "weak"
    if on_port_batch:
        ref_state = _jax_state(flat, tx)
        ref_step = jax_steps.make_supervised_train_step(module, CLASSES, fused_ce=fused,
                                                        aug_cfg=jax_augment.NONE)
    ce = jax_fused_ce if fused else jax_ce

    @functools.partial(jax.jit, static_argnames="cfg")
    def jgrads(params, batch_stats, key, images, masks, cfg):
        x, m = jax_augment.augment_batch(key, images, masks, cfg=cfg)

        def loss_fn(p):
            logits, _ = jax_steps._apply_train(module, p, batch_stats, x)
            return ce(logits, m), logits

        g, logits = jax.grad(loss_fn, has_aux=True)(params)
        norm = optax.global_norm(g)
        if clip is not None:
            g, _ = optax.clip_by_global_norm(clip).update(g, optax.EmptyState())
        best = jax.lax.top_k(logits, 2)[0]
        return g, norm, jnp.sum(best[..., 0] - best[..., 1] < MARGIN)

    model = _port_model(flat)
    pstate = TrainState(model, adam(LR, clip))
    aug = {} if kind == "weak" else {"aug_cfg": pcfg}
    pstep = make_supervised_train_step(model, CLASSES, fused_ce=fused, **aug)
    assert kind != "weak" or (jcfg == jax_steps.make_supervised_train_step.__defaults__[0]
                              and pcfg == make_supervised_train_step.__defaults__[0])

    key = jax.random.key(5)
    out = []
    for i, (images, masks) in enumerate(_batches()):
        step_key = jax.random.fold_in(key, i)
        abc = params = None
        if kind != "none":
            abc, params = augment_draws(step_key, images.shape, jcfg, has_masks=True)
        extra = {}
        _, _, ambiguous = jgrads(jstate.params, jstate.batch_stats, step_key,
                                 jnp.asarray(images), jnp.asarray(masks), cfg=jcfg)
        if on_port_batch:
            x_aug, m_aug = augment.augment_batch(None, torch.from_numpy(images),
                                                 torch.from_numpy(masks), cfg=pcfg, abc=abc,
                                                 params=params, normalize=False)
            jx_aug, jm_aug = jax_augment.augment_batch(step_key, jnp.asarray(images),
                                                       jnp.asarray(masks), cfg=jcfg,
                                                       normalize=False)
            extra = dict(aug_diff=np.abs(x_aug.numpy() - np.asarray(jx_aug)),
                         masks_equal=np.array_equal(m_aug.numpy(), np.asarray(jm_aug)))
            ref_batch = (jnp.asarray(x_aug.numpy()), jnp.asarray(m_aug.numpy()))
            jg, norm, _ = jgrads(ref_state.params, ref_state.batch_stats, step_key,
                                 *ref_batch, cfg=jax_augment.NONE)
            ref_state, _ = ref_step(ref_state, key, *ref_batch)
        else:
            jg, norm, _ = jgrads(jstate.params, jstate.batch_stats, step_key,
                                 jnp.asarray(images), jnp.asarray(masks), cfg=jcfg)
        jg = _flat({"params": jg})
        assert int(jstate.step) == pstate.step == i
        jstate, jm = jstep(jstate, key, jnp.asarray(images), jnp.asarray(masks))
        pstate, pm = pstep(pstate, None, images.copy(), masks.copy(), abc=abc, params=params)
        final = ref_state if on_port_batch else jstate
        out.append(dict(
            jax_metrics={k: np.array(v) for k, v in jm.items()},
            port_metrics={k: v.numpy() for k, v in pm.items()},
            jax_grads=jg, port_grads=to_jax_state_dict(model, grads=True),
            grad_norm=float(norm), ambiguous=int(ambiguous),
            jax_state=_flat({"params": final.params, "batch_stats": final.batch_stats}),
            port_state=to_jax_state_dict(model), **extra))
    return out


# ---------------------------------------------------------------------------
# the supervised train step as a whole
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(CASES))
def test_train_step_metrics_match_jax(name):
    for step in _run(name):
        jm, pm = step["jax_metrics"], step["port_metrics"]
        assert set(pm) == set(jm) == {"loss", "iou", "accuracy", "per_class_iou", "hist"}
        assert pm["hist"].dtype == np.int32 and pm["hist"].sum() == BATCH * SIZE * SIZE
        np.testing.assert_array_equal(pm["hist"].sum(1), jm["hist"].sum(1))   # true labels
        # a pixel that changes its prediction leaves one cell and enters another
        assert np.abs(pm["hist"] - jm["hist"]).sum() <= 2 * step["ambiguous"]
        np.testing.assert_allclose(pm["loss"], jm["loss"], rtol=SCALAR_TOL, atol=SCALAR_TOL)
        slack = step["ambiguous"] / (BATCH * SIZE * SIZE) * CLASSES
        for k in ("iou", "accuracy", "per_class_iou"):
            np.testing.assert_allclose(pm[k], jm[k], rtol=SCALAR_TOL,
                                       atol=SCALAR_TOL + slack, err_msg=k)
        if "aug_diff" in step:      # the two augmentations: tests/test_torch_augment_pipeline.py
            assert step["masks_equal"]
            assert step["aug_diff"].max() <= 2.0 ** -4
            assert (step["aug_diff"] > 0).mean() <= 0.01


def _all(tensors, keys):
    return np.concatenate([tensors[k].ravel() for k in keys])


@pytest.mark.parametrize("name", list(CASES))
def test_train_step_gradients_match_jax(name):
    clip = CASES[name][2]
    for i, step in enumerate(_run(name)):
        jg, pg = step["jax_grads"], step["port_grads"]
        assert set(pg) == set(jg)
        keys = sorted(jg)
        if clip is not None:       # the clip acted, and the port's gradients are clipped
            assert step["grad_norm"] > 2 * clip
            np.testing.assert_allclose(np.linalg.norm(_all(pg, keys)), clip, rtol=1e-3)
        rel_l2 = (np.linalg.norm(_all(pg, keys) - _all(jg, keys))
                  / np.linalg.norm(_all(jg, keys)))
        head = "params/segmentation_head/kernel"
        head_err = np.abs(pg[head] - jg[head]).max() / np.abs(jg[head]).max()
        if i == 0:
            assert rel_l2 <= 3e-2 and head_err <= 1e-4, (rel_l2, head_err)
            for k in keys:
                np.testing.assert_allclose(pg[k], jg[k], rtol=0,
                                           atol=0.1 * np.abs(jg[k]).max(), err_msg=k)
        else:
            assert rel_l2 <= 0.1 and head_err <= 1e-3, (rel_l2, head_err)


@pytest.mark.parametrize("name", list(CASES))
def test_train_step_updated_parameters_match_jax(name):
    _, flat = _weights()
    for i, step in enumerate(_run(name)):
        keys = sorted(k for k in step["jax_state"] if k.startswith("params/"))
        diff = np.abs(_all(step["port_state"], keys) - _all(step["jax_state"], keys))
        assert diff.max() <= 2.5 * LR * (i + 1)
        moved = np.abs(_all(step["jax_state"], keys) - _all(flat, keys))
        assert (moved > 0.5 * LR).mean() > 0.8          # Adam moved nearly every entry
        if i == 0:
            significant = np.concatenate(
                [(np.abs(step["jax_grads"][k]) >= SIGNIFICANT
                  * np.abs(step["jax_grads"][k]).max()).ravel() for k in keys])
            assert significant.mean() > 0.5
            assert diff[significant].max() <= 0.02 * LR + ULP
        else:
            assert (diff > 0.1 * LR).mean() <= 0.1


@pytest.mark.parametrize("name", list(CASES))
def test_train_step_batch_norm_buffers_match_jax(name):
    _, flat = _weights()
    n_norms = sum(isinstance(m, BatchNorm) for m in _port_model(flat).modules())
    for i, step in enumerate(_run(name)):
        keys = [k for k in step["jax_state"] if k.startswith("batch_stats/")]
        assert len(keys) == 2 * n_norms
        tol = 1e-5 if i == 0 else 1e-4
        for k in keys:
            np.testing.assert_allclose(step["port_state"][k], step["jax_state"][k],
                                       rtol=tol, atol=tol, err_msg=k)
            assert not np.array_equal(step["port_state"][k], flat[k])      # they moved


def test_train_step_draws_from_the_generator_and_repeats_with_the_seed():
    _, flat = _weights()
    _, pcfg = _configs("dihedral")
    images = np.random.default_rng(1).integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    masks = np.random.default_rng(2).integers(0, CLASSES, (8, 32, 32)).astype(np.uint8)
    losses = []
    for seed in (0, 0, 1):
        model = _port_model(flat)
        state = TrainState(model, adam(LR))
        step = make_supervised_train_step(model, CLASSES, aug_cfg=pcfg)
        gen = torch.Generator().manual_seed(seed)
        run = []
        for _ in range(2):
            state, metrics = step(state, gen, images, masks)
            run.append(metrics["loss"].item())
        assert state.step == 2 and model.training
        losses.append(run)
    assert losses[0] == losses[1] and losses[0] != losses[2]


def test_train_step_factory_validates_like_jax():
    _, flat = _weights()
    model = _port_model(flat)
    with pytest.raises(ValueError, match="seg_loss"):
        make_supervised_train_step(model, CLASSES, aug_cfg=augment.NONE, seg_loss="focal")
    with pytest.raises(ValueError, match="class_weights"):
        make_supervised_train_step(model, CLASSES, aug_cfg=augment.NONE, fused_ce=True,
                                   class_weights=np.ones(CLASSES, np.float32))
    with pytest.raises(ValueError, match="dice"):
        make_supervised_train_step(model, CLASSES, aug_cfg=augment.NONE, seg_loss="dice",
                                   fused_ce=True)
    # seg_loss="dice" trains with SMPDiceLoss (held against JAX in tests/test_torch_trainer.py)
    dice_state, dice_metrics = make_supervised_train_step(
        model, CLASSES, aug_cfg=augment.NONE, seg_loss="dice")(
        TrainState(model, adam(LR)), None, *_batches()[0])
    assert dice_state.step == 1 and 0.0 <= dice_metrics["loss"].item() <= 1.0
    # WEAK by default, as in the JAX package: every stage runs on the CPU
    weak = make_supervised_train_step(model, CLASSES)
    weak_state, metrics = weak(TrainState(model, adam(LR)), torch.Generator().manual_seed(0),
                               *_batches()[0])
    assert weak_state.step == 1 and np.isfinite(metrics["loss"].item())
    assert metrics["hist"].sum().item() == BATCH * SIZE * SIZE
    dice_eval = make_eval_step(model, CLASSES, seg_loss="dice")(*_batches()[0])
    assert 0.0 <= dice_eval["loss"].item() <= 1.0
    assert dice_eval["hist"].sum().item() == BATCH * SIZE * SIZE
    with pytest.raises(ValueError, match="seg_loss"):
        make_eval_step(model, CLASSES, seg_loss="focal")
    step = make_supervised_train_step(model, CLASSES, aug_cfg=augment.NONE)
    other = TrainState(_port_model(flat), adam(LR))
    with pytest.raises(ValueError, match="another model"):
        step(other, None, *_batches()[0])


def test_train_step_with_class_weights_matches_jax():
    module, flat = _weights()
    weights = np.linspace(0.5, 2.0, CLASSES).astype(np.float32)
    images, masks = _batches()[0]
    variables = jax_variables(flat)
    tx = jax_state.adam(LR)
    jstate = jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                                  batch_stats=variables["batch_stats"],
                                  opt_state=tx.init(variables["params"]), tx=tx)
    jstep = jax_steps.make_supervised_train_step(module, CLASSES, aug_cfg=jax_augment.NONE,
                                                 class_weights=weights)
    _, jm = jstep(jstate, jax.random.key(0), jnp.asarray(images), jnp.asarray(masks))
    model = _port_model(flat)
    pstep = make_supervised_train_step(model, CLASSES, aug_cfg=augment.NONE,
                                       class_weights=weights)
    _, pm = pstep(TrainState(model, adam(LR)), None, images, masks)
    np.testing.assert_allclose(pm["loss"].item(), float(jm["loss"]), rtol=SCALAR_TOL)


# ---------------------------------------------------------------------------
# the model in train mode
# ---------------------------------------------------------------------------
def test_train_mode_unet_matches_jax():
    """Logits, new BatchNorm buffers and parameter gradients (of a fixed
    random projection of the logits) vs ``Unet.apply(train=True,
    mutable=['batch_stats'])``."""
    module, flat = _weights()
    variables = jax_variables(flat)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(BATCH, SIZE, SIZE, 3)).astype(np.float32)
    w = rng.normal(size=(BATCH, SIZE, SIZE, CLASSES)).astype(np.float32)

    def loss_fn(params):
        logits, upd = module.apply({"params": params,
                                    "batch_stats": variables["batch_stats"]},
                                   jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.mean(logits * w), (logits, upd["batch_stats"])

    (_, (logits_ref, stats_ref)), grads_ref = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])

    model = _port_model(flat, fused_eval=True).train()     # fused_eval is eval-only
    logits = model(torch.from_numpy(x))
    (logits * torch.from_numpy(w)).mean().backward()
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_ref),
                               rtol=2e-4, atol=2e-4)
    state = to_jax_state_dict(model)
    for k, ref in _flat({"batch_stats": stats_ref}).items():
        np.testing.assert_allclose(state[k], ref, rtol=1e-5, atol=1e-6, err_msg=k)
    grads = to_jax_state_dict(model, grads=True)
    for k, ref in _flat({"params": grads_ref}).items():
        np.testing.assert_allclose(grads[k], ref, rtol=0, atol=0.1 * np.abs(ref).max(),
                                   err_msg=k)
    ref = _flat({"params": grads_ref})
    keys = sorted(ref)
    assert (np.linalg.norm(_all(grads, keys) - _all(ref, keys))
            <= 3e-2 * np.linalg.norm(_all(ref, keys)))
    head = "params/segmentation_head/kernel"
    np.testing.assert_allclose(grads[head], ref[head], rtol=0,
                               atol=1e-4 * np.abs(ref[head]).max())


def test_to_jax_state_dict_inverts_the_weight_bridge():
    _, flat = _weights()
    model = _port_model(flat)
    back = to_jax_state_dict(model)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    with pytest.raises(ValueError, match="without a gradient"):
        to_jax_state_dict(model, grads=True)


# ---------------------------------------------------------------------------
# the eval step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fused_eval", [False, True])
def test_eval_step_matches_jax(fused_eval):
    module, flat = _weights()
    variables = jax_variables(flat)
    images, masks = _batches()[0]
    jm = jax_steps.make_eval_step(module, CLASSES)(
        variables["params"], variables["batch_stats"], jnp.asarray(images),
        jnp.asarray(masks))
    model = _port_model(flat, fused_eval=fused_eval).train()     # the step sets eval mode
    pm = make_eval_step(model, CLASSES)(images, masks)
    assert not model.training
    np.testing.assert_array_equal(pm["hist"].numpy(), np.asarray(jm["hist"]))
    for k in ("loss", "iou", "accuracy", "per_class_iou"):
        np.testing.assert_allclose(pm[k].numpy(), np.asarray(jm[k]), rtol=SCALAR_TOL,
                                   atol=SCALAR_TOL, err_msg=k)
    for k, v in to_jax_state_dict(model).items():                # nothing moved
        np.testing.assert_array_equal(v, flat[k], err_msg=k)


# ---------------------------------------------------------------------------
# optimizer state
# ---------------------------------------------------------------------------
def _random_tree(seed, scale):
    rng = np.random.default_rng(seed)
    return {"a": (scale * rng.normal(size=(5, 3))).astype(np.float32),
            "b": (scale * rng.normal(size=(7,))).astype(np.float32)}


@pytest.mark.parametrize("scale", [1e-3, 1.0])
def test_clip_by_global_norm_matches_optax(scale):
    """Below the threshold the gradients are untouched, above it they are
    ``(g / norm) * max_norm`` -- optax's arithmetic, not
    ``clip_grad_norm_``'s ``norm + 1e-6``."""
    tree = _random_tree(0, scale)
    ref, _ = optax.clip_by_global_norm(0.1).update(
        {k: jnp.asarray(v) for k, v in tree.items()}, optax.EmptyState())
    grads = [torch.from_numpy(v.copy()) for v in tree.values()]
    norm = clip_by_global_norm_(grads, 0.1)
    np.testing.assert_allclose(norm.item(), float(optax.global_norm(tree)), rtol=1e-6)
    for g, (k, r) in zip(grads, ref.items()):
        if scale < 1.0:
            np.testing.assert_array_equal(g.numpy(), tree[k])
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=0)


@pytest.mark.parametrize("clip", [None, 0.5])
def test_adam_matches_optax_over_three_updates(clip):
    params = _random_tree(1, 1.0)
    tx = jax_state.adam(1e-2, clip)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jparams)

    class Leaves(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for k, v in params.items():
                self.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))

    model = Leaves()
    state = TrainState(model, adam(1e-2, clip))
    assert state.clip_norm == clip and state.step == 0
    for i in range(3):
        grads = _random_tree(10 + i, 1.0)
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[k].copy())
        state.apply_gradients()
    assert state.step == 3
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]),
                                   rtol=1e-6, atol=1e-6)
