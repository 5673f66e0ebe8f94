"""The port's GRL steps (``make_grl_sequential_step``, its alias
``make_grl_train_step``, and ``make_grl_eval_step``) against the JAX
package's joint and sequential steps (CPU, float32).

Identical weights (numpy, seeded; through ``from_jax_state_dict``) and uint8
batches go through both packages; resnet18 ``UDASegmentationModel`` at
64 px, 7 classes, B=2, ``lambda_domain`` 0.5 (large, so that the domain
term's gradient shows) and ``alpha`` 0.7.  Both packages augment with
``NONE`` (every stage off), so no random draw enters a step, except in
one test, where the dihedral stage is on and the port is given the draws
JAX makes from its key (``tests/torch_augment_draws.py``).

Tolerances, and why (``tests/test_torch_adversarial.py`` gives the
reasons in full):
- losses 1e-5; ``domain_acc`` exact (no logit within 1e-4 of 0 here,
  checked); IoU / accuracy 2e-3 and the confusion matrix within 0.1% of the
  pixels;
- BatchNorm buffers 1e-5;
- parameters after one Adam step at ``lr`` 1e-6: every entry within
  ``2.5 * lr``, and the entries whose gradient is at least 10% of their
  tensor's largest within ``0.02 * lr`` plus one float32 ulp;
- ``domain_only`` against the full target traversal, in the port: domain
  logits and gradients bit-equal, the encoder's and head's buffers
  bit-equal, only the decoder's buffers differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from tests.test_torch_adversarial import (
    JCFG,
    KEY,
    PCFG,
    ULP,
    _all,
    _draws,
    _jax_train_state,
    _significant,
    few_torch_threads,  # noqa: F401  (a module-scoped autouse fixture)
)
from tests.test_torch_uda import _port_uda, _uda_weights
from uda_aerial_semantic_segmentation_research_tpu.ops import augment as jax_augment
from uda_aerial_semantic_segmentation_research_tpu.training import steps as jax_steps
from uda_aerial_semantic_segmentation_research_tpu_torch.models import to_jax_state_dict
from uda_aerial_semantic_segmentation_research_tpu_torch.ops import augment
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.losses import (
    sigmoid_bce_with_logits,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.training import steps
from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import (
    TrainState,
    adam,
)

SIZE, CLASSES, BATCH = 64, 7, 2
LR, LAMBDA, ALPHA = 1e-6, 0.5, 0.7
METRICS = {"loss", "seg_loss", "domain_loss", "domain_acc", "iou", "accuracy",
           "per_class_iou", "hist"}
FACTORIES = {"joint": ("make_grl_train_step", steps.make_grl_train_step),
             "sequential": ("make_grl_sequential_step", steps.make_grl_sequential_step)}


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8),
            rng.integers(0, CLASSES, (BATCH, SIZE, SIZE)).astype(np.uint8),
            np.clip(rng.integers(0, 256, (BATCH, SIZE, SIZE, 3)) * 0.7 + 40, 0,
                    255).astype(np.uint8))


def _flat(tree):
    return {"/".join(k): np.array(v) for k, v in flatten_dict(tree).items()}


def _port_step(kind, **kw):
    """A port model with the test's weights, its state and one ``kind`` step."""
    model = _port_uda("resnet18", _uda_weights("resnet18", SIZE)[1])
    step = FACTORIES[kind][1](model, CLASSES, lambda_domain=LAMBDA, aug_cfg=augment.NONE,
                              **kw)
    return model, TrainState(model, adam(LR)), step


def _run_port(kind, batch, **kw):
    model, state, step = _port_step(kind, **kw)
    _, metrics = step(state, torch.Generator().manual_seed(0), *batch, ALPHA)
    assert state.step == 1
    return model, {k: v.numpy() for k, v in metrics.items()}


@pytest.fixture(scope="module", params=sorted(FACTORIES))
def step_run(request):
    """One step of the ``kind`` step in both packages, from the same weights."""
    kind = request.param
    module, flat = _uda_weights("resnet18", SIZE)
    batch = _batch()
    jstep = getattr(jax_steps, FACTORIES[kind][0])(module, CLASSES, lambda_domain=LAMBDA,
                                                   aug_cfg=jax_augment.NONE)
    jm, jstate = _jax_run(jstep, flat, batch)
    model, pm = _run_port(kind, batch)
    return dict(kind=kind, flat=flat, jax_metrics=jm, port_metrics=pm, jax_state=jstate,
                port_state=to_jax_state_dict(model),
                grads=to_jax_state_dict(model, grads=True))


def _check_metrics(jm, pm, seg_loss="dice"):
    assert set(pm) == set(jm) == METRICS
    for k in ("loss", "seg_loss", "domain_loss"):
        np.testing.assert_allclose(pm[k], jm[k], rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(pm["loss"], pm["seg_loss"] + LAMBDA * pm["domain_loss"],
                               rtol=1e-6)
    if seg_loss == "dice":
        assert 0.0 <= pm["seg_loss"] <= 1.0                  # dice, not CE
    else:
        assert pm["seg_loss"] > 1.0                          # ln(7) scale, not dice
    assert pm["domain_acc"] == jm["domain_acc"]
    assert pm["hist"].sum() == BATCH * SIZE * SIZE
    assert np.abs(pm["hist"] - jm["hist"]).sum() <= 2 * int(1e-3 * BATCH * SIZE * SIZE)
    for k in ("iou", "accuracy"):
        np.testing.assert_allclose(pm[k], jm[k], rtol=0, atol=2e-3, err_msg=k)


def _check_update(theirs, ours, initial, grads):
    assert set(ours) == set(theirs)
    for k in theirs:
        if k.startswith("batch_stats/"):
            np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-5, atol=1e-5, err_msg=k)
            # domain_only target traversal: the decoder saw the source batch only
            assert not np.array_equal(ours[k], initial[k]), k
    keys = sorted(k for k in theirs if k.startswith("params/"))
    assert {k.split("/")[1] for k in keys} == {"net", "domain_discriminator"}
    diff = np.abs(_all(ours, keys) - _all(theirs, keys))
    assert diff.max() <= 2.5 * LR
    assert (np.abs(_all(theirs, keys) - _all(initial, keys)) > 0.5 * LR).mean() > 0.8
    significant = _all(_significant(grads, keys), keys)
    assert significant.mean() > 0.05
    assert diff[significant].max() <= 0.02 * LR + ULP


def _jax_run(jstep, flat, batch, key=KEY):
    jstate, jm = jstep(_jax_train_state(flat, LR), jax.random.key(key),
                       *map(jnp.asarray, batch), jnp.float32(ALPHA))
    return ({k: np.array(v) for k, v in jm.items()},
            _flat({"params": jstate.params, "batch_stats": jstate.batch_stats}))


def test_grl_step_metrics_match_jax(step_run):
    _check_metrics(step_run["jax_metrics"], step_run["port_metrics"])


def test_grl_step_update_matches_jax(step_run):
    _check_update(step_run["jax_state"], step_run["port_state"], step_run["flat"],
                  step_run["grads"])


def test_no_domain_logit_sits_at_the_threshold():
    """The premise of the exact ``domain_acc``: the domain logits of the
    steps' train-mode forwards (recomputed, each test's batches) lie away
    from 0."""
    model = _port_uda("resnet18", _uda_weights("resnet18", SIZE)[1]).train()
    batch = _batch(5)
    xs, _, xt = steps._grl_inputs(
        model, None, *batch, PCFG,
        _draws(jax.random.fold_in(jax.random.key(KEY), 0), batch[0].shape, batch[2].shape))
    inputs = [augment.normalize_images(torch.from_numpy(b[i]))
              for b in (_batch(), _batch(1)) for i in (0, 2)] + [xs, xt]
    with torch.no_grad():
        for x in inputs:
            d = model(x, domain_adaptation=True, domain_only=True)[1]
            assert (d.abs() > 1e-4).all()


# ---------------------------------------------------------------------------
# one body against JAX's joint step and JAX's draws; the domain_only traversal
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seg_loss", ["dice", "ce"])
def test_grl_sequential_step_matches_the_joint_step(seg_loss):
    """The port has one GRL body (two backward passes; ``make_grl_train_step``
    is its alias).  Held against the JAX package's joint, single-backward
    step, on another batch than ``step_run``'s, with both criteria."""
    assert steps.make_grl_train_step is steps.make_grl_sequential_step
    module, flat = _uda_weights("resnet18", SIZE)
    batch = _batch(1)
    jm, jstate = _jax_run(jax_steps.make_grl_train_step(
        module, CLASSES, lambda_domain=LAMBDA, aug_cfg=jax_augment.NONE, seg_loss=seg_loss),
        flat, batch)
    model, pm = _run_port("sequential", batch, seg_loss=seg_loss)
    _check_metrics(jm, pm, seg_loss)
    _check_update(jstate, to_jax_state_dict(model), flat, to_jax_state_dict(model, grads=True))


def test_grl_step_matches_jax_on_its_own_draws():
    """One step with the dihedral stage on (``PCFG`` / ``JCFG``: WEAK,
    float32, every other stage off): the port is given the draws the JAX
    step makes from its key (``fold_in(key, 0)``, then ``k1`` for the source
    and ``k2`` for the target), so the draw order is held against JAX's."""
    module, flat = _uda_weights("resnet18", SIZE)
    batch = _batch(5)
    jm, jstate = _jax_run(jax_steps.make_grl_sequential_step(
        module, CLASSES, lambda_domain=LAMBDA, aug_cfg=JCFG), flat, batch)
    model = _port_uda("resnet18", flat)
    draws = _draws(jax.random.fold_in(jax.random.key(KEY), 0), batch[0].shape,
                   batch[2].shape)
    _, pm = steps.make_grl_sequential_step(model, CLASSES, lambda_domain=LAMBDA,
                                           aug_cfg=PCFG)(
        TrainState(model, adam(LR)), None, *batch, ALPHA, draws=draws)
    _check_metrics(jm, {k: v.numpy() for k, v in pm.items()})
    _check_update(jstate, to_jax_state_dict(model), flat, to_jax_state_dict(model, grads=True))


def test_grl_domain_only_target_traversal_is_gradient_exact():
    """The target traversal of the step runs ``domain_only``: against the
    full traversal in train mode, the domain logits and every parameter's
    gradient of the step's target term are bit-equal, and only the
    decoder's BatchNorm buffers differ (they did not see the batch)."""
    flat = _uda_weights("resnet18", SIZE)[1]
    x = augment.normalize_images(torch.from_numpy(_batch(2)[2]))
    runs = {}
    for domain_only in (True, False):
        model = _port_uda("resnet18", flat).train()
        seg, d = model(x, domain_adaptation=True, alpha=ALPHA, domain_only=domain_only)
        assert (seg is None) == domain_only
        ((LAMBDA / 2.0) * sigmoid_bce_with_logits(d, torch.zeros_like(d))).backward()
        runs[domain_only] = (model, d.detach())
    (fast, d_fast), (full, d_full) = runs[True], runs[False]
    assert torch.equal(d_fast, d_full)
    for (k, p), q in zip(fast.named_parameters(), full.parameters()):
        reached = k.startswith(("net.encoder.", "domain_discriminator."))
        assert (p.grad is None) == (q.grad is None) == (not reached), k
        assert p.grad is None or torch.equal(p.grad, q.grad), k
    decoder_moved = []
    for (k, b), c in zip(fast.named_buffers(), full.buffers()):
        if k.startswith("net.decoder."):
            decoder_moved.append(not torch.equal(b, c))
        else:
            assert torch.equal(b, c), k
    assert decoder_moved and all(decoder_moved)


def test_grl_step_checks_its_state_and_loss_name():
    model, state, step = _port_step("joint")
    other, _, _ = _port_step("sequential")
    with pytest.raises(ValueError, match="another model"):
        step(TrainState(other, adam(LR)), None, *_batch(), ALPHA)
    for factory in (steps.make_grl_train_step, steps.make_grl_sequential_step,
                    steps.make_grl_eval_step):
        with pytest.raises(ValueError, match="seg_loss"):
            factory(model, CLASSES, seg_loss="focal")


def test_grl_step_draws_source_then_target_and_takes_a_device_alpha():
    """The draws come from the generator: source, then target (the draws given
    explicitly in that order reproduce the step); ``alpha`` as a 0-d tensor
    gives the update of the same float."""
    src, msk, tgt = _batch(3)
    cfg = PCFG                         # WEAK, float32, the dihedral stage only
    copy = torch.Generator().manual_seed(9)
    draws = ((augment._sample_dihedral(copy, BATCH, cfg), None),
             (augment._sample_dihedral(copy, BATCH, cfg), None))
    results = []
    for generator, d, alpha in ((torch.Generator().manual_seed(9), None, ALPHA),
                                (None, draws, torch.tensor(ALPHA))):
        model = _port_uda("resnet18", _uda_weights("resnet18", SIZE)[1])
        state = TrainState(model, adam(LR))
        _, m = steps.make_grl_train_step(model, CLASSES, lambda_domain=LAMBDA, aug_cfg=cfg)(
            state, generator, src, msk, tgt, alpha, draws=d)
        results.append((m, [p.detach().clone() for p in model.parameters()]))
    (m1, p1), (m2, p2) = results
    for k in ("loss", "domain_acc", "hist"):
        assert torch.equal(m1[k], m2[k]), k
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))


# ---------------------------------------------------------------------------
# the eval step
# ---------------------------------------------------------------------------
def test_grl_eval_step_matches_jax():
    module, flat = _uda_weights("resnet18", SIZE)
    src, msk, tgt = _batch(4)
    variables = _jax_train_state(flat, LR)
    jm = jax_steps.make_grl_eval_step(module, CLASSES, lambda_domain=LAMBDA)(
        variables.params, variables.batch_stats, *map(jnp.asarray, (src, msk, tgt)))
    model = _port_uda("resnet18", flat).train()
    pm = steps.make_grl_eval_step(model, CLASSES, lambda_domain=LAMBDA)(src, msk, tgt)
    assert not model.training
    assert set(pm) == set(jm) == METRICS
    for k in ("loss", "seg_loss", "domain_loss"):
        np.testing.assert_allclose(pm[k].numpy(), np.asarray(jm[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    assert pm["domain_acc"].item() == float(jm["domain_acc"])
    for k in ("iou", "accuracy"):
        np.testing.assert_allclose(pm[k].numpy(), np.asarray(jm[k]), rtol=0, atol=2e-3)
    state = to_jax_state_dict(model)
    for k, v in flat.items():                                   # eval mode moves nothing
        if k.startswith("batch_stats/"):
            np.testing.assert_array_equal(state[k], v, err_msg=k)
