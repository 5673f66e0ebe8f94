"""The port's memory-decomposed phase-2 and phase-3 steps
(``make_adversarial_sequential_step``, ``make_unsupervised_sequential_step``)
against the port's joint steps and the JAX package's sequential steps (CPU,
float32), and the phase-3 trainer's resolution of its memory options.

Sizes, weights, draws and configs are those of
``tests/test_torch_adversarial.py`` and ``tests/test_torch_unsupervised.py``
(resnet18 U-Net, 64 px, 7 classes, B=2, the float32 dihedral-only pipeline,
the supervised view's ``WEAK`` replaced by it in both step modules, the
port fed the JAX steps' own draws), and so are their tolerances against
JAX: losses 1e-5, BatchNorm buffers 1e-5 after the first step and 1e-4 after
the second, parameters by the Adam-sign rule (every entry within
``2.5 * lr`` a step; after the first, entries whose gradient is at least 10%
of their tensor's largest within ``0.02 * lr`` plus one float32 ulp; after
the second at most 10% of the entries off by more than ``0.1 * lr``).

The port's phase-2 step is one body under both JAX names: its cast of the
carried batches is held to change no value, bit for bit (float32 and
bfloat16 models).  Against the port's joint step, on the same draws:
- the sequential phase-3 step with ``carry_dtype=None``: loss components
  1e-6 relative (the consistency term is summed in another order), the
  BatchNorm buffers bit-identical (the statistics chain v1 -> v2 ->
  supervised as in the joint step, and ``grad_view1`` moves none), the
  clipped gradient within 1e-5 of each tensor's largest entry (the joint
  backward and the sum of partials add the same terms in another order),
  the parameters by the Adam-sign rule.

With ``carry_dtype=bfloat16`` the port is held against the JAX sequential
step with the same carry (the carry rounds the float32 logits to bf16, and
where the two packages' logits straddle a rounding boundary the KL targets
differ by one bf16 ulp): the losses 1e-5 relative (measured: 9.3e-7), the
rest as above.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_adversarial import (
    LAMBDA,
    PCFG,
    ULP,
    JCFG,
    _all,
    _hold_update,
    _jax_train_state,
    _significant,
    _weights,
    few_torch_threads,  # noqa: F401  (a module-scoped autouse fixture)
)
from tests.test_torch_adversarial import _batches as _adv_batches
from tests.test_torch_adversarial import _draws as _adv_draws
from tests.test_torch_adversarial import _flat
from tests.test_torch_unsupervised import (
    EPOCH,
    LR,
    _batches,
    _draws,
    _jax_state,
    _split,
    supervised_view_is_dihedral,  # noqa: F401  (a fixture)
)
from uda_aerial_semantic_segmentation_research_tpu.ops import losses as jax_losses
from uda_aerial_semantic_segmentation_research_tpu.training import state as jax_state
from uda_aerial_semantic_segmentation_research_tpu.training import steps as jax_steps
from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
    DomainAdaptationModel,
    create_discriminator,
    create_unet,
    from_jax_state_dict,
    to_jax_state_dict,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops import losses
from uda_aerial_semantic_segmentation_research_tpu_torch.ops import batch_norm as bn_mod
from uda_aerial_semantic_segmentation_research_tpu_torch.training import (
    steps,
    unsupervised_trainer,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import (
    AdversarialState,
    TrainState,
    adam,
)

CLASSES, BATCH, SIZE = 7, 2, 64
KEY = 8
UNSUP_METRICS = {"total", "consistency", "domain_confusion", "supervised", "rampup_weight",
                 "finite", "domain_prob"}
# resnet18 U-Net: 30 BatchNorms, 19 of them in the encoder's blocks; the
# discriminator's 3
N_UNET_BN, N_DISC_BN = 30, 3


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------
def _models(dtype=torch.float32):
    """The shared weights in the port's U-Net and discriminator."""
    _, seg_flat, _, disc_flat = _weights()
    seg = create_unet("resnet18", classes=CLASSES, dtype=dtype, device="cpu")
    seg.load_state_dict(from_jax_state_dict(seg_flat), strict=True)
    disc = create_discriminator(dtype=dtype, device="cpu")
    disc.load_state_dict(from_jax_state_dict(disc_flat), strict=True)
    return seg, disc


@functools.cache
def _adv_port_run(factory, dtype=torch.float32, n=2, uncast=False):
    """``n`` steps of the port from the shared weights on the JAX draws.  With
    ``uncast`` the step's ``d_step`` and ``g_step`` get the float32 batches
    of ``_source_target_inputs`` instead of ``prep``'s cast ones.  Run once
    per module: the phase-2 step is one factory under both JAX names, so its
    float32 run serves the JAX comparison and the cast comparison alike
    (callers only read the result)."""
    seg, disc = _models(dtype)
    state = AdversarialState(TrainState(seg, adam(LR)), TrainState(disc, adam(LR)))
    step = factory(seg, disc, CLASSES, LAMBDA, aug_cfg=PCFG)
    key = jax.random.key(KEY)
    out = []
    for i, (src, msk, tgt) in enumerate(_adv_batches(n)):
        draws = _adv_draws(jax.random.fold_in(key, i), src.shape, tgt.shape)
        if uncast:
            xs, ms, xt = steps._source_target_inputs(seg, None, src, msk, tgt, PCFG, draws)
            d_loss, s_logit, t_logit = step.programs["d_step"](state.disc, xs, xt)
            metrics = step.programs["g_step"](state.seg, xs, ms, xt)
            metrics.update({"d_loss": d_loss, "source_domain_prob": torch.sigmoid(s_logit),
                            "target_domain_prob": torch.sigmoid(t_logit)})
        else:
            state, metrics = step(state, None, src, msk, tgt, draws=draws)
        out.append(dict(metrics={k: v.float().numpy() for k, v in metrics.items()},
                        seg=to_jax_state_dict(seg), disc=to_jax_state_dict(disc),
                        seg_grads=to_jax_state_dict(seg, grads=True),
                        disc_grads=to_jax_state_dict(disc, grads=True)))
    return step, out


def test_adversarial_sequential_step_matches_jax():
    _, seg_flat, _, disc_flat = _weights()
    seg_module, _, disc_module, _ = _weights()
    jstep = jax_steps.make_adversarial_sequential_step(seg_module, disc_module, CLASSES,
                                                       LAMBDA, aug_cfg=JCFG)
    jstate = jax_state.AdversarialState(seg=_jax_train_state(seg_flat, LR),
                                        disc=_jax_train_state(disc_flat, LR))
    step, ours = _adv_port_run(steps.make_adversarial_sequential_step, torch.float32)
    assert set(step.programs) == set(jstep.programs) == {"prep", "d_step", "g_step"}
    key = jax.random.key(KEY)
    runs = []
    for (src, msk, tgt), mine in zip(_adv_batches(), ours):
        jstate, jm = jstep(jstate, key, jnp.asarray(src), jnp.asarray(msk), jnp.asarray(tgt))
        assert set(mine["metrics"]) == set(jm)
        for k in ("loss", "seg_loss", "adv_loss", "d_loss", "source_domain_prob",
                  "target_domain_prob"):
            np.testing.assert_allclose(mine["metrics"][k], np.array(jm[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        runs.append(dict(
            jax_seg=_flat({"params": jstate.seg.params, "batch_stats": jstate.seg.batch_stats}),
            jax_disc=_flat({"params": jstate.disc.params,
                            "batch_stats": jstate.disc.batch_stats}),
            port_seg=mine["seg"], port_disc=mine["disc"], seg_grads=mine["seg_grads"],
            disc_grads=mine["disc_grads"]))
    _hold_update(runs, "disc")
    _hold_update(runs, "seg")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adversarial_sequential_step_is_the_joint_update(dtype):
    """The JAX package's two phase-2 steps are one step in the port, run as
    the sequential step's three programs.  Its one departure from the joint
    step's plain composition, the carried batches cast to the modules'
    compute dtype, changes no value: two steps each from the same weights
    on the same draws, with ``prep``'s cast batches and with the float32
    ones, give bit-identical metrics, parameters, gradients and buffers
    (bfloat16 modules: ``xs`` and ``xt`` are carried in bf16)."""
    assert steps.make_adversarial_sequential_step is steps.make_adversarial_train_step
    step, cast = _adv_port_run(steps.make_adversarial_train_step, dtype)
    assert set(step.programs) == {"prep", "d_step", "g_step"}
    _, plain = _adv_port_run(steps.make_adversarial_train_step, dtype, uncast=True)
    for a, b in zip(plain, cast):
        for part in ("metrics", "seg", "disc", "seg_grads", "disc_grads"):
            assert set(a[part]) == set(b[part])
            for k in a[part]:
                np.testing.assert_array_equal(b[part][k], a[part][k], err_msg=f"{part} {k}")


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------
def _unsup_port_run(factory, with_supervised, counts=None, **kw):
    """One step of the port from the shared weights on the JAX step's draws:
    metrics, both models' JAX-layout states and clipped gradients."""
    seg, disc = _models()
    state = TrainState(DomainAdaptationModel(seg, disc), adam(LR, clip_norm=1.0),
                       skip_nonfinite=True)
    step = factory(seg, disc, CLASSES, losses.FineTuningLoss(), aug_cfg=PCFG,
                   with_supervised=with_supervised, **kw)
    tgt, sup, msk = _batches(1)[0]
    draws = _draws(jax.random.fold_in(jax.random.key(KEY), 0), tgt.shape, with_supervised)
    if counts is not None:
        counts.clear()
    state, metrics = step(state, None, tgt, EPOCH, *((sup, msk) if with_supervised else ()),
                          draws=draws)
    return step, dict(metrics={k: v.float().numpy() for k, v in metrics.items()},
                      seg=to_jax_state_dict(seg), disc=to_jax_state_dict(disc),
                      seg_grads=to_jax_state_dict(seg, grads=True),
                      disc_grads=to_jax_state_dict(disc, grads=True),
                      counts=None if counts is None else dict(counts), step=int(state.step))


def _adam_rule(ours, theirs, grads, initial):
    """The Adam-sign rule of the module docstring, first step."""
    keys = sorted(k for k in theirs if k.startswith("params/"))
    diff = np.abs(_all(ours, keys) - _all(theirs, keys))
    assert diff.max() <= 2.5 * LR
    significant = _all(_significant(grads, keys), keys)
    assert significant.mean() > 0.05
    assert diff[significant].max() <= 0.02 * LR + ULP
    assert not np.array_equal(_all(ours, keys), _all(initial, keys))


@pytest.fixture(scope="module")
def counted():
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
        yield counts


@pytest.mark.parametrize("with_supervised", [False, True])
def test_unsupervised_sequential_step_is_the_joint_update(supervised_view_is_dihedral,
                                                          counted, with_supervised):
    _, joint = _unsup_port_run(steps.make_unsupervised_train_step, with_supervised, counted)
    step, seq = _unsup_port_run(steps.make_unsupervised_sequential_step, with_supervised,
                                counted)
    programs = {"prep", "grad_disc", "fwd_view1", "grad_view2", "grad_view1", "combine"}
    assert set(step.programs) == programs | ({"grad_sup"} if with_supervised else set())
    assert set(seq["metrics"]) == set(joint["metrics"]) == UNSUP_METRICS
    assert seq["metrics"]["finite"] and seq["step"] == joint["step"] == 1
    for k in UNSUP_METRICS - {"finite"}:
        np.testing.assert_allclose(seq["metrics"][k], joint["metrics"][k], rtol=1e-6,
                                   atol=1e-9, err_msg=k)
    assert (seq["metrics"]["supervised"] > 0) == with_supervised
    _, seg_flat, _, disc_flat = _weights()
    for which, initial in (("seg", seg_flat), ("disc", disc_flat)):
        ours, theirs = seq[which], joint[which]
        for k in (k for k in theirs if k.startswith("batch_stats/")):
            np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
        for k, g in joint[f"{which}_grads"].items():
            assert np.abs(seq[f"{which}_grads"][k] - g).max() <= 1e-5 * np.abs(g).max(), k
        _adam_rule(ours, theirs, joint[f"{which}_grads"], initial)
    # the census: D once; the U-Net forwards v1 (no gradient) and twice with
    # gradients (three with the supervised view); each grad-bearing pass has
    # its backward
    views = 3 if with_supervised else 2
    assert joint["counts"] == {"channel_sums": N_DISC_BN + views * N_UNET_BN,
                               "channel_dual_sums": N_DISC_BN + views * N_UNET_BN}
    assert seq["counts"] == {"channel_sums": N_DISC_BN + (views + 1) * N_UNET_BN,
                             "channel_dual_sums": N_DISC_BN + views * N_UNET_BN}


@pytest.fixture(scope="module")
def jax_bf16_carry_runs(supervised_view_is_dihedral):
    """The JAX sequential step with a bf16 carry, one step per case."""
    seg_module, _, disc_module, _ = _weights()
    out = {}
    for ws in (False, True):
        jstep = jax_steps.make_unsupervised_sequential_step(
            seg_module, disc_module, CLASSES, jax_losses.FineTuningLoss(), aug_cfg=JCFG,
            with_supervised=ws, carry_dtype=jnp.bfloat16)
        tgt, sup, msk = _batches(1)[0]
        extra = (jnp.asarray(sup), jnp.asarray(msk)) if ws else ()
        jstate, jm = jstep(_jax_state(), jax.random.key(KEY), jnp.asarray(tgt),
                           jnp.float32(EPOCH), *extra)
        theirs = _split(_flat({"params": jstate.params, "batch_stats": jstate.batch_stats}))
        out[ws] = dict(metrics={k: np.array(v) for k, v in jm.items()}, seg=theirs["seg"],
                       disc=theirs["disc"], programs=set(jstep.programs))
    return out


@pytest.mark.parametrize("with_supervised", [False, True])
def test_unsupervised_sequential_bf16_carry_matches_jax(jax_bf16_carry_runs, with_supervised):
    theirs = jax_bf16_carry_runs[with_supervised]
    step, ours = _unsup_port_run(steps.make_unsupervised_sequential_step, with_supervised,
                                 carry_dtype=torch.bfloat16)
    assert set(step.programs) == theirs["programs"]
    assert set(ours["metrics"]) == set(theirs["metrics"]) == UNSUP_METRICS
    assert ours["metrics"]["finite"] and theirs["metrics"]["finite"]
    for k in UNSUP_METRICS - {"finite"}:
        np.testing.assert_allclose(ours["metrics"][k], theirs["metrics"][k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    _, seg_flat, _, disc_flat = _weights()
    for which, initial in (("seg", seg_flat), ("disc", disc_flat)):
        for k in (k for k in theirs[which] if k.startswith("batch_stats/")):
            np.testing.assert_allclose(ours[which][k], theirs[which][k], rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        _adam_rule(ours[which], theirs[which], ours[f"{which}_grads"], initial)


def test_sequential_step_non_finite_guard(supervised_view_is_dihedral):
    """A NaN in the discriminator's classifier bias: ``finite`` is false and
    parameters, Adam moments and count, both models' buffers and the step
    counter stay bit-identical (one good step first)."""
    seg, disc = _models()
    state = TrainState(DomainAdaptationModel(seg, disc), adam(LR, clip_norm=1.0),
                       skip_nonfinite=True)
    step = steps.make_unsupervised_sequential_step(seg, disc, CLASSES, losses.FineTuningLoss(),
                                                   aug_cfg=PCFG, with_supervised=True,
                                                   carry_dtype=torch.bfloat16)
    tgt, sup, msk = _batches(1, seed=9)[0]
    draws = _draws(jax.random.fold_in(jax.random.key(KEY), 0), tgt.shape, True)
    state, _ = step(state, None, tgt, EPOCH, sup, msk, draws=draws)
    with torch.no_grad():
        disc.classifier.bias.fill_(float("nan"))

    def snapshot():
        out = {k: v.detach().clone() for k, v in
               list(state.model.named_parameters()) + list(state.model.named_buffers())}
        for i, st in enumerate(state.optimizer.state.values()):
            out.update({f"adam{i}/{k}": v.clone() for k, v in st.items()})
        out["step"] = state.step.clone()
        return out

    before = snapshot()
    state, metrics = step(state, None, tgt, EPOCH, sup, msk, draws=draws)
    assert not bool(metrics["finite"]) and not torch.isfinite(metrics["total"])
    after = snapshot()
    assert set(after) == set(before) and int(state.step) == 1
    for k, v in before.items():
        assert torch.equal(after[k].view(torch.int32) if v.dtype == torch.float32 else after[k],
                           v.view(torch.int32) if v.dtype == torch.float32 else v), k


# ---------------------------------------------------------------------------
# the trainer's options
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("device", ["cpu", "cuda", "cuda:1"])
def test_phase3_options_resolve_as_jax_with_the_card_as_the_tpu(device):
    """No model is built: the rule reads only the device."""
    card = device.startswith("cuda")
    for dev in (device, torch.device(device)):
        resolve = unsupervised_trainer.resolve_phase3_options
        assert resolve(dev) == ("encoder", card, torch.bfloat16 if card else None)
        assert resolve(dev, remat=False) == (False, card, torch.bfloat16 if card else None)
        assert resolve(dev, remat="decoder_convs", sequential=False) == (
            "decoder_convs", False, None)
        assert resolve(dev, sequential=True) == ("encoder", True, None)
        assert resolve(dev, carry_dtype=torch.float32) == ("encoder", card, torch.float32)


def test_sequential_trainer_epoch_is_the_joint_one(monkeypatch, tmp_path):
    """``UnsupervisedTrainer(sequential=True)`` on the CPU trains with the
    sequential step (over its encoder-remat clone of the U-Net) to the joint
    trainer's losses, parameters and buffers (one epoch of 2 steps)."""
    monkeypatch.setattr(Config, "LOGS_DIR", str(tmp_path))
    rng = np.random.default_rng(14)
    targets = rng.integers(0, 256, (4, SIZE, SIZE, 3), dtype=np.uint8)
    results = []
    for sequential in (False, True):
        seg, disc = _models()
        trainer = unsupervised_trainer.UnsupervisedTrainer(
            DomainAdaptationModel(seg, disc), device="cpu", sequential=sequential)
        trainer.fine_tuning_loss = losses.FineTuningLoss()
        made = []
        real = (steps.make_unsupervised_sequential_step if sequential
                else steps.make_unsupervised_train_step)

        def factory(model, *a, _real=real, **kw):
            made.append(model)
            return _real(model, *a, aug_cfg=PCFG, **kw)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(steps, real.__name__, factory)
            batches = [(targets[i:i + BATCH], None) for i in (0, BATCH)]
            state = trainer._make_state(LR)
            state, loss, _ = trainer.train_epoch(batches, state, 1)
        assert made[0].remat == "encoder" and seg.remat is False
        results.append((loss, to_jax_state_dict(seg), to_jax_state_dict(disc)))
    (lj, sj, dj), (ls, ss, ds) = results
    np.testing.assert_allclose(ls, lj, rtol=1e-6)
    for theirs, ours in ((sj, ss), (dj, ds)):
        for k, v in theirs.items():
            if k.startswith("batch_stats/"):
                np.testing.assert_array_equal(ours[k], v, err_msg=k)
            else:
                np.testing.assert_allclose(ours[k], v, rtol=0, atol=2 * 2.5 * LR, err_msg=k)
