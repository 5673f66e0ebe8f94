"""The port's phase 3 -- the unsupervised step, its chunked consistency loss,
the non-finite guard and ``UnsupervisedTrainer`` -- against the JAX package
(CPU, float32).

Identical weights (numpy, seeded; through ``from_jax_state_dict``) and uint8
batches go through both packages; resnet18 U-Net, 64 px, 7 classes, B=2,
the discriminator at full width, ``adam(lr, clip_norm=1.0)`` over both
models, epoch 20 (rampup 0.5).  The two target views use the WEAK pipeline
with every stage after the dihedral one off, in float32, and so does the
supervised view: its ``WEAK`` is replaced by that config in both step
modules for these tests (the full ``WEAK`` differs between the packages by
single bf16 roundings, ``tests/test_torch_augment_pipeline.py``, which move
a B=2 gradient by ~10%).  The port is fed the draws the JAX step makes:
``fold_in(key, step)``, then ``k1``, ``k2``, ``k3`` for v1, v2 and the
supervised view (``tests/torch_augment_draws.py``).

Tolerances, and why (``tests/test_torch_adversarial.py`` gives the
reasons in full):
- loss components and domain probabilities 1e-5 relative (float32, sums in
  another order; the consistency sum is ~1e3 here);
- BatchNorm buffers 1e-5 after the first step, 1e-4 after the second;
- parameters: within ``2.5 * lr`` a step; after the first step, entries
  whose gradient is at least 10% of their tensor's largest within
  ``0.02 * lr`` plus one float32 ulp; after the second, at most 10% of the
  entries off by more than ``0.1 * lr``;
- the non-finite guard: bit-identical states in both packages;
- the chunked consistency against the whole: 1e-6 relative, value and
  gradients (float reassociation only);
- the trainer: as in ``tests/test_torch_adversarial.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from tests.test_torch_adversarial import (
    JCFG,
    PCFG,
    ULP,
    _Tiles,
    _all,
    _significant,
    _weights,
    few_torch_threads,  # noqa: F401  (a module-scoped autouse fixture)
)
from tests.test_torch_models import jax_variables
from tests.torch_augment_draws import augment_draws
from uda_aerial_semantic_segmentation_research_tpu.config import Config as JaxConfig
from uda_aerial_semantic_segmentation_research_tpu.data import dataset as jax_dataset
from uda_aerial_semantic_segmentation_research_tpu.data import loader as jax_loader
from uda_aerial_semantic_segmentation_research_tpu.models.bundle import ModelBundle
from uda_aerial_semantic_segmentation_research_tpu.models.domain_model import (
    DomainAdaptationModel as JaxDomainAdaptationModel,
)
from uda_aerial_semantic_segmentation_research_tpu.ops import losses as jax_losses
from uda_aerial_semantic_segmentation_research_tpu.training import state as jax_state
from uda_aerial_semantic_segmentation_research_tpu.training import steps as jax_steps
from uda_aerial_semantic_segmentation_research_tpu.training import (
    unsupervised_trainer as jax_unsup_trainer,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
from uda_aerial_semantic_segmentation_research_tpu_torch.data import dataset, loader
from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
    DomainAdaptationModel,
    create_discriminator,
    create_unet,
    from_jax_state_dict,
    to_jax_state_dict,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops import augment, losses
from uda_aerial_semantic_segmentation_research_tpu_torch.training import (
    steps,
    unsupervised_trainer,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import (
    TrainState,
    adam,
)

SIZE, CLASSES, BATCH, STEPS = 64, 7, 2, 2
LR, TRAINER_LR = 1e-6, 1e-5
EPOCH = 20.0
KEY = 6


def _port_models():
    _, seg_flat, _, disc_flat = _weights()
    seg = create_unet("resnet18", classes=CLASSES, dtype=torch.float32, device="cpu")
    seg.load_state_dict(from_jax_state_dict(seg_flat), strict=True)
    disc = create_discriminator(dtype=torch.float32, device="cpu")
    disc.load_state_dict(from_jax_state_dict(disc_flat), strict=True)
    return seg, disc


def _jax_state(lr=LR):
    _, seg_flat, _, disc_flat = _weights()
    seg, disc = jax_variables(seg_flat), jax_variables(disc_flat)
    params = {"seg": seg["params"], "disc": disc["params"]}
    tx = jax_state.adam(lr, clip_norm=1.0)
    return jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                batch_stats={"seg": seg["batch_stats"],
                                             "disc": disc["batch_stats"]},
                                opt_state=tx.init(params), tx=tx)


def _batches(n=STEPS, seed=1, size=SIZE):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (BATCH, size, size, 3), dtype=np.uint8),
             rng.integers(0, 256, (BATCH, size, size, 3), dtype=np.uint8),
             rng.integers(0, CLASSES, (BATCH, size, size)).astype(np.uint8))
            for _ in range(n)]


def _draws(key, shape, with_supervised):
    k1, k2, k3 = jax.random.split(key, 3)
    return (augment_draws(k1, shape, JCFG, has_masks=False),
            augment_draws(k2, shape, JCFG, has_masks=False),
            augment_draws(k3, shape, JCFG, has_masks=True) if with_supervised else None)


def _split(flat):
    """``{'params/seg/...'}`` (the JAX phase-3 tree) -> per-model JAX flat dicts."""
    out = {"seg": {}, "disc": {}}
    for k, v in flat.items():
        coll, model, rest = k.split("/", 2)
        out[model][f"{coll}/{rest}"] = v
    return out


def _flat(tree):
    return {"/".join(k): np.array(v) for k, v in flatten_dict(tree).items()}


@pytest.fixture(scope="module")
def supervised_view_is_dihedral():
    """The supervised view's ``WEAK``, in both step modules, as the float32
    dihedral-only config (module docstring)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_steps, "WEAK", JCFG)
        mp.setattr(steps, "WEAK", PCFG)
        yield


@functools.cache
def _fine_tuning_losses():
    return jax_losses.FineTuningLoss(), losses.FineTuningLoss()


@pytest.fixture(scope="module")
def jax_steps_by_case(supervised_view_is_dihedral):
    seg_module, _, disc_module, _ = _weights()
    return {ws: jax_steps.make_unsupervised_train_step(
        seg_module, disc_module, CLASSES, _fine_tuning_losses()[0], aug_cfg=JCFG,
        with_supervised=ws) for ws in (False, True)}


@pytest.fixture(scope="module")
def step_runs(jax_steps_by_case):
    out = {}
    for ws, jstep in jax_steps_by_case.items():
        jstate = _jax_state()
        seg, disc = _port_models()
        pstate = TrainState(DomainAdaptationModel(seg, disc), adam(LR, clip_norm=1.0),
                            skip_nonfinite=True)
        pstep = steps.make_unsupervised_train_step(seg, disc, CLASSES, _fine_tuning_losses()[1],
                                                   aug_cfg=PCFG, with_supervised=ws)
        key = jax.random.key(KEY)
        runs = []
        for i, (tgt, sup, msk) in enumerate(_batches()):
            draws = _draws(jax.random.fold_in(key, i), tgt.shape, ws)
            extra = (jnp.asarray(sup), jnp.asarray(msk)) if ws else ()
            jstate, jm = jstep(jstate, key, jnp.asarray(tgt), jnp.float32(EPOCH), *extra)
            pextra = (sup, msk) if ws else ()
            pstate, pm = pstep(pstate, None, tgt, EPOCH, *pextra, draws=draws)
            theirs = _split(_flat({"params": jstate.params, "batch_stats": jstate.batch_stats}))
            runs.append(dict(
                jax_metrics={k: np.array(v) for k, v in jm.items()},
                port_metrics={k: v.numpy() for k, v in pm.items()},
                jax_seg=theirs["seg"], jax_disc=theirs["disc"],
                port_seg=to_jax_state_dict(seg), port_disc=to_jax_state_dict(disc),
                seg_grads=to_jax_state_dict(seg, grads=True),
                disc_grads=to_jax_state_dict(disc, grads=True),
                steps=(int(jstate.step), int(pstate.step))))
        out[ws] = runs
    return out


@pytest.mark.parametrize("with_supervised", [False, True])
def test_unsupervised_step_components_match_jax(step_runs, with_supervised):
    for i, step in enumerate(step_runs[with_supervised]):
        jm, pm = step["jax_metrics"], step["port_metrics"]
        assert set(pm) == set(jm) == {"total", "consistency", "domain_confusion", "supervised",
                                      "rampup_weight", "finite", "domain_prob"}
        assert pm["finite"].dtype == np.bool_ and pm["finite"] and jm["finite"]
        for k in ("total", "consistency", "domain_confusion", "supervised", "rampup_weight",
                  "domain_prob"):
            assert pm[k].shape == jm[k].shape, k
            np.testing.assert_allclose(pm[k], jm[k], rtol=1e-5, atol=1e-7, err_msg=k)
        assert pm["rampup_weight"] == 0.5 and pm["consistency"] > 1.0
        assert (pm["supervised"] > 0) == with_supervised
        assert step["steps"] == (i + 1, i + 1)


@pytest.mark.parametrize("which", ["seg", "disc"])
@pytest.mark.parametrize("with_supervised", [False, True])
def test_unsupervised_step_clipped_update_matches_jax(step_runs, with_supervised, which):
    _, seg_flat, _, disc_flat = _weights()
    initial = seg_flat if which == "seg" else disc_flat
    for i, step in enumerate(step_runs[with_supervised]):
        theirs, ours, grads = step[f"jax_{which}"], step[f"port_{which}"], step[f"{which}_grads"]
        assert set(ours) == set(theirs)
        tol = 1e-5 if i == 0 else 1e-4
        for k in (k for k in theirs if k.startswith("batch_stats/")):
            np.testing.assert_allclose(ours[k], theirs[k], rtol=tol, atol=tol, err_msg=k)
            assert not np.array_equal(ours[k], initial[k]), k
        keys = sorted(k for k in theirs if k.startswith("params/"))
        diff = np.abs(_all(ours, keys) - _all(theirs, keys))
        assert diff.max() <= 2.5 * LR * (i + 1)
        if i == 0:
            significant = _all(_significant(grads, keys), keys)
            assert significant.mean() > 0.05
            assert diff[significant].max() <= 0.02 * LR + ULP
        else:
            assert (diff > 0.1 * LR).mean() <= 0.1
    # the clip acted: the two models' gradients together have a norm of 1
    last = step_runs[with_supervised][-1]
    norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum() for which_ in ("seg", "disc")
                       for g in last[f"{which_}_grads"].values()))
    np.testing.assert_allclose(norm, 1.0, rtol=1e-4)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def test_non_finite_step_leaves_both_states_bit_identical(jax_steps_by_case):
    """A NaN in the discriminator's classifier bias: ``finite`` is false and
    every element of the state -- parameters, Adam moments and count, both
    models' BatchNorm buffers, the step counter -- stays bit-identical, in
    the port as in JAX.  One good step first, so that the Adam state is not
    at its initial zeros."""
    tgt, _, _ = _batches(1, seed=9)[0]
    key = jax.random.key(KEY)
    jstate = _jax_state()
    jstate, _ = jax_steps_by_case[False](jstate, key, jnp.asarray(tgt), jnp.float32(EPOCH))
    params = dict(jstate.params)
    params["disc"] = {**params["disc"], "classifier": {
        **params["disc"]["classifier"],
        "bias": jnp.full_like(params["disc"]["classifier"]["bias"], jnp.nan)}}
    jstate = jstate.replace(params=params)
    before = [np.array(x) for x in jax.tree.leaves(jstate)]
    jstate, jm = jax_steps_by_case[False](jstate, key, jnp.asarray(tgt), jnp.float32(EPOCH))
    after = [np.array(x) for x in jax.tree.leaves(jstate)]
    assert not bool(jm["finite"])
    assert all(np.array_equal(_bits(a), _bits(b)) for a, b in zip(before, after))

    seg, disc = _port_models()
    state = TrainState(DomainAdaptationModel(seg, disc), adam(LR, clip_norm=1.0),
                       skip_nonfinite=True)
    step = steps.make_unsupervised_train_step(seg, disc, CLASSES, losses.FineTuningLoss(),
                                              aug_cfg=PCFG)
    draws = _draws(jax.random.fold_in(key, 0), tgt.shape, False)
    state, _ = step(state, None, tgt, EPOCH, draws=draws)
    with torch.no_grad():
        disc.classifier.bias.fill_(float("nan"))

    def snapshot():
        out = {k: _bits(v.detach().numpy()).copy() for k, v in
               list(state.model.named_parameters()) + list(state.model.named_buffers())}
        for i, st in enumerate(state.optimizer.state.values()):
            out.update({f"adam{i}/{k}": _bits(v.numpy()).copy() for k, v in st.items()})
        out["step"] = state.step.numpy().copy()
        return out

    before = snapshot()
    assert int(state.step) == 1 and len(before) > 3 * len(list(state.model.parameters()))
    state, metrics = step(state, None, tgt, EPOCH, draws=draws)
    assert not bool(metrics["finite"]) and not np.isfinite(metrics["total"].item())
    after = snapshot()
    assert set(after) == set(before)
    for k, v in before.items():
        np.testing.assert_array_equal(after[k], v, err_msg=k)
    # with the bias repaired the next step updates again
    with torch.no_grad():
        disc.classifier.bias.zero_()
    state, metrics = step(state, None, tgt, EPOCH, draws=draws)
    assert bool(metrics["finite"]) and int(state.step) == 2


@pytest.mark.parametrize("height", [64, 48, 32])
def test_chunked_consistency_equals_the_whole(height):
    """Row chunks of 32 (64 rows: two chunks; 48 and 32: one region), value
    and gradients, against the whole loss and the JAX ``_chunked_consistency``."""
    rng = np.random.default_rng(height)
    a, b = (rng.normal(size=(2, height, 16, CLASSES)).astype(np.float32) * 3 for _ in range(2))
    whole = losses.ConsistencyLoss()
    chunked = steps.chunked_consistency(whole)
    results = []
    for fn in (whole, chunked):
        x, y = (torch.tensor(v, requires_grad=True) for v in (a, b))
        loss = fn(x, y)
        loss.backward()
        results.append((loss.item(), x.grad.numpy(), y.grad.numpy()))
    (lw, gw1, gw2), (lc, gc1, gc2) = results
    np.testing.assert_allclose(lc, lw, rtol=1e-6)
    np.testing.assert_allclose(gc1, gw1, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(gc2, gw2, rtol=1e-6, atol=1e-9)
    theirs = jax_steps._chunked_consistency(jax_losses.ConsistencyLoss())(
        jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(lc, float(theirs), rtol=1e-6)


def test_unsupervised_step_draws_v1_v2_then_the_supervised_view():
    """Default configs (STRONG views, WEAK supervised view): the step's draws
    from the generator equal explicit draws made in the order v1, v2,
    supervised from a copy of it."""
    tgt, sup, msk = _batches(1, seed=4, size=32)[0]
    copy = torch.Generator().manual_seed(3)
    draws = []
    for cfg, shape, masks in ((augment.STRONG, tgt.shape, False),
                              (augment.STRONG, tgt.shape, False),
                              (augment.WEAK, sup.shape, True)):
        abc = augment._sample_dihedral(copy, BATCH, cfg)
        draws.append((abc, augment.sample_params(copy, tuple(shape), cfg, masks)))
    results = []
    for gen, d in ((torch.Generator().manual_seed(3), None), (None, tuple(draws))):
        seg, disc = _port_models()
        state = TrainState(DomainAdaptationModel(seg, disc), adam(LR, clip_norm=1.0),
                           skip_nonfinite=True)
        step = steps.make_unsupervised_train_step(seg, disc, CLASSES, losses.FineTuningLoss(),
                                                  with_supervised=True)
        _, m = step(state, gen, tgt, EPOCH, sup, msk, draws=d)
        results.append(m)
    for k in ("total", "consistency", "supervised", "domain_prob"):
        assert torch.equal(results[0][k], results[1][k]), k
    seg, disc = _port_models()
    with pytest.raises(ValueError, match="skip_nonfinite"):
        steps.make_unsupervised_train_step(seg, disc, CLASSES, losses.FineTuningLoss())(
            TrainState(DomainAdaptationModel(seg, disc), adam(LR)), None, tgt, EPOCH)
    with pytest.raises(ValueError, match="both models"):
        steps.make_unsupervised_train_step(seg, disc, CLASSES, losses.FineTuningLoss())(
            TrainState(seg, adam(LR), skip_nonfinite=True), None, tgt, EPOCH)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------
def test_unsupervised_trainer_options():
    """The JAX trainer's resolution with the card in the TPU's place: on the
    CPU ``"auto"`` is encoder remat and the joint step; ``remat`` /
    ``sequential`` / ``carry_dtype`` build the matching step, over a clone of
    the U-Net that shares its parameters."""
    seg, disc = _port_models()
    trainer = unsupervised_trainer.UnsupervisedTrainer(DomainAdaptationModel(seg, disc),
                                                       device="cpu")
    assert trainer.discriminator is disc and trainer.domain_model.segmentation_model is seg
    assert trainer.remat == "encoder" and trainer.sequential is False
    assert trainer.carry_dtype is None
    built = []
    with pytest.MonkeyPatch.context() as mp:
        for name in ("make_unsupervised_train_step", "make_unsupervised_sequential_step"):
            mp.setattr(steps, name, lambda model, *a, _n=name, **kw: built.append(
                (_n, model, kw)))
        trainer._get_unsup_step(False)
        for kw, factory, remat, carry in (
                ({"remat": "encoder"}, "make_unsupervised_train_step", "encoder", None),
                ({"remat": True}, "make_unsupervised_train_step", True, None),
                ({"sequential": True}, "make_unsupervised_sequential_step", "encoder", None),
                ({"carry_dtype": torch.bfloat16}, "make_unsupervised_train_step", "encoder",
                 torch.bfloat16)):
            other = unsupervised_trainer.UnsupervisedTrainer(seg, device="cpu", **kw)
            assert (other.remat, other.carry_dtype) == (remat, carry), kw
            other._get_unsup_step(True)
            name, model, step_kw = built[-1]
            assert name == factory and step_kw["with_supervised"], kw
            assert step_kw.get("carry_dtype") == (carry if other.sequential else None), kw
            assert model.remat == remat and model is not seg, kw
    name, model, _ = built[0]
    assert name == "make_unsupervised_train_step" and model.remat == "encoder"
    assert all(a is b for a, b in zip(model.parameters(), seg.parameters()))
    assert seg.remat is False and seg.encoder.remat is False
    fresh = unsupervised_trainer.UnsupervisedTrainer(seg, device="cpu")
    assert fresh.discriminator is not disc
    state = fresh._make_state(1e-4)
    assert state.skip_nonfinite and state.clip_norm == 1.0
    assert len(state.optimizer.param_groups[0]["params"]) == len(
        list(seg.parameters())) + len(list(fresh.discriminator.parameters()))


@pytest.fixture(scope="module")
def trainer_runs(jax_steps_by_case, tmp_path_factory):
    """Both trainers, 2 epochs of 2 steps; the port's step is fed the draws of
    the JAX trainer's step keys."""
    seg_module, seg_flat, disc_module, disc_flat = _weights()
    rng = np.random.default_rng(12)
    images = rng.integers(0, 256, (4, SIZE, SIZE, 3), dtype=np.uint8)
    masks = rng.integers(0, CLASSES, (4, SIZE, SIZE)).astype(np.int32)
    targets = rng.integers(0, 256, (4, SIZE, SIZE, 3), dtype=np.uint8)
    out = {}
    for name in ("jax", "port"):
        root = tmp_path_factory.mktemp(f"unsup_{name}")
        cfg, mod, dmod, lmod = ((JaxConfig, jax_unsup_trainer, jax_dataset, jax_loader)
                                if name == "jax" else
                                (Config, unsupervised_trainer, dataset, loader))
        record = {"train": [], "val": []}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(cfg, "LOGS_DIR", str(root / "logs"))
            if name == "jax":
                seg = ModelBundle(seg_module, jax_variables(seg_flat))
                disc = ModelBundle(disc_module, jax_variables(disc_flat))
                model = JaxDomainAdaptationModel(seg, disc)
            else:
                seg, disc = _port_models()
                model = DomainAdaptationModel(seg, disc)
            trainer = mod.UnsupervisedTrainer(model, device="cpu", log_interval=1, patience=1)
            if name == "jax":
                trainer._unsup_steps[False] = jax_steps_by_case[False]
            else:
                real = steps.make_unsupervised_train_step(
                    seg, disc, CLASSES, trainer.fine_tuning_loss, aug_cfg=PCFG)

                def port_step(state, generator, tgt, epoch, *sup, _real=real):
                    key = jax.random.fold_in(jax.random.fold_in(
                        jax.random.key(Config.SEED), int(epoch)), int(state.step))
                    return _real(state, generator, tgt, epoch, *sup,
                                 draws=_draws(key, tuple(tgt.shape), False))

                trainer._unsup_steps[False] = port_step
            record["probs"], update = [], trainer.domain_metrics.update

            def update_and_keep(source_pred, target_pred, _f=update, _r=record["probs"]):
                _r.append(np.asarray(source_pred).ravel())
                return _f(source_pred=source_pred, target_pred=target_pred)

            trainer.domain_metrics.update = update_and_keep
            epoch_fn, validate_fn = trainer.train_epoch, trainer.validate

            def train_epoch(*args, _fn=epoch_fn, **kw):
                state, loss, domain = _fn(*args, **kw)
                record["train"].append((loss, dict(domain)))
                return state, loss, domain

            def validate(*args, _fn=validate_fn):
                metrics = _fn(*args)
                record["val"].append(dict(metrics))
                return metrics

            trainer.train_epoch, trainer.validate = train_epoch, validate
            tr, va = dmod.random_split(_Tiles(images, masks), [2, 2], seed=0)
            val_loader = lmod.DataLoader(va, batch_size=BATCH)
            target_loader = lmod.DataLoader(_Tiles(targets), batch_size=BATCH)
            record["best"] = trainer.train(target_loader, val_loader, epochs=2,
                                           learning_rate=TRAINER_LR)
            record["stopping"] = (trainer.best_score, trainer.best_epoch, trainer.counter)
            record["seg"] = seg.state_dict() if name == "jax" else to_jax_state_dict(seg)
            record["disc"] = disc.state_dict() if name == "jax" else to_jax_state_dict(disc)
        out[name] = record
    return out


def test_unsupervised_trainer_matches_jax(trainer_runs):
    j, p = trainer_runs["jax"], trainer_runs["port"]
    assert len(p["train"]) == len(j["train"]) == 2
    near = sum(int((np.abs(q - 0.5) < 1e-4).sum()) for q in p["probs"])
    for (pl, pd), (jl, jd) in zip(p["train"], j["train"]):
        np.testing.assert_allclose(pl, jl, rtol=1e-4)
        assert set(pd) == set(jd)
        np.testing.assert_allclose(pd["domain_confusion"], jd["domain_confusion"], rtol=1e-5)
        for k in ("source_domain_acc", "target_domain_acc"):
            assert abs(pd[k] - jd[k]) <= near / (2 * BATCH), k
        # both slots see the target probabilities
        assert pd["source_domain_acc"] + pd["target_domain_acc"] == pytest.approx(1.0)
    for pv, jv in zip(p["val"], j["val"], strict=True):
        assert set(pv) == set(jv) == {"iou", "accuracy", "loss"}
        np.testing.assert_allclose(pv["loss"], jv["loss"], rtol=1e-4)
        for k in ("iou", "accuracy"):
            np.testing.assert_allclose(pv[k], jv[k], rtol=0, atol=2e-3, err_msg=k)
    np.testing.assert_allclose(p["best"], j["best"], rtol=0, atol=2e-3)
    scores = [v["iou"] for v in j["val"]]
    if abs(scores[0] - scores[1]) > 2e-3:            # the decision is not float noise
        assert p["stopping"][1:] == j["stopping"][1:]
    for which in ("seg", "disc"):
        assert set(p[which]) == set(j[which])
        for k, v in j[which].items():
            stats = k.startswith("batch_stats/")
            np.testing.assert_allclose(p[which][k], v, rtol=1e-2 * stats,
                                       atol=2e-3 if stats else 4 * 2.5 * TRAINER_LR, err_msg=k)
