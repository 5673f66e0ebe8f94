"""The port's phase 2 -- the adversarial step, its discriminator update and
``AdversarialTrainer`` -- against the JAX package (CPU, float32).

Identical weights (numpy, seeded; through ``from_jax_state_dict``) and uint8
batches go through both packages.  The augmentation is the WEAK pipeline
with every stage after the dihedral one off, in float32; the port is fed
the draws the JAX step makes: ``fold_in(key, step)``, then ``k1`` for the
source batch and ``k2`` for the target batch
(``tests/torch_augment_draws.py``).  Size: resnet18 U-Net, 64 px, 7
classes, B=2; the discriminator at full width.

Tolerances, and why (those of ``tests/test_torch_train_step.py``'s first
step, where they are measured):
- losses, domain probabilities: 1e-5 (float32, sums in another order);
  IoU / accuracy 2e-3 and the confusion matrix within 0.1% of the pixels
  (a pixel whose two best logits are within float32 noise flips);
- BatchNorm buffers: 1e-5 after the first step, 1e-4 after the second;
- parameters moved by Adam: its first update is ``lr * g / (|g| + eps)``,
  +-lr whatever |g|, so an entry whose gradient is noise around zero moves
  by +lr in one package and -lr in the other: every entry within
  ``2.5 * lr`` a step, and after the first step every entry whose
  gradient is at least 10% of its tensor's largest within ``0.02 * lr``
  plus one float32 ulp (through the whole U-Net a gradient entry may be off
  by up to 10% of its tensor's largest, ``tests/test_torch_train_step.py``,
  so below that its sign is noise: measured here, entries at 1% flipped);
  tensors whose gradient is exactly zero in exact arithmetic (a conv bias
  in front of a BatchNorm: largest entry below 1e-6 of the network's) hold
  no such entry; after the second step at most 10% of the entries off by
  more than ``0.1 * lr``.  ``lr`` is 1e-6.
- the trainer (2 epochs of 2 steps, lr 1e-5): per-epoch losses 1e-4
  relative, validation IoU / accuracy 2e-3, domain accuracies exact unless
  a probability lies within 1e-4 of the 0.5 threshold, domain confusion
  1e-5, the written-back weights within ``4 * 2.5 * lr`` and their
  BatchNorm buffers within 2e-3 + 1e-2 relative (the phase-1 trainer's test,
  ``tests/test_torch_trainer.py``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from tests.test_torch_models import jax_variables, random_variables
from tests.torch_augment_draws import augment_draws
from uda_aerial_semantic_segmentation_research_tpu.config import Config as JaxConfig
from uda_aerial_semantic_segmentation_research_tpu.data import dataset as jax_dataset
from uda_aerial_semantic_segmentation_research_tpu.data import loader as jax_loader
from uda_aerial_semantic_segmentation_research_tpu.models.bundle import ModelBundle
from uda_aerial_semantic_segmentation_research_tpu.models.discriminator import (
    DomainDiscriminator as JaxDiscriminator,
)
from uda_aerial_semantic_segmentation_research_tpu.models.unet import Unet as JaxUnet
from uda_aerial_semantic_segmentation_research_tpu.ops import augment as jax_augment
from uda_aerial_semantic_segmentation_research_tpu.ops.losses import (
    AdversarialLoss as JaxAdversarialLoss,
)
from uda_aerial_semantic_segmentation_research_tpu.training import (
    adversarial_trainer as jax_adv_trainer,
)
from uda_aerial_semantic_segmentation_research_tpu.training import state as jax_state
from uda_aerial_semantic_segmentation_research_tpu.training import steps as jax_steps
from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
from uda_aerial_semantic_segmentation_research_tpu_torch.data import dataset, loader
from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
    create_discriminator,
    create_unet,
    from_jax_state_dict,
    to_jax_state_dict,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops import augment
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.losses import AdversarialLoss
from uda_aerial_semantic_segmentation_research_tpu_torch.training import (
    adversarial_trainer,
    steps,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import (
    AdversarialState,
    TrainState,
    adam,
)

SIZE, CLASSES, BATCH, STEPS = 64, 7, 2, 2
LR, TRAINER_LR = 1e-6, 1e-5
LAMBDA = 0.5          # large, so that a generator gradient that leaked would show
ULP = 1.2e-7
NO_STAGES = dict(p_ssr=0.0, p_distort=0.0, p_noise=0.0, p_blur=0.0, p_color=0.0, p_hsv=0.0)
JCFG = dataclasses.replace(jax_augment.WEAK, compute_dtype="float32", **NO_STAGES)
PCFG = dataclasses.replace(augment.WEAK, compute_dtype="float32", **NO_STAGES)
KEY = 5


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads for this module's small tensors: the tier-1 run
    has six workers on eight cores, and torch's default of one thread per
    core oversubscribes them.  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@functools.cache
def _weights():
    seg_module = JaxUnet("resnet18", classes=CLASSES, dtype=jnp.float32)
    disc_module = JaxDiscriminator(dtype=jnp.float32)
    sample = jnp.zeros((BATCH, SIZE, SIZE, 3), jnp.float32)
    return (seg_module, random_variables(seg_module, sample, seed=21),
            disc_module, random_variables(disc_module, sample, seed=22))


def _batches(n=STEPS, seed=0, size=SIZE):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (BATCH, size, size, 3), dtype=np.uint8),
             rng.integers(0, CLASSES, (BATCH, size, size)).astype(np.uint8),
             np.clip(rng.integers(0, 256, (BATCH, size, size, 3)) * 0.7 + 40, 0,
                     255).astype(np.uint8)) for _ in range(n)]


def _jax_train_state(flat, lr):
    v = jax_variables(flat)
    tx = jax_state.adam(lr)
    return jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                                batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]),
                                tx=tx)


def _port_models():
    _, seg_flat, _, disc_flat = _weights()
    seg = create_unet("resnet18", classes=CLASSES, dtype=torch.float32, device="cpu")
    seg.load_state_dict(from_jax_state_dict(seg_flat), strict=True)
    disc = create_discriminator(dtype=torch.float32, device="cpu")
    disc.load_state_dict(from_jax_state_dict(disc_flat), strict=True)
    return seg, disc


def _draws(key, src_shape, tgt_shape):
    """The port's draws for the JAX step's ``key`` (already folded with the step)."""
    k1, k2 = jax.random.split(key)
    return (augment_draws(k1, src_shape, JCFG, has_masks=True),
            augment_draws(k2, tgt_shape, JCFG, has_masks=False))


def _flat(tree):
    return {"/".join(k): np.array(v) for k, v in flatten_dict(tree).items()}


def _all(tensors, keys):
    return np.concatenate([tensors[k].ravel() for k in keys])


def _significant(grads, keys):
    """Per key, the entries whose gradient's sign both packages agree on
    (module docstring)."""
    largest = max(np.abs(grads[k]).max() for k in keys)
    return {k: (np.abs(grads[k]) >= 0.1 * np.abs(grads[k]).max())
            & (np.abs(grads[k]).max() >= 1e-6 * largest) for k in keys}


@pytest.fixture(scope="module")
def jax_step():
    seg_module, _, disc_module, _ = _weights()
    return jax_steps.make_adversarial_train_step(seg_module, disc_module, CLASSES, LAMBDA,
                                                 aug_cfg=JCFG)


@pytest.fixture(scope="module")
def step_runs(jax_step):
    """Two steps of both packages: metrics, states, the port's gradients."""
    _, seg_flat, _, disc_flat = _weights()
    jstate = jax_state.AdversarialState(seg=_jax_train_state(seg_flat, LR),
                                        disc=_jax_train_state(disc_flat, LR))
    seg, disc = _port_models()
    pstate = AdversarialState(TrainState(seg, adam(LR)), TrainState(disc, adam(LR)))
    pstep = steps.make_adversarial_train_step(seg, disc, CLASSES, LAMBDA, aug_cfg=PCFG)
    key = jax.random.key(KEY)
    out = []
    for i, (src, msk, tgt) in enumerate(_batches()):
        draws = _draws(jax.random.fold_in(key, i), src.shape, tgt.shape)
        jstate, jm = jax_step(jstate, key, jnp.asarray(src), jnp.asarray(msk), jnp.asarray(tgt))
        pstate, pm = pstep(pstate, None, src, msk, tgt, draws=draws)
        out.append(dict(
            jax_metrics={k: np.array(v) for k, v in jm.items()},
            port_metrics={k: v.numpy() for k, v in pm.items()},
            jax_seg=_flat({"params": jstate.seg.params, "batch_stats": jstate.seg.batch_stats}),
            jax_disc=_flat({"params": jstate.disc.params,
                            "batch_stats": jstate.disc.batch_stats}),
            port_seg=to_jax_state_dict(seg), port_disc=to_jax_state_dict(disc),
            seg_grads=to_jax_state_dict(seg, grads=True),
            disc_grads=to_jax_state_dict(disc, grads=True)))
        assert pstate.seg.step == pstate.disc.step == i + 1
    return out


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------
def test_adversarial_step_metrics_match_jax(step_runs):
    for step in step_runs:
        jm, pm = step["jax_metrics"], step["port_metrics"]
        assert set(pm) == set(jm) == {"loss", "seg_loss", "adv_loss", "d_loss",
                                      "source_domain_prob", "target_domain_prob", "iou",
                                      "accuracy", "per_class_iou", "hist"}
        for k in ("loss", "seg_loss", "adv_loss", "d_loss", "source_domain_prob",
                  "target_domain_prob"):
            assert pm[k].shape == jm[k].shape, k
            np.testing.assert_allclose(pm[k], jm[k], rtol=1e-5, atol=1e-5, err_msg=k)
        assert pm["source_domain_prob"].shape == (BATCH, 1)
        np.testing.assert_allclose(pm["loss"], pm["seg_loss"] + pm["adv_loss"], rtol=1e-6)
        assert pm["hist"].sum() == BATCH * SIZE * SIZE
        assert np.abs(pm["hist"] - jm["hist"]).sum() <= 2 * int(1e-3 * BATCH * SIZE * SIZE)
        for k in ("iou", "accuracy"):
            np.testing.assert_allclose(pm[k], jm[k], rtol=0, atol=2e-3, err_msg=k)


def _hold_update(step_runs, which):
    """Updated parameters and buffers of the ``which`` model ("seg" / "disc")."""
    _, seg_flat, _, disc_flat = _weights()
    initial = seg_flat if which == "seg" else disc_flat
    for i, step in enumerate(step_runs):
        theirs, ours = step[f"jax_{which}"], step[f"port_{which}"]
        grads = step[f"{which}_grads"]
        assert set(ours) == set(theirs)
        stats = [k for k in theirs if k.startswith("batch_stats/")]
        tol = 1e-5 if i == 0 else 1e-4
        for k in stats:
            np.testing.assert_allclose(ours[k], theirs[k], rtol=tol, atol=tol, err_msg=k)
            assert not np.array_equal(ours[k], initial[k]), k            # they moved
        keys = sorted(k for k in theirs if k.startswith("params/"))
        diff = np.abs(_all(ours, keys) - _all(theirs, keys))
        assert diff.max() <= 2.5 * LR * (i + 1)
        assert (np.abs(_all(theirs, keys) - _all(initial, keys)) > 0.5 * LR).mean() > 0.8
        if i == 0:
            significant = _all(_significant(grads, keys), keys)
            assert significant.mean() > 0.05
            assert diff[significant].max() <= 0.02 * LR + ULP
        else:
            assert (diff > 0.1 * LR).mean() <= 0.1


def test_adversarial_step_updates_the_discriminator_like_jax(step_runs):
    _hold_update(step_runs, "disc")


def test_adversarial_step_updates_the_unet_like_jax(step_runs):
    _hold_update(step_runs, "seg")


def test_generator_term_has_no_gradient_and_step_b_leaves_d_alone():
    """The quirk of the JAX step (``steps.py:244-252``): D sees raw images, so
    the generator term has no gradient with respect to the U-Net, whose
    update is bit-identical to that of ``lambda_adv=0``; and the G-step's
    eval-mode D(tgt) moves neither D's parameters nor its statistics."""
    batches = _batches(1, seed=3, size=32)
    states, after_step_a = {}, {}
    for lam in (LAMBDA, 0.0):
        seg, disc = _port_models()
        state = AdversarialState(TrainState(seg, adam(LR)), TrainState(disc, adam(LR)))
        d_update = state.disc.apply_gradients

        def snapshot_after_d(_f=d_update, _lam=lam, _disc=disc):
            out = _f()
            after_step_a[_lam] = {k: v.clone() for k, v in _disc.state_dict().items()}
            return out

        state.disc.apply_gradients = snapshot_after_d
        gen = torch.Generator().manual_seed(0)
        _, metrics = steps.make_adversarial_train_step(seg, disc, CLASSES, lam, aug_cfg=PCFG)(
            state, gen, *batches[0])
        states[lam] = (seg, disc, metrics)
        for k, v in disc.state_dict().items():
            assert torch.equal(v, after_step_a[lam][k]), k
    (seg_a, disc_a, m_a), (seg_b, disc_b, m_b) = states[LAMBDA], states[0.0]
    assert m_a["adv_loss"] > 0 and m_b["adv_loss"] == 0
    for (k, a), b in zip(seg_a.state_dict().items(), seg_b.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(seg_a.parameters(), seg_b.parameters()):
        assert torch.equal(a.grad, b.grad)
    for (k, a), b in zip(disc_a.state_dict().items(), disc_b.state_dict().values()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("concat_disc", [False, True])
def test_discriminator_update_matches_jax(concat_disc):
    """Step A alone, both values of ``concat_disc`` (one forward over the
    concatenated batch: joint statistics, moved once)."""
    _, _, disc_module, disc_flat = _weights()
    rng = np.random.default_rng(7)
    xs, xt = (rng.normal(size=(BATCH, SIZE, SIZE, 3)).astype(np.float32) for _ in range(2))
    jd, jloss, js, jt = jax.jit(
        lambda st, a, b: jax_steps._adv_d_update(JaxAdversarialLoss(LAMBDA), disc_module, st,
                                                 a, b, concat_disc))(
        _jax_train_state(disc_flat, LR), jnp.asarray(xs), jnp.asarray(xt))
    _, disc = _port_models()
    state = TrainState(disc, adam(LR))
    loss, s, t = steps._adv_d_update(AdversarialLoss(LAMBDA), disc, state,
                                     torch.from_numpy(xs), torch.from_numpy(xt), concat_disc)
    for a, b in ((loss, jloss), (s, js), (t, jt)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    theirs, ours = _flat({"params": jd.params, "batch_stats": jd.batch_stats}), \
        to_jax_state_dict(disc)
    grads = to_jax_state_dict(disc, grads=True)
    significant = _significant(grads, list(grads))
    for k, v in theirs.items():
        if k.startswith("batch_stats/"):
            np.testing.assert_allclose(ours[k], v, rtol=1e-5, atol=1e-5, err_msg=k)
        else:
            diff = np.abs(ours[k] - v)
            assert diff.max() <= 2.5 * LR, k
            assert (diff[significant[k]] <= 0.02 * LR + ULP).all(), k


def test_adversarial_step_draws_source_then_target_from_the_generator():
    seg, disc = _port_models()
    src, msk, tgt = _batches(1, seed=4, size=32)[0]
    gen = torch.Generator().manual_seed(9)
    copy = torch.Generator().manual_seed(9)
    abc_s = augment._sample_dihedral(copy, BATCH, PCFG)
    abc_t = augment._sample_dihedral(copy, BATCH, PCFG)
    results = []
    for g, draws in ((gen, None), (None, ((abc_s, None), (abc_t, None)))):
        s, d = _port_models()
        state = AdversarialState(TrainState(s, adam(LR)), TrainState(d, adam(LR)))
        _, m = steps.make_adversarial_train_step(s, d, CLASSES, aug_cfg=PCFG)(
            state, g, src, msk, tgt, draws=draws)
        results.append(m)
    for k in ("loss", "d_loss", "hist"):
        assert torch.equal(results[0][k], results[1][k]), k
    with pytest.raises(ValueError, match="other models"):
        steps.make_adversarial_train_step(seg, disc, CLASSES)(
            AdversarialState(TrainState(seg, adam(LR)), TrainState(seg, adam(LR))),
            gen, src, msk, tgt)


def test_match_batch_size_matches_jax():
    a = np.arange(3 * 2).reshape(3, 2)
    for b in (1, 3, 5, 7):
        expected = jax_adv_trainer.match_batch_size(a, b)
        np.testing.assert_array_equal(adversarial_trainer.match_batch_size(a, b), expected)
        np.testing.assert_array_equal(
            adversarial_trainer.match_batch_size(torch.from_numpy(a), b).numpy(), expected)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------
class _Tiles:
    def __init__(self, images, masks=None):
        self.images, self.masks = images, masks

    def __len__(self):
        return len(self.images)

    def load_raw(self, i):
        return self.images[i] if self.masks is None else (self.images[i], self.masks[i])

    __getitem__ = load_raw


@pytest.fixture(scope="module")
def trainer_runs(jax_step, tmp_path_factory):
    """Both trainers, 2 epochs of 2 steps, the same weights and tiles; the
    port's step is fed the draws of the JAX trainer's step keys."""
    seg_module, seg_flat, disc_module, disc_flat = _weights()
    rng = np.random.default_rng(11)
    images = rng.integers(0, 256, (6, SIZE, SIZE, 3), dtype=np.uint8)
    masks = rng.integers(0, CLASSES, (6, SIZE, SIZE)).astype(np.int32)
    targets = rng.integers(0, 256, (3, SIZE, SIZE, 3), dtype=np.uint8)     # a short last batch
    out = {}
    for name in ("jax", "port"):
        root = tmp_path_factory.mktemp(f"adv_{name}")
        cfg, mod, dmod, lmod = ((JaxConfig, jax_adv_trainer, jax_dataset, jax_loader)
                                if name == "jax" else
                                (Config, adversarial_trainer, dataset, loader))
        record = {"train": [], "val": []}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(cfg, "LOGS_DIR", str(root / "logs"))
            if name == "jax":
                disc = ModelBundle(disc_module, jax_variables(disc_flat))
                model = ModelBundle(seg_module, jax_variables(seg_flat))
            else:
                model, disc = _port_models()
            mp.setattr(mod, "create_discriminator", lambda *a, _d=disc, **k: _d)
            trainer = mod.AdversarialTrainer(model, device="cpu", lambda_adv=LAMBDA)
            assert trainer.discriminator is disc
            if name == "jax":
                trainer._adv_step = jax_step
            else:
                real = steps.make_adversarial_train_step(model, disc, CLASSES, LAMBDA,
                                                         aug_cfg=PCFG)

                def port_step(state, generator, src, msk, tgt, _real=real, _t=trainer):
                    key = jax.random.fold_in(jax.random.fold_in(
                        jax.random.key(Config.SEED), _t.current_epoch), state.seg.step)
                    return _real(state, generator, src, msk, tgt,
                                 draws=_draws(key, tuple(src.shape), tuple(tgt.shape)))

                trainer._adv_step = port_step
            tr, va = dmod.random_split(_Tiles(images, masks), [4, 2], seed=0)
            train_loader = lmod.DataLoader(tr, batch_size=BATCH, drop_last=True)
            val_loader = lmod.DataLoader(va, batch_size=BATCH)
            target_loader = lmod.DataLoader(_Tiles(targets), batch_size=BATCH)
            epoch_fn = trainer.train_epoch

            def train_epoch(*args, _fn=epoch_fn):
                state, loss, domain = _fn(*args)
                record["train"].append((loss, dict(domain)))
                return state, loss, domain

            trainer.train_epoch = train_epoch
            if name == "port":     # the probabilities the accuracies count
                record["probs"], update = [], trainer.domain_metrics.update

                def update_and_keep(sp, tp, _f=update, _r=record["probs"]):
                    _r.append(np.concatenate([sp, tp]))
                    return _f(sp, tp)

                trainer.domain_metrics.update = update_and_keep
            record["best"] = trainer.train(train_loader, target_loader, val_loader, epochs=2,
                                           learning_rate=TRAINER_LR, patience=1)
            record["val"] = trainer.validate(val_loader)
            record["weights"] = (model.state_dict() if name == "jax"
                                 else to_jax_state_dict(model))
            record["disc"] = disc.state_dict() if name == "jax" else to_jax_state_dict(disc)
            record["iou"] = trainer.calculate_iou(masks[0] > 2, masks[1] > 3)
        out[name] = record
    return out


def test_adversarial_trainer_matches_jax(trainer_runs):
    j, p = trainer_runs["jax"], trainer_runs["port"]
    assert len(p["train"]) == len(j["train"]) == 2
    for (pl, pd), (jl, jd) in zip(p["train"], j["train"]):
        np.testing.assert_allclose(pl, jl, rtol=1e-4)
        assert set(pd) == set(jd) == {"source_domain_acc", "target_domain_acc",
                                      "domain_confusion"}
        np.testing.assert_allclose(pd["domain_confusion"], jd["domain_confusion"], rtol=1e-5)
        # thresholds ``>= 0.5`` / ``< 0.5``: a probability within 1e-4 of 0.5
        # may fall on the other side in the other package
        near = sum(int((np.abs(q - 0.5) < 1e-4).sum()) for q in p["probs"])
        for k in ("source_domain_acc", "target_domain_acc"):
            assert abs(pd[k] - jd[k]) <= near / (2 * BATCH), k
    np.testing.assert_allclose(p["best"], j["best"], rtol=1e-4)
    (pv, pm), (jv, jm) = p["val"], j["val"]
    np.testing.assert_allclose(pv, jv, rtol=1e-4)
    assert set(pm) == set(jm) == {"iou", "accuracy"}
    for k in pm:
        assert isinstance(pm[k], float)
        np.testing.assert_allclose(pm[k], jm[k], rtol=0, atol=2e-3, err_msg=k)
    assert p["iou"] == pytest.approx(j["iou"], rel=1e-6)
    for which in ("weights", "disc"):
        assert set(p[which]) == set(j[which])
        for k, v in j[which].items():
            stats = k.startswith("batch_stats/")
            np.testing.assert_allclose(p[which][k], v, rtol=1e-2 * stats,
                                       atol=2e-3 if stats else 4 * 2.5 * TRAINER_LR, err_msg=k)
