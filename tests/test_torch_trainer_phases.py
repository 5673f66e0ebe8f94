"""The port's ``MultiPhaseTrainer`` (the GRL stack's three phases): its
phase-3 step against the JAX package's, the loss assembly of its phases,
and the three phases end to end on the CPU with their checkpoints.

Phase-3 step parity: identical weights (numpy, seeded; through
``from_jax_state_dict``) and uint8 target batches go through both
packages; resnet18 ``UDASegmentationModel`` at 64 px, 7 classes, B=2, two
steps.  ``STRONG`` is replaced in both trainer modules by the WEAK pipeline
with every stage after the dihedral one off, in float32 (the full pipeline
differs between the packages by single bf16 roundings,
``tests/test_torch_augment_pipeline.py``), and the port is fed the draws
the JAX step makes: ``fold_in(key, step)``, then ``k1`` for v1 and ``k2``
for v2 (``tests/torch_augment_draws.py``).

Tolerances, and why (``tests/test_torch_adversarial.py`` gives the
reasons in full): loss components 1e-5 relative (float32, sums in another
order); BatchNorm buffers 1e-5 after the first step, 1e-4 after the second;
parameters within ``2.5 * lr`` a step, after the first step the entries
whose gradient is at least 10% of their tensor's largest within
``0.02 * lr`` plus one float32 ulp, after the second at most 10% of the
entries off by more than ``0.1 * lr``; ``lr`` 1e-6.  The end-to-end run
(resnet18, 32 px) checks what the trainer writes, not values against JAX:
checkpoints equal to the model at the moment they were written, bit for bit.
"""

import types

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
    _all,
    _jax_train_state,
    _significant,
    _Tiles,
    few_torch_threads,  # noqa: F401  (a module-scoped autouse fixture)
)
from tests.test_torch_models import jax_variables
from tests.test_torch_uda import _port_uda, _uda_weights
from tests.torch_augment_draws import augment_draws
from uda_aerial_semantic_segmentation_research_tpu.models.bundle import ModelBundle
from uda_aerial_semantic_segmentation_research_tpu.training import (
    trainer_phases as jax_trainer_phases,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
from uda_aerial_semantic_segmentation_research_tpu_torch.data import loader
from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
    create_uda_model,
    from_jax_state_dict,
    to_jax_state_dict,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops import augment
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.losses import SMPDiceLoss
from uda_aerial_semantic_segmentation_research_tpu_torch.training import (
    MultiPhaseTrainer,
    steps,
    trainer_phases,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import (
    TrainState,
    adam,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.utils.checkpoint import (
    load_checkpoint,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.visualization.tensorboard_logger import (
    read_events,
)

SIZE, CLASSES, BATCH, STEPS = 64, 7, 2, 2
LR = 1e-6
KEY = 7


def _flat(tree):
    return {"/".join(k): np.array(v) for k, v in flatten_dict(tree).items()}


def _targets(n, seed, size=SIZE):
    return np.clip(np.random.default_rng(seed).integers(0, 256, (n, size, size, 3)) * 0.7
                   + 40, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# the phase-3 step against JAX's
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def phase3_runs(tmp_path_factory):
    module, flat = _uda_weights("resnet18", SIZE)
    batches = [_targets(BATCH, 20 + i) for i in range(STEPS)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer_phases, "STRONG", JCFG)
        mp.setattr(trainer_phases, "STRONG", PCFG)
        jax_step = jax_trainer_phases.MultiPhaseTrainer._phase3_step(types.SimpleNamespace(
            _steps={}, model=ModelBundle(module, jax_variables(flat)), confusion_weight=0.1))
        model = _port_uda("resnet18", flat)
        root = tmp_path_factory.mktemp("phase3")
        trainer = MultiPhaseTrainer(model, device="cpu", checkpoint_dir=str(root),
                                    log_dir=str(root / "logs"))
        port_step = trainer._phase3_step()
        jstate, pstate = _jax_train_state(flat, LR), TrainState(model, adam(LR))
        key = jax.random.key(KEY)
        out = []
        for i, tgt in enumerate(batches):
            k1, k2 = jax.random.split(jax.random.fold_in(key, i))
            draws = tuple(augment_draws(k, tgt.shape, JCFG, has_masks=False) for k in (k1, k2))
            jstate, jm = jax_step(jstate, key, jnp.asarray(tgt))
            pstate, pm = port_step(pstate, None, tgt, draws=draws)
            out.append(dict(
                jax_metrics={k: float(v) for k, v in jm.items()},
                port_metrics={k: v.item() for k, v in pm.items()},
                jax_state=_flat({"params": jstate.params, "batch_stats": jstate.batch_stats}),
                port_state=to_jax_state_dict(model),
                grads=to_jax_state_dict(model, grads=True)))
    return flat, out


def test_phase3_step_loss_matches_jax(phase3_runs):
    _, runs = phase3_runs
    for step in runs:
        jm, pm = step["jax_metrics"], step["port_metrics"]
        assert set(pm) == set(jm) == {"loss", "consistency", "confusion"}
        for k in pm:
            np.testing.assert_allclose(pm[k], jm[k], rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(pm["loss"], pm["consistency"] + 0.1 * pm["confusion"],
                                   rtol=1e-6)
        assert -0.5 <= pm["confusion"] <= 0.0                # -mean|sigmoid(d) - 0.5|


def test_phase3_step_update_matches_jax(phase3_runs):
    initial, runs = phase3_runs
    for i, step in enumerate(runs):
        theirs, ours, grads = step["jax_state"], step["port_state"], step["grads"]
        assert set(ours) == set(theirs)
        tol = 1e-5 if i == 0 else 1e-4
        for k in theirs:
            if k.startswith("batch_stats/"):
                np.testing.assert_allclose(ours[k], theirs[k], rtol=tol, atol=tol, err_msg=k)
                assert not np.array_equal(ours[k], initial[k]), k        # x0 moves all
        keys = sorted(k for k in theirs if k.startswith("params/"))
        diff = np.abs(_all(ours, keys) - _all(theirs, keys))
        assert diff.max() <= 2.5 * LR * (i + 1)
        if i == 0:
            significant = _all(_significant(grads, keys), keys)
            assert significant.mean() > 0.05
            assert diff[significant].max() <= 0.02 * LR + ULP
            # the x0 traversal's decoder gets no gradient, v1's and v2's do
            assert all(np.abs(grads[k]).max() > 0 for k in keys if "/decoder/" in k)
        else:
            assert (diff > 0.1 * LR).mean() <= 0.1


# ---------------------------------------------------------------------------
# the loss assembly of the three phases
# ---------------------------------------------------------------------------
def test_multiphase_trainer_builds_the_reference_criteria(monkeypatch, tmp_path):
    """Phase 1 trains and validates with dice, phase 2 with the sequential
    GRL step at ``lambda_domain`` 0.001 and validates with the GRL eval
    step at the same weight, phase 3 weighs confusion by 0.1; each phase
    starts a fresh Adam."""
    calls = []
    for name in ("make_supervised_train_step", "make_eval_step", "make_grl_sequential_step",
                 "make_grl_eval_step"):
        real = getattr(steps, name)
        monkeypatch.setattr(steps, name, lambda *a, _n=name, _r=real, **k: (
            calls.append((_n, k)), _r(*a, **k))[1])
    model = create_uda_model("resnet18", classes=CLASSES, dtype=torch.float32, device="cpu")
    tr = MultiPhaseTrainer(model, device="cpu", checkpoint_dir=str(tmp_path),
                           num_classes=CLASSES, log_dir=str(tmp_path / "logs"))
    assert tr.lambda_domain == 0.001 and tr.confusion_weight == 0.1
    tr._phase1_step(), tr._phase2_step()
    assert calls == [("make_supervised_train_step", {"seg_loss": "dice"}),
                     ("make_grl_sequential_step", {"lambda_domain": 0.001})]
    a, b = tr._state(1e-3), tr._state(1e-3)
    assert a.optimizer is not b.optimizer and not a.optimizer.state
    assert {id(p) for g in a.optimizer.param_groups for p in g["params"]} \
        == {id(p) for p in model.parameters()}

    # the phase-2 loss: dice on the step's own train-mode logits + 0.001 * domain
    rng = np.random.default_rng(0)
    src = rng.integers(0, 256, (BATCH, 32, 32, 3), dtype=np.uint8)
    msk = rng.integers(0, CLASSES, (BATCH, 32, 32)).astype(np.uint8)
    tgt = _targets(BATCH, 1, size=32)
    with torch.no_grad():
        logits = model.train()(augment.normalize_images(torch.from_numpy(src)))
    dice = SMPDiceLoss()(logits, torch.from_numpy(msk).long())
    step = steps.make_grl_sequential_step(model, CLASSES, lambda_domain=tr.lambda_domain,
                                          aug_cfg=augment.NONE)
    _, m = step(tr._state(1e-3), torch.Generator().manual_seed(0), src, msk, tgt, 1.0)
    np.testing.assert_allclose(m["loss"].item(),
                               m["seg_loss"].item() + 0.001 * m["domain_loss"].item(),
                               rtol=1e-6)
    np.testing.assert_allclose(m["seg_loss"].item(), dice.item(), rtol=1e-5)
    assert 0.0 <= m["seg_loss"].item() <= 1.0


# ---------------------------------------------------------------------------
# the three phases end to end
# ---------------------------------------------------------------------------
def test_multiphase_trainer_phases_end_to_end(tmp_path):
    """Phases 1-3 of one epoch each (two steps) on the CPU: finite results,
    ``phase{n}_best.pth`` in the JAX format (it loads into the JAX package's
    bundle) holding the model as it was when written, the validation
    metrics, the logged tags; target train batches stand in for the
    missing target validation loader."""
    size = 32
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (6, size, size, 3), dtype=np.uint8)
    masks = rng.integers(0, CLASSES, (6, size, size)).astype(np.int32)
    train = loader.DataLoader(_Tiles(images[:4], masks[:4]), batch_size=BATCH, drop_last=True)
    val = loader.DataLoader(_Tiles(images[4:], masks[4:]), batch_size=BATCH)
    target = loader.DataLoader(_Tiles(_targets(3, 4, size=size)), batch_size=BATCH)
    model = create_uda_model("resnet18", classes=CLASSES, dtype=torch.float32, device="cpu")
    tr = MultiPhaseTrainer(model, device="cpu", checkpoint_dir=str(tmp_path / "ckpt"),
                           num_classes=CLASSES, log_dir=str(tmp_path / "logs"))
    written, val_loaders = {}, []
    save, validate2 = tr._save_best, tr._validate_phase2

    def save_and_keep(phase, metrics):
        written[phase] = (to_jax_state_dict(model), dict(metrics))
        save(phase, metrics)

    def validate_and_keep(val_loader, target_val_loader, eval_step):
        val_loaders.append(target_val_loader)
        return validate2(val_loader, target_val_loader, eval_step)

    tr._save_best, tr._validate_phase2 = save_and_keep, validate_and_keep
    iou1 = tr.phase1_train(train, val, epochs=1, learning_rate=1e-3)
    score2 = tr.phase2_train(train, target, val, epochs=1, learning_rate=5e-5)
    loss3 = tr.phase3_train(target, val, epochs=1, learning_rate=1e-5)
    assert 0.0 <= iou1 <= 1.0 and np.isfinite(score2) and np.isfinite(loss3)
    assert val_loaders == [target]

    keys = {1: {"iou", "accuracy", "loss"}, 2: {"iou", "accuracy", "loss", "domain_acc", "score"},
            3: {"loss"}}
    jax_module, flat = _uda_weights("resnet18", SIZE)
    bundle = ModelBundle(jax_module, jax_variables(flat))
    for phase in (1, 2, 3):
        ckpt = load_checkpoint(tmp_path / "ckpt" / f"phase{phase}_best.pth")
        assert set(ckpt) == {"model_state_dict", "metrics", "phase"} and ckpt["phase"] == phase
        state, metrics = written[phase]
        assert ckpt["metrics"] == metrics and set(metrics) == keys[phase]
        assert set(ckpt["model_state_dict"]) == set(state)
        for k, v in state.items():
            np.testing.assert_array_equal(ckpt["model_state_dict"][k], v, err_msg=k)
        bundle.load_state_dict(ckpt["model_state_dict"], strict=True)
        reloaded = create_uda_model("resnet18", classes=CLASSES, seed=5, dtype=torch.float32,
                                    device="cpu")
        reloaded.load_state_dict(from_jax_state_dict(ckpt["model_state_dict"]), strict=True)
    np.testing.assert_allclose(written[2][1]["score"],
                               written[2][1]["iou"] * written[2][1]["domain_acc"], rtol=1e-12)
    assert written[3][1] == {"loss": loss3}
    for a, b in zip(reloaded.state_dict().values(), model.state_dict().values()):
        assert torch.equal(a, b)                   # phase 3's file holds the final model

    tags = {v["tag"] for e in read_events(tr.logger.path) for v in e.get("values", [])}
    assert {"phase1/val/iou", "phase1/val/loss", "phase2/train/domain_acc", "phase2/val/score",
            "phase2/val/domain_acc", "phase3/train/loss"} <= tags


def test_multiphase_trainer_needs_cuda_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    model = create_uda_model("resnet18", classes=CLASSES, dtype=torch.float32, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(Config, "DEVICE", "cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiPhaseTrainer(model, checkpoint_dir=str(tmp_path))
    assert MultiPhaseTrainer(model, device="cpu", checkpoint_dir=str(tmp_path),
                             log_dir=str(tmp_path / "logs")).device.type == "cpu"
