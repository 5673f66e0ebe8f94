"""The port's phase lifecycle and three-phase pipeline against the JAX
package (CPU): ``PhaseManager`` (metadata, gates, transitions, checkpoints,
GC, resume across the two packages), ``run_pipeline`` end to end on fixture
files, its resume at phase 2, and the phase-2 and phase-3 trainers in a
process without the JAX trainers' host packages.

Weights cross between the packages exactly (``to_jax_state_dict`` /
``from_jax_state_dict``; checkpoints are numpy pickles), so every weight
comparison here is exact.
"""

import functools
import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_adversarial import few_torch_threads  # noqa: F401  (autouse)
from tests.test_torch_models import jax_variables, random_variables
from uda_aerial_semantic_segmentation_research_tpu.models.bundle import ModelBundle
from uda_aerial_semantic_segmentation_research_tpu.models.discriminator import (
    DomainDiscriminator as JaxDiscriminator,
)
from uda_aerial_semantic_segmentation_research_tpu.models.unet import Unet as JaxUnet
from uda_aerial_semantic_segmentation_research_tpu.ops.metrics import (
    DomainAdaptationMetrics as JaxDomainAdaptationMetrics,
)
from uda_aerial_semantic_segmentation_research_tpu.training import (
    phase_manager as jax_phase_manager,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
from uda_aerial_semantic_segmentation_research_tpu_torch.data.setup_test_data import (
    setup_test_data,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
    create_discriminator,
    create_unet,
    from_jax_state_dict,
    to_jax_state_dict,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.training import (
    adversarial_trainer,
    phase_manager,
    pipeline,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.utils.checkpoint import (
    load_checkpoint,
)

SIZE, CLASSES = 32, 7
PORT = "uda_aerial_semantic_segmentation_research_tpu_torch"
PHASES = ("SEGMENTATION", "ADVERSARIAL", "FINE_TUNING")


@functools.cache
def _flats(seed):
    sample = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
    seg = JaxUnet("resnet18", classes=CLASSES, dtype=jnp.float32)
    disc = JaxDiscriminator(dtype=jnp.float32)
    return seg, random_variables(seg, sample, seed), disc, random_variables(disc, sample,
                                                                            seed + 100)


def _models(name, seed):
    """(U-Net, discriminator) of package ``name`` with the seeded weights."""
    seg_module, seg_flat, disc_module, disc_flat = _flats(seed)
    if name == "jax":
        return (ModelBundle(seg_module, jax_variables(seg_flat)),
                ModelBundle(disc_module, jax_variables(disc_flat)))
    seg = create_unet("resnet18", classes=CLASSES, dtype=torch.float32, device="cpu")
    seg.load_state_dict(from_jax_state_dict(seg_flat), strict=True)
    disc = create_discriminator(dtype=torch.float32, device="cpu")
    disc.load_state_dict(from_jax_state_dict(disc_flat), strict=True)
    return seg, disc


def _weights(name, module):
    return module.state_dict() if name == "jax" else to_jax_state_dict(module)


class _Trainer:
    def __init__(self, discriminator=None):
        self.discriminator = discriminator


def _without_times(obj):
    if isinstance(obj, dict):
        return {k: _without_times(v) for k, v in obj.items()
                if k not in ("timestamp", "start_time")}
    if isinstance(obj, list):
        return [_without_times(v) for v in obj]
    return obj


def _lifecycle(name, root):
    """The same calls on a ``PhaseManager`` of package ``name``: what they
    return, the metadata after each, the files left."""
    mod = jax_phase_manager if name == "jax" else phase_manager
    seg, disc = _models(name, seed=1)
    pm = mod.PhaseManager(seg, device="cpu", checkpoints_dir=str(root))
    trace = [pm.get_current_phase().name, sorted(p.name for p in pm.phase_dirs)]
    gates = [({"iou": 0.6, "accuracy": 0.8}), ({"iou": 0.4, "accuracy": 0.9}),
             ({"iou": 0.51, "accuracy": 0.75}), ({"domain_confusion": 0.5, "iou": 0.5}), {}]
    trace.append([pm.can_transition(m) for m in gates])
    pm.save_checkpoint(_Trainer(disc), {"iou": 0.3, "accuracy": 0.6}, mod.TrainingPhase.SEGMENTATION,
                       is_best=True)
    pm.save_checkpoint(_Trainer(disc), {"iou": 0.1}, mod.TrainingPhase.SEGMENTATION)
    trace.append(pm.transition_to_next_phase().name)
    trace.append([pm.can_transition(m) for m in gates + [{"domain_confusion": 0.41,
                                                           "iou": 0.46}]])
    pm.save_checkpoint(_Trainer(disc), {"iou": 0.5, "domain_confusion": 0.6},
                       mod.TrainingPhase.ADVERSARIAL, is_best=True)
    pm.save_checkpoint(_Trainer(None), {"iou": 0.2}, mod.TrainingPhase.ADVERSARIAL)
    trace.append(pm.get_phase_metrics())
    trace.append(pm.get_phase_metrics(mod.TrainingPhase.SEGMENTATION))
    trace.append(pm.load_checkpoint(mod.TrainingPhase.FINE_TUNING) is None)
    ckpt = pm.load_checkpoint(mod.TrainingPhase.ADVERSARIAL, load_best=False)
    trace.append(sorted(ckpt))
    trace.append(pm.transition_to_next_phase().name)
    trace.append(pm.transition_to_next_phase().name)          # stays in phase 3
    trace.append(pm.can_transition({"iou": 1.0, "accuracy": 1.0}))
    trace.append(pm.phases_completed())
    (pm.phase_dirs[mod.TrainingPhase.ADVERSARIAL] / "epoch_3.pth").write_bytes(b"x")
    pm.cleanup_old_checkpoints()
    files = sorted(str(p.relative_to(pm.experiment_dir)) for p in pm.experiment_dir.rglob("*")
                   if p.is_file())
    metadata = json.loads(pm.metadata_path.read_text())
    return trace, _without_times(metadata), files, pm


def test_phase_manager_lifecycle_matches_jax(tmp_path):
    jt, jmeta, jfiles, jpm = _lifecycle("jax", tmp_path / "jax")
    pt, pmeta, pfiles, ppm = _lifecycle("port", tmp_path / "port")
    assert pt == jt
    assert pmeta == jmeta
    assert set(pmeta) == {"phases_completed", "current_phase", "phase_transitions",
                          "best_metrics", "last_loaded_checkpoint"}
    assert pfiles == jfiles and "phase2_adversarial/epoch_3.pth" not in pfiles
    assert ppm.experiment_dir.parent == tmp_path / "port"
    for f in ("phase1_segmentation/best_model.pth", "phase2_adversarial/best_model.pth",
              "phase2_adversarial/latest_model.pth"):
        theirs, ours = load_checkpoint(jpm.experiment_dir / f), load_checkpoint(
            ppm.experiment_dir / f)
        assert set(ours) == set(theirs), f
        assert _without_times(ours["metrics"]) == theirs["metrics"] and ours["phase"] == theirs["phase"]
        for part in ("model_state_dict", "discriminator_state_dict"):
            if part in theirs:
                assert set(ours[part]) == set(theirs[part])
                for k, v in theirs[part].items():
                    np.testing.assert_array_equal(ours[part][k], v, err_msg=f"{f} {k}")


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_resume_across_the_packages(tmp_path, writer, reader):
    """An experiment written by one package resumes in the other: phase,
    U-Net weights and the discriminator's."""
    wmod = jax_phase_manager if writer == "jax" else phase_manager
    rmod = jax_phase_manager if reader == "jax" else phase_manager
    seg, disc = _models(writer, seed=2)
    pm = wmod.PhaseManager(seg, checkpoints_dir=str(tmp_path))
    pm.save_checkpoint(_Trainer(), {"iou": 0.7}, wmod.TrainingPhase.SEGMENTATION, is_best=True)
    pm.transition_to_next_phase()
    pm.save_checkpoint(_Trainer(disc), {"iou": 0.6}, wmod.TrainingPhase.ADVERSARIAL,
                       is_best=True)
    expected_seg, expected_disc = _weights(writer, seg), _weights(writer, disc)

    other_seg, other_disc = _models(reader, seed=3)
    resumed = rmod.PhaseManager.resume(other_seg, experiment_dir=str(pm.experiment_dir))
    assert resumed.get_current_phase().name == "ADVERSARIAL"
    assert resumed.phases_completed() == ["SEGMENTATION"]
    assert resumed.load_discriminator_state(other_disc)
    for got, expected in ((_weights(reader, other_seg), expected_seg),
                          (_weights(reader, other_disc), expected_disc)):
        assert set(got) == set(expected)
        for k, v in expected.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    meta = json.loads(resumed.metadata_path.read_text())
    assert meta["last_loaded_checkpoint"]["phase"] == "ADVERSARIAL"
    with pytest.raises(FileNotFoundError):
        rmod.PhaseManager.resume(other_seg, experiment_dir=str(tmp_path / "none"))


# ---------------------------------------------------------------------------
# run_pipeline on fixture files
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """Fixture files and every ``Config`` path under a temporary directory;
    a small model on the CPU."""
    root = tmp_path_factory.mktemp("pipeline")
    with pytest.MonkeyPatch.context() as mp:
        for attr, rel in (("DATA_DIR", "data"),
                          ("SAMPLE_DATA_DIR", "data/sample/semantic_drone"),
                          ("SAMPLE_HOLYROOD_DIR", "data/sample/holyrood"),
                          ("TARGET_DATA_DIR", "data/target/holyrood"), ("LOGS_DIR", "logs"),
                          ("CHECKPOINTS_DIR", "checkpoints"), ("CHECKPOINT_DIR", "checkpoints"),
                          ("RESULTS_DIR", "results")):
            mp.setattr(Config, attr, str(root / rel))
        for attr, value in (("DEVICE", "cpu"), ("ENCODER_NAME", "resnet18"),
                            ("IMAGE_SIZE", SIZE), ("BATCH_SIZE", 2), ("NUM_CLASSES", CLASSES),
                            ("ENCODER_WEIGHTS", None), ("COMPUTE_DTYPE", "float32"),
                            ("NUM_WORKERS", 2)):
            mp.setattr(Config, attr, value)
        for var in ("UDA_TPU_IMAGE_SIZE", "UDA_TPU_ENCODER", "UDA_TPU_BATCH_SIZE",
                    "UDA_TPU_NUM_CLASSES"):
            mp.delenv(var, raising=False)
        setup_test_data(num_source=5, num_holyrood=4, image_size=40, force=True)
        yield root


@pytest.fixture(scope="module")
def first_run(workspace):
    """One ``run_pipeline``, one epoch a phase, gates forced."""
    return pipeline.run_pipeline(phase1_epochs=1, phase2_epochs=1, phase3_epochs=1,
                                 force_transitions=True)


def _expected_summary_keys():
    """The JAX pipeline's summary, key by key (``training/pipeline.py``)."""
    domain = set(JaxDomainAdaptationMetrics().get_metrics())
    return {"segmentation": ({"metrics", "gate"}, {"loss", "iou", "accuracy", "iou_epoch"}),
            "adversarial": ({"metrics", "gate"}, {"iou", "accuracy"} | domain),
            "fine_tuning": ({"metrics"}, {"iou"} | domain)}


def test_run_pipeline_end_to_end_on_the_cpu(workspace, first_run):
    summary = first_run
    assert set(summary) == {"experiment_dir", "phases", "final_phase"}
    assert summary["final_phase"] == "FINE_TUNING"
    expected = _expected_summary_keys()
    assert set(summary["phases"]) == set(expected)
    for phase, (keys, metric_keys) in expected.items():
        assert set(summary["phases"][phase]) == keys, phase
        assert set(summary["phases"][phase]["metrics"]) == metric_keys, phase
    experiment = Path(summary["experiment_dir"])
    assert experiment.parent == workspace / "checkpoints"
    meta = json.loads((experiment / "training_metadata.json").read_text())
    assert meta["phases_completed"] == list(PHASES[:2]) and meta["current_phase"] == PHASES[2]
    assert sorted(meta["best_metrics"]) == sorted(PHASES)
    for d in ("phase1_segmentation", "phase2_adversarial", "phase3_finetuning"):
        ckpt = load_checkpoint(experiment / d / "best_model.pth")
        assert ("discriminator_state_dict" in ckpt) == (d != "phase1_segmentation")
        assert all(np.isfinite(v).all() for v in ckpt["model_state_dict"].values())
    assert len(list((workspace / "logs").rglob("events.out.tfevents.*"))) >= 3


def test_run_pipeline_resumes_at_phase_2_with_the_discriminator(workspace, first_run,
                                                                monkeypatch):
    experiment = workspace / "resume"
    shutil.copytree(first_run["experiment_dir"], experiment)
    meta_path = experiment / "training_metadata.json"
    meta = json.loads(meta_path.read_text())
    meta.update(current_phase="ADVERSARIAL", phases_completed=["SEGMENTATION"])
    meta_path.write_text(json.dumps(meta))
    saved = load_checkpoint(experiment / "phase2_adversarial" / "best_model.pth")

    seen = {}
    real_train = adversarial_trainer.AdversarialTrainer.train

    def train(self, *args, **kw):
        seen["disc"] = to_jax_state_dict(self.discriminator)
        seen["seg"] = to_jax_state_dict(self.model)
        return real_train(self, *args, **kw)

    monkeypatch.setattr(adversarial_trainer.AdversarialTrainer, "train", train)
    summary = pipeline.run_pipeline(phase1_epochs=1, phase2_epochs=1, phase3_epochs=1,
                                    force_transitions=True, resume_dir=str(experiment))
    assert set(summary["phases"]) == {"adversarial", "fine_tuning"}       # phase 1 skipped
    for part, got in (("discriminator_state_dict", seen["disc"]),
                      ("model_state_dict", seen["seg"])):
        assert set(got) == set(saved[part])
        for k, v in saved[part].items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_pipeline_requires_the_card_unless_asked_for_the_cpu(workspace, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(Config, "DEVICE", "cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.run_pipeline(phase1_epochs=1, phase2_epochs=1, phase3_epochs=1)
    seg, _ = _models("port", seed=4)
    for cls in (adversarial_trainer.AdversarialTrainer,):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(seg)
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.unsupervised_trainer import (
        UnsupervisedTrainer,
    )

    with pytest.raises(RuntimeError, match="CUDA"):
        UnsupervisedTrainer(seg)


def test_pipeline_cli_names_the_jax_flags_and_device():
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-m", f"{PORT}.training.pipeline", "--help"],
                          cwd=root, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    for flag in ("--phase1-epochs", "--phase2-epochs", "--phase3-epochs", "--learning-rate",
                 "--batch-size", "--lambda-adv", "--force-transitions", "--resume", "--device"):
        assert flag in proc.stdout, flag


def test_pipeline_builds_its_loaders_in_the_module():
    """``chip_smoke.py`` hands ``run_pipeline`` in-memory loaders by replacing
    ``pipeline._build_loaders``: the name must stay where it looks."""
    assert pipeline._build_loaders.__module__ == f"{PORT}.training.pipeline"
    assert "_build_loaders(batch_size)" in Path(pipeline.__file__).read_text()


# ---------------------------------------------------------------------------
# the card's installation: none of the JAX trainers' host packages
# ---------------------------------------------------------------------------
BLOCKED = ("cv2", "pandas", "tqdm", "matplotlib", "seaborn", "sklearn", "tensorboard", "PIL",
           "jax", "flax", "optax")

_BLOCKED_RUN = r'''
import sys
for m in {blocked!r}:
    sys.modules[m] = None
import importlib, numpy as np, torch
for m in {modules!r}:
    importlib.import_module(m)
from {port}.config import Config
from {port}.data.dataset import Subset
from {port}.data.loader import DataLoader
from {port}.models import DomainAdaptationModel, create_discriminator, create_unet
from {port}.training.adversarial_trainer import AdversarialTrainer
from {port}.training.unsupervised_trainer import UnsupervisedTrainer
Config.LOGS_DIR, Config.COMPUTE_DTYPE = {logs!r}, "float32"
rng = np.random.default_rng(0)
tiles = [(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8),
          rng.integers(0, 7, (32, 32)).astype(np.int32)) for _ in range(4)]
targets = [rng.integers(0, 256, (32, 32, 3), dtype=np.uint8) for _ in range(2)]
model = create_unet("resnet18", classes=7, device="cpu", dtype=torch.float32)
src = DataLoader(Subset(tiles, [0, 1]), batch_size=2, num_workers=2)
val = DataLoader(Subset(tiles, [2, 3]), batch_size=2)
tgt = DataLoader(targets, batch_size=2, shuffle=True, drop_last=True, num_workers=2)
adv = AdversarialTrainer(model, device="cpu")
print("phase2", adv.train(src, tgt, val, epochs=1, learning_rate=1e-4))
unsup = UnsupervisedTrainer(DomainAdaptationModel(model, adv.discriminator), device="cpu")
print("phase3", unsup.train(tgt, val, epochs=1, learning_rate=1e-5))
bad = sorted(m for m in {blocked!r} if sys.modules.get(m) is not None)
assert not bad, bad
print("ok")
'''


def test_phases_2_and_3_train_without_the_jax_trainers_host_packages(tmp_path):
    """A fresh process where cv2, pandas, tqdm, matplotlib, seaborn, sklearn,
    tensorboard, PIL, JAX, flax and optax cannot be imported: every port
    module imports, and one phase-2 and one phase-3 epoch run on the CPU
    from in-memory data."""
    root = Path(__file__).resolve().parents[1]
    modules = sorted(".".join(f.relative_to(root).with_suffix("").parts)
                     for f in (root / PORT).rglob("*.py"))
    for name in ("training.pipeline", "training.phase_manager", "training.adversarial_trainer",
                 "training.unsupervised_trainer", "data.target_dataset",
                 "data.create_sample_holyrood", "models.discriminator",
                 "models.domain_model"):
        assert f"{PORT}.{name}" in modules
    code = _BLOCKED_RUN.format(blocked=BLOCKED, modules=modules, port=PORT,
                               logs=str(tmp_path / "logs"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "phase2" in proc.stdout and "phase3" in proc.stdout
    assert proc.stdout.strip().endswith("ok")
