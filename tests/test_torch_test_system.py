"""The port's ``test_system`` CLI end to end on the CPU, and what its files
give the JAX package.

One run of ``python -m ..._torch.test_system --device cpu`` at 32 px,
resnet18, B=2 (the ``UDA_TPU_*`` knobs), in a temporary working directory:
all 14 suites ✓ and exit 0; the phase-1 trainer's event file holds the
early-stopping scalars; the ``model_io`` checkpoint loads into a JAX bundle
(``ModelBundle.load_state_dict``) whose logits agree with the port's on the
same file within 2e-4 (float32 on both sides); the phase manager's
``best_model.pth`` and ``training_metadata.json`` are there and load in the
JAX package.  Beside it: an unknown suite name warns and is skipped, a
failed prerequisite turns its dependants ✗, and without ``--device`` on a
host without a GPU every suite fails with the no-CUDA error and the command
exits 1.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_adversarial import few_torch_threads  # noqa: F401  (autouse)
from uda_aerial_semantic_segmentation_research_tpu import models as jax_models
from uda_aerial_semantic_segmentation_research_tpu.utils import checkpoint as jax_checkpoint
from uda_aerial_semantic_segmentation_research_tpu_torch import test_system as ts
from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
    create_unet,
    from_jax_state_dict,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.utils.checkpoint import (
    load_checkpoint,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.visualization.tensorboard_logger import (
    read_events,
)

pytest.importorskip("cv2")                     # setup_test_data writes the fixtures with cv2

ROOT = Path(__file__).resolve().parents[1]
CLI = ["-m", "uda_aerial_semantic_segmentation_research_tpu_torch.test_system"]
S, CLASSES = 32, 23
TOL = 2e-4


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("UDA_TPU_")}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2", UDA_TPU_IMAGE_SIZE=str(S),
               UDA_TPU_ENCODER="resnet18", UDA_TPU_BATCH_SIZE="2", **extra)
    return env


def _cli(cwd, *args, **env):
    return subprocess.run([sys.executable, *CLI, *args], cwd=cwd, env=_env(**env),
                          capture_output=True, text=True, timeout=600)


def _summary(stdout):
    """suite -> ✓ / ✗ from the summary lines at the end."""
    return {line.split()[1]: line.split()[0] for line in stdout.splitlines()
            if line.startswith("  ✓ ") or line.startswith("  ✗ ")}


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    cwd = tmp_path_factory.mktemp("cli")
    proc = _cli(cwd, "--device", "cpu")
    return cwd, proc


def test_cli_runs_every_suite_on_the_cpu(cli_run):
    cwd, proc = cli_run
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert _summary(proc.stdout) == {name: "✓" for name in ts.ALL_SUITE_NAMES}
    assert list(_summary(proc.stdout)) == ts.ALL_SUITE_NAMES
    assert "All system tests completed successfully! ✓" in proc.stdout
    assert proc.stdout.rstrip().endswith("System is ready for training!")
    # the default ENCODER_WEIGHTS="imagenet" has no converted file here: a warning, no fetch
    assert "encoder stays randomly initialized" in proc.stderr
    for d in ("data/sample/semantic_drone/original_images", "data/target/holyrood",
              "data/sample/holyrood", "logs", "checkpoints", "test_logs", "results/plots"):
        assert (cwd / d).is_dir(), d


def test_cli_event_files_hold_the_early_stopping_scalars(cli_run):
    cwd, _ = cli_run
    runs = sorted((cwd / "logs").glob("*/events.out.tfevents.*"))
    assert len(runs) == 3                      # phase-1, phase-2 and phase-3 trainers
    scalars = {}
    for event in read_events(runs[0]):
        for v in event["values"]:
            if v.get("kind") == "scalar":
                scalars.setdefault(v["tag"], []).append(event["step"])
    assert scalars["early_stopping/score"] == scalars["early_stopping/counter"] == [1, 2]
    graph = read_events(next((cwd / "test_logs").glob("*/events.out.tfevents.*")))
    tags = {v["tag"] for e in graph for v in e["values"]}
    assert {"model/structure/text_summary", "model/graph/text_summary", "test/figure",
            "test/histogram"} <= tags


def test_cli_model_io_checkpoint_loads_in_the_jax_package(cli_run):
    cwd, _ = cli_run
    path = cwd / "checkpoints" / "test_checkpoint" / "test_model.pth"
    flat = jax_checkpoint.load_checkpoint(str(path))
    bundle = jax_models.create_unet("resnet18", None, 3, CLASSES, image_size=S,
                                    dtype=jnp.float32)
    assert set(flat) == set(bundle.state_dict())
    bundle.load_state_dict(flat)
    model = create_unet("resnet18", classes=CLASSES, dtype=torch.float32, device="cpu", seed=3)
    model.load_state_dict(from_jax_state_dict(load_checkpoint(path)), strict=True)
    x = np.random.default_rng(70).normal(size=(2, S, S, 3)).astype(np.float32)
    with torch.inference_mode():
        ours = model(torch.from_numpy(x)).numpy()
    ref = np.asarray(bundle(jnp.asarray(x)))
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)


def test_cli_phase_manager_files(cli_run):
    cwd, _ = cli_run
    experiments = [d for d in (cwd / "checkpoints").iterdir() if d.name != "test_checkpoint"]
    assert len(experiments) == 1
    best = experiments[0] / "phase1_segmentation" / "best_model.pth"
    ckpt = jax_checkpoint.load_checkpoint(str(best))
    assert ckpt["phase"] == "SEGMENTATION"
    assert ckpt["metrics"] == {"iou": 0.6, "accuracy": 0.85, "domain_confusion": 0.3}
    assert all(k.startswith(("params/", "batch_stats/")) for k in ckpt["model_state_dict"])
    metadata = json.loads((experiments[0] / "training_metadata.json").read_text())
    assert metadata["current_phase"] == "ADVERSARIAL"
    assert metadata["phases_completed"] == ["SEGMENTATION"]
    assert [(t["from_phase"], t["to_phase"]) for t in metadata["phase_transitions"]] == [
        ("SEGMENTATION", "ADVERSARIAL")]


def test_cli_warns_on_an_unknown_suite_and_skips_it(tmp_path):
    proc = _cli(tmp_path, "--device", "cpu", "no_such_suite", "model_creation")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "Warning: Unknown test suite 'no_such_suite'" in proc.stdout
    assert _summary(proc.stdout) == {"model_creation": "✓"}


def test_cli_without_device_on_a_host_without_a_gpu_fails_every_suite(tmp_path):
    proc = _cli(tmp_path, "training", "holyrood", CUDA_VISIBLE_DEVICES="")
    assert proc.returncode == 1
    assert "no CUDA device available" in proc.stdout
    assert _summary(proc.stdout) == {"training": "✗", "holyrood": "✗"}
    assert not list(tmp_path.iterdir())              # nothing was written


def test_a_failed_prerequisite_fails_its_dependants(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("UDA_TPU_IMAGE_SIZE", str(S))
    for name in ("IMAGE_SIZE", "DEVICE", "ENCODER_NAME", "BATCH_SIZE", "NUM_CLASSES"):
        monkeypatch.setattr(Config, name, getattr(Config, name))
    monkeypatch.setattr(ts.TestSuites, "model_creation_suite",
                        staticmethod(lambda: (False, None)))
    assert ts.test_system(["fine_tuning", "model_io", "prediction"], device="cpu") is False
    assert Config.DEVICE == "cpu" and Config.IMAGE_SIZE == S
    out = capsys.readouterr().out
    assert _summary(out) == {"fine_tuning": "✓", "model_io": "✗", "prediction": "✗"}
    assert "✗ prediction: its prerequisite 'model' is missing" in out
