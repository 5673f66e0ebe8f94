"""Phase lifecycle state machine, per-phase checkpoints and resume.

The port's copy of the JAX package's ``training/phase_manager.py``, with the
same contract:

- a timestamped experiment directory with ``phase1_segmentation``,
  ``phase2_adversarial`` and ``phase3_finetuning`` subdirectories;
- ``training_metadata.json`` with ``start_time``, ``phases_completed``,
  ``current_phase``, ``phase_transitions``, ``best_metrics`` (and
  ``last_loaded_checkpoint`` after a load);
- ``best_model.pth`` / ``latest_model.pth`` per phase in the JAX package's
  checkpoint format (``utils/checkpoint``): ``model_state_dict`` in the JAX
  layout (``models.convert.to_jax_state_dict``), plus the discriminator's as
  ``discriminator_state_dict`` for phases 2 and 3, so a checkpoint or an
  experiment directory written by either package resumes in the other;
- metric gates (phase 1 -> 2: iou > 0.5 and accuracy > 0.75; phase 2 -> 3:
  domain_confusion > 0.4 and iou > 0.45), transitions and checkpoint GC.

The model is an ``nn.Module`` (the U-Net, or a ``DomainAdaptationModel``,
whose ``state_dict`` is already in the JAX layout).  Under a process group
only process 0 creates the directories and writes checkpoints and metadata,
as in the JAX package; the other processes keep the metadata in memory (the
metrics are the global batch's, so the copies agree).
"""

from __future__ import annotations

import copy
import datetime
import json
from enum import Enum, auto
from pathlib import Path
from typing import Any, Dict, Optional

from uda_aerial_semantic_segmentation_research_tpu_torch.models.convert import (
    from_jax_state_dict,
    to_jax_state_dict,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.models.domain_model import (
    DomainAdaptationModel,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.parallel.distributed import is_primary
from uda_aerial_semantic_segmentation_research_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)


class TrainingPhase(Enum):
    SEGMENTATION = auto()   # phase 1: supervised segmentation
    ADVERSARIAL = auto()    # phase 2: adversarial domain adaptation
    FINE_TUNING = auto()    # phase 3: unsupervised fine-tuning


_ORDER = [TrainingPhase.SEGMENTATION, TrainingPhase.ADVERSARIAL, TrainingPhase.FINE_TUNING]


def jax_state_dict(module) -> Dict[str, Any]:
    """``module``'s weights in the JAX layout."""
    if isinstance(module, DomainAdaptationModel):
        return module.state_dict()
    return to_jax_state_dict(module)


def load_jax_state_dict(module, state: Dict[str, Any]) -> None:
    """Load weights in the JAX layout into ``module`` (strict)."""
    if isinstance(module, DomainAdaptationModel):
        module.load_state_dict(state)
    else:
        module.load_state_dict(from_jax_state_dict(state), strict=True)


class PhaseManager:
    """Manages training phases, transitions and per-phase checkpoints."""

    def __init__(self, model, device=None, checkpoints_dir: str = "checkpoints"):
        self.model = model
        self.device = device
        self.checkpoints_dir = Path(checkpoints_dir)
        self.current_phase = TrainingPhase.SEGMENTATION
        self.phase_metrics: Dict[str, Any] = {}
        self.last_checkpoint: Optional[Dict[str, Any]] = None

        timestamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S-%f")
        self.experiment_dir = self.checkpoints_dir / timestamp
        self.phase_dirs = self._phase_dirs(self.experiment_dir)
        if is_primary():
            for d in self.phase_dirs.values():
                d.mkdir(parents=True, exist_ok=True)
        self.metadata_path = self.experiment_dir / "training_metadata.json"
        self._initialize_metadata()

    @staticmethod
    def _phase_dirs(experiment_dir: Path):
        return {
            TrainingPhase.SEGMENTATION: experiment_dir / "phase1_segmentation",
            TrainingPhase.ADVERSARIAL: experiment_dir / "phase2_adversarial",
            TrainingPhase.FINE_TUNING: experiment_dir / "phase3_finetuning",
        }

    # ------------------------------------------------------------------
    @classmethod
    def resume(cls, model, device=None, experiment_dir: str = None,
               load_best: bool = True) -> "PhaseManager":
        """Rebind to an existing experiment directory: restore
        ``current_phase`` from the metadata and load into ``model`` the
        best (or latest) checkpoint of the newest phase up to it that has
        one.  The loaded checkpoint stays on ``last_checkpoint`` (for the
        discriminator: ``load_discriminator_state``)."""
        pm = cls.__new__(cls)
        pm.model = model
        pm.device = device
        pm.experiment_dir = Path(experiment_dir)
        pm.checkpoints_dir = pm.experiment_dir.parent
        pm.phase_metrics = {}
        pm.last_checkpoint = None
        pm.phase_dirs = cls._phase_dirs(pm.experiment_dir)
        pm.metadata_path = pm.experiment_dir / "training_metadata.json"
        if not pm.metadata_path.exists():
            raise FileNotFoundError(f"no training_metadata.json under {experiment_dir}")
        md = pm._load_metadata()
        pm.current_phase = TrainingPhase[md.get("current_phase", "SEGMENTATION")]
        candidates = _ORDER[:_ORDER.index(pm.current_phase) + 1][::-1]
        for phase in candidates:
            ckpt = (pm.load_checkpoint(phase, load_best=load_best)
                    or pm.load_checkpoint(phase, load_best=not load_best))
            if ckpt is not None:
                break
        return pm

    def phases_completed(self):
        return list(self._load_metadata().get("phases_completed", []))

    # ------------------------------------------------------------------
    def _initialize_metadata(self):
        self._save_metadata({
            "start_time": datetime.datetime.now().isoformat(),
            "phases_completed": [],
            "current_phase": self.current_phase.name,
            "phase_transitions": [],
            "best_metrics": {},
        })

    def _save_metadata(self, metadata: Dict[str, Any]):
        if not is_primary():
            self._metadata = copy.deepcopy(metadata)
            return
        with open(self.metadata_path, "w") as f:
            json.dump(metadata, f, indent=4)

    def _load_metadata(self) -> Dict[str, Any]:
        if not is_primary() and getattr(self, "_metadata", None) is not None:
            return copy.deepcopy(self._metadata)
        if self.metadata_path.exists():
            with open(self.metadata_path) as f:
                return json.load(f)
        return {}

    # ------------------------------------------------------------------
    def save_checkpoint(self, trainer, metrics: Dict[str, float], phase: TrainingPhase,
                        is_best: bool = False):
        """Write the phase's best or latest checkpoint and record the metrics."""
        checkpoint = {
            "model_state_dict": jax_state_dict(self.model),
            "metrics": metrics,
            "phase": phase.name,
            "timestamp": datetime.datetime.now().isoformat(),
        }
        if phase in (TrainingPhase.ADVERSARIAL, TrainingPhase.FINE_TUNING):
            disc = getattr(trainer, "discriminator", None)
            if disc is not None:
                checkpoint["discriminator_state_dict"] = jax_state_dict(disc)
        path = self.phase_dirs[phase] / ("best_model.pth" if is_best else "latest_model.pth")
        save_checkpoint(checkpoint, path)

        metadata = self._load_metadata()
        metadata["best_metrics"][phase.name] = (
            metrics if is_best else metadata["best_metrics"].get(phase.name, {}))
        self._save_metadata(metadata)

    def load_checkpoint(self, phase: TrainingPhase,
                        load_best: bool = True) -> Optional[Dict[str, Any]]:
        """Load a phase checkpoint into the model; None when there is none."""
        path = self.phase_dirs[phase] / ("best_model.pth" if load_best else "latest_model.pth")
        if not path.exists():
            return None
        checkpoint = load_checkpoint(path)
        load_jax_state_dict(self.model, checkpoint["model_state_dict"])
        self.last_checkpoint = checkpoint

        metadata = self._load_metadata()
        metadata["last_loaded_checkpoint"] = {
            "phase": phase.name,
            "checkpoint_type": "best" if load_best else "latest",
            "timestamp": datetime.datetime.now().isoformat(),
        }
        self._save_metadata(metadata)
        return checkpoint

    def load_discriminator_state(self, discriminator) -> bool:
        """Restore ``discriminator`` from the last loaded checkpoint; True when
        it held a ``discriminator_state_dict``."""
        state = (self.last_checkpoint or {}).get("discriminator_state_dict")
        if state is None or discriminator is None:
            return False
        load_jax_state_dict(discriminator, state)
        return True

    # ------------------------------------------------------------------
    def can_transition(self, metrics: Dict[str, float]) -> bool:
        """The metric gate out of the current phase."""
        if self.current_phase == TrainingPhase.SEGMENTATION:
            return (float(metrics.get("iou", 0)) > 0.5
                    and float(metrics.get("accuracy", 0)) > 0.75)
        if self.current_phase == TrainingPhase.ADVERSARIAL:
            return (float(metrics.get("domain_confusion", 0)) > 0.4
                    and float(metrics.get("iou", 0)) > 0.45)
        return False

    def transition_to_next_phase(self) -> TrainingPhase:
        """Advance to the next phase and record the transition."""
        metadata = self._load_metadata()
        metadata["phases_completed"].append(self.current_phase.name)
        metadata["phase_transitions"].append({
            "from_phase": self.current_phase.name,
            "timestamp": datetime.datetime.now().isoformat(),
        })
        if self.current_phase != TrainingPhase.FINE_TUNING:
            self.current_phase = _ORDER[_ORDER.index(self.current_phase) + 1]
        metadata["current_phase"] = self.current_phase.name
        metadata["phase_transitions"][-1]["to_phase"] = self.current_phase.name
        self._save_metadata(metadata)
        return self.current_phase

    def get_current_phase(self) -> TrainingPhase:
        return self.current_phase

    def get_phase_metrics(self, phase: Optional[TrainingPhase] = None) -> Dict[str, Any]:
        phase = phase or self.current_phase
        return self._load_metadata().get("best_metrics", {}).get(phase.name, {})

    def cleanup_old_checkpoints(self, keep_best: bool = True, keep_latest: bool = True):
        """Delete every phase checkpoint other than the kept best / latest."""
        for phase_dir in self.phase_dirs.values():
            for f in phase_dir.glob("*.pth"):
                if (keep_best and f.name == "best_model.pth") or (
                        keep_latest and f.name == "latest_model.pth"):
                    continue
                f.unlink()
