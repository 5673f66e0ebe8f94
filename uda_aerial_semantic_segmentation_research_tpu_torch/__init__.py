"""PyTorch + CUDA port of the UDA aerial segmentation framework.

This package is the Hopper (NVIDIA H100) counterpart of the JAX package
``uda_aerial_semantic_segmentation_research_tpu``, which stays the
numerical reference.  It imports ``torch`` only -- never JAX, and nothing
of the JAX package -- and keeps its own copies of what it needs.

Ported so far: the serving path (U-Net eval forward -> ``predict_batch``
/ ``predict_raster``), the phase-1 train and eval steps with the whole
on-device augmentation, the phase-1 trainer (``training.train``) with
its data layer, checkpoints and event files, and phases 2 and 3 with the
three-phase pipeline (``training.pipeline.run_pipeline``: discriminator,
adversarial and unsupervised steps and trainers, ``PhaseManager``, the
target-domain data); the JAX package's four Pallas
kernels are hand-written CUDA under ``csrc/``.  Public functions keep the
JAX package's NHWC layout; entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.  Each package ``__init__`` exports the public names
of its JAX counterpart's ``__all__``.
"""

__version__ = "0.1.0"

from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config

__all__ = ["Config", "__version__"]
