"""The plain reference: plain float32 PyTorch that imports nothing of the
program.  One module an architecture (``unet.py``), named by a
configuration's ``reference``; the training step (``train.py``), serving
(``serve.py``) and the augmentation (``augment.py``) are shared."""

import torch


def disable_tf32() -> None:
    """float32 matrix products and convolutions in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def trainable(name: str) -> bool:
    """A parameter, not a BatchNorm's running statistic."""
    return not (name.endswith(".mean") or name.endswith(".var"))
