"""Checkpoint serialization, in the JAX package's on-disk format.

A checkpoint is a pickle (protocol 4) of the object with every array leaf
converted to a plain numpy array -- torch tensors are detached, copied to
the host, and bfloat16 (which numpy cannot hold) becomes float32 -- so a
file written by either package loads in the other, with no torch import
needed to read it.  ``save_checkpoint`` writes a temporary file in the
target directory and renames it over the target, so an interrupted write
leaves the previous checkpoint intact.

A JAX checkpoint may hold optax state objects (NamedTuples) that a process
without optax cannot import; ``load_checkpoint`` rebuilds those as tuples
of a stand-in class of the same name.  Only load files that this program
or the JAX package wrote: unpickling can run code.
"""

from __future__ import annotations

import functools
import os
import pickle
import tempfile
from pathlib import Path
from typing import Any

import numpy as np
import torch


def _to_numpy(obj: Any) -> Any:
    """Recursively convert array leaves (torch / numpy) to numpy arrays."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy().copy()
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # NamedTuple
        return type(obj)(*(_to_numpy(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy(v) for v in obj)
    if isinstance(obj, np.ndarray):
        return np.asarray(obj)
    return obj


def save_checkpoint(obj: Any, path: str | os.PathLike) -> None:
    """Atomically pickle ``obj`` (arrays converted to numpy) to ``path``.

    Under a process group only process 0 writes (the training state is the
    same on every process; N writers of one file would be wasted IO)."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.parallel.distributed import (
        is_primary,
    )

    if not is_primary():
        return
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = _to_numpy(obj)
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(payload, f, protocol=4)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


@functools.cache
def _stand_in(module: str, name: str) -> type:
    """A tuple subclass named like a class that cannot be imported."""
    return type(name, (tuple,), {"__module__": module,
                                 "__new__": lambda cls, *fields: tuple.__new__(cls, fields)})


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return _stand_in(module, name)


def load_checkpoint(path: str | os.PathLike) -> Any:
    """Load a checkpoint written by :func:`save_checkpoint` (of either package)."""
    with open(path, "rb") as f:
        return _Unpickler(f).load()
