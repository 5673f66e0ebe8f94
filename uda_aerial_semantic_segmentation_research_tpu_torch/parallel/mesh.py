"""The data-parallel mesh of the port and its placement helpers.

Counterpart of the JAX package's ``parallel/mesh.py``.  There a mesh is a
``jax.sharding.Mesh`` over every device and a batch is one global array
sharded along its data axis.  Here a process drives one device, so the mesh
is a record of the process group along the one data axis
(``Config.MESH_AXIS``): its size, this process's rank in it and this
process's device.  A batch "sharded" over it is this process's rows on its
device, and "replicated" state is a copy on every process's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
from uda_aerial_semantic_segmentation_research_tpu_torch.parallel import distributed as dist

_DEFAULT_MESH: Optional["Mesh"] = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh: ``size`` processes along ``axis_name``,
    this one at ``rank``, driving ``device``."""

    axis_name: str
    size: int
    rank: int
    device: torch.device

    @property
    def axis_names(self):
        return (self.axis_name,)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where an array lives on a mesh: split along the batch axis over the
    mesh's data axis (``axis`` set) or copied on every process (``None``)."""

    mesh: Mesh
    axis: Optional[str]

    @property
    def is_fully_replicated(self) -> bool:
        return self.axis is None


def create_mesh(devices: Optional[Sequence] = None,
                axis_name: Optional[str] = None) -> Mesh:
    """1-D data-parallel mesh over the processes of the group.

    ``devices``: one device per process, in rank order (default: the device
    each process was initialized with, or ``Config.get_device()`` without a
    process group).  A list of another length raises: each process drives
    one device."""
    axis_name = axis_name or Config.MESH_AXIS
    size, rank = dist.process_count(), dist.process_index()
    if devices is not None:
        devices = list(devices)
        if len(devices) != size:
            raise ValueError(f"{len(devices)} devices for {size} process(es): each process "
                             "drives one device")
        device = torch.device(devices[rank])
    else:
        device = dist.process_device() or Config.get_device()
    return Mesh(axis_name, size, rank, device)


def default_mesh() -> Mesh:
    """Process-wide default mesh (created lazily; made anew when the process
    group changed)."""
    global _DEFAULT_MESH
    if (_DEFAULT_MESH is None or _DEFAULT_MESH.size != dist.process_count()
            or _DEFAULT_MESH.rank != dist.process_index()):
        _DEFAULT_MESH = create_mesh()
    return _DEFAULT_MESH


def batch_sharding(mesh: Optional[Mesh] = None) -> Sharding:
    """Axis 0 (the batch) split across the data axis."""
    mesh = mesh or default_mesh()
    return Sharding(mesh, mesh.axis_names[0])


def replicated_sharding(mesh: Optional[Mesh] = None) -> Sharding:
    """A copy on every process (parameters, optimizer state, scalars)."""
    return Sharding(mesh or default_mesh(), None)


def shard_batch(arrays, mesh: Optional[Mesh] = None):
    """This process's rows of host batch array(s) of the GLOBAL batch, as
    tensors on its device.

    The loader guarantees static batch sizes divisible by the mesh size
    (``DataLoader(drop_last=True)`` + ``global_batch_size``); this raises
    rather than padding."""
    mesh = mesh or default_mesh()
    n = mesh.size

    def put(a):
        if a is None:
            return None
        if a.shape[0] % n:
            raise ValueError(
                f"batch dim {a.shape[0]} not divisible by mesh size {n}; "
                "use global_batch_size() and drop_last=True")
        b = a.shape[0] // n
        return torch.as_tensor(a[mesh.rank * b:(mesh.rank + 1) * b]).to(mesh.device)

    if isinstance(arrays, (tuple, list)):
        return type(arrays)(put(a) for a in arrays)
    return put(arrays)


def replicate(tree, mesh: Optional[Mesh] = None):
    """``tree``'s arrays as tensors on this process's device: tensors and
    numpy arrays in dicts, lists and tuples are moved; a module or a train
    state already lives on its device and is returned as it is."""
    mesh = mesh or default_mesh()

    def put(a):
        if isinstance(a, (torch.Tensor, np.ndarray)):
            return torch.as_tensor(a).to(mesh.device)
        if isinstance(a, dict):
            return {k: put(v) for k, v in a.items()}
        if isinstance(a, (list, tuple)) and not hasattr(a, "_fields"):
            return type(a)(put(v) for v in a)
        return a

    return put(tree)


def global_batch_size(per_device: int, mesh: Optional[Mesh] = None) -> int:
    """per-device batch size -> global batch size for the current mesh."""
    mesh = mesh or default_mesh()
    return int(per_device) * int(mesh.size)
