"""Data parallelism across processes: one process per GPU on ``torch.distributed``.

Counterpart of the JAX package's ``parallel/distributed.py``, with the same
names and contracts.  There every process's chips join one global mesh and
the train steps are written once for the global batch: XLA's partitioner
inserts the gradient ``psum`` and the cross-replica BatchNorm sums.  Here
each process drives one device and holds its own copy of the state, so the
port places those collectives itself, in the same places:

- ``ops.batch_norm``: the per-channel sums of a train-mode BatchNorm,
  forward and backward, all-reduced around the sums kernels;
- ``training.state.TrainState.apply_gradients``: the gradients averaged
  over the ranks, in a few flat buckets, before the clip;
- ``training.steps``: the step metrics of the global batch (loss scalars
  averaged, confusion matrices summed), the phase-3 ``finite`` flag of the
  global loss, and global per-class sums where a loss is not a mean over
  rows (``SMPDiceLoss``, class-weighted CE);
- ``ops.metrics.DomainAdaptationMetrics``: per-row outputs gathered through
  :func:`host_array`.

N ranks with B/N rows each thus make the update of one process with the
global batch B, to float reassociation.  Every rank must hold the same
number of rows (even dataset shards, ``drop_last``), and every rank must run
the same steps in the same order: a collective that one rank skips hangs
the others until the group's timeout.

Lifecycle:

- :func:`initialize` -- ``init_process_group`` from arguments, the
  ``UDA_TPU_*`` variables or ``torchrun``'s; NCCL for the card, gloo for the
  CPU.  Call it before the first device touch on every process.
- :func:`shard_dataset` / :func:`process_shard_indices` -- the slice of the
  dataset this process loads.
- :func:`global_batch` -- this process's local batch on its device.
- :func:`replicate_global` -- a tree that every process must hold
  identically, checked by a per-leaf fingerprint against process 0.
- :func:`is_primary` -- checkpoint, metadata and TensorBoard writes happen
  on process 0 only; :func:`barrier` for sync points.

Without a process group every function is the single-process identity, and
the steps run exactly the operations they run without this module.  With a
group of one process the collectives run and change no value.

Collectives are counted by kind in ``all_reduce_.counts`` (calls and bytes
of each kind: ``bn_forward``, ``bn_backward``, ``gradients``, ``metrics``,
``loss_sums``, ``rows``, ``control``; the height-sharded forward's boundary
rows ``halo`` and whole levels ``level``, ``parallel.spatial``).

Verification without a multi-GPU machine: :func:`dryrun_multihost` spawns N
processes that meet through a ``file://`` store, runs the supervised train
step over them and returns process 0's result (``mode="pipeline"``: the
three-phase pipeline).
"""

from __future__ import annotations

import datetime
import os
import zlib
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as tdist

__all__ = [
    "initialize",
    "is_initialized",
    "process_count",
    "process_index",
    "is_primary",
    "local_batch_size",
    "process_shard_indices",
    "shard_dataset",
    "align_local_batch",
    "broadcast_from_primary",
    "local_mesh_device_count",
    "global_batch",
    "replicate_global",
    "host_array",
    "barrier",
    "dryrun_multihost",
    "shutdown",
    "process_device",
    "all_reduce_",
    "sum_over_ranks",
    "average_gradients",
    "reduce_metrics",
    "gather_rows",
]

INIT_TIMEOUT_S = 600.0
GRADIENT_BUCKET_BYTES = 32 << 20

_DEVICE: Optional[torch.device] = None


def _device_index(local_device_ids, process_id: int) -> int:
    if local_device_ids is not None:
        ids = list(local_device_ids)
        if len(ids) != 1:
            raise ValueError(f"one process drives one GPU: local_device_ids={ids}")
        return int(ids[0])
    return process_id % torch.cuda.device_count()


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None,
               env=os.environ, *, backend: Optional[str] = None, device=None,
               timeout: float = INIT_TIMEOUT_S) -> bool:
    """Join this process to the process group.

    Resolution order (first match wins):

    1. explicit arguments (``coordinator_address`` + ``num_processes`` +
       ``process_id``); the address is an ``init_method`` URL
       (``tcp://host:port``, ``file:///path``) or ``host:port``;
    2. the ``UDA_TPU_COORDINATOR`` / ``UDA_TPU_NUM_PROCESSES`` /
       ``UDA_TPU_PROCESS_ID`` variables;
    3. ``UDA_TPU_MULTIHOST=1``: ``torchrun``'s ``RANK`` / ``WORLD_SIZE`` /
       ``LOCAL_RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT`` (``torchrun
       --nproc-per-node=N``, one process per GPU);
    4. otherwise a no-op, single-process semantics (returns ``False``).

    ``device``: ``cuda`` (``Config.DEVICE`` when None) or ``cpu``.  The
    backend is ``nccl`` for the card and ``gloo`` for the CPU unless
    ``backend`` names one (gloo also takes CUDA tensors: several processes
    can share one card that way, which NCCL refuses).  On the card the
    process drives ``local_device_ids[0]`` (the JAX argument; one id), else
    ``LOCAL_RANK`` under torchrun, else ``process_id`` modulo the card
    count, and ``torch.cuda.set_device`` selects it.  A missing card or
    backend raises: nothing switches from NCCL to gloo or from the card to
    the CPU.  ``timeout`` bounds every collective of the group.

    Idempotent: a second call once the group exists returns ``True``.
    """
    global _DEVICE
    if is_initialized():
        return True

    if coordinator_address is None and env.get("UDA_TPU_COORDINATOR"):
        coordinator_address = env["UDA_TPU_COORDINATOR"]
        num_processes = int(env.get("UDA_TPU_NUM_PROCESSES", "0")) or None
        pid = env.get("UDA_TPU_PROCESS_ID")
        process_id = int(pid) if pid is not None else None
    if coordinator_address is None:
        if env.get("UDA_TPU_MULTIHOST") != "1":
            return False
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
                   if k not in env]
        if missing:
            raise RuntimeError(f"UDA_TPU_MULTIHOST=1 needs torchrun's variables; missing "
                               f"{missing}")
        coordinator_address = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
        if local_device_ids is None and "LOCAL_RANK" in env:
            local_device_ids = [int(env["LOCAL_RANK"])]
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator address needs num_processes and process_id")

    from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
    from uda_aerial_semantic_segmentation_research_tpu_torch.utils.device import (
        resolve_device,
    )

    dev = resolve_device(Config.DEVICE if device is None else device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the NCCL backend runs on the card, not on the CPU")
        if not tdist.is_nccl_available():
            raise RuntimeError("this PyTorch has no NCCL backend")
    elif backend == "gloo":
        if not tdist.is_gloo_available():
            raise RuntimeError("this PyTorch has no gloo backend")
    else:
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if dev.type == "cuda":
        dev = torch.device("cuda", _device_index(local_device_ids, process_id))
        torch.cuda.set_device(dev)
    elif local_device_ids is not None:
        raise ValueError("local_device_ids name cards; a CPU process has none")

    address = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
    tdist.init_process_group(backend, init_method=address, world_size=int(num_processes),
                             rank=int(process_id),
                             timeout=datetime.timedelta(seconds=timeout))
    _DEVICE = dev
    return True


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    global _DEVICE
    if is_initialized():
        tdist.destroy_process_group()
    _DEVICE = None


def is_initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def process_count() -> int:
    return tdist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return tdist.get_rank() if is_initialized() else 0


def is_primary() -> bool:
    """True on the process that owns checkpoint and log writes (process 0)."""
    return process_index() == 0


def process_device() -> Optional[torch.device]:
    """The device :func:`initialize` gave this process (None without a group)."""
    return _DEVICE if is_initialized() else None


def _uses_nccl() -> bool:
    return is_initialized() and tdist.get_backend() == "nccl"


def local_batch_size(global_batch_size: int) -> int:
    """This process's share of a global batch (must divide evenly)."""
    n = process_count()
    if global_batch_size % n:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by "
            f"{n} processes")
    return global_batch_size // n


def process_shard_indices(num_items: int,
                          index: Optional[int] = None,
                          count: Optional[int] = None,
                          even: bool = False) -> range:
    """Contiguous index range of a dataset that THIS process loads.

    Every process must see the same ``num_items``.  ``even=False``: shards
    cover the dataset exactly, the first ``num_items % count`` processes
    taking one extra item (offline scans).  ``even=True``: every shard is
    ``num_items // count`` items, the remainder dropped -- training loaders
    must use it, since a ragged shard under ``drop_last`` can give one
    process one more step per epoch than its peers, whose collectives the
    others never join (a hang).
    """
    index = process_index() if index is None else index
    count = process_count() if count is None else count
    base, extra = divmod(num_items, count)
    if even:
        start = index * base
        return range(start, start + base)
    start = index * base + min(index, extra)
    return range(start, start + base + (1 if index < extra else 0))


def shard_dataset(dataset, index: Optional[int] = None,
                  count: Optional[int] = None, even: bool = False):
    """This process's contiguous ``Subset`` view of ``dataset`` (``even``:
    see :func:`process_shard_indices`)."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.data.dataset import Subset

    idx = process_shard_indices(len(dataset), index, count, even=even)
    if len(idx) == len(dataset):
        return dataset
    return Subset(dataset, list(idx))


def align_local_batch(n: int, arrays):
    """Make every array's leading dim a positive multiple of ``n``: trim to
    ``n * (b // n)`` rows, or cycle rows up to ``n`` when ``b < n``; each
    array on its own (leading dims may differ), ``None`` passes through.
    With even dataset shards every process sees the same batch shapes, so
    the alignment is the same everywhere."""

    def fix(a):
        if a is None:
            return None
        b = a.shape[0]
        if b % n == 0:
            return a
        if b >= n:
            return a[:n * (b // n)]
        return a[np.arange(n) % b]

    return type(arrays)(fix(a) for a in arrays)


def broadcast_from_primary(values):
    """Process 0's ``values`` (numbers, arrays, or dicts / lists / tuples of
    them) on every process; the identity single-process.

    For control-flow inputs that are not identical everywhere by
    construction (scores of process-local batches): broadcasting process
    0's keeps early stopping, checkpoint selection and phase gates in
    lockstep, since a process whose control flow diverges stops joining the
    others' collectives."""
    if process_count() == 1:
        return values
    _count("control", 0)
    box = [values]
    tdist.broadcast_object_list(box, src=0)
    return box[0]


def local_mesh_device_count(mesh) -> int:
    """How many of ``mesh``'s devices this process drives (one per process)."""
    return 1 if process_count() > 1 else int(mesh.size)


def global_batch(arrays, mesh=None):
    """This process's LOCAL batch as tensors on its device.

    Each process passes its own (local_B, ...) batch, which is its rows of
    the global batch of ``local_B * process_count`` rows.  Single-process
    this is ``mesh.shard_batch`` (and delegates to it)."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.parallel import mesh as mesh_lib

    if process_count() == 1:
        return mesh_lib.shard_batch(arrays, mesh)
    mesh = mesh or mesh_lib.default_mesh()

    def put(a):
        if a is None:
            return None
        local_devices = local_mesh_device_count(mesh)
        if local_devices == 0 or a.shape[0] % local_devices:
            raise ValueError(
                f"local batch dim {a.shape[0]} not divisible by this "
                f"process's {local_devices} mesh devices")
        return torch.as_tensor(a).to(mesh.device)

    if isinstance(arrays, (tuple, list)):
        return type(arrays)(put(a) for a in arrays)
    return put(arrays)


def _leaves(tree) -> list:
    """The array leaves of ``tree``: a module's ``state_dict``, a train
    state's model, optimizer state and step, dicts (sorted keys), lists,
    tuples, tensors, arrays and numbers."""
    if tree is None:
        return []
    if isinstance(tree, torch.nn.Module):
        return list(tree.state_dict().values())
    if hasattr(tree, "model") and hasattr(tree, "optimizer"):       # TrainState
        out = _leaves(tree.model)
        for p in tree.model.parameters():
            out += _leaves(dict(tree.optimizer.state.get(p, {})))
        return out + [tree.step]
    if hasattr(tree, "seg") and hasattr(tree, "disc"):              # AdversarialState
        return _leaves(tree.seg) + _leaves(tree.disc)
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _tree_fingerprint(tree):
    """Per-leaf crc32 digest (bytes + shape + dtype) as a uint32 vector:
    bit-identical trees give identical digests, any divergent leaf flips
    its crc."""

    def digest(a):
        if isinstance(a, torch.Tensor):
            t = a.detach().cpu().contiguous()
            meta = f"{tuple(t.shape)}:{t.dtype}".encode()
            raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        else:
            a = np.ascontiguousarray(np.asarray(a))
            meta = f"{a.shape}:{a.dtype}".encode()
            raw = a.tobytes()
        return np.uint32(zlib.crc32(raw, zlib.crc32(meta)))

    return np.asarray([digest(a) for a in _leaves(tree)], dtype=np.uint32)


def _assert_same_everywhere(fingerprint: np.ndarray, message: str) -> None:
    """Raise on EVERY process when any process's fingerprint differs from
    process 0's (so no process goes on alone into a collective)."""
    theirs = broadcast_from_primary(fingerprint)
    differs = (theirs.shape != fingerprint.shape or bool((theirs != fingerprint).any()))
    flag = torch.tensor([int(differs)], dtype=torch.int32, device=_comm_device())
    all_reduce_(flag, "control")
    if int(flag.item()):
        raise RuntimeError(f"{message} ({int(flag.item())} process(es) differ from "
                           "process 0)")


def replicate_global(tree, mesh=None):
    """``tree`` (a module, a train state, or arrays) on this process's
    device, after checking that every process holds an identical copy.

    Every process must hold the same values (weights from the same seed, a
    checkpoint loaded everywhere); this is checked through a per-leaf crc32
    fingerprint against process 0's (``UDA_TPU_SKIP_REPLICA_CHECK=1`` skips
    it).  A divergence raises on every process; nothing is overwritten."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.parallel import mesh as mesh_lib

    if process_count() == 1:
        return mesh_lib.replicate(tree, mesh)
    if os.environ.get("UDA_TPU_SKIP_REPLICA_CHECK") != "1":
        _assert_same_everywhere(
            _tree_fingerprint(tree),
            "replicate_global: host trees differ across processes "
            "(divergent init/checkpoint state -- every process must hold "
            "an identical copy before replication)")
    return mesh_lib.replicate(tree, mesh or mesh_lib.default_mesh())


def host_array(a):
    """The full numpy value of ``a``, available on every process.

    A tensor is this process's rows of a batch (the per-row outputs of a
    step, such as the discriminator's probabilities): with several
    processes the rows of all of them are gathered, in process order, so
    that host-side accumulators stay identical everywhere.  Anything else
    (numpy arrays, numbers) is taken as it is, as in the JAX function."""
    if not isinstance(a, torch.Tensor):
        return np.asarray(a)
    a = gather_rows(a.detach())
    if a.dtype == torch.bfloat16:
        a = a.float()
    return a.cpu().numpy()


def barrier(name: str = "uda_tpu_barrier") -> None:
    """Block until every process reaches this point (no-op single-process).
    ``name`` is the JAX function's argument; the process group needs none."""
    del name
    if process_count() == 1:
        return
    flag = torch.zeros(1, device=_comm_device())
    all_reduce_(flag, "control")
    flag.item()


# ---------------------------------------------------------------------------
# the collectives that XLA's partitioner inserts in the JAX package
# ---------------------------------------------------------------------------
def _comm_device() -> torch.device:
    """Where a control tensor lives: the process's card under NCCL, the CPU
    under gloo."""
    return _DEVICE if _uses_nccl() else torch.device("cpu")


def _count(kind: str, nbytes: int) -> None:
    calls, total = all_reduce_.counts.get(kind, (0, 0))
    all_reduce_.counts[kind] = (calls + 1, total + int(nbytes))


def all_reduce_(t: torch.Tensor, kind: str, group=None) -> torch.Tensor:
    """Sum ``t`` over the processes (of ``group``, default all) in place and
    return it; counted under ``kind``.  Without a process group ``t`` is
    returned untouched."""
    if not is_initialized():
        return t
    _count(kind, t.numel() * t.element_size())
    tdist.all_reduce(t, group=group)
    return t


all_reduce_.counts = {}


class _SumOverRanks(torch.autograd.Function):
    """Differentiable all-reduce: the forward sums over the processes, the
    backward sums the incoming gradients over them."""

    @staticmethod
    def forward(ctx, t, kind):
        ctx.kind = kind
        return all_reduce_(t.clone(memory_format=torch.contiguous_format), kind)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(memory_format=torch.contiguous_format), ctx.kind), None


def sum_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the processes, differentiably; ``t`` itself without
    a process group.

    For a loss that is not a mean over rows (per-class sums over the whole
    batch, as ``SMPDiceLoss``'s): every process computes the global loss
    from the global sums, and the backward's sum makes each process's share
    of the gradient ``N`` times the single-process one, which the gradient
    average then divides back."""
    if not is_initialized():
        return t
    return _SumOverRanks.apply(t, "loss_sums")


def _buckets(tensors, bucket_bytes: int):
    bucket, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and (size + nbytes > bucket_bytes or t.dtype != bucket[0].dtype):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
    if bucket:
        yield bucket


def average_gradients(grads) -> None:
    """Replace every gradient in ``grads`` by its mean over the processes,
    in place: flat buckets of at most ``GRADIENT_BUCKET_BYTES`` (one dtype
    each), one all-reduce per bucket.  Without a process group nothing
    happens; with one process the sums run and nothing is divided."""
    if not is_initialized():
        return
    world = process_count()
    for bucket in _buckets([g for g in grads if g is not None], GRADIENT_BUCKET_BYTES):
        flat = torch.cat([g.reshape(-1) for g in bucket])
        all_reduce_(flat, "gradients")
        if world > 1:
            flat.div_(world)
        for g, v in zip(bucket, flat.split([g.numel() for g in bucket])):
            g.copy_(v.view(g.shape))


# metrics that are the same on every process by construction
_REPLICATED_METRICS = frozenset({"rampup_weight"})
# metrics that a summed confusion matrix determines
_HIST_METRICS = frozenset({"iou", "accuracy", "per_class_iou"})


def reduce_metrics(metrics: dict) -> dict:
    """A step's metrics of the global batch: every 0-d floating metric
    averaged over the processes (one all-reduce), ``hist`` summed and
    ``iou`` / ``accuracy`` / ``per_class_iou`` recomputed from the sum.
    Per-row outputs and the metrics that every process holds identically
    (``rampup_weight``, booleans) stay as they are.  Without a process
    group ``metrics`` is returned untouched."""
    if not is_initialized():
        return metrics
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops.metrics import (
        accuracy_from_hist,
        iou_from_hist,
    )

    world = process_count()
    out = dict(metrics)
    has_hist = "hist" in metrics
    keys = [k for k, v in metrics.items()
            if isinstance(v, torch.Tensor) and v.dim() == 0 and v.is_floating_point()
            and k not in _REPLICATED_METRICS and not (has_hist and k in _HIST_METRICS)]
    if keys:
        flat = all_reduce_(torch.stack([metrics[k].detach().float() for k in keys]),
                           "metrics")
        if world > 1:
            flat = flat / world
        for k, v in zip(keys, flat.unbind()):
            out[k] = v.to(metrics[k].dtype)
    if has_hist:
        hist = all_reduce_(metrics["hist"].clone(), "metrics")
        per_class, mean_iou = iou_from_hist(hist)
        out.update(hist=hist, per_class_iou=per_class, iou=mean_iou,
                   accuracy=accuracy_from_hist(hist))
    return out


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every process's ``t`` (its rows of a batch; the same shape on every
    process) concatenated along dim 0 in process order, on ``t``'s device;
    ``t`` itself with one process.  An all-reduce of a zeroed global buffer
    that holds this process's rows at its offset, so that it runs under
    NCCL and under gloo on the CPU and on the card alike."""
    world = process_count()
    if world == 1:
        return t
    rank, b, dtype = process_index(), t.shape[0], t.dtype
    device = _DEVICE if (_uses_nccl() and t.device.type == "cpu") else t.device
    src = t.to(device=device, dtype=torch.uint8 if dtype == torch.bool else dtype)
    buf = torch.zeros((world * b, *t.shape[1:]), dtype=src.dtype, device=device)
    buf[rank * b:(rank + 1) * b] = src
    all_reduce_(buf, "rows")
    return buf.to(device=t.device, dtype=dtype)


# ---------------------------------------------------------------------------
# dry run: N coordinated processes on one machine
# ---------------------------------------------------------------------------
_WORKER_ENTRY = "uda_aerial_semantic_segmentation_research_tpu_torch.parallel.distributed"


def _worker_main(argv) -> None:
    """Entry of one dry-run process (spawned by :func:`dryrun_multihost`).

    Usage: python -m ...parallel.distributed worker <store> <nprocs> <pid>
           <global_batch> <out_dir> <mode> <device> <timeout>
    """
    store, nprocs, pid, global_b, out_dir, mode, device, timeout = argv[:8]
    nprocs, pid, global_b = int(nprocs), int(pid), int(global_b)
    from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config

    Config.DEVICE = device
    initialize(coordinator_address=store, num_processes=nprocs, process_id=pid,
               device=device, timeout=float(timeout))
    try:
        assert process_count() == nprocs and process_index() == pid
        if mode == "pipeline":
            _pipeline_worker(out_dir)
        else:
            model, metrics = _equivalence_step(global_b, device)
            spatial_ok = _spatial_check(device)
            if is_primary():
                from uda_aerial_semantic_segmentation_research_tpu_torch.models.convert import (
                    to_jax_state_dict,
                )
                from uda_aerial_semantic_segmentation_research_tpu_torch.utils.checkpoint import (
                    save_checkpoint,
                )

                save_checkpoint(
                    {"params": to_jax_state_dict(model), "loss": float(metrics["loss"]),
                     "iou": float(metrics["iou"]), "spatial_ok": spatial_ok},
                    os.path.join(out_dir, "multihost_result.pth"))
        barrier("dryrun_done")
    finally:
        shutdown()


def _spatial_check(device) -> bool:
    """The height-sharded forward with the space axis over every process:
    the boundary rows cross the processes.  Every process computes the
    unsharded forward itself and holds the gathered blocks against it
    (resnet18 U-Net, 32 px, 7 classes, float32, the JAX check's input)."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.models import create_unet
    from uda_aerial_semantic_segmentation_research_tpu_torch.parallel.spatial import (
        gather_blocks,
        spatial_forward,
        spatial_mesh,
    )

    size, classes = 32, 7
    model = create_unet("resnet18", classes=classes, seed=0, dtype=torch.float32,
                        device=device)
    mesh = spatial_mesh(1, process_count())        # height across every process
    x = np.random.default_rng(5).normal(0, 1, (2, size, size, 3)).astype(np.float32)
    with torch.inference_mode():
        ref = model(torch.from_numpy(x).to(mesh.device)).cpu().numpy()
    out = gather_blocks(spatial_forward(model, None, x, mesh), mesh).cpu().numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    return True


def _pipeline_worker(out_dir: str) -> None:
    """The three-phase pipeline (1 epoch a phase, 32 px, resnet18, one tile
    a process a step) across the processes: per-process dataset shards,
    full validation on every process, process-0 writes.  Uses the source and
    target fixtures under the working directory."""
    import json

    os.environ["UDA_TPU_IMAGE_SIZE"] = "32"
    os.environ["UDA_TPU_ENCODER"] = "resnet18"
    os.environ["UDA_TPU_BATCH_SIZE"] = "1"
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.pipeline import (
        run_pipeline,
    )

    summary = run_pipeline(phase1_epochs=1, phase2_epochs=1, phase3_epochs=1,
                           force_transitions=True,
                           checkpoints_dir=os.path.join(out_dir, "ckpt"))
    if is_primary():
        with open(os.path.join(out_dir, "multihost_pipeline.json"), "w") as f:
            json.dump({"final_phase": summary.get("final_phase"),
                       "phases": sorted(summary.get("phases", {}))}, f)


def _equivalence_step(global_b: int, device):
    """One supervised train step (WEAK) on the deterministic equivalence
    fixture: resnet18 U-Net, 32 px, 7 classes, float32, Adam 1e-3.  The
    global batch is made identically on every process from a fixed seed and
    each process feeds its rows; the augmentation's generator is seeded
    alike everywhere.  Returns the model (updated in place) and the
    metrics."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.models import create_unet
    from uda_aerial_semantic_segmentation_research_tpu_torch.parallel.mesh import create_mesh
    from uda_aerial_semantic_segmentation_research_tpu_torch.training import (
        steps as step_lib,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import (
        TrainState,
        adam,
    )

    size, classes = 32, 7
    model = create_unet("resnet18", classes=classes, seed=0, dtype=torch.float32,
                        device=device)
    mesh = create_mesh(devices=[torch.device(device)] if process_count() == 1 else None)
    state = replicate_global(TrainState(model, adam(1e-3)), mesh)

    rng = np.random.default_rng(123)
    images = rng.integers(0, 255, (global_b, size, size, 3)).astype(np.uint8)
    masks = rng.integers(0, classes, (global_b, size, size)).astype(np.int32)
    lo = process_index() * local_batch_size(global_b)
    hi = lo + local_batch_size(global_b)
    batch = global_batch((images[lo:hi], masks[lo:hi]), mesh)
    generator = torch.Generator(device=mesh.device).manual_seed(7)

    step = step_lib.make_supervised_train_step(model, classes)
    _, metrics = step(state, generator, *batch)
    return model, metrics


def dryrun_multihost(num_processes: int = 2, global_batch_size: int = 8,
                     out_dir: Optional[str] = None, timeout: float = 600.0,
                     mode: str = "step", device: Optional[str] = None) -> dict:
    """Spawn ``num_processes`` coordinated processes on this machine and run
    distributed work across them.

    ``mode="step"``: one data-parallel supervised step
    (:func:`_equivalence_step` at ``global_batch_size``) and the
    height-sharded forward over every process (:func:`_spatial_check`);
    returns process 0's ``{params, loss, iou, spatial_ok}``.  ``mode="pipeline"``: the
    three-phase pipeline at tiny shapes over the fixtures under the working
    directory; returns process 0's ``{final_phase, phases}``.

    ``device``: ``cuda`` (the default: NCCL, one card a process) or ``cpu``
    (gloo).  The processes meet through a ``file://`` store in a temporary
    directory.
    Each is waited on for at most ``timeout`` seconds and killed after it; a
    process that fails or times out raises here with its output."""
    import json
    import shutil
    import subprocess
    import sys
    import tempfile

    from uda_aerial_semantic_segmentation_research_tpu_torch.utils.checkpoint import (
        load_checkpoint,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.utils.device import (
        resolve_device,
    )

    device = resolve_device(device).type
    own_dir = out_dir is None
    out_dir = out_dir or tempfile.mkdtemp(prefix="uda_multihost_")
    store_dir = tempfile.mkdtemp(prefix="uda_store_")
    store = "file://" + os.path.join(store_dir, "rendezvous")
    package_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {k: v for k, v in os.environ.items()
           if k not in ("UDA_TPU_COORDINATOR", "UDA_TPU_MULTIHOST", "RANK", "WORLD_SIZE")}
    env["PYTHONPATH"] = os.pathsep.join([package_root] + [p for p in env.get(
        "PYTHONPATH", "").split(os.pathsep) if p])
    if device == "cpu":
        env.setdefault("OMP_NUM_THREADS", "2")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", _WORKER_ENTRY, "worker", store, str(num_processes),
             str(pid), str(global_batch_size), out_dir, mode, device, str(timeout)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(num_processes)
    ]
    outputs = {}
    try:
        for pid, p in enumerate(procs):
            outputs[pid], _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise RuntimeError(f"multihost workers did not finish in {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(store_dir, ignore_errors=True)
    for pid, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(
                f"multihost worker {pid} failed (rc={p.returncode}):\n"
                f"{outputs.get(pid, '')[-4000:]}")
    if mode == "pipeline":
        with open(os.path.join(out_dir, "multihost_pipeline.json")) as f:
            result = json.load(f)
    else:
        result = load_checkpoint(os.path.join(out_dir, "multihost_result.pth"))
    if own_dir:
        shutil.rmtree(out_dir, ignore_errors=True)
    return result


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        _worker_main(sys.argv[2:])
    elif len(sys.argv) > 1 and sys.argv[1] == "pipeline":
        res = dryrun_multihost(mode="pipeline", timeout=1500.0)
        print(f"dryrun_multihost(2, pipeline): final_phase={res['final_phase']} "
              f"phases={res['phases']} -- OK")
    else:
        res = dryrun_multihost()
        print(f"dryrun_multihost(2): loss={res['loss']:.4f} iou={res['iou']:.4f} -- OK")
