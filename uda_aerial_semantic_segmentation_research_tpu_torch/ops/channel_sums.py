"""Per-channel float32 sums of a channel-last activation.

Counterpart of the JAX package's ``ops/pallas_moments.py::lane_sums`` and
``lane_dual_sums`` (the Pallas kernels ``_sums_kernel`` / ``_dual_kernel``)
folded to channels by ``ops/lane_bn.py::_fold``:

- ``channel_sums(x)``          -> (2, C): (sum x,  sum x*x)   BatchNorm forward
- ``channel_dual_sums(dy, x)`` -> (2, C): (sum dy, sum dy*x)  BatchNorm backward

The kernels are hand-written CUDA (``csrc/channel_sums.cu``), one launch
per call.  The TPU version's flat ``(M, 128)`` lane view and its
divisibility rule are lane tricks and are not carried over: any channel
count and any row count are taken.  The result is deterministic (partial
rows folded in a fixed order by the last block, no float atomics).
``plan`` sizes the grid to the input; the partial rows and the ticket
counter live in a scratch buffer kept per device and stream.

Under CUDA graph capture the launch goes to the capture stream (the current
one) and is recorded like any other.  What is set up once and then cached
-- the library, ``_device_limits``' attribute and occupancy queries, a
stream's scratch -- raises if it would first happen during a capture: a
scratch allocated there would live in the graph's private pool, and one
grown there would free the buffer that launches captured before still
use.  Run the work once on the capture stream first.  A scratch that
grows outside capture keeps its predecessor alive, so that graphs
captured over the old one stay valid; graphs captured on one stream share
its scratch and must replay one after another.

Each function launches the kernel for a CUDA tensor and raises on what the
kernel does not take; for a CPU tensor it computes the plain PyTorch version
(``channel_sums_reference`` / ``channel_dual_sums_reference``).  The
``launches`` attribute of each function counts its kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from uda_aerial_semantic_segmentation_research_tpu_torch.utils.device import (
    refuse_under_capture,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.utils.dtypes import to_f32

_DTYPES = (torch.float32, torch.bfloat16)


def channel_sums_reference(x):
    """Plain PyTorch version: ``x`` (..., C) -> (2, C) (sum x, sum x*x),
    accumulated in float32."""
    x32 = to_f32(x).reshape(-1, x.shape[-1])
    return torch.stack([x32.sum(0), (x32 * x32).sum(0)])


def channel_dual_sums_reference(dy, x):
    """Plain PyTorch version: (..., C) x 2 -> (2, C) (sum dy, sum dy*x),
    accumulated in float32."""
    d32 = to_f32(dy).reshape(-1, dy.shape[-1])
    x32 = to_f32(x).reshape(-1, x.shape[-1])
    return torch.stack([d32.sum(0), (d32 * x32).sum(0)])


# the grid plan; the kernel checks it (csrc/channel_sums.cu head note)
THREADS = 256                  # threads per block
CLUSTER_SIZES = (1, 2, 4, 8)   # bulk path: blocks per cluster, one partial row per cluster
FOLD_BYTES = 64 << 10          # bulk path: most partial-row bytes the last block reads
MIN_BLOCK_BYTES = 64 << 10     # bulk path: least input bytes per block before fewer blocks
GENERIC_MIN_ROWS = 128         # generic path: least rows per block
SCRATCH_HEAD = 4               # scratch words before the partial rows: the ticket counter


class Plan(NamedTuple):
    cluster: int          # bulk kernel in clusters of this many blocks; 0: generic kernel
    blocks: int
    rows_per_block: int
    partial_rows: int     # rows of (2, C) floats in the scratch


def bulk_consumers(vecs_per_row: int) -> int:
    """Threads of a bulk-kernel block that read the ring for rows of
    ``vecs_per_row`` 16-byte vectors: the most of ``THREADS`` that is a
    multiple of it, so each keeps one channel group (the kernel's
    ``bulk_consumers``)."""
    return vecs_per_row * (THREADS // vecs_per_row)


@functools.lru_cache(maxsize=256)
def plan(m: int, c: int, a_elt: int, b_elt: int, aligned: bool,
         max_clusters: tuple[int, ...], sms: int) -> Plan:
    """Grid of one launch over an (m, c) input of ``a_elt``-byte elements
    (and a second one of ``b_elt`` bytes, 0 for ``channel_sums``) on a card
    with ``sms`` SMs that runs ``max_clusters[i]`` clusters of
    ``CLUSTER_SIZES[i]`` bulk-kernel blocks at once.

    Bulk path when the pointers are 16-byte ``aligned``, every row is a
    multiple of 16 bytes and holds at most ``THREADS`` 16-byte vectors of
    the wider type: the smallest cluster whose full grid leaves the last
    block at most ``FOLD_BYTES`` of partial rows to read (the largest where
    none does, C > 512, with no more clusters than keep it so), and fewer
    clusters where the input gives a block less than ``MIN_BLOCK_BYTES``.
    Otherwise the generic path: at least ``GENERIC_MIN_ROWS`` rows a block,
    at most one block per SM, one partial row per block.
    """
    elts = (a_elt, b_elt) if b_elt else (a_elt,)
    bulk = (aligned and all(c * e % 16 == 0 for e in elts)
            and c * max(elts) // 16 <= THREADS)
    if not bulk:
        blocks = max(1, min(sms, m // GENERIC_MIN_ROWS))
        return Plan(0, blocks, -(-m // blocks), blocks)
    sizes = [(k, n) for k, n in zip(CLUSTER_SIZES, max_clusters) if n > 0]
    cluster, most = next(((k, n) for k, n in sizes if n * 2 * c * 4 <= FOLD_BYTES), sizes[-1])
    wanted = -(-m * c * sum(elts) // (cluster * MIN_BLOCK_BYTES))
    clusters = max(1, min(most, wanted, FOLD_BYTES // (2 * c * 4)))
    return Plan(cluster, clusters * cluster, -(-m // (clusters * cluster)), clusters)


@functools.cache
def _library():
    """The built kernel library with its C signatures declared."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops._build import (
        load_library,
    )

    lib = load_library("channel_sums")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.channel_sums_max_clusters.argtypes = [i32, i32, i32]
    lib.channel_sums_max_clusters.restype = i32
    lib.channel_sums_launch.argtypes = [ptr] * 4 + [i32, i32, i64, i32, i32, i64, i32, ptr]
    lib.channel_sums_launch.restype = i32
    return lib


@functools.cache
def _device_limits(index: int, a_bf16: int, b_kind: int) -> tuple[tuple[int, ...], int]:
    """(clusters of each of ``CLUSTER_SIZES`` that the bulk kernel runs at
    once, SMs) on the current device, ``index``; also sets the kernel's
    shared-memory limit there.  Never during CUDA graph capture."""
    refuse_under_capture("channel_sums' attribute and occupancy queries")
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    counts = []
    for k in CLUSTER_SIZES:
        n = _library().channel_sums_max_clusters(a_bf16, b_kind, k)
        if n < 0:
            raise RuntimeError(f"channel_sums: no occupancy for clusters of {k} on "
                               f"cuda:{index} (CUDA error {-n})")
        counts.append(min(n, sms // k))
    if not any(counts):
        raise RuntimeError(f"channel_sums cannot place its kernel on cuda:{index}")
    return tuple(counts), sms


# (device index, stream) -> f32 scratch: SCRATCH_HEAD words (the ticket
# counter, zeroed once and re-armed by every launch) + the partial rows.
# One per stream, so two streams never share a counter.
_scratch: dict[tuple[int, int], torch.Tensor] = {}
# scratch buffers replaced by larger ones: kept, as captured graphs may use them
_retired: list[torch.Tensor] = []


def _scratch_for(device, stream, floats):
    key = (device.index, stream)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < floats:
        refuse_under_capture("allocating or growing channel_sums' scratch of a stream")
        if buf is not None:
            _retired.append(buf)
        buf = _scratch[key] = torch.zeros(max(floats, 1 << 16), dtype=torch.float32,
                                          device=device)
    return buf


def _check(name, *tensors):
    first = tensors[0]
    for t in tensors:
        if t.dim() < 2:
            raise ValueError(f"{name} takes (..., C) tensors of rank >= 2, got "
                             f"{tuple(t.shape)}")
        if t.shape != first.shape or t.device != first.device:
            raise ValueError(f"{name}: shapes and devices must agree, got "
                             f"{tuple(first.shape)} on {first.device} and "
                             f"{tuple(t.shape)} on {t.device}")
        if t.numel() == 0:
            raise ValueError(f"{name} cannot reduce an empty tensor {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous channel-last tensors; the "
                             "NHWC view of a channels_last activation is one")


def _launch(fn, a, b):
    for t in (a, b):
        if t is not None and t.dtype not in _DTYPES:
            raise TypeError(f"{fn.__name__} takes float32 or bfloat16, not {t.dtype}")
    if a.shape[-1] > 2 ** 20:
        raise ValueError(f"{fn.__name__} cannot launch on {a.shape[-1]} channels")
    device = a.device
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return _launch_here(fn, a, b, device)
    return _launch_here(fn, a, b, device)


def _launch_here(fn, a, b, device):
    c = a.shape[-1]
    m = a.numel() // c
    a_bf16 = int(a.dtype == torch.bfloat16)
    b_kind = -1 if b is None else int(b.dtype == torch.bfloat16)
    max_clusters, sms = _device_limits(device.index, a_bf16, b_kind)
    a_ptr, b_ptr = a.data_ptr(), None if b is None else b.data_ptr()
    p = plan(m, c, a.element_size(), 0 if b is None else b.element_size(),
             a_ptr % 16 == 0 and (b_ptr is None or b_ptr % 16 == 0), max_clusters, sms)
    # the raw handle: no Stream object built per call (92 calls a train step)
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    scratch = _scratch_for(device, stream, SCRATCH_HEAD + p.partial_rows * 2 * c)
    out = torch.empty((2, c), dtype=torch.float32, device=device)
    err = _library().channel_sums_launch(
        a_ptr, b_ptr, scratch.data_ptr(), out.data_ptr(), a_bf16, max(b_kind, 0), m, c,
        p.blocks, p.rows_per_block, p.cluster, stream)
    if err:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: CUDA error {err}")
    fn.launches += 1
    return out


def channel_sums(x):
    """``x`` (..., C) contiguous -> (2, C) float32 (sum x, sum x*x) over all
    leading dims.  A CUDA tensor (float32 or bfloat16) launches the kernel
    or raises; a CPU tensor runs ``channel_sums_reference``."""
    _check("channel_sums", x)
    if x.device.type == "cpu":
        return channel_sums_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"channel_sums runs on cuda or cpu tensors, not {x.device}")
    return _launch(channel_sums, x, None)


def channel_dual_sums(dy, x):
    """``dy``, ``x`` (..., C) contiguous -> (2, C) float32 (sum dy, sum dy*x).
    CUDA tensors (float32 or bfloat16, the two may differ) launch the kernel
    or raise; CPU tensors run ``channel_dual_sums_reference``."""
    _check("channel_dual_sums", dy, x)
    if x.device.type == "cpu":
        return channel_dual_sums_reference(dy, x)
    if x.device.type != "cuda":
        raise ValueError(f"channel_dual_sums runs on cuda or cpu tensors, not {x.device}")
    return _launch(channel_dual_sums, dy, x)


channel_sums.launches = 0
channel_dual_sums.launches = 0
