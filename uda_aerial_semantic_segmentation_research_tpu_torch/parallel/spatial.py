"""The height-sharded eval forward: a tile split by rows over processes.

Counterpart of the JAX package's ``parallel/spatial.py``: a 2-D
``("data", "space")`` mesh, images sharded batch x height, parameters
replicated, for a raster tile too large for one card's memory.  There XLA's
partitioner inserts the halo exchanges and the cross-shard reductions.
Here one process drives one device (``parallel.distributed``), so the
layers of the segmentation models (the U-Net, the other ``create_model``
families on every encoder, ``UDASegmentationModel``) exchange rows
themselves while a sharded forward runs:

- every convolution (``models.resnet.Conv2d``: the encoders, the decoders,
  the heads), the stem's max-pool and the ``conv_bn_relu`` kernel of
  ``fused_eval`` ask :func:`current_shard` for this thread's sharded forward;
  without one they compute as before;
- a layer fetches exactly the rows its receptive field reads from the rows
  this process holds, ``[a, a + h)`` of its level with ``a`` even: a 3x3/1
  conv 1 row above and 1 below (``d`` each at dilation ``d``), the 7x7/2
  stem 3 above and 2 below, a 3x3/2 conv and the 3x3/2 max-pool 1 above, a
  1x1 conv none.  It pads only at the global top and bottom (zeros for a
  conv, ``-inf`` for the max-pool) and keeps its own padding along W.  So
  its output rows are exactly rows ``[s * h_out, (s + 1) * h_out)`` of the
  whole forward's at that layer.  A neighbour that holds fewer rows than the
  halo needs raises: such a layer runs whole through :func:`whole`;
- the rows travel as one all-reduce over the space group of a zeroed buffer
  that holds each rank's bottom and top rows at its slot (the idea of
  ``distributed.gather_rows``).  It runs under NCCL and under gloo, on CPU
  and CUDA tensors alike; gloo has no send / recv for CUDA tensors and NCCL
  refuses two ranks on one card.  Each is counted in
  ``distributed.all_reduce_.counts`` as ``"halo"``;
- ``conv_bn_relu`` gets the local rows of its pre-affine input with the
  neighbours' row attached where there is one; it applies the folded
  BatchNorm and ReLU to every row it is given and pads zeros only outside
  the tensor, which is then the global edge; the output rows of the
  attached rows are dropped.  Its gate reads the level's global height, so
  every rank takes the path the whole forward takes.

The families add three primitives (:meth:`Shard.resize`, :func:`pooled`,
:func:`whole`), each with one rule:

- a resize to a level's global size by a power-of-two factor ``f``
  (nearest, or the half-pixel bilinear) computes this rank's output rows
  ``[a, a + r)`` from the source rows they read, ``[a // f, ceil((a + r) /
  f))``, one more on each side for the bilinear (a ``"halo"`` exchange from
  split rows; a slice of a whole level).  At the global edges the window
  stops, so the resize's own clamp reads what it reads in the whole resize
  (a replicate edge, without its rounding);
- a mean over H and W (the ASPP's and PAN's pooling, the GAU attention,
  ``_MFAB``'s squeeze-excite) is one all-reduce of the local float32 sums
  over the space group (``"mean"``) divided by the level's global count; the
  ``(B, C, 1, 1)`` result has no rows, and the function of it runs with the
  shard suspended;
- ``whole(fn, x)`` gathers ``x``'s level once (``"level"``), runs ``fn``
  with the shard suspended and keeps this rank's rows of the result: for
  what reads across the whole level (PSPNet's bins, ``_PAB``'s attention,
  PAN's FPA, whose pooled levels go below the pyramid, and the ASPP's
  dilated convs where their rate exceeds a rank's rows).  A tensor whose
  width is on no level raises; nothing runs whole but through this call
  and the level plan.

**Whole levels.**  Level ``k`` of the pyramid (``H / 2**k`` rows) is split
when ``n_space`` divides its rows, each rank holds at least the rows its
readers fetch (3 at the input below a 7x7 stem, else 1), its rows are
exactly half the rows of level ``k - 1`` and level ``k - 1`` is split.
Otherwise (small tiles: the ``/16`` and ``/32`` levels of 32 px over 4
ranks) the level is computed whole on every rank: the stride-2 layer that
enters it gathers its input over the space group (one all-reduce, counted
as ``"level"``, shared by the block's conv and downsample), and the
upsample to the first level that is split again keeps this rank's rows.  A
level is recognised by its width, which no layer shards.

Eval-mode BatchNorm, the ReLUs, the activation and the ``logits_dtype``
cast are per pixel and need no rows.  Every rank runs the same collectives
in the same order: the plan is the same everywhere and the edge ranks take
part in every exchange.

Differences from the JAX function: ``images`` is the full host value on
every process (as JAX ``_global_put`` takes it) and the result is this
process's block, not a global array (:func:`gather_blocks` assembles the
whole); the eval forward only; segmentation models only (a discriminator's
``(B, 1)`` output has no rows, and ``spatial_forward`` refuses it by name);
the means are explicit all-reduces, and the layers that read a whole level
run it whole on every rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as tdist
import torch.nn.functional as F

from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
from uda_aerial_semantic_segmentation_research_tpu_torch.parallel import distributed as dist

__all__ = ["spatial_mesh", "spatial_image_sharding", "spatial_forward", "pooled",
           "whole"]

AXIS_NAMES = ("data", "space")
PYRAMID_LEVELS = 6            # the encoders' levels: identity, /2, /4, /8, /16, /32

_STATE = threading.local()


@dataclasses.dataclass(frozen=True)
class SpatialMesh:
    """A 2-D ``("data", "space")`` mesh of processes: this one at
    ``(data_index, space_index)``, driving ``device``; ``space_group`` is the
    process group of the ranks that share its data index (None without a
    process group)."""

    n_data: int
    n_space: int
    data_index: int
    space_index: int
    device: torch.device
    space_group: Optional[object] = dataclasses.field(default=None, compare=False,
                                                      repr=False)

    @property
    def axis_names(self):
        return AXIS_NAMES

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "space": self.n_space}

    @property
    def size(self) -> int:
        return self.n_data * self.n_space


@dataclasses.dataclass(frozen=True)
class SpatialSharding:
    """A ``(B, H, ...)`` array split batch x height over ``mesh``
    (``spec == ("data", "space")``)."""

    mesh: SpatialMesh
    spec: tuple = AXIS_NAMES

    def block(self, shape: Sequence[int]):
        """``(batch rows, height rows)`` of ``shape`` that this process
        holds; raises unless the mesh's axes divide them."""
        if len(shape) != 4:
            raise ValueError(f"expected (B, H, W, C) images, got shape {tuple(shape)}")
        b, h = int(shape[0]), int(shape[1])
        m = self.mesh
        if b % m.n_data:
            raise ValueError(f"batch {b} not divisible by the data axis ({m.n_data})")
        if h % m.n_space:
            raise ValueError(f"height {h} not divisible by the space axis ({m.n_space})")
        bl, hl = b // m.n_data, h // m.n_space
        return (slice(m.data_index * bl, (m.data_index + 1) * bl),
                slice(m.space_index * hl, (m.space_index + 1) * hl))


def spatial_mesh(n_data: int, n_space: int, devices: Optional[Sequence] = None) -> SpatialMesh:
    """2-D ``(data, space)`` mesh over the processes: batch parallel x height
    parallel.  Process ``r`` sits at ``(r // n_space, r % n_space)`` (the JAX
    ``reshape(n_data, n_space)`` order).  ``devices``: one per process, in
    rank order (default: the device each process was initialized with, or
    ``Config.get_device()`` without a process group).

    Under a process group every process must call it, in the same order: it
    creates the space group of every data index (``new_group``)."""
    count = dist.process_count()
    devices = None if devices is None else list(devices)
    have = count if devices is None else len(devices)
    if n_data * n_space != have:
        raise ValueError(f"mesh {n_data}x{n_space} needs {n_data * n_space} devices, "
                         f"have {have}")
    if devices is not None and len(devices) != count:
        raise ValueError(f"{len(devices)} devices for {count} process(es): each process "
                         "drives one device")
    data_index, space_index = divmod(dist.process_index(), n_space)
    group = None
    if dist.is_initialized():
        for d in range(n_data):
            g = tdist.new_group(list(range(d * n_space, (d + 1) * n_space)))
            if d == data_index:
                group = g
    if devices is not None:
        device = torch.device(devices[dist.process_index()])
    else:
        device = dist.process_device() or Config.get_device()
    return SpatialMesh(n_data, n_space, data_index, space_index, device, group)


def spatial_image_sharding(mesh: SpatialMesh) -> SpatialSharding:
    """NHWC images sharded batch x height."""
    return SpatialSharding(mesh)


# ---------------------------------------------------------------------------
# the sharded forward that the layers see
# ---------------------------------------------------------------------------
def current_shard() -> Optional["Shard"]:
    """This thread's sharded forward, or None."""
    return getattr(_STATE, "shard", None)


@contextlib.contextmanager
def _sharded(shard: Optional["Shard"]):
    before = current_shard()
    _STATE.shard = shard
    try:
        yield shard
    finally:
        _STATE.shard = before


def _rows_read(kernel: int, stride: int, pad: int, dilation: int = 1):
    """Rows above and below its own that a window layer reads for its
    output rows (local rows ``[a, a + h)``, ``a`` and ``h`` even at stride 2)."""
    if stride == 1:
        return pad, dilation * (kernel - 1) - pad
    if dilation != 1:
        raise NotImplementedError(f"a sharded dilated conv takes stride 1, not {stride}")
    if stride == 2:
        return pad, max(0, kernel - pad - 2)
    raise NotImplementedError(f"a sharded layer takes stride 1 or 2, not {stride}")


class Shard:
    """The level plan of one sharded forward and the space axis it runs on
    (module docstring): ``heights[k]`` is level ``k``'s global height and
    ``split[k]`` whether its rows are split over the space group."""

    def __init__(self, mesh: SpatialMesh, height: int, width: int, first_halo: int):
        self.n, self.s, self.group = mesh.n_space, mesh.space_index, mesh.space_group
        heights, widths = [height], [width]
        for _ in range(PYRAMID_LEVELS - 1):
            heights.append(-(-heights[-1] // 2))
            widths.append(-(-widths[-1] // 2))
        if len(set(widths)) != PYRAMID_LEVELS:
            raise ValueError(f"width {width} gives two pyramid levels one width; the "
                             "U-Net needs a multiple of 32")
        self.heights = heights
        self._level = {w: k for k, w in enumerate(widths)}
        self.split = []
        for k, rows in enumerate(heights):
            need = first_halo if k == 0 else 1
            self.split.append(rows % self.n == 0 and rows // self.n >= need
                              and (k == 0 or (self.split[-1] and heights[k - 1] == 2 * rows)))
        self._gathered = None

    def level(self, x) -> int:
        return self._level_of(x.shape[3])

    def _level_of(self, width: int) -> int:
        try:
            return self._level[width]
        except KeyError:
            raise ValueError(f"a tensor of width {width} is on no level of this "
                             f"sharded forward ({sorted(self._level)})") from None

    def global_rows(self, x) -> int:
        return self.heights[self.level(x)]

    def is_local(self, x) -> bool:
        """``x`` holds this rank's rows of its level (not the whole level)."""
        return x.shape[2] != self.global_rows(x)

    def halo(self, x, above: int, below: int, edge: float = 0.0):
        """``x`` (this rank's rows, NCHW) with ``above`` rows of the previous
        rank's and ``below`` of the next rank's attached, ``edge`` beyond the
        global edges: one all-reduce over the space group."""
        b, c, h, w = x.shape
        if above > h or below > h:
            raise ValueError(f"{above} / {below} halo rows from neighbours of {h} rows")
        rows = x.permute(0, 2, 3, 1)
        out = x.new_empty((b, above + h + below, w, c))
        out[:, above:above + h] = rows
        if above + below:
            buf = x.new_zeros((self.n, b, above + below, w, c))
            buf[self.s, :, :above] = rows[:, h - above:]    # the next rank's rows above
            buf[self.s, :, above:] = rows[:, :below]        # the previous rank's rows below
            dist.all_reduce_(buf, "halo", self.group)
            if above:
                out[:, :above] = buf[self.s - 1, :, :above] if self.s > 0 else edge
            if below:
                out[:, above + h:] = (buf[self.s + 1, :, above:] if self.s < self.n - 1
                                      else edge)
        return out.permute(0, 3, 1, 2)

    def gather(self, x):
        """The whole level of ``x`` (this rank's rows), on every rank: one
        all-reduce over the space group, reused for the next reader of the
        same tensor (a block's conv and downsample)."""
        if self._gathered is not None and self._gathered[0] is x:
            return self._gathered[1]
        b, c, h, w = x.shape
        buf = x.new_zeros((b, self.n, h, w, c))
        buf[:, self.s] = x.permute(0, 2, 3, 1)
        dist.all_reduce_(buf, "level", self.group)
        whole = buf.view(b, self.n * h, w, c).permute(0, 3, 1, 2)
        self._gathered = (x, whole)
        return whole

    def own_rows(self, y):
        """``y`` computed whole at a split level -> this rank's rows (the
        decoder's upsample from a whole level)."""
        k = self.level(y)
        if not self.split[k] or self.is_local(y):
            return y
        h = self.heights[k] // self.n
        return y[:, :, self.s * h:(self.s + 1) * h].contiguous(
            memory_format=torch.channels_last)

    def _window(self, x, kernel: int, stride: int, pad: int, edge: float, dilation: int = 1):
        """The input of a window layer on ``x``: ``(input, H padding)``."""
        if not self.is_local(x):
            return x, pad
        if stride == 2 and not self.split[self.level(x) + 1]:
            return self.gather(x), pad
        return self.halo(x, *_rows_read(kernel, stride, pad, dilation), edge), 0

    def conv2d(self, x, weight, bias, stride, padding, dilation, groups):
        """``F.conv2d`` (zero padding ``padding``) on this rank's rows."""
        x, pad_h = self._window(x, weight.shape[2], stride[0], padding[0], 0.0, dilation[0])
        return F.conv2d(x, weight, bias, stride, (pad_h, padding[1]), dilation, groups)

    def max_pool2d(self, x, kernel: int, stride: int, padding: int):
        """``F.max_pool2d`` (``-inf`` padding) on this rank's rows."""
        x, pad_h = self._window(x, kernel, stride, padding, float("-inf"))
        return F.max_pool2d(x, kernel, stride, (pad_h, padding))

    def kernel_rows(self, y):
        """The rows to hand a 3x3 SAME kernel that pads zeros outside its
        input: ``y`` with the neighbours' row attached where one exists, and
        the slice of the kernel's output rows that are this rank's."""
        if not self.is_local(y):
            return y, slice(None)
        h = y.shape[2]
        lo, hi = (0 if self.s > 0 else 1), (h + 2 if self.s < self.n - 1 else h + 1)
        return self.halo(y, 1, 1)[:, :, lo:hi], slice(1 - lo, 1 - lo + h)

    def resize(self, x, h: int, w: int, method: str, plain):
        """``x`` (this rank's rows of a split level, or a whole level) resized
        to the global ``(h, w)`` by ``plain(t, h, w, method)``, the whole
        forward's resize: this rank's rows where the target level is split,
        else the whole (module docstring).  An upsampling by a power of two
        reads the source rows of this rank's output rows only; any other
        ratio runs whole and keeps this rank's rows, from a whole level
        only."""
        src = self.global_rows(x)
        if src == h and x.shape[3] == w:
            return x
        k = self._level_of(w)
        if not self.split[k]:
            if self.is_local(x):
                raise ValueError(f"a resize from split rows to the whole level {k}")
            return plain(x, h, w, method)
        f, rem = divmod(h, src)
        if rem or f & (f - 1):
            if self.is_local(x):
                raise ValueError(f"a sharded resize of split rows upsamples by a power of "
                                 f"two, not {src} -> {h} rows")
            return self.own_rows(plain(x, h, w, method))
        reach = 0 if method == "nearest" else 1        # the half-pixel bilinear's neighbours
        r = h // self.n
        a = self.s * r
        lo, hi = max(a // f - reach, 0), min(-(-(a + r) // f) + reach, src)
        if self.is_local(x):
            start = self.s * x.shape[2] - reach
            t = (self.halo(x, reach, reach) if reach else x)[:, :, lo - start:hi - start]
        else:
            t = x[:, :, lo:hi]
        y = plain(t.contiguous(memory_format=torch.channels_last), (hi - lo) * f, w, method)
        return y[:, :, a - lo * f:a - lo * f + r].contiguous(memory_format=torch.channels_last)

    def mean(self, x):
        """The mean of ``x`` over H and W, ``(B, C, 1, 1)``: from this rank's
        rows, one all-reduce of the float32 sums over the space group."""
        if not self.is_local(x):
            return x.mean((2, 3), keepdim=True)
        sums = x.float().sum((2, 3))
        dist.all_reduce_(sums, "mean", self.group)
        count = self.global_rows(x) * x.shape[3]
        return (sums / count).to(x.dtype)[:, :, None, None]

    def whole(self, fn, x):
        """``fn`` of ``x``'s whole level, run with this shard suspended (one
        gather where ``x`` holds this rank's rows); this rank's rows of the
        result where its level is split (None passes)."""
        t = self.gather(x) if self.is_local(x) else x
        with _sharded(None):
            y = fn(t)
        return None if y is None else self.own_rows(y)


def whole(fn, x):
    """``fn(x)``; under a sharded forward, ``fn`` of ``x``'s whole level and
    this rank's rows of the result (:meth:`Shard.whole`): for a layer that
    reads across the whole level."""
    shard = current_shard()
    return fn(x) if shard is None else shard.whole(fn, x)


def pooled(fn, x):
    """``fn`` of the mean of ``x`` over H and W, ``(B, C, 1, 1)``; under a
    sharded forward the mean over the whole level (:meth:`Shard.mean`), and
    ``fn`` runs with the shard suspended: its input has no rows."""
    shard = current_shard()
    if shard is None:
        return fn(x.mean((2, 3), keepdim=True))
    m = shard.mean(x)
    with _sharded(None):
        return fn(m)


def global_rows(x) -> int:
    """The rows of ``x``'s level in the whole forward (``x``'s own rows
    without a sharded forward)."""
    shard = current_shard()
    return x.shape[2] if shard is None else shard.global_rows(x)


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------
def _like(t, ref, device):
    t = t.to(device=device, dtype=ref.dtype)
    if ref.dim() == 4 and ref.is_contiguous(memory_format=torch.channels_last):
        return t.contiguous(memory_format=torch.channels_last)
    return t


def _state(module, variables, device) -> dict:
    """``variables`` (JAX layout) through ``from_jax_state_dict``, on
    ``device`` in the dtype and memory format of the module's own tensors."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.models.convert import (
        from_jax_state_dict,
    )

    own = module.state_dict()
    return {k: _like(v, own.get(k, v), device)
            for k, v in from_jax_state_dict(variables).items()}


def _naive_decoder(module):
    """A U-Net with its fused decoder schedule run as the naive one, the same
    parameters (the sharded layers cover the naive upsample + conv); any
    other module as it is (``UDASegmentationModel`` builds its U-Net with
    the default, naive, schedule)."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.models.unet import Unet

    if isinstance(module, Unet) and module.decoder.fused is not False:
        return module.clone(fused_decoder=False)
    return module


def _encoder(module):
    """The encoder of a segmentation model; raises, naming it, for any
    other module."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.models.architectures import (
        _SegBase,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.models.uda import (
        UDASegmentationModel,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.models.unet import Unet

    if isinstance(module, UDASegmentationModel):
        return module.net.encoder
    if isinstance(module, (Unet, _SegBase)):
        return module.encoder
    raise NotImplementedError(f"spatial_forward shards the (B, H, W, classes) logits of a "
                              f"segmentation model by rows; {type(module).__name__} is not one "
                              "(a discriminator's (B, 1) output has no rows)")


def spatial_forward(module, variables, images, mesh: SpatialMesh, train: bool = False):
    """A segmentation model's eval forward with ``images`` sharded batch x
    height over ``mesh`` and the parameters replicated; returns this
    process's block of the logits, ``(B / n_data, H / n_space, W, classes)``
    in the module's logits dtype on ``mesh.device``.

    ``module``: a ``Unet``, any other ``create_model`` family on any encoder,
    or a ``UDASegmentationModel`` (its default forward, the segmentation
    logits); anything else raises ``NotImplementedError``, naming it.
    ``images``: the full ``(B, H, W, C)`` host value (numpy or tensor), the
    same on every process.  ``variables``: None (the module's own parameters
    and buffers, which must be on ``mesh.device``) or a flat JAX-layout
    variable dict (``params/...``, ``batch_stats/...``), loaded through
    ``models.convert.from_jax_state_dict`` and run with
    ``torch.func.functional_call``.  The module is not changed: it runs in
    eval mode and every submodule's train / eval mode is set back after.
    ``train=True`` raises: the JAX function fails there too (its BatchNorm
    writes running statistics that ``module.apply`` was given no mutable
    collection for).

    A U-Net's fused decoder schedule (``fused_decoder`` ``True``, a tuple or
    ``"dilated"``) runs as the naive one, ``clone(fused_decoder=False)`` with
    the same parameters, as the JAX function does: the sharded layers cover
    the naive upsample + conv.  Every process of the group must call it with
    the same arguments."""
    if train:
        raise ValueError("spatial_forward runs the eval forward only (train=True fails "
                         "in the JAX package too: its BatchNorm would write running "
                         "statistics)")
    encoder = _encoder(module)
    rows_b, rows_h = spatial_image_sharding(mesh).block(images.shape)
    shard = (Shard(mesh, int(images.shape[1]), int(images.shape[2]),
                   encoder.stem_conv.padding[0]) if mesh.n_space > 1 else None)
    if shard is not None and not shard.split[0]:
        shard = None            # too few rows a rank: every rank runs the whole tile
    x = images[rows_b, rows_h] if shard is not None else images[rows_b]
    x = torch.as_tensor(np.ascontiguousarray(x) if isinstance(x, np.ndarray) else x)
    x = x.to(mesh.device)
    modes = [(m, m.training) for m in module.modules()]
    module.eval()
    try:
        net = _naive_decoder(module)
        with torch.inference_mode(), _sharded(shard):
            if variables is None:
                out = net(x)
            else:
                out = torch.func.functional_call(
                    net, _state(module, variables, mesh.device), (x,), strict=True)
    finally:
        for m, training in modes:
            m.training = training
    return out if shard is not None else out[:, rows_h]


def gather_blocks(block, mesh: SpatialMesh):
    """Every process's block of :func:`spatial_forward`'s output assembled
    into the whole ``(B, H, ...)`` value, on every process (one all-reduce,
    ``distributed.gather_rows``); ``block`` itself on a mesh of one."""
    if mesh.size == 1:
        return block
    b, h, *rest = block.shape
    parts = dist.gather_rows(block[None]).view(mesh.n_data, mesh.n_space, b, h, *rest)
    return parts.transpose(1, 2).reshape(mesh.n_data * b, mesh.n_space * h, *rest)
