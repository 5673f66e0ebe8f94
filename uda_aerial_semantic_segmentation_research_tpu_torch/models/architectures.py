"""The other segmentation families of ``create_model`` (FPN / PSPNet /
Linknet / UnetPlusPlus / DeepLabV3+ / PAN / MAnet), sharing the encoders.

Counterpart of the JAX package's ``models/architectures.py``, the
by-name choice the reference makes with ``getattr(smp, model_name)``.
Conventions, as the port's ``Unet``: NHWC input, float32 NHWC logits at
the input's resolution, NCHW tensors in channels_last memory inside,
parameters in float32, compute in ``dtype``.  ``encode`` returns the
encoder's 6-level pyramid (NCHW, as ``Unet.encode``).  Module names are
the flax names (``lateral5``, ``seg0_conv`` / ``seg0_norm``,
``block0.reduce_conv``, ``pab.q``, ``mfab0.se_reduce``, ...), so the
weight bridge (``models.convert``) maps the JAX tree with no rule of its
own.

The JAX package's documented approximations of smp are kept as they are:
PSPNet pools at (1, 2, 4, 8) bins by resize, FPN's blocks use BatchNorm,
PAN runs on the /32 pyramid.

Resizing (``_upsample_to``, the JAX ``jax.image.resize``): ``"nearest"``
is ``nearest-exact``; ``"linear"`` / ``"bilinear"`` is the half-pixel
bilinear, antialiased where it downsamples (as ``jax.image.resize``,
which leaves an upsampling as it is).  The antialiased resize has no
bfloat16 kernel on the CPU, so a downsampling of a non-float32 tensor
runs in float32 and is cast back: one rounding, where the JAX bf16
resize rounds its weights and each of its two contractions.

Every BatchNorm input stays channels_last: concatenations go along the
NHWC view's last axis (``_cat``), which is what ``jnp.concatenate`` does.

``DeepLabV3Plus(layout="smp")`` is segmentation_models.pytorch's own
DeepLabV3+ with its defaults, not an analogue: the class docstring says how
it differs from the default ``layout="jax"``.  It is the one family with a
dropout (``Dropout``, whose masks are a function of a seed and a count).

Under a height-sharded forward (``parallel.spatial``) the families resize
to a level's global size through ``_resize`` (this rank's rows of it), take
their means over H and W through ``spatial.pooled`` and run what reads the
whole level (PSPNet's bins, ``_PAB``, PAN's FPA, an ASPP rate beyond a
rank's rows) through ``spatial.whole``; a concatenation, sum or product of
two tensors of other rows or widths raises there.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from uda_aerial_semantic_segmentation_research_tpu_torch.models.resnet import (
    Conv2d,
    build_encoder,
    encoder_out_channels,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.batch_norm import BatchNorm
from uda_aerial_semantic_segmentation_research_tpu_torch.parallel import spatial
from uda_aerial_semantic_segmentation_research_tpu_torch.utils.profiling import annotate

_MASK63 = (1 << 63) - 1


def _upsample_to(x, h: int, w: int, method: str = "nearest"):
    """``x`` (NCHW) resized to ``(h, w)`` as ``jax.image.resize`` does it."""
    if x.shape[2] == h and x.shape[3] == w:
        return x
    if method == "nearest":
        return F.interpolate(x, size=(h, w), mode="nearest-exact")
    if method not in ("linear", "bilinear"):
        raise ValueError(f"unknown resize method {method!r}")
    if h >= x.shape[2] and w >= x.shape[3]:
        return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)
    y = F.interpolate(x.float(), size=(h, w), mode="bilinear", align_corners=False,
                      antialias=True)
    return y.to(x.dtype)


def _resize(x, h: int, w: int, method: str = "nearest"):
    """``x`` resized to the global size ``(h, w)``: ``_upsample_to``, or
    this rank's rows of it under a sharded forward (``Shard.resize``)."""
    shard = spatial.current_shard()
    if shard is None:
        return _upsample_to(x, h, w, method)
    return shard.resize(x, h, w, method, _upsample_to)


def _size(t):
    """``t``'s (rows, width) in the whole forward."""
    return spatial.global_rows(t), t.shape[3]


def _same_rows(*tensors):
    """Under a sharded forward, raises unless the tensors have one shape of
    rows x width: a rank's rows mixed with a whole level would broadcast."""
    if spatial.current_shard() is not None and len({t.shape[2:] for t in tensors}) > 1:
        raise ValueError(f"tensors of rows x width {[tuple(t.shape[2:]) for t in tensors]} "
                         "meet under a sharded forward")


def _add(a, b):
    _same_rows(a, b)
    return a + b


def _cat(tensors):
    """Concatenation along channels of NCHW tensors, made on their NHWC views,
    so that the result is channels_last whatever the inputs' layouts."""
    _same_rows(*tensors)
    return torch.cat([t.permute(0, 2, 3, 1) for t in tensors], dim=-1).permute(0, 3, 1, 2)


def _add_conv_bn_relu(parent: nn.Module, name: str, cin: int, cout: int, k: int,
                      dtype: torch.dtype, dilation: int = 1) -> None:
    """``{name}_conv`` (no bias, SAME padding) and ``{name}_norm`` on ``parent``."""
    parent.add_module(f"{name}_conv", Conv2d(cin, cout, k, padding=dilation * (k // 2),
                                             dilation=dilation, bias=False))
    parent.add_module(f"{name}_norm", BatchNorm(cout, dtype=dtype))


def _conv_bn_relu(parent: nn.Module, name: str, x):
    return torch.relu(getattr(parent, f"{name}_norm")(getattr(parent, f"{name}_conv")(x)))


def _add_separable_bn_relu(parent: nn.Module, name: str, cin: int, cout: int,
                           dtype: torch.dtype, dilation: int = 1) -> None:
    """smp's ``SeparableConv2d`` (no bias) and a BatchNorm on ``parent``:
    ``{name}_depthwise`` (3x3, ``groups=cin``, SAME padding at ``dilation``),
    ``{name}_pointwise`` (1x1 to ``cout``), ``{name}_norm``."""
    parent.add_module(f"{name}_depthwise", Conv2d(cin, cin, 3, padding=dilation,
                                                  dilation=dilation, groups=cin, bias=False))
    parent.add_module(f"{name}_pointwise", Conv2d(cin, cout, 1, bias=False))
    parent.add_module(f"{name}_norm", BatchNorm(cout, dtype=dtype))


def _separable_bn_relu(parent: nn.Module, name: str, x):
    y = getattr(parent, f"{name}_pointwise")(getattr(parent, f"{name}_depthwise")(x))
    return torch.relu(getattr(parent, f"{name}_norm")(y))


def _head(cin: int, classes: int, k: int = 1) -> Conv2d:
    return Conv2d(cin, classes, k, padding=k // 2, bias=True)


def _nearest2x(x):
    """Each pixel repeated 2x2 (the JAX broadcast-and-reshape)."""
    rows, w = _size(x)
    return _resize(x, 2 * rows, 2 * w)


class Linear(nn.Linear):
    """``nn.Linear`` with float32 parameters cast to the input's dtype."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def dropout_draw_seed(seed: int, k: int) -> int:
    """The seed of ``Dropout``'s ``k``-th mask under ``seed``: the first
    word of ``numpy.random.SeedSequence([seed mod 2**63, k])``, mod 2**63."""
    mixed = np.random.SeedSequence([int(seed) & _MASK63, int(k)]).generate_state(1, np.uint64)
    return int(mixed[0]) & _MASK63


class Dropout(nn.Module):
    """Dropout whose masks are a function of a seed and a count.

    The ``k``-th train-mode forward since ``seed`` was set (``k`` = 0, 1,
    ...) draws ``u = torch.rand(x.shape, dtype=torch.float32, generator=g)``
    over ``x``'s NCHW shape from ``g``, a ``torch.Generator`` on ``x``'s
    device seeded with ``dropout_draw_seed(seed, k)``, and returns ``x``
    where ``u >= p``, times ``1 / (1 - p)`` (exactly 2 at ``p = 0.5``), and
    0 elsewhere.  Eval mode returns ``x`` and draws nothing.  So a
    reference that knows ``seed`` and counts the forwards draws the same
    masks, and under data parallelism every rank, with the same seed and
    count, draws the same masks over its own rows.  The generator lives for
    one forward: the module holds two ints, which ``copy.deepcopy`` copies
    and ``state_dict`` leaves out.
    """

    def __init__(self, p: float, seed: int = 0):
        super().__init__()
        self.p, self.seed, self.draws = float(p), int(seed), 0

    def forward(self, x):
        if not self.training:
            return x
        g = torch.Generator(device=x.device)
        g.manual_seed(dropout_draw_seed(self.seed, self.draws))
        self.draws += 1
        u = torch.rand(x.shape, dtype=torch.float32, generator=g, device=x.device)
        return x * (u >= self.p).to(x.dtype).mul_(1.0 / (1.0 - self.p))


class _SegBase(nn.Module):
    """Encoder + the float32 NHWC logits contract."""

    def __init__(self, encoder_name: str = "resnet34", classes: int = 23,
                 in_channels: int = 3, dtype: torch.dtype = torch.bfloat16,
                 output_stride: int = 32):
        super().__init__()
        self.classes = classes
        self.dtype = dtype
        self.encoder = build_encoder(encoder_name, in_channels, dtype,
                                     output_stride=output_stride)
        self.channels = encoder_out_channels(encoder_name)

    def encode(self, x):
        """(B, H, W, in_channels) -> the pyramid ``[identity, /2, /4, /8, /16,
        /32]`` in the internal NCHW form (channels_last memory)."""
        return self.encoder.features(x.permute(0, 3, 1, 2))

    def _logits(self, y, image):
        """Head output -> (B, H, W, classes) float32 at the size of ``image``
        (the pyramid's level 0), upsampled in ``dtype``."""
        return _resize(y, *_size(image), "bilinear").float().permute(0, 2, 3, 1).contiguous()


class FPN(_SegBase):
    """Feature Pyramid Network decoder (smp.FPN analogue): 1x1 laterals on
    C2..C5, top-down nearest-add merge, per-level conv blocks at 1/4 scale,
    summed, head, upsample x4."""

    def __init__(self, encoder_name: str = "resnet34", classes: int = 23,
                 in_channels: int = 3, dtype: torch.dtype = torch.bfloat16,
                 pyramid_channels: int = 256, segmentation_channels: int = 128):
        super().__init__(encoder_name, classes, in_channels, dtype)
        for level in (5, 4, 3, 2):
            self.add_module(f"lateral{level}",
                            Conv2d(self.channels[level], pyramid_channels, 1, bias=True))
        for i in range(4):
            _add_conv_bn_relu(self, f"seg{i}", pyramid_channels, segmentation_channels, 3,
                              dtype)
        self.head = _head(segmentation_channels, classes)

    def forward(self, x):
        feats = self.encode(x)
        c2, c3, c4, c5 = feats[2:6]
        p5 = self.lateral5(c5)
        p4 = _add(self.lateral4(c4), _resize(p5, *_size(c4)))
        p3 = _add(self.lateral3(c3), _resize(p4, *_size(c3)))
        p2 = _add(self.lateral2(c2), _resize(p3, *_size(c2)))
        merged = None
        for i, p in enumerate((p5, p4, p3, p2)):
            s = _resize(_conv_bn_relu(self, f"seg{i}", p), *_size(c2))
            merged = s if merged is None else _add(merged, s)
        return self._logits(self.head(merged), feats[0])


class PSPNet(_SegBase):
    """Pyramid Scene Parsing network (smp.PSPNet analogue): the bottleneck
    resized (antialiased bilinear) to each of ``bins`` -> 1x1 conv blocks ->
    upsampled back -> concat -> 3x3 conv block -> head -> upsample."""

    def __init__(self, encoder_name: str = "resnet34", classes: int = 23,
                 in_channels: int = 3, dtype: torch.dtype = torch.bfloat16,
                 psp_channels: int = 512, bins: Sequence[int] = (1, 2, 4, 8)):
        super().__init__(encoder_name, classes, in_channels, dtype)
        self.bins = tuple(bins)
        c5, branch = self.channels[5], psp_channels // len(self.bins)
        for i in range(len(self.bins)):
            _add_conv_bn_relu(self, f"psp{i}", c5, branch, 1, dtype)
        _add_conv_bn_relu(self, "bottleneck", c5 + branch * len(self.bins), psp_channels, 3,
                          dtype)
        self.head = _head(psp_channels, classes)

    def _branch(self, i: int, c5):
        """Bin ``i``: the bottleneck pooled to ``bins[i]`` squared, a 1x1 conv
        block, back to the bottleneck's size."""
        b = self.bins[i]
        pooled = _conv_bn_relu(self, f"psp{i}", _upsample_to(c5, b, b, "linear"))
        return _upsample_to(pooled, c5.shape[2], c5.shape[3], "bilinear")

    def forward(self, x):
        feats = self.encode(x)
        c5 = feats[-1]
        branches = [c5] + [spatial.whole(functools.partial(self._branch, i), c5)
                           for i in range(len(self.bins))]
        y = _conv_bn_relu(self, "bottleneck", _cat(branches))
        return self._logits(self.head(y), feats[0])


class LinknetDecoderBlock(nn.Module):
    """1x1 reduce to ``max(cin // 4, 16)`` -> nearest 2x -> 3x3 -> 1x1 expand,
    each a conv block."""

    def __init__(self, cin: int, out_channels: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        mid = max(cin // 4, 16)
        _add_conv_bn_relu(self, "reduce", cin, mid, 1, dtype)
        _add_conv_bn_relu(self, "up", mid, mid, 3, dtype)
        _add_conv_bn_relu(self, "expand", mid, out_channels, 1, dtype)

    def forward(self, x):
        y = _nearest2x(_conv_bn_relu(self, "reduce", x))
        return _conv_bn_relu(self, "expand", _conv_bn_relu(self, "up", y))


class Linknet(_SegBase):
    """Linknet (smp.Linknet analogue): decoder blocks ADD the encoder skips."""

    def __init__(self, encoder_name: str = "resnet34", classes: int = 23,
                 in_channels: int = 3, dtype: torch.dtype = torch.bfloat16):
        super().__init__(encoder_name, classes, in_channels, dtype)
        cin = self.channels[5]
        for i, skip in enumerate((4, 3, 2, 1)):                # /16 /8 /4 /2
            self.add_module(f"block{i}", LinknetDecoderBlock(cin, self.channels[skip], dtype))
            cin = self.channels[skip]
        self.block4 = LinknetDecoderBlock(cin, 32, dtype)      # /1
        self.head = _head(32, classes, 3)

    def forward(self, x):
        feats = self.encode(x)
        y = feats[5]
        for i, skip in enumerate(feats[4:0:-1]):
            y = _add(getattr(self, f"block{i}")(y), skip)
        return self._logits(self.head(self.block4(y)), feats[0])


class UnetPlusPlus(_SegBase):
    """UNet++ (smp.UnetPlusPlus analogue): node ``x{i}_{j}`` (row i = level
    /2^(i+1), column j = depth) convolves the concat of the row's earlier
    nodes with the upsampled ``x{i+1}_{j-1}``; the head reads ``x0_4`` at /2."""

    ROWS = 5

    def __init__(self, encoder_name: str = "resnet34", classes: int = 23,
                 in_channels: int = 3, dtype: torch.dtype = torch.bfloat16,
                 row_channels: Sequence[int] = (32, 64, 128, 256)):
        super().__init__(encoder_name, classes, in_channels, dtype)
        self.row_channels = tuple(row_channels)
        for j in range(1, self.ROWS):
            for i in range(self.ROWS - j):
                cin = sum(self._width(i, k) for k in range(j)) + self._width(i + 1, j - 1)
                ch = self._width(i, j)
                _add_conv_bn_relu(self, f"x{i}_{j}a", cin, ch, 3, dtype)
                _add_conv_bn_relu(self, f"x{i}_{j}b", ch, ch, 3, dtype)
        self.head = _head(self.row_channels[0], classes)

    def _width(self, i: int, j: int) -> int:
        if j == 0:
            return self.channels[i + 1]
        return self.row_channels[min(i, len(self.row_channels) - 1)]

    def forward(self, x):
        feats = self.encode(x)
        nodes = {(i, 0): feats[i + 1] for i in range(self.ROWS)}
        for j in range(1, self.ROWS):
            for i in range(self.ROWS - j):
                up = _resize(nodes[(i + 1, j - 1)], *_size(nodes[(i, 0)]))
                y = _cat([nodes[(i, k)] for k in range(j)] + [up])
                y = _conv_bn_relu(self, f"x{i}_{j}a", y)
                nodes[(i, j)] = _conv_bn_relu(self, f"x{i}_{j}b", y)
        return self._logits(self.head(nodes[(0, self.ROWS - 1)]), feats[0])


class DeepLabV3Plus(_SegBase):
    """DeepLabV3+ in one of two layouts.

    ``layout="jax"`` (the default) is the JAX package's smp.DeepLabV3Plus
    analogue: ASPP over the /32 bottleneck (1x1, dilated 3x3 at
    ``atrous_rates``, default (2, 4, 6), image pooling) -> 1x1 project ->
    upsample to /4 -> concat the 48-channel low level -> two 3x3 -> head,
    half-pixel resizes.

    ``layout="smp"`` is segmentation_models.pytorch's ``DeepLabV3Plus``
    with its defaults (``decoders/deeplabv3/model.py`` and ``decoder.py``,
    ``base/heads.py::SegmentationHead``; Chen et al. 2018): the encoder at
    output stride 16 (``models.resnet``); an ASPP on the last level of a
    1x1 conv, three separable 3x3 convs (depthwise at dilation ``r``, then
    pointwise) at ``atrous_rates``, default (12, 24, 36), and image pooling
    (the mean over H and W, a 1x1 conv, broadcast back), each to
    ``aspp_channels`` with BatchNorm and ReLU, concatenated, projected by a
    1x1 conv block and dropped out at 0.5 (``Dropout``); a separable 3x3
    block; x4 bilinear upsampling with ``align_corners=True``; the /4 level
    through a 1x1 block to 48 channels, concatenated after it; a separable
    3x3 block; a 1x1 head with bias and x4 bilinear with
    ``align_corners=True`` to the logits.  No other conv has a bias.  Its
    ASPP (through the separable 3x3 block) runs under the span
    ``uda.deeplab.aspp`` and the rest under ``uda.deeplab.decoder``.  It
    has no height-sharded forward.  ``seed_dropout`` restarts its masks.
    """

    def __init__(self, encoder_name: str = "resnet34", classes: int = 23,
                 in_channels: int = 3, dtype: torch.dtype = torch.bfloat16,
                 aspp_channels: int = 256, atrous_rates: Optional[Sequence[int]] = None,
                 layout: str = "jax"):
        if layout not in ("jax", "smp"):
            raise ValueError(f"layout is 'jax' or 'smp', not {layout!r}")
        super().__init__(encoder_name, classes, in_channels, dtype,
                         output_stride=16 if layout == "smp" else 32)
        self.layout = layout
        if atrous_rates is None:
            atrous_rates = (12, 24, 36) if layout == "smp" else (2, 4, 6)
        self.atrous_rates = tuple(atrous_rates)
        c5, a = self.channels[5], aspp_channels
        _add_conv_bn_relu(self, "aspp_1x1", c5, a, 1, dtype)
        for r in self.atrous_rates:
            if layout == "smp":
                _add_separable_bn_relu(self, f"aspp_r{r}", c5, a, dtype, dilation=r)
            else:
                _add_conv_bn_relu(self, f"aspp_r{r}", c5, a, 3, dtype, dilation=r)
        _add_conv_bn_relu(self, "aspp_pool", c5, a, 1, dtype)
        _add_conv_bn_relu(self, "aspp_project", a * (len(self.atrous_rates) + 2), a, 1, dtype)
        if layout == "smp":
            self.aspp_dropout = Dropout(0.5)
            _add_separable_bn_relu(self, "aspp_sep", a, a, dtype)
            _add_conv_bn_relu(self, "highres", self.channels[2], 48, 1, dtype)
            _add_separable_bn_relu(self, "fuse", a + 48, a, dtype)
        else:
            _add_conv_bn_relu(self, "low_project", self.channels[2], 48, 1, dtype)
            _add_conv_bn_relu(self, "refine1", a + 48, a, 3, dtype)
            _add_conv_bn_relu(self, "refine2", a, a, 3, dtype)
        self.head = _head(a, classes)

    def seed_dropout(self, seed: int) -> None:
        """Restart the dropout's masks at the first of ``seed``'s
        (``Dropout``); the JAX layout has no dropout."""
        for m in self.modules():
            if isinstance(m, Dropout):
                m.seed, m.draws = int(seed), 0

    def forward(self, x):
        if self.layout == "smp":
            return self._forward_smp(x)
        feats = self.encode(x)
        low, c5 = feats[2], feats[5]
        branches = [_conv_bn_relu(self, "aspp_1x1", c5)]
        for r in self.atrous_rates:
            # a rate beyond the rows a rank holds reads past its neighbour: whole
            atrous = functools.partial(_conv_bn_relu, self, f"aspp_r{r}")
            branches.append(atrous(c5) if r <= c5.shape[2] else spatial.whole(atrous, c5))
        pooled = spatial.pooled(functools.partial(_conv_bn_relu, self, "aspp_pool"), c5)
        branches.append(pooled.expand(-1, -1, c5.shape[2], c5.shape[3]))
        y = _conv_bn_relu(self, "aspp_project", _cat(branches))
        y = _resize(y, *_size(low), "bilinear")
        y = _cat([y, _conv_bn_relu(self, "low_project", low)])
        y = _conv_bn_relu(self, "refine2", _conv_bn_relu(self, "refine1", y))
        return self._logits(self.head(y), feats[0])

    def _forward_smp(self, x):
        if spatial.current_shard() is not None:
            raise ValueError("DeepLabV3Plus(layout='smp') has no height-sharded forward")
        feats = self.encode(x)
        high, c5 = feats[2], feats[5]
        with annotate("uda.deeplab.aspp"):
            branches = [_conv_bn_relu(self, "aspp_1x1", c5)]
            branches += [_separable_bn_relu(self, f"aspp_r{r}", c5) for r in self.atrous_rates]
            pooled = _conv_bn_relu(self, "aspp_pool", c5.mean((2, 3), keepdim=True))
            branches.append(pooled.expand(-1, -1, c5.shape[2], c5.shape[3]))
            y = self.aspp_dropout(_conv_bn_relu(self, "aspp_project", _cat(branches)))
            y = _separable_bn_relu(self, "aspp_sep", y)
        with annotate("uda.deeplab.decoder"):
            y = F.interpolate(y, size=high.shape[2:], mode="bilinear", align_corners=True)
            y = _separable_bn_relu(self, "fuse", _cat([y, _conv_bn_relu(self, "highres", high)]))
            y = F.interpolate(self.head(y), size=x.shape[1:3], mode="bilinear",
                              align_corners=True)
            return y.float().permute(0, 2, 3, 1).contiguous()


class PAN(_SegBase):
    """Pyramid Attention Network (smp.PAN analogue) on the /32 pyramid: FPA
    (a 1x1 main branch modulated by a 7/5/3 downsampling conv pyramid, plus
    a global pooling branch), then three GAU blocks merging C4/C3/C2 up to
    /4; head, upsample.  The pyramid is cut short where the grid is too small
    to halve (``min(H, W) < 2``), as in JAX; its modules exist at every input
    size (the JAX tree has those its init size reached)."""

    FPA = ((7, "d1"), (5, "d2"), (3, "d3"))

    def __init__(self, encoder_name: str = "resnet34", classes: int = 23,
                 in_channels: int = 3, dtype: torch.dtype = torch.bfloat16,
                 decoder_channels: int = 32):
        super().__init__(encoder_name, classes, in_channels, dtype)
        ch, c5 = decoder_channels, self.channels[5]
        self.fpa_pool = Conv2d(c5, ch, 1, bias=True)
        _add_conv_bn_relu(self, "fpa_mid", c5, ch, 1, dtype)
        for n, (kern, lname) in enumerate(self.FPA, 1):
            _add_conv_bn_relu(self, f"fpa_{lname}", c5 if n == 1 else ch, ch, kern, dtype)
            _add_conv_bn_relu(self, f"fpa_u{n}", ch, ch, kern, dtype)
        for i, level in enumerate((4, 3, 2)):
            _add_conv_bn_relu(self, f"gau{i}_low", self.channels[level], ch, 3, dtype)
            self.add_module(f"gau{i}_att", Conv2d(ch, ch, 1, bias=False))
            self.add_module(f"gau{i}_att_norm", BatchNorm(ch, dtype=dtype))
        self.head = _head(ch, classes)

    def _fpa_pyramid(self, c5):
        """The FPA's downsampling pyramid over the whole bottleneck, summed
        back up to its size; None where the grid is too small to halve."""
        downs, cur = [], c5
        for _, lname in self.FPA:
            if min(cur.shape[2], cur.shape[3]) < 2:
                break
            cur = _conv_bn_relu(self, f"fpa_{lname}", F.avg_pool2d(cur, 2, 2))
            downs.append(cur)
        u = None
        for n in range(len(downs), 0, -1):                    # fpa_u{n} on d{n}
            s = _conv_bn_relu(self, f"fpa_u{n}", downs[n - 1])
            u = s if u is None else s + u
            target = downs[n - 2] if n >= 2 else c5
            u = _upsample_to(u, target.shape[2], target.shape[3], "bilinear")
        return u

    def _attention(self, i: int, pooled):
        att = getattr(self, f"gau{i}_att")(pooled)
        return torch.sigmoid(getattr(self, f"gau{i}_att_norm")(att))

    def forward(self, x):
        feats = self.encode(x)
        c2, c3, c4, c5 = feats[2:6]
        glob = spatial.pooled(self.fpa_pool, c5)
        mid = _conv_bn_relu(self, "fpa_mid", c5)
        u = spatial.whole(self._fpa_pyramid, c5)
        if u is not None:
            _same_rows(mid, u)
            mid = mid * u
        y = mid + glob
        for i, skip in enumerate((c4, c3, c2)):
            low = _conv_bn_relu(self, f"gau{i}_low", skip)
            att = spatial.pooled(functools.partial(self._attention, i), y)
            y = _add(_resize(y, *_size(skip), "bilinear"), low * att)
        return self._logits(self.head(y), feats[0])


class _PAB(nn.Module):
    """Position-wise attention over the /32 bottleneck (MAnet):
    ``x + softmax(q k^T / sqrt(C/4)) v``, the scores and softmax in float32,
    cast to ``dtype`` before the product with ``v``."""

    def __init__(self, channels: int):
        super().__init__()
        mid = channels // 4
        self.q = Conv2d(channels, mid, 1, bias=True)
        self.k = Conv2d(channels, mid, 1, bias=True)
        self.v = Conv2d(channels, channels, 1, bias=True)

    def forward(self, x):
        b, c, fh, fw = x.shape

        def flat(t):                     # NCHW (channels_last) -> (B, H*W, C), a view
            return t.permute(0, 2, 3, 1).reshape(b, fh * fw, t.shape[1])

        q, k, v = flat(self.q(x)), flat(self.k(x)), flat(self.v(x))
        scores = torch.bmm(q.float(), k.float().transpose(1, 2)) / math.sqrt(q.shape[-1])
        att = torch.softmax(scores, dim=-1).to(x.dtype)
        y = torch.bmm(att, v).reshape(b, fh, fw, c).permute(0, 3, 1, 2)
        return x + y


class _MFAB(nn.Module):
    """Multi-scale fusion attention block (a MAnet decoder stage): concat
    (nearest-upsampled deep, skip) -> two 3x3 conv blocks -> squeeze-excite
    channel attention (``max(C // reduction, 4)`` wide) -> scale."""

    def __init__(self, cin: int, cskip: int, out_channels: int,
                 dtype: torch.dtype = torch.bfloat16, reduction: int = 16):
        super().__init__()
        _add_conv_bn_relu(self, "fuse1", cin + cskip, out_channels, 3, dtype)
        _add_conv_bn_relu(self, "fuse2", out_channels, out_channels, 3, dtype)
        squeeze = max(out_channels // reduction, 4)
        self.se_reduce = Linear(out_channels, squeeze)
        self.se_expand = Linear(squeeze, out_channels)

    def _excite(self, pooled):
        return torch.sigmoid(self.se_expand(torch.relu(self.se_reduce(pooled[:, :, 0, 0]))))

    def forward(self, deep, skip):
        y = _cat([_resize(deep, *_size(skip)), skip])
        y = _conv_bn_relu(self, "fuse2", _conv_bn_relu(self, "fuse1", y))
        return y * spatial.pooled(self._excite, y)[:, :, None, None]


class MAnet(_SegBase):
    """Multi-scale Attention Net (smp.MAnet analogue): PAB on the bottleneck,
    MFAB stages up the pyramid, a nearest 2x and a 16-channel conv block to
    full resolution, head."""

    def __init__(self, encoder_name: str = "resnet34", classes: int = 23,
                 in_channels: int = 3, dtype: torch.dtype = torch.bfloat16,
                 decoder_channels: Sequence[int] = (256, 128, 64, 32)):
        super().__init__(encoder_name, classes, in_channels, dtype)
        self.pab = _PAB(self.channels[5])
        cin = self.channels[5]
        self.n_stages = min(len(decoder_channels), 4)
        for i, (skip, ch) in enumerate(zip((4, 3, 2, 1), decoder_channels)):
            self.add_module(f"mfab{i}", _MFAB(cin, self.channels[skip], ch, dtype))
            cin = ch
        _add_conv_bn_relu(self, "final", cin, 16, 3, dtype)
        self.head = _head(16, classes)

    def forward(self, x):
        feats = self.encode(x)
        y = spatial.whole(self.pab, feats[5])
        for i, skip in zip(range(self.n_stages), feats[4:0:-1]):
            y = getattr(self, f"mfab{i}")(y, skip)
        y = _conv_bn_relu(self, "final", _nearest2x(y))
        return self._logits(self.head(y), feats[0])
