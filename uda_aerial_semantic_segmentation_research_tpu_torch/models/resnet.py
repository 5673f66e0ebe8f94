"""ResNet and MobileNetV2 encoders producing the U-Net feature pyramid.

Counterpart of the JAX package's ``models/resnet.py`` (resnet18/34/50/
101/152 and mobilenet_v2).  Modules compute on NCHW tensors in
channels_last memory, so the NHWC view of every activation is free;
``forward`` keeps the JAX package's NHWC boundary and returns the same
6-level pyramid ``[identity, /2, /4, /8, /16, /32]``.

Padding follows the JAX encoders exactly: torch-style symmetric ``k//2``
for every conv (equal to SAME at stride 1; the JAX ``_tpad`` at the
stride-2 stems and depthwise convs), max-pool 3/2 with -inf padding 1.
Parameters are float32; activations run in ``dtype``.  Under a
height-sharded forward (``parallel.spatial``) the convs and the max-pool
compute this rank's rows.

``output_stride`` 16 (smp's ``encoder_output_stride=16``, which
DeepLabV3+ uses) runs the ResNet's stage 4 as smp's
``replace_strides_with_dilation(layer4, 2)`` makes it: no conv of the stage
strides, every 3x3 conv has dilation 2 and padding 2, so the pyramid's last
two levels are both /16.  smp also sets dilation 2 on the stage's 1x1
convs, where it changes nothing; here they keep dilation 1.  The default,
32, is the plain ResNet.

``remat`` (the JAX encoder's option, numerically the same network and the
same parameters in every mode) recomputes activations in the backward
instead of saving them: ``True`` checkpoints each residual block (the stem
is never recomputed), ``"stageN..."`` only the blocks of those stages, and
``"convs"`` each normalize(+ReLU) between the convs, so that the conv
outputs stay saved and only the elementwise chain runs again.  The
recompute moves no BatchNorm buffer (``ops.batch_norm.checkpoint``).
MobileNetV2 takes ``False``, ``True`` (each inverted residual block) and
``"convs"``; a stage set raises, as in JAX.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from uda_aerial_semantic_segmentation_research_tpu_torch.ops.batch_norm import (
    BatchNorm,
    checkpoint,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.parallel.spatial import current_shard


def _remat_stage_set(remat):
    """Parse stage-granular remat specs: ``"stage1"`` remats only stage 1's
    blocks, ``"stage12"`` stages 1 and 2, etc. (1-based, matching the
    ``stageN_blockM`` names).  Returns None for every other remat mode."""
    if isinstance(remat, str) and remat.startswith("stage"):
        stages = {int(c) for c in remat[len("stage"):]}
        if not stages or not stages <= {1, 2, 3, 4}:
            raise ValueError(f"Bad stage-remat spec {remat!r}; use e.g. "
                             "'stage1' or 'stage12' (stages 1-4)")
        return stages
    return None


def norm_act(norm, x, relu, remat: bool = False):
    """``norm(x)``, then a ReLU if ``relu`` (a ReLU6 if it is ``"relu6"``);
    with ``remat`` the two are recomputed in the backward (the ``"convs"``
    mode)."""
    def fn(t):
        y = norm(t)
        if relu == "relu6":
            return F.relu6(y)
        return torch.relu(y) if relu else y
    return checkpoint(fn, x) if remat else fn(x)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with float32 parameters cast to the input's dtype; on
    this rank's rows under a height-sharded forward (``parallel.spatial``)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        shard = current_shard()
        if shard is not None:
            return shard.conv2d(x, self.weight.to(x.dtype), bias, self.stride, self.padding,
                                self.dilation, self.groups)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


def conv(cin: int, cout: int, k: int, stride: int = 1, bias: bool = False,
         groups: int = 1, dilation: int = 1) -> Conv2d:
    return Conv2d(cin, cout, k, stride=stride, padding=dilation * (k // 2), dilation=dilation,
                  bias=bias, groups=groups)


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block (resnet18/34); ``dilation`` on both 3x3s."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, dtype: torch.dtype,
                 dilation: int = 1):
        super().__init__()
        self.conv1 = conv(cin, filters, 3, stride, dilation=dilation)
        self.bn1 = BatchNorm(filters, dtype=dtype)
        self.conv2 = conv(filters, filters, 3, dilation=dilation)
        self.bn2 = BatchNorm(filters, zero_scale=True, dtype=dtype)
        self.downsample_conv = self.downsample_norm = None
        if stride != 1 or cin != filters:
            self.downsample_conv = conv(cin, filters, 1, stride)
            self.downsample_norm = BatchNorm(filters, dtype=dtype)

    def forward(self, x, remat_norms: bool = False):
        y = norm_act(self.bn1, self.conv1(x), True, remat_norms)
        y = norm_act(self.bn2, self.conv2(y), False, remat_norms)
        residual = x
        if self.downsample_conv is not None:
            residual = norm_act(self.downsample_norm, self.downsample_conv(x), False,
                                remat_norms)
        return torch.relu(y + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 residual block (resnet50+); ``dilation`` on the 3x3."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, dtype: torch.dtype,
                 dilation: int = 1):
        super().__init__()
        out = filters * self.expansion
        self.conv1 = conv(cin, filters, 1)
        self.bn1 = BatchNorm(filters, dtype=dtype)
        self.conv2 = conv(filters, filters, 3, stride, dilation=dilation)
        self.bn2 = BatchNorm(filters, dtype=dtype)
        self.conv3 = conv(filters, out, 1)
        self.bn3 = BatchNorm(out, zero_scale=True, dtype=dtype)
        self.downsample_conv = self.downsample_norm = None
        if stride != 1 or cin != out:
            self.downsample_conv = conv(cin, out, 1, stride)
            self.downsample_norm = BatchNorm(out, dtype=dtype)

    def forward(self, x, remat_norms: bool = False):
        y = norm_act(self.bn1, self.conv1(x), True, remat_norms)
        y = norm_act(self.bn2, self.conv2(y), True, remat_norms)
        y = norm_act(self.bn3, self.conv3(y), False, remat_norms)
        residual = x
        if self.downsample_conv is not None:
            residual = norm_act(self.downsample_norm, self.downsample_conv(x), False,
                                remat_norms)
        return torch.relu(y + residual)


class ResNetEncoder(nn.Module):
    """ResNet backbone returning the smp-style 6-feature pyramid.

    Blocks are registered as ``stage{s}_block{b}`` (1-based stages), the
    JAX package's module names.  ``remat``: ``False``, ``True``, ``"convs"``
    or ``"stageN..."``; ``output_stride``: 32, or 16 for a dilated stage 4
    (module docstring).
    """

    def __init__(self, stage_sizes, block_cls, in_channels: int = 3,
                 num_filters: int = 64, dtype: torch.dtype = torch.bfloat16,
                 remat=False, output_stride: int = 32):
        super().__init__()
        _remat_stage_set(remat)                      # a bad stage spec raises here
        if output_stride not in (16, 32):
            raise ValueError(f"output_stride is 16 or 32, not {output_stride!r}")
        self.dtype = dtype
        self.remat = remat
        self.stem_conv = conv(in_channels, num_filters, 7, 2)
        self.stem_norm = BatchNorm(num_filters, dtype=dtype)
        self.stages: List[List[str]] = []
        cin = num_filters
        for stage, n_blocks in enumerate(stage_sizes):
            names = []
            filters = num_filters * 2 ** stage
            dilated = output_stride == 16 and stage == 3
            for blk in range(n_blocks):
                stride = 2 if stage > 0 and blk == 0 and not dilated else 1
                name = f"stage{stage + 1}_block{blk}"
                self.add_module(name, block_cls(cin, filters, stride, dtype,
                                                dilation=2 if dilated else 1))
                cin = filters * block_cls.expansion
                names.append(name)
            self.stages.append(names)

    def features(self, x) -> List[torch.Tensor]:
        """NCHW input -> NCHW pyramid (the U-Net's internal form)."""
        feats = [x]
        y = torch.relu(self.stem_norm(self.stem_conv(x.to(self.dtype))))
        feats.append(y)                                          # /2
        shard = current_shard()
        y = (F.max_pool2d(y, 3, stride=2, padding=1) if shard is None
             else shard.max_pool2d(y, 3, 2, 1))
        remat_stages = _remat_stage_set(self.remat)
        for stage, names in enumerate(self.stages, 1):
            whole = (stage in remat_stages if remat_stages is not None
                     else bool(self.remat) and self.remat != "convs")
            for name in names:
                block = getattr(self, name)
                y = checkpoint(block, y) if whole else block(y, self.remat == "convs")
            feats.append(y)                                      # /4 /8 /16 /32 (or /16)
        return feats

    def forward(self, x) -> List[torch.Tensor]:
        """NHWC input -> NHWC pyramid, as the JAX encoder."""
        return [f.permute(0, 2, 3, 1) for f in self.features(x.permute(0, 3, 1, 2))]


class InvertedResidual(nn.Module):
    """MobileNetV2 inverted residual: 1x1 expand (when ``expand`` > 1) ->
    3x3 depthwise -> 1x1 project, each normalized, ReLU6 after the first
    two; residual when stride 1 and the widths match.  The layers are
    ``conv{i}`` / ``bn{i}`` in that order (flax's ``Conv_{i-1}`` /
    ``BatchNorm_{i-1}``)."""

    def __init__(self, cin: int, filters: int, stride: int, expand: int,
                 dtype: torch.dtype):
        super().__init__()
        hidden = cin * expand
        layers = [conv(cin, hidden, 1)] if expand != 1 else []
        layers += [conv(hidden, hidden, 3, stride, groups=hidden), conv(hidden, filters, 1)]
        for i, layer in enumerate(layers, 1):
            self.add_module(f"conv{i}", layer)
            self.add_module(f"bn{i}", BatchNorm(layer.out_channels, dtype=dtype))
        self.n_layers = len(layers)
        self.residual = stride == 1 and cin == filters

    def forward(self, x, remat_norms: bool = False):
        y = x
        for i in range(1, self.n_layers + 1):
            act = "relu6" if i < self.n_layers else False      # the projection is linear
            y = norm_act(getattr(self, f"bn{i}"), getattr(self, f"conv{i}")(y), act,
                         remat_norms)
        return y + x if self.residual else y


# (expand, filters, repeats, first stride) per MobileNetV2 stage
MOBILENET_STAGES = ((6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1),
                    (6, 160, 3, 2), (6, 320, 1, 1))
_MOBILENET_MARKS = (0, 1, 3)          # stages after which the pyramid takes /4, /8, /16


class MobileNetV2Encoder(nn.Module):
    """MobileNetV2 backbone with the smp-style 6-level pyramid, out channels
    ``(3, 16, 24, 32, 96, 1280)``: a 3x3/2 stem, the block ``ir0`` (/2),
    ``stage{s}_block{b}`` (0-based stages), a 1x1 ``head_conv`` to 1280.
    ``remat``: ``False``, ``True`` or ``"convs"``, applied to the blocks
    (``ir0`` included); a stage set raises."""

    def __init__(self, in_channels: int = 3, dtype: torch.dtype = torch.bfloat16,
                 remat=False):
        super().__init__()
        _mobilenet_remat(remat)
        self.dtype = dtype
        self.remat = remat
        self.stem_conv = conv(in_channels, 32, 3, 2)
        self.stem_norm = BatchNorm(32, dtype=dtype)
        self.ir0 = InvertedResidual(32, 16, 1, 1, dtype)
        self.stages: List[List[str]] = []
        cin = 16
        for si, (t, c, n, s) in enumerate(MOBILENET_STAGES):
            names = []
            for bi in range(n):
                name = f"stage{si}_block{bi}"
                self.add_module(name, InvertedResidual(cin, c, s if bi == 0 else 1, t, dtype))
                cin = c
                names.append(name)
            self.stages.append(names)
        self.head_conv = conv(cin, 1280, 1)
        self.head_norm = BatchNorm(1280, dtype=dtype)

    def _block(self, block, y):
        if self.remat and self.remat != "convs":
            return checkpoint(block, y)
        return block(y, self.remat == "convs")

    def features(self, x) -> List[torch.Tensor]:
        """NCHW input -> NCHW pyramid (the U-Net's internal form)."""
        _mobilenet_remat(self.remat)         # a clone may have set a stage set
        feats = [x]
        y = F.relu6(self.stem_norm(self.stem_conv(x.to(self.dtype))))
        y = self._block(self.ir0, y)
        feats.append(y)                                          # /2, 16ch
        for si, names in enumerate(self.stages):
            for name in names:
                y = self._block(getattr(self, name), y)
            if si in _MOBILENET_MARKS:
                feats.append(y)                                  # /4, /8, /16
        feats.append(F.relu6(self.head_norm(self.head_conv(y))))  # /32, 1280ch
        return feats

    def forward(self, x) -> List[torch.Tensor]:
        """NHWC input -> NHWC pyramid, as the JAX encoder."""
        return [f.permute(0, 2, 3, 1) for f in self.features(x.permute(0, 3, 1, 2))]


def _mobilenet_remat(remat):
    if _remat_stage_set(remat) is not None:
        raise ValueError("stage-granular remat is ResNet-only; MobileNetV2 takes remat "
                         "in {False, True, 'convs'}")


ENCODERS = {
    "resnet18": dict(stage_sizes=(2, 2, 2, 2), block_cls=BasicBlock,
                     out_channels=(3, 64, 64, 128, 256, 512)),
    "resnet34": dict(stage_sizes=(3, 4, 6, 3), block_cls=BasicBlock,
                     out_channels=(3, 64, 64, 128, 256, 512)),
    "resnet50": dict(stage_sizes=(3, 4, 6, 3), block_cls=Bottleneck,
                     out_channels=(3, 64, 256, 512, 1024, 2048)),
    "resnet101": dict(stage_sizes=(3, 4, 23, 3), block_cls=Bottleneck,
                      out_channels=(3, 64, 256, 512, 1024, 2048)),
    "resnet152": dict(stage_sizes=(3, 8, 36, 3), block_cls=Bottleneck,
                      out_channels=(3, 64, 256, 512, 1024, 2048)),
    "mobilenet_v2": dict(stage_sizes=None, block_cls=InvertedResidual,
                         out_channels=(3, 16, 24, 32, 96, 1280)),
}


def encoder_out_channels(encoder_name: str):
    return ENCODERS[encoder_name]["out_channels"]


def build_encoder(encoder_name: str, in_channels: int = 3,
                  dtype: torch.dtype = torch.bfloat16, remat=False,
                  output_stride: int = 32) -> nn.Module:
    """The encoder ``encoder_name`` of ``ENCODERS``; ``output_stride`` 16
    dilates a ResNet's stage 4 (module docstring)."""
    if encoder_name not in ENCODERS:
        raise ValueError(
            f"Unknown encoder '{encoder_name}'; available: {sorted(ENCODERS)}")
    if encoder_name == "mobilenet_v2":
        if output_stride != 32:
            raise ValueError(f"mobilenet_v2 runs at output_stride 32 only, not "
                             f"{output_stride!r}")
        return MobileNetV2Encoder(in_channels=in_channels, dtype=dtype, remat=remat)
    spec = ENCODERS[encoder_name]
    return ResNetEncoder(spec["stage_sizes"], spec["block_cls"],
                         in_channels=in_channels, dtype=dtype, remat=remat,
                         output_stride=output_stride)
