"""The plain reference of DeepLabV3+: smp's ``DeepLabV3Plus`` on a
torchvision ResNet at output stride 16.

The module an architecture gives the harness: ``weight_spec`` (the
parameter tree), ``Net`` (the forward), and the layer tables that
``counts`` reads (``conv_layers``, ``bn_inputs``).

Written from the published description (segmentation_models.pytorch's
``decoders/deeplabv3/model.py`` and ``decoder.py``, ``encoders/_utils.py::
replace_strides_with_dilation`` and ``base/heads.py::SegmentationHead``;
Chen et al. 2018, arXiv:1802.02611; He et al.'s ResNet with the stride on
the 3x3 conv of a bottleneck), in plain float32 ``torch`` with no kernel,
no cache and no module of the program:

- the encoder's stage 4 with every stride 1 and its 3x3 convs at
  dilation 2 (padding 2), so the last level is at /16;
- the ASPP on the last level: a 1x1 conv, three separable 3x3 convs
  (depthwise at dilation ``r`` of ``atrous_rates``, ``groups`` = channels,
  then a pointwise 1x1), and image pooling (adaptive average pool to 1x1,
  1x1 conv, bilinear back to the level's size, ``align_corners=False``),
  each to ``decoder_channels`` with BatchNorm and ReLU; concatenated, a
  1x1 conv, BatchNorm, ReLU, Dropout(``aspp_dropout``); a separable 3x3,
  BatchNorm, ReLU;
- bilinear x``upsampling`` with ``align_corners=True``
  (``nn.UpsamplingBilinear2d``), the /4 level through a 1x1 conv to
  ``highres_channels`` with BatchNorm and ReLU, concatenated after it, a
  separable 3x3, BatchNorm, ReLU;
- the head: a 1x1 conv with bias, bilinear x``upsampling`` with
  ``align_corners=True``.  No other conv has a bias.

Departures from smp: none in the arithmetic.  smp also sets dilation 2 on
stage 4's 1x1 convs, which changes nothing; here they have none.  As in
``unet.py``, BatchNorm normalizes over the batch's statistics in train
mode, and the running statistics are never moved.

Dropout draws the program's masks (``models/architectures.py::Dropout``
documents them): the ``k``-th train-mode forward given the same parameter
tensors draws ``torch.rand`` of the input's NCHW shape, float32, from a
``torch.Generator`` on its device seeded with the first word of
``numpy.random.SeedSequence([dropout_seed mod 2**63, k])`` mod 2**63, keeps
``u >= aspp_dropout`` and scales by ``1 / (1 - aspp_dropout)``.  ``k``
counts per set of parameters, so every ``train.follow`` starts at 0, and a
recompute under ``remat`` draws its forward's mask again.

``quant="fp8"`` is the control of ``unet.py``: every convolution's input
and weight, the depthwise ones included, through float8 e4m3 forward and
their gradients through e5m2.  ``remat`` checkpoints each residual block,
the ASPP and the decoder.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference.unet import UNet, _stage_ends

_MASK63 = (1 << 63) - 1
_DRAWS: dict = {}          # id of a parameter set's head kernel -> train forwards so far


def _blocks(cfg):
    """(name, cin, filters, stride, dilation, out) of every residual block."""
    expansion = 4 if cfg["block"] == "bottleneck" else 1
    dilate_last = cfg["encoder_output_stride"] == 16
    cin, out = cfg["stem_channels"], []
    for stage, n in enumerate(cfg["stage_sizes"]):
        filters = cfg["stem_channels"] * 2 ** stage
        dilated = dilate_last and stage == len(cfg["stage_sizes"]) - 1
        for b in range(n):
            stride = 2 if stage > 0 and b == 0 and not dilated else 1
            out.append((f"encoder.stage{stage + 1}_block{b}", cin, filters, stride,
                        2 if dilated else 1, filters * expansion))
            cin = filters * expansion
    return out


def encoder_channels(cfg):
    """Channels of the pyramid ``[input, /2, /4, /8, /16, last]``."""
    blocks = _blocks(cfg)
    return [cfg["in_channels"], cfg["stem_channels"]] + [blocks[e][5] for e in _stage_ends(cfg)]


def _decoder_convs(cfg):
    """``[(name, cin, cout, k, depthwise, level)]`` of the ASPP and decoder
    convs in order; ``level``, where the conv runs: ``"last"`` (the last
    level), ``"pool"`` (1 x 1) or ``"high"`` (the /4 level)."""
    enc = encoder_channels(cfg)
    c5, a, hr = enc[-1], cfg["decoder_channels"], cfg["highres_channels"]
    out = [("aspp_1x1_conv", c5, a, 1, False, "last")]
    for r in cfg["atrous_rates"]:
        out += [(f"aspp_r{r}_depthwise", c5, c5, 3, True, "last"),
                (f"aspp_r{r}_pointwise", c5, a, 1, False, "last")]
    out += [("aspp_pool_conv", c5, a, 1, False, "pool"),
            ("aspp_project_conv", a * (len(cfg["atrous_rates"]) + 2), a, 1, False, "last"),
            ("aspp_sep_depthwise", a, a, 3, True, "last"),
            ("aspp_sep_pointwise", a, a, 1, False, "last"),
            ("highres_conv", enc[2], hr, 1, False, "high"),
            ("fuse_depthwise", a + hr, a + hr, 3, True, "high"),
            ("fuse_pointwise", a + hr, a, 1, False, "high"),
            ("head", a, cfg["classes"], 1, False, "high")]
    return out


def _norm_of(conv_name: str):
    """The BatchNorm a conv feeds, or None (a depthwise conv, the head)."""
    if conv_name == "head" or conv_name.endswith("_depthwise"):
        return None
    if conv_name.endswith("downsample_conv"):
        return conv_name.replace("downsample_conv", "downsample_norm")
    if conv_name.startswith("encoder.stage"):
        return conv_name.replace(".conv", ".bn")
    if conv_name == "encoder.stem_conv":
        return "encoder.stem_norm"
    return conv_name.rsplit("_", 1)[0] + "_norm"


def weight_spec(cfg):
    """``[(name, shape, kind)]`` of every parameter and BatchNorm buffer, as
    ``unet.weight_spec`` gives them (a depthwise kernel is ``(C, 1, 3, 3)``)."""
    spec = []

    def conv(name, cin, cout, k, groups=1):
        spec.append((f"{name}.weight", (cout, cin // groups, k, k), "conv"))

    def bn(name, c, kind="bn"):
        for leaf in ("scale", "bias", "mean", "var"):
            spec.append((f"{name}.{leaf}", (c,), kind))

    stem = cfg["stem_channels"]
    conv("encoder.stem_conv", cfg["in_channels"], stem, 7)
    bn("encoder.stem_norm", stem)
    for name, cin, filters, stride, _dil, out in _blocks(cfg):
        if cfg["block"] == "bottleneck":
            conv(f"{name}.conv1", cin, filters, 1)
            bn(f"{name}.bn1", filters)
            conv(f"{name}.conv2", filters, filters, 3)
            bn(f"{name}.bn2", filters)
            conv(f"{name}.conv3", filters, out, 1)
            bn(f"{name}.bn3", out, "bn_last")
        else:
            conv(f"{name}.conv1", cin, filters, 3)
            bn(f"{name}.bn1", filters)
            conv(f"{name}.conv2", filters, filters, 3)
            bn(f"{name}.bn2", filters, "bn_last")
        if stride != 1 or cin != out:
            conv(f"{name}.downsample_conv", cin, out, 1)
            bn(f"{name}.downsample_norm", out)
    for name, cin, cout, k, depthwise, _level in _decoder_convs(cfg):
        if name == "head":
            spec.append(("head.weight", (cout, cin, k, k), "head"))
            spec.append(("head.bias", (cout,), "head_bias"))
            continue
        conv(name, cin, cout, k, groups=cin if depthwise else 1)
        norm = _norm_of(name)
        if norm is not None:
            bn(norm, cout)
    return spec


def draw_seed(seed: int, k: int) -> int:
    """The seed of the ``k``-th dropout mask under ``seed``."""
    mixed = np.random.SeedSequence([int(seed) & _MASK63, int(k)]).generate_state(1, np.uint64)
    return int(mixed[0]) & _MASK63


def _count_forward(p) -> int:
    """The number of train-mode forwards made so far with the parameter set
    ``p`` (keyed by its head kernel, forgotten with it), then one more."""
    anchor = p["head.weight"]
    key = id(anchor)
    if key not in _DRAWS:
        _DRAWS[key] = 0
        weakref.finalize(anchor, _DRAWS.pop, key, None)
    k = _DRAWS[key]
    _DRAWS[key] = k + 1
    return k


class DeepLabV3Plus(UNet):
    """The forward of the reference over a flat dict of tensors ``p``; the
    BatchNorm, the control and ``stats`` are ``UNet``'s."""

    def __init__(self, cfg, p, train: bool, quant=None, remat: bool = False, stats=None):
        super().__init__(cfg, p, train, quant=quant, remat=remat, stats=stats)
        self.k = None

    def conv(self, x, name, stride=1, bias=None, dilation=1, groups=1):
        w = self.p[f"{name}.weight"]
        return F.conv2d(self.q(x), self.q(w), bias, stride=stride,
                        padding=dilation * (w.shape[-1] // 2), dilation=dilation, groups=groups)

    def conv_bn_relu(self, x, name):
        return F.relu(self.bn(self.conv(x, f"{name}_conv"), f"{name}_norm"))

    def separable_bn_relu(self, x, name, dilation=1):
        y = self.conv(x, f"{name}_depthwise", dilation=dilation, groups=x.shape[1])
        return F.relu(self.bn(self.conv(y, f"{name}_pointwise"), f"{name}_norm"))

    def dropout(self, x):
        if not self.train:
            return x
        rate = self.cfg["aspp_dropout"]
        g = torch.Generator(device=x.device)
        g.manual_seed(draw_seed(self.cfg["dropout_seed"], self.k))
        u = torch.rand(x.shape, dtype=torch.float32, generator=g, device=x.device)
        return x * (u >= rate).to(x.dtype) * (1.0 / (1.0 - rate))

    def block(self, x, name, stride, dilation=1):
        if self.cfg["block"] == "bottleneck":
            y = F.relu(self.bn(self.conv(x, f"{name}.conv1"), f"{name}.bn1"))
            y = F.relu(self.bn(self.conv(y, f"{name}.conv2", stride, dilation=dilation),
                               f"{name}.bn2"))
            y = self.bn(self.conv(y, f"{name}.conv3"), f"{name}.bn3")
        else:
            y = F.relu(self.bn(self.conv(x, f"{name}.conv1", stride, dilation=dilation),
                               f"{name}.bn1"))
            y = self.bn(self.conv(y, f"{name}.conv2", dilation=dilation), f"{name}.bn2")
        if f"{name}.downsample_conv.weight" in self.p:
            x = self.bn(self.conv(x, f"{name}.downsample_conv", stride),
                        f"{name}.downsample_norm")
        return F.relu(y + x)

    def aspp(self, c5):
        branches = [self.conv_bn_relu(c5, "aspp_1x1")]
        branches += [self.separable_bn_relu(c5, f"aspp_r{r}", r) for r in self.cfg["atrous_rates"]]
        pooled = self.conv_bn_relu(F.adaptive_avg_pool2d(c5, 1), "aspp_pool")
        branches.append(F.interpolate(pooled, size=c5.shape[2:], mode="bilinear",
                                      align_corners=False))
        y = self.dropout(self.conv_bn_relu(torch.cat(branches, dim=1), "aspp_project"))
        return self.separable_bn_relu(y, "aspp_sep")

    def decoder(self, y, high):
        up = self.cfg["upsampling"]
        y = F.interpolate(y, scale_factor=up, mode="bilinear", align_corners=True)
        y = torch.cat([y, self.conv_bn_relu(high, "highres")], dim=1)
        y = self.separable_bn_relu(y, "fuse")
        logits = self.conv(y, "head", bias=self.p["head.bias"])
        return F.interpolate(logits, scale_factor=up, mode="bilinear", align_corners=True)

    def __call__(self, x_nhwc):
        """Normalized float32 (B, H, W, 3) -> float32 logits (B, H, W, classes)."""
        if self.train:
            self.k = _count_forward(self.p)
        x = x_nhwc.permute(0, 3, 1, 2).contiguous()
        y = F.relu(self.bn(self.conv(x, "encoder.stem_conv", 2), "encoder.stem_norm"))
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        feats = [x, None]
        ends = set(_stage_ends(self.cfg))
        for i, (name, _cin, _f, stride, dilation, _out) in enumerate(_blocks(self.cfg)):
            y = self._run(lambda t, n=name, s=stride, d=dilation: self.block(t, n, s, d), y)
            if i in ends:
                feats.append(y)
        y = self._run(self.aspp, feats[-1])
        logits = self._run(self.decoder, y, feats[2])
        return logits.permute(0, 2, 3, 1)


Net = DeepLabV3Plus


def conv_layers(cfg, tile: int):
    """``[(name, cin, cout, k, stride, hout, wout)]`` of every convolution
    of one image of ``tile`` x ``tile`` pixels; a depthwise conv is listed
    with ``cin`` 1, which counts its operations exactly."""
    out = []
    s = tile // 2
    out.append(("encoder.stem_conv", cfg["in_channels"], cfg["stem_channels"], 7, 2, s, s))
    s //= 2                                                     # the max pool
    high = s
    for name, cin, filters, stride, _dil, width in _blocks(cfg):
        s_out = s // stride
        if cfg["block"] == "bottleneck":
            out += [(f"{name}.conv1", cin, filters, 1, 1, s, s),
                    (f"{name}.conv2", filters, filters, 3, stride, s_out, s_out),
                    (f"{name}.conv3", filters, width, 1, 1, s_out, s_out)]
        else:
            out += [(f"{name}.conv1", cin, filters, 3, stride, s_out, s_out),
                    (f"{name}.conv2", filters, filters, 3, 1, s_out, s_out)]
        if stride != 1 or cin != width:
            out.append((f"{name}.downsample_conv", cin, width, 1, stride, s_out, s_out))
        s = s_out
    size = {"last": s, "pool": 1, "high": high}
    for name, cin, cout, k, depthwise, level in _decoder_convs(cfg):
        hw = size[level]
        out.append((name, 1 if depthwise else cin, cout, k, 1, hw, hw))
    return out


def bn_inputs(cfg, tile: int):
    """``[(name, channels, h, w)]`` of every BatchNorm input of one image:
    each convolution but a depthwise one and the head feeds one."""
    out = []
    for name, _cin, cout, _k, _stride, h, w in conv_layers(cfg, tile):
        norm = _norm_of(name)
        if norm is not None:
            out.append((norm, cout, h, w))
    return out
