"""The plain reference of the U-Net: smp's ``Unet`` on a torchvision ResNet.

The module an architecture gives the harness: ``weight_spec`` (the
parameter tree), ``Net`` (the forward), and the layer tables that
``counts`` reads (``conv_layers``, ``bn_inputs``).

Written from the published description (segmentation_models.pytorch's
``Unet``: the encoder's pyramid at /2 ... /32, five decoder blocks of
nearest 2x upsample, concatenation with the skip, and two conv3x3 + BN +
ReLU; a conv3x3 head with bias; He et al.'s ResNet with the stride on the
3x3 conv of a bottleneck), in plain float32 ``torch`` with no kernel,
no cache and no module of the program.  Parameters live in a flat dict
keyed by the names of the program's checkpoint tree (``weight_spec``), so
one set of tensors made from the seed serves both sides.

BatchNorm is ``y = (x - mean) * rsqrt(var + 1e-5) * scale + bias`` over
the batch's statistics in train mode (biased variance) and over the
running ones in eval mode.  The reference never moves running statistics:
nothing it is compared on reads them after a train step.

``quant="fp8"`` is the control: every convolution's input and weight go
through float8 e4m3 with a per-tensor scale (amax / 448) in the forward,
and the gradients that flow back to them through float8 e5m2; the lower
precision next to the configuration's bfloat16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

BN_EPS = 1e-5
FP8_MAX = 448.0        # largest e4m3 value
E5M2_MAX = 57344.0     # largest e5m2 value


def _blocks(cfg):
    """(name, cin, filters, stride, out) of every residual block."""
    expansion = 4 if cfg["block"] == "bottleneck" else 1
    cin, out = cfg["stem_channels"], []
    for stage, n in enumerate(cfg["stage_sizes"]):
        filters = cfg["stem_channels"] * 2 ** stage
        for b in range(n):
            stride = 2 if stage > 0 and b == 0 else 1
            out.append((f"encoder.stage{stage + 1}_block{b}", cin, filters, stride,
                        filters * expansion))
            cin = filters * expansion
    return out


def _stage_ends(cfg):
    """Index of the last block of each stage in ``_blocks``."""
    ends, total = [], 0
    for n in cfg["stage_sizes"]:
        total += n
        ends.append(total - 1)
    return ends


def weight_spec(cfg):
    """``[(name, shape, kind)]`` of every parameter and BatchNorm buffer.
    ``kind``: ``conv`` (a kernel, He-initialised), ``head`` / ``head_bias``,
    ``bn`` or ``bn_last`` (the last norm of a residual branch), each a group
    of ``.scale``, ``.bias``, ``.mean``, ``.var``."""
    spec = []

    def conv(name, cin, cout, k):
        spec.append((f"{name}.weight", (cout, cin, k, k), "conv"))

    def bn(name, c, kind="bn"):
        for leaf in ("scale", "bias", "mean", "var"):
            spec.append((f"{name}.{leaf}", (c,), kind))

    stem = cfg["stem_channels"]
    conv("encoder.stem_conv", cfg["in_channels"], stem, 7)
    bn("encoder.stem_norm", stem)
    for name, cin, filters, stride, out in _blocks(cfg):
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
    enc = encoder_channels(cfg)
    skips = list(enc[1:-1])[::-1] + [0]
    cin = enc[-1]
    for i, (ch, cs) in enumerate(zip(cfg["decoder_channels"], skips)):
        conv(f"decoder.block{i}.conv1", cin + cs, ch, 3)
        bn(f"decoder.block{i}.norm1", ch)
        conv(f"decoder.block{i}.conv2", ch, ch, 3)
        bn(f"decoder.block{i}.norm2", ch)
        cin = ch
    spec.append(("segmentation_head.weight", (cfg["classes"], cin, 3, 3), "head"))
    spec.append(("segmentation_head.bias", (cfg["classes"],), "head_bias"))
    return spec


def encoder_channels(cfg):
    """Channels of the pyramid ``[input, /2, /4, /8, /16, /32]``."""
    blocks = _blocks(cfg)
    return [cfg["in_channels"], cfg["stem_channels"]] + [blocks[e][4] for e in _stage_ends(cfg)]


def _fp8(t, dtype, top):
    """``t`` rounded to a float8 ``dtype`` under a per-tensor scale (amax / ``top``)."""
    scale = torch.clamp_min(t.abs().amax(), 1e-12) / top
    return (t / scale).to(dtype).to(torch.float32) * scale


class _Float8(torch.autograd.Function):
    """A tensor through float8: e4m3 forward, e5m2 for the gradient back."""

    @staticmethod
    def forward(ctx, t):
        return _fp8(t, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, E5M2_MAX)


class UNet:
    """The forward of the reference over a flat dict of tensors ``p``."""

    def __init__(self, cfg, p, train: bool, quant=None, remat: bool = False, stats=None):
        """``stats``: a dict that receives each train-mode BatchNorm's batch
        ``(mean, biased var)`` under its name."""
        self.cfg, self.p, self.train, self.remat, self.stats = cfg, p, train, remat, stats
        if quant not in (None, "fp8"):
            raise ValueError(f"quant is None or 'fp8', not {quant!r}")
        self.q = _Float8.apply if quant == "fp8" else (lambda t: t)

    def conv(self, x, name, stride=1, bias=None):
        w = self.p[f"{name}.weight"]
        return F.conv2d(self.q(x), self.q(w), bias, stride=stride, padding=w.shape[-1] // 2)

    def bn(self, x, name):
        p = self.p
        if self.train:
            if self.stats is not None:
                with torch.no_grad():
                    var, mean = torch.var_mean(x.detach(), dim=(0, 2, 3), correction=0)
                self.stats[name] = (mean, var)
            return F.batch_norm(x, None, None, p[f"{name}.scale"], p[f"{name}.bias"],
                                training=True, eps=BN_EPS)
        return F.batch_norm(x, p[f"{name}.mean"], p[f"{name}.var"], p[f"{name}.scale"],
                            p[f"{name}.bias"], training=False, eps=BN_EPS)

    def block(self, x, name, stride):
        if self.cfg["block"] == "bottleneck":
            y = F.relu(self.bn(self.conv(x, f"{name}.conv1"), f"{name}.bn1"))
            y = F.relu(self.bn(self.conv(y, f"{name}.conv2", stride), f"{name}.bn2"))
            y = self.bn(self.conv(y, f"{name}.conv3"), f"{name}.bn3")
        else:
            y = F.relu(self.bn(self.conv(x, f"{name}.conv1", stride), f"{name}.bn1"))
            y = self.bn(self.conv(y, f"{name}.conv2"), f"{name}.bn2")
        if f"{name}.downsample_conv.weight" in self.p:
            x = self.bn(self.conv(x, f"{name}.downsample_conv", stride),
                        f"{name}.downsample_norm")
        return F.relu(y + x)

    def decoder_block(self, x, skip, name):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        x = F.relu(self.bn(self.conv(x, f"{name}.conv1"), f"{name}.norm1"))
        return F.relu(self.bn(self.conv(x, f"{name}.conv2"), f"{name}.norm2"))

    def _run(self, fn, *args):
        if self.remat and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def __call__(self, x_nhwc):
        """Normalized float32 (B, H, W, 3) -> float32 logits (B, H, W, classes)."""
        x = x_nhwc.permute(0, 3, 1, 2).contiguous()
        feats = [x]
        y = F.relu(self.bn(self.conv(x, "encoder.stem_conv", 2), "encoder.stem_norm"))
        feats.append(y)
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        ends = set(_stage_ends(self.cfg))
        for i, (name, _cin, _f, stride, _out) in enumerate(_blocks(self.cfg)):
            y = self._run(lambda t, n=name, s=stride: self.block(t, n, s), y)
            if i in ends:
                feats.append(y)
        skips = list(feats[1:-1])[::-1] + [None]
        y = feats[-1]
        for i, skip in enumerate(skips):
            if skip is None:
                y = self._run(lambda t, n=f"decoder.block{i}": self.decoder_block(t, None, n), y)
            else:
                y = self._run(lambda t, s, n=f"decoder.block{i}": self.decoder_block(t, s, n),
                              y, skip)
        logits = self.conv(y, "segmentation_head", bias=self.p["segmentation_head.bias"])
        return logits.permute(0, 2, 3, 1)


Net = UNet


def conv_layers(cfg, tile: int):
    """``[(name, cin, cout, k, stride, hout, wout)]`` of every convolution
    of one image of ``tile`` x ``tile`` pixels."""
    out = []
    s = tile // 2
    out.append(("encoder.stem_conv", cfg["in_channels"], cfg["stem_channels"], 7, 2, s, s))
    s //= 2                                                     # the max pool
    for name, cin, filters, stride, width in _blocks(cfg):
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
    enc = encoder_channels(cfg)
    skips = list(enc[1:-1])[::-1] + [0]
    cin = enc[-1]
    for i, (ch, cs) in enumerate(zip(cfg["decoder_channels"], skips)):
        s *= 2
        out += [(f"decoder.block{i}.conv1", cin + cs, ch, 3, 1, s, s),
                (f"decoder.block{i}.conv2", ch, ch, 3, 1, s, s)]
        cin = ch
    out.append(("segmentation_head", cin, cfg["classes"], 3, 1, s, s))
    return out


def bn_inputs(cfg, tile: int):
    """``[(name, channels, h, w)]`` of every BatchNorm input of one image:
    each convolution but the head feeds one."""
    norm = {"encoder.stem_conv": "encoder.stem_norm"}
    out = []
    for name, _cin, cout, _k, _stride, h, w in conv_layers(cfg, tile):
        if name == "segmentation_head":
            continue
        if name in norm:
            bn = norm[name]
        elif name.endswith("downsample_conv"):
            bn = name.replace("downsample_conv", "downsample_norm")
        elif name.startswith("decoder."):
            bn = name.replace(".conv", ".norm")
        else:
            bn = name.replace(".conv", ".bn")
        out.append((bn, cout, h, w))
    return out
