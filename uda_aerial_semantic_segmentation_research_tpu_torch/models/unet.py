"""U-Net segmentation model (smp.Unet-style) with a fused eval path.

Counterpart of the JAX package's ``models/unet.py``: ResNet encoder ->
five decoder blocks with skip connections (channels 256/128/64/32/16)
-> 3x3 segmentation head.

``fused_decoder`` picks the schedule of each decoder block's first conv,
with the JAX ``Unet``'s values: ``False`` (naive: upsample -> concat ->
conv3x3), ``True`` (every block fused: ``ops.upsample_conv.upsample2x_conv3x3``
over the low-resolution input plus a conv3x3 of the skip, the two channel
slices of the same conv1 kernel, so the 4x upsampled concatenation is never
made), a tuple of block indices (0 = lowest resolution) to fuse only those,
``"dilated"`` (every block through ``upsample2x_conv3x3_dilated``; as in JAX,
inputs below 128 px keep the naive schedule), and ``"auto"``, the default,
which resolves as the JAX rule does: ``"dilated"`` on the TPU and naive
elsewhere -- so naive on CUDA and on the CPU.  The parameter tree is the
same for every value (the one (3, 3, Cin, Cout) conv1 kernel), so the
weight bridge and checkpoints do not change.

``fused_eval=True`` is the counterpart of the JAX pair
``packed_decoder=True, pallas_eval=True``: in eval mode, each decoder
block with <= 32 filters and even H, W runs BN1-affine + ReLU + conv2
as one CUDA kernel (``ops.conv_bn_relu``).  With the default decoder
channels that is blocks 3 and 4: two launches per forward.  The JAX
space-to-depth packing is a TPU lane trick, numerically a plain conv,
and is not ported.

``Unet.forward`` takes NHWC input and returns NHWC logits in
``logits_dtype`` (float32 by default; bfloat16 halves the largest tensor
of a train step and is value-identical when the head computes in bf16);
inside, tensors are NCHW views in channels_last memory.  ``encode`` /
``decode`` split it at the encoder pyramid (kept NCHW), for the
feature-level domain discriminator of ``models.uda``.

``remat`` recomputes activations in the backward instead of saving them,
with the JAX ``Unet``'s modes: ``True`` (encoder and decoder blocks),
``"encoder"``, ``"decoder"``, ``"convs"`` / ``"encoder_convs"`` /
``"decoder_convs"`` (conv outputs saved, each normalize(+ReLU) recomputed)
and ``"stageN..."`` (those encoder stages' blocks).  Every mode computes the
same logits, gradients and BatchNorm buffers as ``remat=False``, and the
parameter names do not change, so checkpoints interchange.  ``clone``
gives the same network under another ``remat``, ``logits_dtype`` or
``fused_decoder``, sharing the parameters and buffers (the JAX
``module.clone``).

Under a height-sharded forward (``parallel.spatial``) the decoder takes
this rank's rows after an upsample from a whole level, and the
``conv_bn_relu`` gate reads the level's global height.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from uda_aerial_semantic_segmentation_research_tpu_torch.models.resnet import (
    _remat_stage_set,
    build_encoder,
    conv,
    encoder_out_channels,
    norm_act,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.batch_norm import (
    BatchNorm,
    checkpoint,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.conv_bn_relu import (
    conv_bn_relu,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.upsample_conv import (
    upsample2x_conv3x3,
    upsample2x_conv3x3_dilated,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.parallel.spatial import current_shard

FUSED_MAX_FILTERS = 32
DILATED_MIN_SIZE = 128    # "dilated" below this input size keeps the naive schedule (JAX)
_KEEP = object()          # a ``clone`` option left as it is
_UP_CONVS = {"phase": upsample2x_conv3x3, "dilated": upsample2x_conv3x3_dilated}


def resolve_fused_decoder(fused_decoder):
    """``Unet``'s ``fused_decoder`` -> ``False``, ``True``, a tuple of block
    indices or ``"dilated"``; ``"auto"`` resolves by the JAX rule to the
    naive schedule off the TPU, so to ``False`` for the port."""
    if fused_decoder == "auto":
        return False
    if fused_decoder == "dilated" or isinstance(fused_decoder, bool):
        return fused_decoder
    if isinstance(fused_decoder, (tuple, list)) and all(
            isinstance(i, int) and not isinstance(i, bool) for i in fused_decoder):
        return tuple(fused_decoder)
    raise ValueError(f"fused_decoder must be True, False, a tuple of block indices, "
                     f"'dilated' or 'auto', got {fused_decoder!r}")


class DecoderBlock(nn.Module):
    """Upsample 2x -> concat skip -> (conv3x3 + BN + ReLU) x 2.

    ``forward(..., fused=impl)`` with ``impl`` ``"phase"`` or ``"dilated"``
    computes conv1 without the upsampled concatenation:
    ``conv3x3(concat(up2(x), skip)) == up_conv(x, W_up) + conv3x3(skip, W_skip)``
    with ``(W_up, W_skip)`` the input-channel slices of the same conv1
    kernel, in the block's dtype (the JAX ``DecoderBlock(fused=True)``)."""

    def __init__(self, cin: int, cskip: int, filters: int,
                 dtype: torch.dtype = torch.bfloat16, fused_eval: bool = False):
        super().__init__()
        self.dtype = dtype
        self.filters = filters
        self.fused_eval = fused_eval
        self.conv1 = conv(cin + cskip, filters, 3)
        self.norm1 = BatchNorm(filters, dtype=dtype)
        self.conv2 = conv(filters, filters, 3)
        self.norm2 = BatchNorm(filters, dtype=dtype)

    def _fused_conv2(self, y):
        """norm1 folded to an affine (as the JAX pallas_eval branch),
        then relu + conv2 in one kernel launch on the NHWC view."""
        inv, bias = self.norm1.folded()
        shift = bias - self.norm1.mean * inv
        # guard the fold against an exactly-zero BN scale, as the JAX fold
        inv = torch.where(inv.abs() < 1e-12, torch.full_like(inv, 1e-12), inv)
        k3 = self.conv2.weight.to(self.dtype).permute(2, 3, 1, 0)   # OIHW -> HWIO
        # under a height-sharded forward: the neighbours' rows attached, their
        # output rows dropped
        shard = current_shard()
        y, keep = shard.kernel_rows(y) if shard is not None else (y, slice(None))
        y2 = conv_bn_relu(y.permute(0, 2, 3, 1).contiguous(), k3, inv, shift)
        return y2.permute(0, 3, 1, 2)[:, :, keep]

    def _fused_conv1(self, x, skip, impl):
        w1 = self.conv1.weight.to(self.dtype)
        cup = x.shape[1]
        y = _UP_CONVS[impl](x.to(self.dtype), w1[:, :cup])
        if skip is not None:
            y = y + F.conv2d(skip.to(self.dtype), w1[:, cup:], padding=1)
        return y

    def forward(self, x, skip: Optional[torch.Tensor] = None, remat_norms: bool = False,
                fused=None):
        shard = current_shard()
        if fused:
            y = self._fused_conv1(x, skip, fused)
        else:
            y = F.interpolate(x.to(self.dtype), scale_factor=2, mode="nearest")
            if shard is not None:      # from a whole level: this rank's rows
                y = shard.own_rows(y)
            if skip is not None:
                y = torch.cat([y, skip.to(self.dtype)], dim=1)
            y = self.conv1(y)
        rows = y.shape[2] if shard is None else shard.global_rows(y)
        if (self.fused_eval and not self.training
                and self.filters <= FUSED_MAX_FILTERS
                and rows % 2 == 0 and y.shape[3] % 2 == 0):
            return torch.relu(self.norm2(self._fused_conv2(y)))
        x = norm_act(self.norm1, y, True, remat_norms)
        return norm_act(self.norm2, self.conv2(x), True, remat_norms)


class UnetDecoder(nn.Module):
    """Five decoder blocks ``block0..block4`` over an NCHW pyramid.
    ``remat``: ``False``, ``True`` (each block recomputed) or ``"convs"``;
    ``fused``: a resolved ``fused_decoder`` (``resolve_fused_decoder``)."""

    def __init__(self, encoder_channels: Sequence[int],
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 dtype: torch.dtype = torch.bfloat16, fused_eval: bool = False,
                 remat=False, fused=False):
        super().__init__()
        self.remat = remat
        self.fused = fused
        # skips: /16, /8, /4, /2, none (features[1:-1] reversed)
        skip_ch = list(encoder_channels[1:-1])[::-1] + [0]
        cin = encoder_channels[-1]
        for i, (ch, cs) in enumerate(zip(decoder_channels, skip_ch)):
            self.add_module(f"block{i}", DecoderBlock(cin, cs, ch, dtype, fused_eval))
            cin = ch
        self.n_blocks = len(decoder_channels)

    def block_schedules(self, size: int):
        """Per block the conv1 schedule at input size ``size``: ``None``
        (naive), ``"phase"`` or ``"dilated"`` (the JAX ``UnetDecoder``'s rule)."""
        impl = "dilated" if self.fused == "dilated" else "phase"
        fused = False if impl == "dilated" and size < DILATED_MIN_SIZE else self.fused
        return [impl if (i in fused if isinstance(fused, tuple) else bool(fused)) else None
                for i in range(self.n_blocks)]

    def forward(self, features):
        skips = list(features[1:-1])[::-1] + [None]
        x = features[-1]
        schedules = self.block_schedules(features[0].shape[2])
        for i, skip in zip(range(self.n_blocks), skips):
            block = getattr(self, f"block{i}")
            if self.remat and self.remat != "convs":
                x = checkpoint(block, x, skip, False, schedules[i])
            else:
                x = block(x, skip, self.remat == "convs", schedules[i])
        return x


def resolve_remat(remat):
    """The U-Net's ``remat`` -> ``(encoder remat, decoder remat)``, by the
    JAX ``Unet.setup``'s table."""
    if remat == "convs":
        return "convs", "convs"
    if remat == "encoder_convs":
        return "convs", False
    if remat == "decoder_convs":
        return False, "convs"
    if isinstance(remat, str) and remat.startswith("stage"):
        return remat, False
    return (remat is True or remat == "encoder"), (remat is True or remat == "decoder")


class Unet(nn.Module):
    """Encoder-decoder semantic segmentation network (NHWC in and out)."""

    def __init__(self, encoder_name: str = "resnet34", classes: int = 23,
                 in_channels: int = 3,
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 activation: Optional[str] = None,
                 dtype: torch.dtype = torch.bfloat16, fused_eval: bool = False,
                 remat=False, logits_dtype: torch.dtype = torch.float32,
                 fused_decoder="auto"):
        super().__init__()
        if activation not in (None, "softmax", "sigmoid"):
            raise ValueError(f"unknown activation {activation!r}")
        self.classes = classes
        self.activation = activation
        self.dtype = dtype
        self.remat = remat
        self.logits_dtype = logits_dtype
        enc_remat, dec_remat = resolve_remat(remat)
        self.encoder = build_encoder(encoder_name, in_channels, dtype, remat=enc_remat)
        self.fused_decoder = fused_decoder
        self.decoder = UnetDecoder(encoder_out_channels(encoder_name),
                                   decoder_channels, dtype, fused_eval, remat=dec_remat,
                                   fused=resolve_fused_decoder(fused_decoder))
        self.segmentation_head = conv(decoder_channels[-1], classes, 3, bias=True)

    def clone(self, *, remat=_KEEP, logits_dtype=_KEEP, fused_decoder=_KEEP) -> "Unet":
        """This U-Net with another ``remat``, ``logits_dtype`` and/or
        ``fused_decoder`` (the JAX ``module.clone``), for running forwards and
        backwards only.  The options are the clone's own, so
        ``self`` computes as before; every parameter, buffer and block is
        ``self``'s, shared and not copied.  So module-state calls belong on
        ``self``: on the clone, ``.to()``, ``.half()``, ``register_buffer``
        or a hook change the shared dicts and blocks without a word, and
        ``train()`` / ``eval()`` set the shared blocks' mode but leave
        ``self.training`` as it was."""
        new = copy.copy(self)
        new._modules = dict(self._modules)
        if remat is not _KEEP:
            enc_remat, dec_remat = resolve_remat(remat)
            _remat_stage_set(enc_remat)
            new.remat = remat
            for name, value in (("encoder", enc_remat), ("decoder", dec_remat)):
                part = copy.copy(getattr(self, name))
                part.remat = value
                setattr(new, name, part)
        if logits_dtype is not _KEEP:
            new.logits_dtype = logits_dtype
        if fused_decoder is not _KEEP:
            part = copy.copy(new.decoder)
            part.fused = resolve_fused_decoder(fused_decoder)
            new.fused_decoder = fused_decoder
            new.decoder = part
        return new

    def encode(self, x):
        """(B, H, W, in_channels) -> the encoder pyramid ``[identity, /2, /4,
        /8, /16, /32]`` in the internal NCHW form (channels_last memory)."""
        return self.encoder.features(x.permute(0, 3, 1, 2))

    def _logits(self, features):
        return self.segmentation_head(self.decoder(features)).to(self.logits_dtype)

    def decode(self, features):
        """The pyramid of ``encode`` -> logits (B, H, W, classes) in
        ``logits_dtype``, before any ``activation`` (the JAX ``Unet.decode``)."""
        return self._logits(features).permute(0, 2, 3, 1).contiguous()

    def forward(self, x):
        """(B, H, W, in_channels) -> logits (B, H, W, classes) in ``logits_dtype``."""
        y = self._logits(self.encode(x))
        if self.activation == "softmax":
            y = torch.softmax(y, dim=1)
        elif self.activation == "sigmoid":
            y = torch.sigmoid(y)
        return y.permute(0, 2, 3, 1).contiguous()
