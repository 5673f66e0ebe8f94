"""Fused nearest-upsample-2x + 3x3 convolution (exact decompositions).

Counterpart of the JAX package's ``ops/upsample_conv.py``.  The U-Net
decoder's ``conv3x3(nearest_up2(x))`` computed naively materializes the
4x larger upsampled tensor and runs 9 taps over 4x the positions.  Nearest
upsampling duplicates pixels, so the composition is exactly:

- ``upsample2x_conv3x3``: four 2x2 convolutions on the small input, one
  per output phase ``(r, s)`` in {0, 1}^2, whose kernels are partial sums
  of the 3x3 kernel (``_phase_kernels``), run as ONE convolution of
  ``(4 * Cout, Cin, 2, 2)`` at padding 1 and interleaved back
  (depth-to-space);
- ``upsample2x_conv3x3_dilated``: one convolution of the 2x-dilated input
  with a 4x4 kernel whose taps are the 3x3 taps that land on the same
  source pixel, summed in float32 -- on the card a transposed convolution
  (``F.conv_transpose2d``, stride 2) with that kernel flipped.

Both equal ``conv3x3_same(nearest_up2(x))`` to float rounding.  These are
convolutions that the JAX package computes with ``lax.conv`` outside any
Pallas kernel, so the port calls the library's (cuDNN's) convolutions.

Layout: ``x`` is NCHW (a channels_last tensor stays channels_last) and the
kernel OIHW, as the port's ``Conv2d`` holds it; the result is NCHW of
``2H x 2W`` in ``x``'s dtype.  As in the JAX functions the phase kernels
are summed in ``x``'s dtype and the dilated kernel in float32, then cast.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _phase_kernels(kernel):
    """(Cout, Cin, 3, 3) OIHW -> {(r, s): (Cout, Cin, 2, 2)} phase kernels.

    Row grouping (dy -> source row offset a in {0, 1} of the 2-tap):
      r=0: taps (m-1, m):   a0 = W[0],        a1 = W[1] + W[2]
      r=1: taps (m, m+1):   a0 = W[0] + W[1], a1 = W[2]
    and identically for columns.
    """
    k = kernel
    rows = {
        0: torch.stack([k[:, :, 0], k[:, :, 1] + k[:, :, 2]], dim=2),     # (O, I, 2, 3)
        1: torch.stack([k[:, :, 0] + k[:, :, 1], k[:, :, 2]], dim=2),
    }

    def cols(a, s):
        if s == 0:
            return torch.stack([a[..., 0], a[..., 1] + a[..., 2]], dim=-1)   # (O, I, 2, 2)
        return torch.stack([a[..., 0] + a[..., 1], a[..., 2]], dim=-1)

    return {(r, s): cols(rows[r], s) for r in (0, 1) for s in (0, 1)}


def upsample2x_conv3x3(x, kernel):
    """conv3x3-SAME over the nearest-2x upsampling of ``x``, as one
    convolution of the four phase kernels (``(4 * Cout, Cin, 2, 2)``, padding
    1, over the ``(H+1, W+1)`` window grid that all phases share) and the
    phase interleave.  ``x`` (B, Cin, H, W); ``kernel`` (Cout, Cin, 3, 3)."""
    b, _, h, w = x.shape
    cout = kernel.shape[0]
    phases = _phase_kernels(kernel.to(x.dtype))
    k_all = torch.cat([phases[(r, s)] for r in (0, 1) for s in (0, 1)], dim=0)
    y = F.conv2d(x, k_all, padding=1).permute(0, 2, 3, 1)     # (B, H+1, W+1, 4 * Cout)

    def phase(g, r, s):
        return y[:, r:r + h, s:s + w, g * cout:(g + 1) * cout]

    # interleave the phases: (B, H, 2, W, 2, Cout) -> (B, 2H, 2W, Cout)
    top = torch.stack([phase(0, 0, 0), phase(1, 0, 1)], dim=3)
    bot = torch.stack([phase(2, 1, 0), phase(3, 1, 1)], dim=3)
    out = torch.stack([top, bot], dim=2).reshape(b, 2 * h, 2 * w, cout)
    return out.permute(0, 3, 1, 2)


def dilated_kernel(kernel):
    """(Cout, Cin, 3, 3) -> the (Cout, Cin, 4, 4) float32 kernel over the
    2x-dilated input: ``k4[t, s] = sum_{dy in T(t), dx in T(s)} w[dy, dx]``
    with T(0)={0}, T(1)={0,1}, T(2)={1,2}, T(3)={2} (the JAX ``_FOLD``
    matrix), summed by slices on the kernel's device: no constant to copy
    there, so nothing that a CUDA graph capture refuses."""

    def fold(a, dim):
        t = [a.select(dim, i) for i in range(3)]
        return torch.stack([t[0], t[0] + t[1], t[1] + t[2], t[2]], dim=dim)

    return fold(fold(kernel.float(), 2), 3)


def upsample2x_conv3x3_dilated(x, kernel):
    """conv3x3-SAME over the nearest-2x upsampling of ``x`` as ONE
    convolution of the 2x-dilated input (padding 2) with the tap-folded 4x4
    kernel (``dilated_kernel``, cast to ``x``'s dtype): 16 tap-multiplies per
    2x2 output quad instead of 36, no interleave.  Run as the equivalent
    transposed convolution (stride 2, padding 1, the kernel flipped and its
    in/out axes swapped).  ``x`` (B, Cin, H, W); ``kernel`` (Cout, Cin, 3, 3)."""
    k4 = dilated_kernel(kernel).to(x.dtype)
    return F.conv_transpose2d(x, k4.flip(2, 3).transpose(0, 1), stride=2, padding=1)
