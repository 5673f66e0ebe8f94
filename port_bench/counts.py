"""Operations and bytes of a configuration, from its layer shapes.

What the roofline and utilization metrics divide by.  Counted from the
architecture's layer tables alone (the ``conv_layers`` and ``bn_inputs``
of the configuration's reference module), never from the program:

- a convolution's forward is ``2 * cin * k * k * cout * hout * wout``
  operations an image; a train step counts it three times (the backward
  at twice the forward), with no recompute, and nothing for the
  augmentation, the normalizations or the elementwise work;
- a train-mode BatchNorm input of ``n`` elements moves ``n * itemsize``
  bytes through the forward's channel sums and ``2 * n * itemsize``
  (the output gradient and the input) through the backward's dual sums,
  each read once, plus its per-channel float32 sums written once.
"""

from __future__ import annotations


def forward_flops(conv_layers) -> int:
    """Operations of one image's forward through ``conv_layers``
    (``[(name, cin, cout, k, stride, hout, wout)]``)."""
    return sum(2 * cin * k * k * cout * h * w for _n, cin, cout, k, _s, h, w in conv_layers)


def train_step_flops(conv_layers, batch: int) -> int:
    """Operations of a train step: forward and a backward at twice it."""
    return 3 * forward_flops(conv_layers) * batch


def serve_flops(conv_layers, batch: int) -> int:
    """Operations of a serving request of ``batch`` images (forward only)."""
    return forward_flops(conv_layers) * batch


def bn_sums_bytes(bn_inputs, batch: int, itemsize: int = 2) -> int:
    """Bytes the channel sums of a train step must move over ``bn_inputs``
    (``[(name, channels, h, w)]`` of one image): every BatchNorm input
    read once forward, it and its output gradient read once backward, and
    two float32 sums a channel written by each pass."""
    total = 0
    for _name, c, h, w in bn_inputs:
        n = batch * c * h * w
        total += n * itemsize + 2 * n * itemsize + 2 * (2 * c * 4)
    return total
