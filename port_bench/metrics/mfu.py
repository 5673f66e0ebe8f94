"""The whole step's share of the card's bf16 peak, in %: the model's
convolution operations a step (``counts``; a train step's backward at
twice its forward) over the traced window's time a step."""

from port_bench.peaks import BF16_FLOPS


def read(t):
    if not t.steps or t.window_s <= 0:
        return None
    return t.info["flops_per_step"] * t.steps / t.window_s / BF16_FLOPS * 100.0
