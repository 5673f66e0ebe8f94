"""The channel sums kernels' share of their roofline, in %: the bytes a
train step's BatchNorm inputs must move through them (``counts``) at the
card's HBM bandwidth, over their device time."""

from port_bench.peaks import HBM_BYTES_PER_S


def read(t):
    kernel_s = t.category_s("channel_sums kernels")
    if not t.steps or kernel_s <= 0:
        return None
    return t.info["sums_bytes_per_step"] * t.steps / HBM_BYTES_PER_S / kernel_s * 100.0
