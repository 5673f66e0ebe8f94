"""Device ms a step in the kernels that run the depthwise convs (the 3x3
of each separable conv, ``groups`` = channels), forward and backward, by the
names cuDNN gives them on the H100: for a dilated one the grouped direct
forward, its layout transforms (``tensorTransformGeneric``), a grouped
(``_g16_``) indexed weight-gradient GEMM and ``dgrad2d_c1_k1_nhwc``; for
an undilated one the ``c1_k1`` forward, data- and weight-gradient kernels.
No dense conv of the cell launches any of them."""

NAMES = ("conv2d_grouped_direct_kernel", "tensorTransformGeneric", "conv2d_c1_k1_nhwc",
         "dgrad2d_c1_k1_nhwc", "wgrad2d_c1_k1_nhwc")


def _depthwise(e) -> bool:
    name = e["name"]
    return e["cat"] == "kernel" and (any(k in name for k in NAMES) or (
        "wgrad_implicit_gemm_indexed" in name and "_g16_" in name))


def read(t):
    if not t.steps:
        return None
    ms = t.device_s(_depthwise) / t.steps * 1e3
    return ms if ms > 0 else None
