"""Device ms a step in the model's bilinear resize kernels, forward and
backward: ``upsample_bilinear2d`` kernels on bfloat16 (the augmentation's
bilinear resize of its float32 displacement fields is left out)."""


def _model_bilinear(e) -> bool:
    name = e["name"]
    return e["cat"] == "kernel" and "upsample_bilinear2d" in name and "BFloat16" in name


def read(t):
    if not t.steps:
        return None
    ms = t.device_s(_model_bilinear) / t.steps * 1e3
    return ms if ms > 0 else None
