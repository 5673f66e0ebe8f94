"""Device ms a step (training) or a request (serving) in cuDNN's
convolution kernels."""


def read(t):
    if not t.steps:
        return None
    return t.category_s("cuDNN convolution") / t.steps * 1e3
