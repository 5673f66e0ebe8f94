"""Device ms a step (training) or a request (serving) in the elementwise
and cast categories: BatchNorm's normalize, ReLU, adds, casts."""

NAMES = ("elementwise (BatchNorm, ReLU, add, normalize)", "copy / dtype cast")


def read(t):
    if not t.steps:
        return None
    return t.category_s(*NAMES) / t.steps * 1e3
