"""Device ms a step of host-to-device copies (the loader's batches)."""


def read(t):
    if not t.steps:
        return None
    return t.memcpy_s("HtoD") / t.steps * 1e3
