"""Device idle ms a step under the host's call of the train step
(``uda.step.train`` and the spans inside it: augmentation, BatchNorm)."""

from port_bench.spans import idle_ms_per_step


def read(t):
    return idle_ms_per_step(t, "uda.step.train")
