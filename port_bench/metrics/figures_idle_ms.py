"""Device idle ms a step under the trainer's figure logging
(``uda.trainer.figures`` and the spans inside it)."""

from port_bench.spans import idle_ms_per_step


def read(t):
    return idle_ms_per_step(t, "uda.trainer.figures")
