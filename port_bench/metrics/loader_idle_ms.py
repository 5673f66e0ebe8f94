"""Device idle ms a step while the trainer waits for the ``DataLoader``'s
next batch (``uda.data.wait``)."""

from port_bench.spans import idle_ms_per_step


def read(t):
    return idle_ms_per_step(t, "uda.data.wait")
