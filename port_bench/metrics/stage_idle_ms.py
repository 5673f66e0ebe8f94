"""Device idle ms a step under ``prefetch_to_device``'s staging of the
batches (``uda.data.stage``: the masks' range check and narrowing, the
pinned copy, the copy issued)."""

from port_bench.spans import idle_ms_per_step


def read(t):
    return idle_ms_per_step(t, "uda.data.stage")
