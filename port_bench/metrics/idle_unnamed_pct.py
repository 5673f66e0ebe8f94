"""The share of the window's device idle time, in %, under none of the
program's spans, or under the outer span alone (``uda.trainer.step`` in
training, ``uda.serve.request`` in serving)."""

from port_bench.spans import unnamed_idle_pct


def read(t):
    return unnamed_idle_pct(t)
