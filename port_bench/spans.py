"""The device's idle time in the traced window, put down to the program's
spans.

The program opens spans named ``uda.<layer>.<stage>`` on the profiler's
clock (``utils/profiling.py::annotate`` in the port); the trace keeps those
of the thread that runs the window among its host events, where they nest.
The window's idle time is the complement of the device's merged kernel,
copy and fill intervals (``Trace.busy_s``'s union).  Each idle interval is
cut where the spans open and close, and each piece goes to the spans open
over it, the innermost first: a metric of a span sums its pieces and those
of every span inside it.  Idle under no span, or under an outer span alone
(``OUTER``: a training step, a request), is unnamed.
"""

from __future__ import annotations

from port_bench.trace import _merged

PREFIX = "uda."
OUTER = ("uda.trainer.step", "uda.serve.request")


def idle_intervals(t) -> list:
    """The window's ``(start, end)`` intervals (µs) with nothing on the
    device, in order."""
    start, end = t.window
    busy = _merged([(max(e["ts"], start), min(e["ts"] + e["dur"], end)) for e in t.device])
    out, cursor = [], start
    for s, e in busy:
        if s > cursor:
            out.append((cursor, s))
        cursor = max(cursor, e)
    if cursor < end:
        out.append((cursor, end))
    return out


def _segments(spans) -> list:
    """The spans' timeline as disjoint ``(start, end, names)`` pieces, in
    order; ``names`` the spans open over the piece, outermost first."""
    out, stack, cursor = [], [], None

    def advance(to):
        nonlocal cursor
        while stack and stack[-1][0] <= to:
            end = stack[-1][0]
            if end > cursor:
                out.append((cursor, end, tuple(n for _, n in stack)))
                cursor = end
            stack.pop()
        if stack and to > cursor:
            out.append((cursor, to, tuple(n for _, n in stack)))
        cursor = to if cursor is None else max(cursor, to)

    for s in sorted(spans, key=lambda s: (s["ts"], -s["dur"])):
        advance(s["ts"])
        stack.append((s["ts"] + s["dur"], s["name"]))
    if stack:
        advance(max(end for end, _ in stack))
    return out


def idle_pieces(t):
    """``(idle intervals, [(µs, names), ...])``: the idle time under the
    program's spans, by the spans open over it; None without spans."""
    spans = [h for h in t.host if h["name"].startswith(PREFIX)]
    if not spans:
        return None
    idle = idle_intervals(t)
    pieces, i = [], 0
    for s, e, names in _segments(spans):
        while i < len(idle) and idle[i][1] <= s:
            i += 1
        j = i
        while j < len(idle) and idle[j][0] < e:
            lo, hi = max(s, idle[j][0]), min(e, idle[j][1])
            if hi > lo:
                pieces.append((hi - lo, names))
            j += 1
    return idle, pieces


def idle_ms_per_step(t, name: str):
    """Device idle ms a step under span ``name`` and the spans inside it;
    None without steps or spans."""
    found = idle_pieces(t)
    if not t.steps or found is None:
        return None
    return sum(us for us, names in found[1] if name in names) / 1e3 / t.steps


def unnamed_idle_pct(t):
    """The share of the window's idle time, in %, under no span or under an
    ``OUTER`` span alone; None without steps or spans."""
    found = idle_pieces(t)
    if not t.steps or found is None:
        return None
    idle, pieces = found
    total = sum(e - s for s, e in idle)
    if total <= 0:
        return 0.0
    named = sum(us for us, names in pieces if names[-1] not in OUTER)
    return (total - named) / total * 100.0
