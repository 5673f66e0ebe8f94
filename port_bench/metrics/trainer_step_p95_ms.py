"""p95 of the trainer's own step times (its ``StepTimer``, host clock, one
step of lag) over the window's epoch, in ms."""


def read(t):
    summary = t.info.get("step_timer") or {}
    return summary.get("step_ms_p95")
