"""p95 over the window's requests of the time from the call of
``predict_batch`` to the labels in host memory (host clock), in ms."""


def read(t):
    return t.info.get("latency_ms_p95")
