"""Profiling and per-step timing utilities.

Counterpart of the JAX package's ``utils/profiling.py``:

- ``trace(logdir)``: a ``torch.profiler`` trace of the enclosed block
  (host and, with a GPU, device activity), written to ``logdir`` as a
  Chrome trace that TensorBoard's profile plugin and ``chrome://tracing``
  read;
- ``annotate(name)``: a named span on the timeline (``record_function``);
- ``StepTimer``: wall-clock step times after warm-up, p50 / p95 and
  items per second.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str = "logs/profile"):
    """Capture a ``torch.profiler`` trace of the enclosed block into ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Named span on the host and device timelines (``record_function``)."""
    return torch.profiler.record_function(name)


def _wait_for(t: torch.Tensor) -> None:
    """Block until the work queued on ``t``'s device stream has finished
    (a CPU tensor is ready when it exists)."""
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


class StepTimer:
    """Wall-clock step timing with explicit device synchronization.

    Usage::

        timer = StepTimer(items_per_step=batch_size)
        for batch in loader:
            with timer.step(sync=metrics["loss"]):
                state, metrics = train_step(state, ...)
        print(timer.summary())

    ``sync``: a tensor whose device stream is waited for before the step's
    time is taken; without it the time is the host's.
    """

    def __init__(self, items_per_step: int = 1, warmup: int = 2):
        self.items_per_step = items_per_step
        self.warmup = warmup
        self.times: List[float] = []
        self._n_seen = 0

    @contextlib.contextmanager
    def step(self, sync=None):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            _wait_for(sync)
        self.record(time.perf_counter() - t0)

    def record(self, seconds: float):
        self._n_seen += 1
        if self._n_seen > self.warmup:
            self.times.append(seconds)

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {"steps": 0}
        t = np.asarray(self.times)
        return {
            "steps": len(t),
            "step_ms_p50": float(np.percentile(t, 50) * 1e3),
            "step_ms_p95": float(np.percentile(t, 95) * 1e3),
            "steps_per_sec": float(1.0 / t.mean()),
            "items_per_sec": float(self.items_per_step / t.mean()),
        }
