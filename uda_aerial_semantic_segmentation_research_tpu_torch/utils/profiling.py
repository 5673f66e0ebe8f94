"""Profiling and per-step timing utilities.

Counterpart of the JAX package's ``utils/profiling.py``:

- ``trace(logdir)``: a ``torch.profiler`` trace of the enclosed block
  (host and, with a GPU, device activity), written to ``logdir`` as a
  Chrome trace that TensorBoard's profile plugin and ``chrome://tracing``
  read;
- ``annotate(name)``: a named span on the timeline (``record_function``)
  while a profiler runs, and a shared null context otherwise;
- ``StepTimer``: wall-clock step times after warm-up, p50 / p95 and
  items per second.

The program's spans are named ``uda.<layer>.<stage>``, so that a reader of
a trace tells them from torch's own annotations:

- ``uda.trainer.step`` (one step of ``SegmentationTrainer.train_epoch``, the
  interval its ``StepTimer`` times), ``uda.trainer.log`` (one step's
  read-back and logging) and ``uda.trainer.figures`` (a figure step's
  figures and per-class scalars);
- ``uda.data.wait`` (``DataLoader``: one batch awaited from the worker
  threads, or fetched and stacked without them) and ``uda.data.stage``
  (``prefetch_to_device``: one batch narrowed, pinned and its copy issued);
- ``uda.step.train`` (the supervised train step) and ``uda.step.augment``
  (its augmentation);
- ``uda.bn.train``, ``uda.bn.train_backward`` (on autograd's thread) and
  ``uda.bn.eval`` (``ops.batch_norm.BatchNorm``);
- ``uda.serve.request`` (``predict_batch``) and, inside it,
  ``uda.serve.upload``, ``uda.serve.forward`` and ``uda.serve.download``.
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


_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """Named span on the host timeline of the running profiler, on its
    clock (``record_function``); with no profiler running, one shared null
    context, so that a span costs one check of the profiler's state."""
    if not torch._C._autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


class StepTimer:
    """Host wall-clock step timing.

    Usage::

        timer = StepTimer(items_per_step=batch_size)
        for batch in loader:
            with timer.step():
                state, metrics = train_step(state, ...)
        print(timer.summary())

    The time is the host's: a step that only queues device work is timed
    as long as the host took.  ``SegmentationTrainer.train_epoch`` times the
    dispatch of step N plus the read of step N-1, which waits for step N-1's
    end alone; staging the next batch falls outside the block.  So with a
    step queued on the card its times are the device's step less the host
    work outside the block, not the loop's period: its ``items_per_sec`` is
    no rate of the loop.
    """

    def __init__(self, items_per_step: int = 1, warmup: int = 2):
        self.items_per_step = items_per_step
        self.warmup = warmup
        self.times: List[float] = []
        self._n_seen = 0

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
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
