"""What every driver shares.  A traffic mix's ``kind`` names its driver,
``kinds/<kind>.py`` (found by ``spec``), which holds a ``Driver`` built on
the class here and the ``FAULTS`` the kind can have.

A driver has ``setup()``, ``window(seconds, tracer)``, ``free()`` (drops
the program's state) and ``check(control=False, shared=None)`` (the
reference's judgement, run after ``free``: the compared numbers of the
program, or with ``control`` of the control in the program's place;
``shared`` is a dict that drivers of one cell and seed may fill with what
stays the same across them, such as the reference's own readings).  It
fills ``self.result``.  ``CHECK_NEEDS_WINDOW`` says whether ``check``
judges what a window produced (else what set-up produced).
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch

from port_bench import inputs


@contextlib.contextmanager
def patched(owner, name, value):
    """``owner.name`` replaced by ``value`` while the block runs."""
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


class Driver:
    CHECK_NEEDS_WINDOW = True

    def __init__(self, cell, seed: int, device, tmpdir: str):
        self.cell, self.cfg, self.traffic = cell, cell.config, cell.traffic
        self.seed, self.device, self.tmpdir = seed, torch.device(device), tmpdir
        self.net = functools.partial(cell.arch.Net, self.cfg)
        self.result = {"attempted": 0, "failed": 0, "metrics": {}, "info": {}}
        self.setup_parts, self._mark = {}, time.perf_counter()

    def lap(self, part: str):
        """Seconds since the last lap, under ``part`` (set-up's breakdown)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.setup_parts[part] = now - self._mark
        self._mark = now

    def build_model(self):
        """The program's model as the configuration's builder makes it, on
        the device, checked against the reference's parameter tree, with
        the seed's weights loaded (also kept as ``self.w0`` for the
        reference)."""
        model = self.cell.builder.build(self.cfg, self.device)
        spec = self.cell.arch.weight_spec(self.cfg)
        have = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        want = {name: tuple(shape) for name, shape, _ in spec}
        if have != want:
            raise ValueError(f"the program's model differs from the reference's: "
                             f"{sorted(set(have.items()) ^ set(want.items()))[:8]}")
        self.lap("build model")
        self.w0 = inputs.make_weights(spec, self.seed, self.device)
        model.load_state_dict(self.w0)
        self.lap("weights")
        return model

    def peak_reset(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak_bytes(self) -> int:
        return (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)

    def free(self):
        for name in ("model", "trainer", "state"):
            self.__dict__.pop(name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
