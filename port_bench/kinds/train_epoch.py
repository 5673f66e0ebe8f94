"""Traffic kind ``train_epoch``: ``SegmentationTrainer.train_epoch`` over
the port's ``DataLoader`` on an in-memory ring of tiles, prepared as
``SegmentationTrainer.train`` prepares it.

Set-up runs the first three steps through that same call and feed (one
epoch of one batch, then one of two), which warms every shape the window
uses; the window is one more epoch over seeded permutations of the ring
without end, whose loader stops yielding when the window's time is up.
The mix's file gives ``batch``, ``tile`` and ``ring_tiles``.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import time

import numpy as np
import torch

from port_bench import check, counts, inputs, trainer_access
from port_bench.drivers import Driver as _Driver
from port_bench.drivers import patched
from port_bench.reference import train as ref_train
from port_bench.reference import disable_tf32

LEARNING_RATE = 1e-4      # SegmentationTrainer.train's, as train_model passes Config's
SETUP_STEPS = 3           # steps the reference follows: epoch 1 of one, epoch 2 of two
WINDOW_EPOCH = 3
BN_MOMENTUM = 0.9         # the port's running-statistics decay (flax's convention)
LOADER_STEPS = 1024       # batches one DataLoader of the window serves before the next


def epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The augmentation generator the trainer makes for ``epoch`` with
    ``Config.SEED = seed``, by the formula its module documents."""
    value = np.random.SeedSequence([seed, epoch]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(value) & ((1 << 63) - 1))


def batch_statistics(model, initial: dict) -> dict:
    """Each BatchNorm's batch ``(mean, biased var)`` of the one step since
    ``initial``, from its running buffers: the port documents them as
    ``ra = 0.9 * ra + 0.1 * batch``."""
    buffers = dict(model.named_buffers())
    out = {}
    for key in buffers:
        if key.endswith(".mean"):
            name = key[:-len(".mean")]
            out[name] = tuple((buffers[f"{name}.{s}"].detach() - BN_MOMENTUM
                               * initial[f"{name}.{s}"]) / (1 - BN_MOMENTUM)
                              for s in ("mean", "var"))
    return out


def leaf_norms(tensors: dict) -> dict:
    return {k: float(v) for k, v in zip(tensors, torch._foreach_norm(list(tensors.values())))}


class RingDataset:
    """Tiles in host memory with the ``load_raw`` contract of the port's
    datasets: (uint8 HWC image, int32 HW mask)."""

    def __init__(self, images, masks):
        self.images, self.masks = images, masks

    def __len__(self):
        return len(self.images)

    def load_raw(self, idx):
        return self.images[idx], self.masks[idx]

    __getitem__ = load_raw


class WindowLoader:
    """Batches of the port's loader over ``indices`` (an endless iterator),
    ``LOADER_STEPS`` batches a loader, cut off when the window's time is
    up: no batch asked for after ``deadline`` (``time.perf_counter``) is
    yielded."""

    def __init__(self, make_loader, indices, batch_size: int, deadline: float):
        self.make_loader, self.indices = make_loader, indices
        self.batch_size, self.deadline, self.batches = batch_size, deadline, 0

    def iter_raw(self):
        while True:
            chunk = list(itertools.islice(self.indices, LOADER_STEPS * self.batch_size))
            batches = self.make_loader(chunk).iter_raw()
            try:
                for batch in batches:
                    if time.perf_counter() >= self.deadline:
                        return
                    self.batches += 1
                    yield batch
            finally:
                batches.close()          # stops the loader's thread


class Driver(_Driver):
    CHECK_NEEDS_WINDOW = False        # the check follows set-up's three steps

    def free(self):
        self.trainer.logger.close()
        super().free()

    def setup(self):
        from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
        from uda_aerial_semantic_segmentation_research_tpu_torch.data.loader import DataLoader
        from uda_aerial_semantic_segmentation_research_tpu_torch.training.train import (
            SegmentationTrainer,
        )

        t = self.traffic
        self.batch, self.tile = t["batch"], t["tile"]
        self.config_seed = inputs.data_seed(self.seed)
        Config.SEED = self.config_seed
        self.lap("imports")
        self.model = self.build_model()
        images, masks = inputs.make_tiles(self.seed, t["ring_tiles"], self.tile,
                                          self.cfg["classes"], self.device)
        self.dataset = RingDataset(images, masks)
        self.lap("tiles")
        b = self.batch
        self.order = inputs.order(self.seed, len(images), SETUP_STEPS * b)

        def loader(indices):
            return DataLoader(self.dataset, batch_size=b, sampler=indices, drop_last=False,
                              num_workers=Config.NUM_WORKERS)

        self.loader = loader
        self.trainer = SegmentationTrainer(self.model, self.device,
                                           log_dir=f"{self.tmpdir}/logs")
        self.losses = trainer_access.tap_losses(self.trainer)
        first = loader(self.order[:b])
        self.state = trainer_access.prepare(self.trainer, first, LEARNING_RATE)
        self.state, _ = self.trainer.train_epoch(first, self.state, 1)
        self.lap("step 1")
        self.program = {"stats1": batch_statistics(self.model, self.w0)}
        beta1 = self.state.optimizer.defaults["betas"][0]
        opt_state = self.state.optimizer.state
        self.program["grad1"] = {
            k: n / (1 - beta1) for k, n in leaf_norms({
                k: (opt_state[p]["exp_avg"] if p in opt_state else torch.zeros_like(p))
                for k, p in self.model.named_parameters()}).items()}
        self.state, _ = self.trainer.train_epoch(loader(self.order[b:SETUP_STEPS * b]),
                                                 self.state, 2)
        self.program["change"] = leaf_norms({k: p.detach() - self.w0[k]
                                             for k, p in self.model.named_parameters()})
        self.program["loss"] = list(self.losses)
        self.lap("steps 2-3")

    def window(self, seconds: float, tracer):
        b = self.batch
        # the seed's order after set-up's batches, without end
        indices = itertools.islice(inputs.orders(self.seed, len(self.dataset)),
                                   SETUP_STEPS * b, None)
        self.peak_reset()
        with tracer.window():        # the clock starts once a tracer is running
            start = time.perf_counter()
            feed = WindowLoader(self.loader, indices, b, start + seconds)
            self.state, _ = self.trainer.train_epoch(feed, self.state, WINDOW_EPOCH)
            window_s = time.perf_counter() - start
        peak = self.peak_bytes()
        steps = feed.batches
        window_losses = self.losses[SETUP_STEPS:]
        if len(window_losses) != steps:
            raise RuntimeError(f"{steps} batches fed, {len(window_losses)} losses logged")
        self.result.update(attempted=steps,
                           failed=sum(not math.isfinite(v) for v in window_losses))
        self.result["metrics"] = {"train_tiles_per_s": steps * b / window_s,
                                  "peak_gib": peak / 2 ** 30}
        arch = self.cell.arch
        self.result["info"].update({
            "steps": steps, "items_per_step": b, "window_s": window_s,
            "flops_per_step": counts.train_step_flops(arch.conv_layers(self.cfg, self.tile), b),
            "sums_bytes_per_step": counts.bn_sums_bytes(arch.bn_inputs(self.cfg, self.tile), b),
            "step_timer": self.trainer.timer.summary(), "memory_peak_bytes": peak})

    def _batches(self):
        """The first steps' uint8 batches on the device, and their
        augmentation generators as the trainer seeds them."""
        b = self.batch
        images, masks = self.dataset.images, self.dataset.masks
        batches = []
        for i in range(SETUP_STEPS):
            idx = self.order[i * b:(i + 1) * b]
            batches.append((torch.from_numpy(images[idx]).to(self.device),
                            torch.from_numpy(masks[idx]).to(self.device)))
        g1 = epoch_generator(self.config_seed, 1, self.device)
        g2 = epoch_generator(self.config_seed, 2, self.device)
        return batches, [g1, g2, g2]

    def follow(self, quant=None) -> dict:
        """The reference's first steps from the seed (``quant="fp8"``: the
        control's)."""
        disable_tf32()
        batches, generators = self._batches()
        return ref_train.follow(self.net, self.w0, batches, generators, LEARNING_RATE,
                                quant=quant, remat=True)

    def check(self, control: bool = False, shared=None) -> dict:
        """The program's first steps against the reference's; with
        ``control`` the control's readings stand in for the program's."""
        shared = {} if shared is None else shared
        if "reference" not in shared:
            shared["reference"] = self.follow()
        reference = shared["reference"]
        program = self.follow("fp8") if control else self.program
        self.result["info"]["leaves_left_out"] = check.left_out(reference)
        return check.training_numbers(program, reference)


@contextlib.contextmanager
def frozen_state():
    """A train step that returns its state unchanged: no update is made."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import TrainState

    with patched(TrainState, "apply_gradients", lambda self, finite=None: self):
        yield


@contextlib.contextmanager
def half_batch():
    """A train step that leaves out the second half of its batch: the loss
    is the mean over the rest."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.training import steps

    make = steps.make_supervised_train_step

    def make_half(*args, **kwargs):
        step = make(*args, **kwargs)

        def half(state, generator, images, masks, *rest, **kw):
            n = images.shape[0] // 2
            return step(state, generator, images[:n], masks[:n], *rest, **kw)

        return half

    with patched(steps, "make_supervised_train_step", make_half):
        yield


FAULTS = {"frozen_state": frozen_state, "half_batch": half_batch}
