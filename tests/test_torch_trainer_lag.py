"""The phase-1 trainer's one-step-lagged read of its logged scalars.

``SegmentationTrainer.train_epoch`` queues each step's loss, IoU and
accuracy for the host at the end of that step (``train._QueuedScalars``)
and reads step N-1's after dispatching step N.  On the CPU (tier-1) the
logged floats are each step's own, in order and at their global steps,
and ``perf/lag_held_share`` is logged only where a read can find the next
step still running.  On the card (``-m gpu``; they skip here, and import
no JAX: ``python -m pytest --noconftest -m gpu tests/test_torch_trainer_lag.py``)
a read returns while the next step is still queued, and one real phase-1
step makes no synchronizing call.
"""

import math

import numpy as np
import pytest
import torch

from uda_aerial_semantic_segmentation_research_tpu_torch.data import dataset, loader
from uda_aerial_semantic_segmentation_research_tpu_torch.models import create_unet
from uda_aerial_semantic_segmentation_research_tpu_torch.training import train
from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import (
    TrainState,
    adam,
)

SIZE, CLASSES, BATCH, BATCHES, EPOCH = 64, 7, 2, 4, 2
LOGGED = ("train/loss", "train/iou", "train/accuracy")
SLEEP_MS = 100        # the stub step's device time


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads: the tier-1 run has six workers on eight cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tiles(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8),
            rng.integers(0, CLASSES, (n, SIZE, SIZE)).astype(np.int32))


def _loader(n, seed=0):
    images, masks = _tiles(n, seed)
    return loader.DataLoader(dataset.Subset(list(zip(images, masks)), list(range(n))),
                             batch_size=BATCH)


def _trainer(model, device, log_dir):
    """A trainer prepared as ``train`` prepares its first epoch, and a list
    that receives every scalar it logs as ``(tag, value, step)``."""
    trainer = train.SegmentationTrainer(model, device=device, log_dir=str(log_dir))
    trainer._lr = 1e-4
    logged = []
    log_scalar = trainer.logger.log_scalar

    def tapped(tag, value, step):
        logged.append((tag, value, step))
        return log_scalar(tag, value, step)

    trainer.logger.log_scalar = tapped
    return trainer, logged


def _recording_steps(trainer):
    """Wrap the trainer's train step; the list of each step's metrics as
    floats, read straight from the metrics it returned."""
    seen = []
    step = trainer._train_step

    def recorded(*args):
        state, metrics = step(*args)
        seen.append({k: float(metrics[k.split("/")[1]].detach().float()) for k in LOGGED})
        return state, metrics

    trainer._train_step = recorded
    return seen


def _cpu_epoch(tmp_path, seed=3):
    torch.manual_seed(seed)
    model = create_unet("resnet18", classes=CLASSES, dtype=torch.float32, device="cpu")
    trainer, logged = _trainer(model, "cpu", tmp_path / "logs")
    trainer._build_steps()
    seen = _recording_steps(trainer)
    trainer.train_epoch(_loader(BATCH * BATCHES), TrainState(model, adam(1e-4)), EPOCH)
    trainer.logger.close()
    return logged, seen


def test_logged_scalars_are_each_steps_own_in_order(tmp_path):
    """Every logged loss, IoU and accuracy is the float of that step's own
    returned metric, at its global step, the last step's (read after the
    loop) included; and the CPU logs no lag share."""
    logged, seen = _cpu_epoch(tmp_path)
    assert len(seen) == BATCHES
    first = (EPOCH - 1) * BATCHES
    for tag in LOGGED:
        got = [(step, value) for t, value, step in logged if t == tag]
        assert got == [(first + i, s[tag]) for i, s in enumerate(seen)], tag
        assert all(type(v) is float for _, v in got)
    assert len({s["train/loss"] for s in seen}) == BATCHES          # it trained
    tags = [t for t, _, _ in logged]
    assert "perf/tiles_per_sec" in tags and "perf/lag_held_share" not in tags


def test_lag_held_share_counts_each_lagged_read(tmp_path, monkeypatch):
    """The share is taken over the reads made after the next step's dispatch
    (not the last, read after the loop), from what each read found, and is
    logged once, at the epoch, after ``perf/tiles_per_sec``."""
    answers = iter([True, False, True])
    calls = []

    class Scripted(train._QueuedScalars):
        def running(self):
            calls.append(super().running())
            return next(answers)

    monkeypatch.setattr(train, "_QueuedScalars", Scripted)
    logged, seen = _cpu_epoch(tmp_path)
    assert calls == [None] * (BATCHES - 1)          # off the card: no event to ask
    shares = [(value, step) for t, value, step in logged if t == "perf/lag_held_share"]
    assert shares == [(2 / 3, EPOCH)]
    tags = [t for t, _, _ in logged]
    assert tags.index("perf/lag_held_share") > tags.index("perf/tiles_per_sec")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _sleep_cycles(ms: float) -> int:
    """``torch.cuda._sleep`` cycles that keep the card busy ~``ms``."""
    probe = 20_000_000
    torch.cuda._sleep(probe)                 # warm
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(probe)
    end.record()
    end.synchronize()
    return int(probe * ms / start.elapsed_time(end))


@pytest.mark.gpu
def test_a_read_returns_with_the_next_step_still_queued_on_gpu(cuda, tmp_path):
    """A stub step that keeps the card busy ~100 ms: each read of step N-1
    returns while step N (its own end event) is still running, and the
    trainer's share says so."""
    cycles = _sleep_cycles(SLEEP_MS)
    model = create_unet("resnet18", classes=CLASSES, device=cuda)
    trainer, logged = _trainer(model, cuda, tmp_path / "logs")
    ends, found = [], []

    def stub(state, generator, images, masks):
        torch.cuda._sleep(cycles)
        i = float(len(ends))
        metrics = {k: torch.full((), i + d, device=cuda)
                   for k, d in (("loss", 0.0), ("iou", 0.25), ("accuracy", 0.5))}
        metrics["hist"] = torch.zeros(CLASSES, CLASSES, device=cuda)
        metrics["per_class_iou"] = torch.zeros(CLASSES, device=cuda)
        end = torch.cuda.Event()
        end.record()
        ends.append(end)
        return state, metrics

    trainer._train_step = stub
    log_scalar = trainer.logger.log_scalar

    def watched(tag, value, step):
        if tag == "train/loss" and step + 1 < len(ends):
            found.append(not ends[step + 1].query())       # the step after the one read
        return log_scalar(tag, value, step)

    trainer.logger.log_scalar = watched
    n = 6
    trainer.train_epoch(_loader(BATCH * n), None, 1)
    trainer.logger.close()
    assert len(ends) == n
    assert found == [True] * (n - 1)
    assert [v for t, v, _ in logged if t == "train/loss"] == [float(i) for i in range(n)]
    assert [v for t, v, _ in logged if t == "train/accuracy"] == [i + 0.5 for i in range(n)]
    (share,) = [v for t, v, _ in logged if t == "perf/lag_held_share"]
    assert share >= 0.8


@pytest.mark.gpu
def test_a_phase1_step_and_its_queued_read_make_no_host_sync_on_gpu(cuda, tmp_path):
    """One real phase-1 step (WEAK, CE, Adam; 64 px, B=2) and the queuing of
    its scalars, under ``set_sync_debug_mode("error")``: a synchronizing call
    would make the read wait for the step again."""
    model = create_unet("resnet18", classes=CLASSES, device=cuda)
    trainer, _ = _trainer(model, cuda, tmp_path / "logs")
    trainer._build_steps()
    state = TrainState(model, adam(1e-4))
    generator = trainer._epoch_generator(1)
    images, masks = _tiles(BATCH)
    images = torch.from_numpy(images).to(cuda)
    masks = torch.from_numpy(masks.astype(np.uint8)).to(cuda)
    state, _ = trainer._train_step(state, generator, images, masks)   # builds, plans
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = trainer._train_step(state, generator, images, masks)
        scalars = train._QueuedScalars(metrics["loss"], metrics["iou"], metrics["accuracy"])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    values = scalars.read()
    assert values == train._scalars(metrics["loss"], metrics["iou"], metrics["accuracy"])
    assert all(math.isfinite(v) for v in values)
    trainer.logger.close()
