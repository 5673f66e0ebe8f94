"""The port's program spans (``utils.profiling.annotate``), on the CPU.

A span is a ``record_function`` while a profiler runs and one shared null
context otherwise.  Under ``utils.profiling.trace`` a
``SegmentationTrainer.train_epoch`` (resnet18 U-Net, 64 px, B=2, three
batches, the first a figure step) writes every training span, nested as
documented, as many times as the batches ask for, on the clock of torch's
own operations, and logs the same losses as without a profiler;
``predict_batch`` writes its four serving spans.
"""

import collections
import copy
import json

import numpy as np
import pytest
import torch

from uda_aerial_semantic_segmentation_research_tpu_torch.data import dataset, loader
from uda_aerial_semantic_segmentation_research_tpu_torch.inference.predict import (
    predict_batch,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.models import create_unet
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.batch_norm import BatchNorm
from uda_aerial_semantic_segmentation_research_tpu_torch.training import train
from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import (
    TrainState,
    adam,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.utils import profiling

SIZE, CLASSES, BATCH, BATCHES = 64, 7, 2, 3
EPS_US = 0.5          # the trace's timestamps are printed to the nanosecond


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads: the tier-1 run has six workers on eight cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiles(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8),
            rng.integers(0, CLASSES, (n, SIZE, SIZE)).astype(np.int32))


def _model():
    torch.manual_seed(3)
    return create_unet("resnet18", classes=CLASSES, dtype=torch.float32, device="cpu")


def _spans(logdir):
    """The ``uda.`` spans and the ``aten::`` operations of the one Chrome
    trace in ``logdir``."""
    (path,) = logdir.glob("trace_*.json")
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith("uda.")]
    ops = [e for e in events if e.get("cat") == "cpu_op" and e["name"].startswith("aten::")]
    return spans, ops


def _named(events, name):
    return [e for e in events if e["name"] == name]


def _inside(inner, outer) -> bool:
    return (inner["tid"] == outer["tid"] and outer["ts"] - EPS_US <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + EPS_US)


def _each_inside(events, outers) -> bool:
    return bool(events) and all(any(_inside(e, o) for o in outers) for e in events)


def _epoch(model, log_dir):
    """One ``train_epoch`` of ``BATCHES`` batches from ``model``'s weights;
    the losses the trainer logs."""
    images, masks = _tiles(BATCH * BATCHES)
    data = loader.DataLoader(dataset.Subset(list(zip(images, masks)),
                                            list(range(len(images)))), batch_size=BATCH)
    trainer = train.SegmentationTrainer(model, device="cpu", log_dir=str(log_dir))
    trainer._build_steps()
    trainer._lr = 1e-4
    losses = []
    log_scalar = trainer.logger.log_scalar

    def tapped(tag, value, step):
        if tag == "train/loss":
            losses.append(value)
        return log_scalar(tag, value, step)

    trainer.logger.log_scalar = tapped
    trainer.train_epoch(data, TrainState(model, adam(1e-4)), 1)
    trainer.logger.close()
    return losses


@pytest.fixture(scope="module")
def epoch_runs(tmp_path_factory):
    """The same epoch from the same weights with and without a profiler."""
    root = tmp_path_factory.mktemp("tracing")
    model = _model()
    plain = copy.deepcopy(model)
    with profiling.trace(str(root / "trace")):
        traced_losses = _epoch(model, root / "logs_traced")
    spans, ops = _spans(root / "trace")
    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    return {"spans": spans, "ops": ops, "n_bn": n_bn, "traced_losses": traced_losses,
            "plain_losses": _epoch(plain, root / "logs_plain")}


def test_annotate_without_a_profiler_is_one_shared_null_context():
    assert not torch._C._autograd._profiler_enabled()
    first, second = profiling.annotate("uda.a"), profiling.annotate("uda.b")
    assert first is second
    with first:
        with second:
            pass


def test_annotate_under_trace_is_a_span(tmp_path):
    with profiling.trace(str(tmp_path)):
        span = profiling.annotate("uda.test.span")
        assert isinstance(span, torch.profiler.record_function)
        with span:
            torch.ones(8).sum()
    spans, ops = _spans(tmp_path)
    assert [s["name"] for s in spans] == ["uda.test.span"]
    assert _each_inside(_named(ops, "aten::sum"), spans)


def test_trainer_epoch_writes_every_training_span(epoch_runs):
    counts = collections.Counter(s["name"] for s in epoch_runs["spans"])
    n_bn = epoch_runs["n_bn"]
    assert n_bn > 0
    assert dict(counts) == {
        "uda.trainer.step": BATCHES, "uda.trainer.log": BATCHES,
        "uda.trainer.figures": 1,                      # batch 0 of LOG_INTERVAL
        "uda.data.wait": BATCHES, "uda.data.stage": BATCHES,
        "uda.step.train": BATCHES, "uda.step.augment": BATCHES,
        "uda.bn.train": BATCHES * n_bn, "uda.bn.train_backward": BATCHES * n_bn,
        "uda.bn.eval": n_bn,                           # the figure step's forward
    }


def test_trainer_spans_nest_as_documented(epoch_runs):
    spans = epoch_runs["spans"]
    steps = _named(spans, "uda.trainer.step")
    step_calls = _named(spans, "uda.step.train")
    logs = _named(spans, "uda.trainer.log")
    figures = _named(spans, "uda.trainer.figures")
    assert _each_inside(figures, logs)
    assert _each_inside(step_calls, steps)
    # the last step's metrics are read after the loop, outside any step
    assert sum(any(_inside(g, s) for s in steps) for g in logs) == BATCHES - 1
    assert _each_inside(_named(spans, "uda.step.augment"), step_calls)
    assert _each_inside(_named(spans, "uda.bn.train"), step_calls)
    assert _each_inside(_named(spans, "uda.bn.train_backward"), step_calls)
    assert _each_inside(_named(spans, "uda.bn.eval"), figures)
    # the loader's spans lie between steps, never inside one
    for name in ("uda.data.wait", "uda.data.stage"):
        assert not any(_inside(d, s) for d in _named(spans, name) for s in steps)
    main = {s["tid"] for s in steps}
    assert len(main) == 1 and {s["tid"] for s in spans} == main


def test_trainer_logs_the_same_losses_under_a_profiler(epoch_runs):
    assert len(epoch_runs["traced_losses"]) == BATCHES
    assert epoch_runs["traced_losses"] == epoch_runs["plain_losses"]


def test_a_steps_operations_lie_in_its_span(epoch_runs):
    """One clock: each step's convolutions, forward and backward, lie within
    its ``uda.step.train``; every other convolution is the figure step's."""
    spans, ops = epoch_runs["spans"], epoch_runs["ops"]
    step_calls = _named(spans, "uda.step.train")
    figures = _named(spans, "uda.trainer.figures")
    convs = _named(ops, "aten::convolution")
    backward = _named(ops, "aten::convolution_backward")
    per_step = [sum(_inside(c, s) for c in convs) for s in step_calls]
    assert per_step[0] > 0 and len(set(per_step)) == 1
    assert _each_inside(backward, step_calls)
    in_figures = [c for c in convs if not any(_inside(c, s) for s in step_calls)]
    assert len(in_figures) == len(convs) - sum(per_step) > 0
    assert _each_inside(in_figures, figures)


def test_loader_worker_threads_wait_in_a_span(tmp_path):
    images, masks = _tiles(BATCH * BATCHES, seed=1)
    data = loader.DataLoader(dataset.Subset(list(zip(images, masks)),
                                            list(range(len(images)))),
                             batch_size=BATCH, num_workers=1)
    with profiling.trace(str(tmp_path)):
        batches = list(data.iter_raw())
    spans, _ = _spans(tmp_path)
    assert len(batches) == BATCHES
    # one wait a batch, and the last for the producer's end of the epoch
    assert [s["name"] for s in spans] == ["uda.data.wait"] * (BATCHES + 1)


def test_predict_batch_writes_the_serving_spans(tmp_path):
    model = _model()
    images, _ = _tiles(BATCH, seed=2)
    plain = predict_batch(model, images, device="cpu")
    with profiling.trace(str(tmp_path)):
        traced = predict_batch(model, images, device="cpu")
    np.testing.assert_array_equal(traced, plain)
    spans, _ = _spans(tmp_path)
    counts = collections.Counter(s["name"] for s in spans)
    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    assert dict(counts) == {"uda.serve.request": 1, "uda.serve.upload": 1,
                            "uda.serve.forward": 1, "uda.serve.download": 1,
                            "uda.bn.eval": n_bn}
    request = _named(spans, "uda.serve.request")
    parts = [_named(spans, f"uda.serve.{p}")[0] for p in ("upload", "forward", "download")]
    assert _each_inside(parts, request)
    assert parts[0]["ts"] < parts[1]["ts"] < parts[2]["ts"]
    assert _each_inside(_named(spans, "uda.bn.eval"), parts[1:2])
