"""The readers of the program's spans (``port_bench/spans.py`` and the
metrics that use it), on hand-made traces: an idle interval is split by
overlap among nested spans and goes to the innermost, idle under an outer
span alone or under none is unnamed, per-step values divide by the steps,
and a reader gives nothing without steps or spans."""

import pytest

from port_bench import spans, spec
from port_bench.trace import Trace

TRAIN = ("figures_idle_ms.train", "stage_idle_ms.train", "loader_idle_ms.train",
         "dispatch_idle_ms.train", "idle_unnamed_pct.train")


def kernel(ts, dur):
    return {"name": "k", "cat": "kernel", "ts": float(ts), "dur": float(dur), "bytes": None}


def span(name, ts, end):
    return {"name": name, "ts": float(ts), "dur": float(end - ts)}


def make(device, host, steps=1, window=(0, 1000)):
    return Trace(device, host, window, {"steps": steps})


def training_trace(steps=1):
    """Idle 100-600 and 700-1000 of a 1000 µs window.  A step 50-650 holds
    its log 200-500 (figures 300-400) and its call 520-640 (augmentation
    520-560); the loader waits 650-800, then stages 800-900; an aten
    operation inside the log names nothing."""
    device = [kernel(0, 100), kernel(600, 100)]
    host = [span("uda.trainer.step", 50, 650), span("uda.trainer.log", 200, 500),
            span("uda.trainer.figures", 300, 400), span("aten::copy_", 310, 320),
            span("uda.step.train", 520, 640), span("uda.step.augment", 520, 560),
            span("uda.data.wait", 650, 800), span("uda.data.stage", 800, 900)]
    return make(device, host, steps)


def reader(cell, metric):
    return spec.Cell(spec.load(), cell).reader(metric)


def test_idle_intervals_are_the_complement_of_the_device():
    t = training_trace()
    assert spans.idle_intervals(t) == [(100, 600), (700, 1000)]
    assert sum(e - s for s, e in spans.idle_intervals(t)) == pytest.approx(
        t.window_s * 1e6 - t.busy_s * 1e6)


def test_an_idle_interval_goes_to_the_innermost_span_by_overlap():
    t = training_trace()
    # the idle 100-600 is cut at 200, 300, 400, 500 and 520: its middle
    # (350) lies in the figures, but only 100 µs of it are theirs
    assert reader("unet34.train.b128", "figures_idle_ms.train")(t) == pytest.approx(0.1)
    assert spans.idle_ms_per_step(t, "uda.trainer.log") == pytest.approx(0.3)
    assert reader("unet34.train.b128", "dispatch_idle_ms.train")(t) == pytest.approx(0.08)
    assert spans.idle_ms_per_step(t, "uda.step.augment") == pytest.approx(0.04)
    assert reader("unet34.train.b128", "loader_idle_ms.train")(t) == pytest.approx(0.1)
    assert reader("unet34.train.b128", "stage_idle_ms.train")(t) == pytest.approx(0.1)


def test_idle_under_the_step_alone_or_no_span_is_unnamed():
    t = training_trace()
    # under the step alone: 100-200, 500-520; under none: 900-1000; of 800
    assert reader("unet34.train.b128", "idle_unnamed_pct.train")(t) == pytest.approx(
        (100 + 20 + 100) / 800 * 100)


def test_the_named_idles_and_the_unnamed_share_make_the_whole():
    t = training_trace()
    named = sum(reader("unet34.train.b128", m)(t) for m in TRAIN[1:4])
    log_self = (spans.idle_ms_per_step(t, "uda.trainer.log")
                - reader("unet34.train.b128", "figures_idle_ms.train")(t))
    idle_ms = sum(e - s for s, e in spans.idle_intervals(t)) / 1e3
    unnamed = reader("unet34.train.b128", "idle_unnamed_pct.train")(t) / 100 * idle_ms
    figures = reader("unet34.train.b128", "figures_idle_ms.train")(t)
    assert named + figures + log_self + unnamed == pytest.approx(idle_ms)


def test_per_step_values_divide_by_the_steps():
    one, four = training_trace(steps=1), training_trace(steps=4)
    for metric in TRAIN[:4]:
        read = reader("unet34.train.b128", metric)
        assert read(four) == pytest.approx(read(one) / 4)
    read = reader("unet34.train.b128", "idle_unnamed_pct.train")
    assert read(four) == pytest.approx(read(one))


def test_serving_has_the_request_as_its_outer_span():
    device = [kernel(0, 100), kernel(400, 100)]
    host = [span("uda.serve.request", 50, 900), span("uda.serve.upload", 60, 150),
            span("uda.serve.forward", 150, 300), span("uda.serve.download", 500, 880)]
    t = make(device, host, steps=2)
    # idle 100-400 and 500-1000: upload 100-150, forward 150-300 and
    # download 500-880 named; request alone 300-400 and 880-900, none 900-1000
    read = reader("unet34.serve.b32", "idle_unnamed_pct.serve")
    assert read(t) == pytest.approx((100 + 20 + 100) / 800 * 100)


def test_no_steps_or_no_spans_give_nothing():
    host_ops = [span("aten::mm", 100, 200)]
    for t in (training_trace(steps=0), make([kernel(0, 100)], host_ops)):
        for metric in TRAIN:
            assert reader("unet34.train.b128", metric)(t) is None
        assert reader("unet34.serve.b32", "idle_unnamed_pct.serve")(t) is None


def test_the_new_metrics_are_read_in_their_cells():
    bench = spec.load()
    for cell, names in (("unet34.train.b128", TRAIN), ("unet50.train.b128", TRAIN),
                        ("unet34.serve.b32", ("idle_unnamed_pct.serve",))):
        listed = {m["name"]: m for m in spec.Cell(bench, cell).per_layer}
        for name in names:
            assert listed[name]["source"] == "program_span"
