"""The traced run: a ``torch.profiler`` trace of the window, read into the
numbers the per-layer metrics take.

The kernel categories and the busy-share arithmetic (the union of the
device's kernel, copy and fill intervals) are copied from the port's
``chip_smoke.py``; see ``PERF.md`` for the original.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

WINDOW_SPAN = "port_bench.window"
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

# device functions grouped by name (first match wins); chip_smoke.py's table
CATEGORIES = [
    ("conv_bn_relu kernel", ("conv_bn_relu", "fold_moments")),
    ("fused_cross_entropy kernels", ("ce_fwd_kernel", "ce_bwd_kernel", "ce_fold_kernel")),
    ("channel_sums kernels", ("channel_sums_bulk_kernel", "channel_sums_generic_kernel")),
    ("dihedral_normalize kernel", ("dihedral_normalize_",)),
    ("optimizer (foreach Adam, clip)", ("multi_tensor_apply",)),
    ("augmentation sorts, pads, index copies, bilinear resize",
     ("sort", "Sort", "_pad", "bilinear", "index_", "indexFunc", "index_elementwise")),
    ("argmax, confusion matrix, gathers / scatters", ("ArgMaxOps", "scatter_gather")),
    ("cuDNN convolution", ("cudnn", "cutlass", "xmma", "sm90_", "conv")),
    ("nearest upsample", ("upsample",)),
    ("concat", ("CatArray", "cat_")),
    ("max pool", ("pool",)),
    ("copy / dtype cast", ("copy",)),
    ("elementwise (BatchNorm, ReLU, add, normalize)", ("elementwise",)),
    ("reduction", ("reduce",)),
]


def category(name: str) -> str:
    return next((c for c, keys in CATEGORIES if any(k in name for k in keys)), "other")


def _merged(spans):
    """The union of ``(start, end)`` spans as disjoint spans in order."""
    out = []
    for start, end in sorted(spans):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def union_us(spans) -> float:
    return sum(end - start for start, end in _merged(spans))


class Trace:
    """The window's device events (dicts: name, cat, ts, dur in µs,
    bytes), its host events, and what the driver knows of the window
    (``info``: steps, items a step, operations and bytes a step, ...)."""

    def __init__(self, device, host, window, info):
        self.window = window
        start, end = window
        self.device = [e for e in device if start <= e["ts"] < end]
        self.host = host
        self.info = info
        self.window_s = (end - start) / 1e6
        self.busy_s = union_us([(max(e["ts"], start), min(e["ts"] + e["dur"], end))
                                for e in self.device]) / 1e6

    @property
    def steps(self) -> int:
        return self.info["steps"]

    def device_s(self, pred) -> float:
        """Device seconds of the events for which ``pred(event)`` holds."""
        return sum(e["dur"] for e in self.device if pred(e)) / 1e6

    def category_s(self, *names) -> float:
        return self.device_s(lambda e: e["cat"] == "kernel" and category(e["name"]) in names)

    def memcpy_s(self, *kinds) -> float:
        return self.device_s(lambda e: e["cat"] == "gpu_memcpy"
                             and any(k in e["name"] for k in kinds))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps of the device by the innermost host operation running at the
        gap's middle."""
        by_name = {}
        for e in self.device:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        start, end = self.window
        busy = _merged([(e["ts"], e["ts"] + e["dur"]) for e in self.device])
        gaps, cursor = [], start
        for s, e in busy:
            if s > cursor:
                gaps.append((cursor, s))
            cursor = max(cursor, e)
        if cursor < end:
            gaps.append((cursor, end))
        by_host = {}
        for (s, e), name in zip(gaps, _innermost(self.host, [(s + e) / 2 for s, e in gaps])):
            by_host[name] = by_host.get(name, 0.0) + (e - s) / 1e6
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n[:160], s] for n, s in idle]}


def _innermost(host, times) -> list:
    """For each of the ascending ``times``, the innermost host operation
    running then (on one thread the operations nest), or "no host op"; one
    sweep over the operations in order of their start."""
    host = sorted((h for h in host if h["name"] != WINDOW_SPAN), key=lambda h: h["ts"])
    out, stack, i = [], [], 0
    for t in times:
        while i < len(host) and host[i]["ts"] <= t:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= host[i]["ts"]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] <= t:
            stack.pop()
        out.append(stack[-1]["name"] if stack else "no host op")
    return out


def read_chrome_trace(path: str, info: dict) -> Trace:
    with open(path) as f:
        raw = json.load(f)
    events = raw["traceEvents"] if isinstance(raw, dict) else raw
    device, host, window, main = [], [], None, None
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") == WINDOW_SPAN:
            main = e.get("tid")
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            device.append({"name": e["name"], "cat": cat, "ts": float(e["ts"]),
                           "dur": float(e["dur"]), "bytes": e.get("args", {}).get("bytes")})
        elif cat in HOST_CATS and e.get("tid") == main:
            if e["name"] == WINDOW_SPAN and cat == "user_annotation":
                window = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            host.append({"name": e["name"], "ts": float(e["ts"]), "dur": float(e["dur"])})
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN} span")
    return Trace(device, host, window, info)


class Tracer:
    """Wraps the window: ``with tracer.window(): ...``; with tracing on, a
    ``torch.profiler`` trace of host and device, then ``tracer.read(info)``."""

    def __init__(self, enabled: bool, tmpdir: str):
        self.enabled, self.tmpdir, self._path, self.export_s = enabled, tmpdir, None, 0.0

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            with record_function(WINDOW_SPAN):
                yield
        start = time.perf_counter()
        self._path = os.path.join(self.tmpdir, "window_trace.json")
        prof.export_chrome_trace(self._path)
        self.export_s = time.perf_counter() - start

    def read(self, info: dict) -> Trace:
        try:
            return read_chrome_trace(self._path, info)
        finally:
            os.remove(self._path)
