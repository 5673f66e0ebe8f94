"""Traffic kind ``predict_batch``: ``inference.predict.predict_batch(model,
images)``, one client in a closed loop, each request a block of tiles of a
ring made from the seed.  The mix's file gives ``batch``, ``tile``,
``ring_tiles`` and ``warmup_requests``.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from port_bench import counts, inputs
from port_bench.drivers import Driver as _Driver
from port_bench.drivers import patched
from port_bench.reference import disable_tf32
from port_bench.reference import serve as ref_serve


class Driver(_Driver):
    KEEP = 6        # finished requests kept for the check, drawn from the seed

    def setup(self):
        from uda_aerial_semantic_segmentation_research_tpu_torch.inference import predict

        t = self.traffic
        self.predict = predict
        self.batch, self.tile = t["batch"], t["tile"]
        self.lap("imports")
        self.model = self.build_model()
        images, _ = inputs.make_tiles(self.seed, t["ring_tiles"], self.tile,
                                      self.cfg["classes"], self.device)
        self.lap("tiles")
        order = inputs.order(self.seed, len(images), len(images))
        n_req = len(images) // self.batch
        self.requests = [np.ascontiguousarray(images[order[i * self.batch:(i + 1) * self.batch]])
                         for i in range(n_req)]
        self.rng = np.random.default_rng([inputs.data_seed(self.seed), 3])
        # on the card the call users make; the CPU (tests only) has to be named
        self.where = {} if self.device.type == "cuda" else {"device": "cpu"}
        for i in range(t["warmup_requests"]):
            self.predict.predict_batch(self.model, self.requests[i % n_req], **self.where)
        self.lap("warm-up requests")

    def window(self, seconds: float, tracer):
        n_req = len(self.requests)
        latencies, kept = [], []
        self.peak_reset()
        with tracer.window():        # the clock starts once a tracer is running
            start = time.perf_counter()
            deadline = start + seconds
            while time.perf_counter() < deadline:
                i = len(latencies)
                t0 = time.perf_counter()
                labels = self.predict.predict_batch(self.model, self.requests[i % n_req],
                                                    **self.where)
                latencies.append(time.perf_counter() - t0)
                # reservoir sample of the finished requests, from the seed
                if len(kept) < self.KEEP:
                    kept.append((i, labels))
                else:
                    j = int(self.rng.integers(0, i + 1))
                    if j < self.KEEP:
                        kept[j] = (i, labels)
            window_s = time.perf_counter() - start
        peak = self.peak_bytes()
        n = len(latencies)
        self.kept = kept
        self.result.update(attempted=n, failed=0)
        self.result["metrics"] = {"serve_tiles_per_s": n * self.batch / window_s,
                                  "peak_gib": peak / 2 ** 30}
        self.result["info"].update({
            "steps": n, "items_per_step": self.batch, "window_s": window_s,
            "flops_per_step": counts.serve_flops(
                self.cell.arch.conv_layers(self.cfg, self.tile), self.batch),
            "latency_ms_p50": float(np.percentile(latencies, 50) * 1e3),
            "latency_ms_p95": float(np.percentile(latencies, 95) * 1e3),
            "memory_peak_bytes": peak})

    def check(self, control: bool = False, shared=None) -> dict:
        """The widest label gap over the kept requests; with ``control``
        the control's labels stand in for the program's."""
        disable_tf32()
        n_req = len(self.requests)
        gap = 0.0
        for i, labels in self.kept:
            images = torch.from_numpy(self.requests[i % n_req]).to(self.device)
            ref = ref_serve.logits(self.net, self.w0, images)
            if control:
                labels = ref_serve.logits(self.net, self.w0, images, quant="fp8").argmax(-1)
            gap = max(gap, ref_serve.widest_gap(ref, labels))
            del ref
        return {"label_gap": gap}


@contextlib.contextmanager
def altered_labels():
    """``predict_batch`` whose first tile's labels are each moved to the
    next class where they are produced."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.inference import predict

    serve = predict.predict_batch

    def altered(model, images, *args, **kwargs):
        labels = serve(model, images, *args, **kwargs)
        labels[0] = (labels[0] + 1) % model.classes
        return labels

    with patched(predict, "predict_batch", altered):
        yield


FAULTS = {"altered_labels": altered_labels}
