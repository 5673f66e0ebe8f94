"""Chip smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card (``nvidia-smi`` name and power limit);
2. builds the port's CUDA kernel from ``csrc/`` with nvcc;
3. holds the kernel against its plain PyTorch version at the serving
   path's shapes (B=32: 256x256x32->32 and 512x512x16->16, bf16 and f32,
   with and without the BN affine, with moments) and one ragged shape,
   and times kernel, plain version, cuDNN conv and the roofline bound;
4. drives the serving path -- resnet34 U-Net, 23 classes, 512 px tiles,
   bf16, seeded random weights -- through ``predict_batch`` (B=32) and
   ``predict_raster`` (2000x1500 raster), checks that every forward
   launched the kernel exactly twice, times the forward (CUDA events)
   and breaks its device time down by kernel (``torch.profiler``), and
   checks the fused path against the plain one in f32;
5. prints one JSON line of kernel results, the card line again, and
   last ``{"ok": true, "device": {...}}``.

Any failed check raises and the script exits non-zero; without a CUDA
device it exits non-zero before printing any result.  It imports
nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

PEAK_BYTES_PER_S = 3.35e12                      # H100 SXM HBM3
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,       # dense bf16 tensor cores
                  torch.float32: 67e12}         # f32 outside the tensor cores
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
SLICE_SHAPES = [(32, 256, 256, 32, 32), (32, 512, 512, 16, 16)]
RAGGED_SHAPE = (2, 18, 50, 24, 20)
SEED = 0
# device functions grouped by name (first match wins)
PROFILE_CATEGORIES = [
    ("conv_bn_relu kernel", ("conv_bn_relu",)),
    ("cuDNN convolution", ("cudnn", "cutlass", "xmma", "sm90_", "conv")),
    ("nearest upsample", ("upsample",)),
    ("concat", ("CatArray", "cat_")),
    ("max pool", ("pool",)),
    ("copy / dtype cast", ("copy",)),
    ("elementwise (BatchNorm, ReLU, add, normalize)", ("elementwise",)),
    ("reduction", ("reduce",)),
]


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(b, h, w, ci, co, dtype, affine):
    """Least time (ms) for the function: each input read once, the output
    written once, vs its multiply-adds at the peak rate of ``dtype``."""
    elt = torch.tensor([], dtype=dtype).element_size()
    nbytes = b * h * w * (ci + co) * elt + 9 * ci * co * 4 + (8 * ci if affine else 0)
    ops = 2 * b * h * w * 9 * ci * co + (3 * b * h * w * ci if affine else 0)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_inputs(gen, b, h, w, ci, co, dtype):
    x = torch.randn(b, h, w, ci, generator=gen, device="cuda").to(dtype)
    k3 = 0.1 * torch.randn(3, 3, ci, co, generator=gen, device="cuda")
    scale = 1.0 + 0.1 * torch.randn(ci, generator=gen, device="cuda")
    shift = 0.1 * torch.randn(ci, generator=gen, device="cuda")
    scale[0], scale[1] = 0.0, -0.5          # zero and negative BN scale
    return x, k3, scale, shift


def check_kernel(conv_bn_relu, reference, gen, shape, dtype, affine, timed):
    """Kernel vs plain version on one case; returns a result dict."""
    b, h, w, ci, co = shape
    x, k3, scale, shift = kernel_inputs(gen, *shape, dtype)
    sc, sh = (scale, shift) if affine else (None, None)
    y, mom = conv_bn_relu(x, k3, sc, sh, moments=True)
    y_plain = conv_bn_relu(x, k3, sc, sh)
    torch.cuda.synchronize()
    y_ref, mom_ref = reference(x, k3, sc, sh, moments=True)
    tol = TOL[dtype]
    torch.testing.assert_close(y.float(), y_ref.float(), atol=tol, rtol=tol)
    if not torch.equal(y, y_plain):
        raise AssertionError("moments=True changed y")
    mom_bound = 1e-3 * y_ref.float().abs().sum((0, 1, 2))
    if not torch.all((mom - mom_ref).abs() <= mom_bound):
        raise AssertionError(f"moments off by {(mom - mom_ref).abs().max().item()}")
    res = dict(shape=list(shape), dtype=str(dtype).split(".")[-1], affine=affine,
               max_abs_err=(y.float() - y_ref.float()).abs().max().item(),
               moments_max_abs_err=(mom - mom_ref).abs().max().item())
    if timed:
        act = x if not affine else torch.relu(x.float() * scale + shift).to(dtype)
        act = act.permute(0, 3, 1, 2)                     # channels_last NCHW view
        w_oihw = k3.to(dtype).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        res["kernel_ms"] = time_ms(lambda: conv_bn_relu(x, k3, sc, sh))
        res["plain_ms"] = time_ms(lambda: reference(x, k3, sc, sh))
        res["library_ms"] = time_ms(lambda: F.conv2d(act, w_oihw, padding=1))
        res["bound_ms"], res["bound_by"] = bound(b, h, w, ci, co, dtype, affine)
    print("kernel check", json.dumps(res), flush=True)
    return res


def profile_forward(fn, reps: int = 3, top: int = 8):
    """Device time by kernel over ``reps`` calls of ``fn`` (torch.profiler).

    Returns per-call device ms (kernels, copies and fills on the device),
    the device busy share (union of device intervals over the host wall
    time of the window), and the ``top`` device functions by time.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            start, end = e.time_range.start, e.time_range.end
            spans.append((start, end))
            by_name[e.name] = by_name.get(e.name, 0.0) + (end - start)
    if not spans:
        return {"device_ms_per_call": "not measured"}
    busy_us, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(spans):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy_us += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy_us += cur_end - cur_start
    total_us = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    by_category = {}
    for name, us in by_name.items():
        cat = next((c for c, keys in PROFILE_CATEGORIES
                    if any(k in name for k in keys)), "other")
        by_category[cat] = by_category.get(cat, 0.0) + us / 1e3 / reps
    return {"device_ms_per_call": total_us / 1e3 / reps,
            "busy_share": busy_us / wall_us,
            "by_category_ms": dict(sorted(by_category.items(), key=lambda kv: -kv[1])),
            "top_kernels": [{"ms": us / 1e3 / reps, "share": us / total_us,
                             "name": name[:100]} for name, us in ranked]}


def randomize_batch_norms_(model, gen):
    """Non-trivial eval-mode statistics, so the fold is exercised."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops.batch_norm import (
        BatchNorm,
    )

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                n = m.scale.numel()
                sign = torch.where(torch.rand(n, generator=gen) < 0.2, -1.0, 1.0)
                m.scale.copy_(sign * (0.5 + 0.5 * torch.rand(n, generator=gen)))
                m.bias.copy_(0.1 * torch.randn(n, generator=gen))
                m.mean.copy_(0.1 * torch.randn(n, generator=gen))
                m.var.copy_(0.5 + torch.rand(n, generator=gen))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    from uda_aerial_semantic_segmentation_research_tpu_torch.data.tiling import (
        tile_grid,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.inference.predict import (
        predict_batch,
        predict_raster,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.models import create_unet
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops import _build
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops import conv_bn_relu as cbr
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.steps import (
        make_predict_step,
    )

    conv_bn_relu, reference = cbr.conv_bn_relu, cbr.conv_bn_relu_reference
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 1. device
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {kind}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    cbr._library()
    print(f"build: conv_bn_relu nvcc {_build.build_seconds['conv_bn_relu']:.1f} s, "
          f"load {time.perf_counter() - t0:.1f} s", flush=True)

    # 3. kernel vs plain version on the card
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = []
    for shape in SLICE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            for affine in (True, False):
                results.append(check_kernel(conv_bn_relu, reference, gen, shape,
                                            dtype, affine, timed=True))
    for dtype in (torch.bfloat16, torch.float32):
        results.append(check_kernel(conv_bn_relu, reference, gen, RAGGED_SHAPE,
                                    dtype, True, timed=False))
    path_cases = [r for r in results
                  if r["dtype"] == "bfloat16" and r["affine"] and "kernel_ms" in r]
    assert len(path_cases) == len(SLICE_SHAPES)

    # 4. the serving path: resnet34 U-Net, 23 classes, 512 px, bf16
    host_rng = np.random.default_rng(SEED)
    model = create_unet("resnet34", classes=23, seed=SEED, dtype=torch.bfloat16,
                        device="cuda", fused_eval=True)
    randomize_batch_norms_(model, torch.Generator().manual_seed(SEED))
    batch = host_rng.integers(0, 256, (32, 512, 512, 3), dtype=np.uint8)
    raster = host_rng.integers(0, 256, (1500, 2000, 3), dtype=np.uint8)
    n_raster_tiles = len(tile_grid(1500, 2000, 512, 64))
    raster_forwards = -(-n_raster_tiles // 8)

    conv_bn_relu.launches = 0
    preds = predict_batch(model, batch)
    torch.cuda.synchronize()
    batch_launches = conv_bn_relu.launches
    label_map = predict_raster(model, raster, tile=512, overlap=64, batch_size=8)
    torch.cuda.synchronize()
    launches = conv_bn_relu.launches
    print(f"main path: predict_batch launches {batch_launches}, predict_raster "
          f"launches {launches - batch_launches} over {raster_forwards} forwards "
          f"({n_raster_tiles} tiles)", flush=True)
    if batch_launches != 2 or launches - batch_launches != 2 * raster_forwards:
        raise AssertionError("the kernel did not run exactly twice per forward")
    if preds.shape != (32, 512, 512) or preds.dtype != np.int32:
        raise AssertionError(f"predict_batch gave {preds.shape} {preds.dtype}")
    if label_map.shape != (1500, 2000) or label_map.dtype != np.int32:
        raise AssertionError(f"predict_raster gave {label_map.shape} {label_map.dtype}")
    for labels in (preds, label_map):
        if labels.min() < 0 or labels.max() >= 23:
            raise AssertionError("labels out of range")

    step = make_predict_step(model)
    batch_dev = torch.from_numpy(batch).cuda()
    logits = step(batch_dev)
    if not torch.isfinite(logits).all() or tuple(logits.shape) != (32, 512, 512, 23):
        raise AssertionError("bf16 logits not finite or of the wrong shape")
    torch.cuda.reset_peak_memory_stats()
    forward_ms = time_ms(lambda: step(batch_dev), reps=10)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(json.dumps({"profile": profile_forward(lambda: step(batch_dev)),
                      "card": card}), flush=True)

    # fused vs plain decoder in f32 (TF32 off), same weights
    state = model.state_dict()
    logits32 = {}
    for fused in (True, False):
        m32 = create_unet("resnet34", classes=23, seed=SEED, dtype=torch.float32,
                          device="cuda", fused_eval=fused)
        m32.load_state_dict(state, strict=True)
        logits32[fused] = make_predict_step(m32)(batch_dev[:4])
        del m32
    torch.testing.assert_close(logits32[True], logits32[False], atol=1e-3, rtol=1e-3)
    f32_err = (logits32[True] - logits32[False]).abs().max().item()
    print(json.dumps({"serving": {
        "model": "resnet34 U-Net, 23 classes, fused_eval", "dtype": "bfloat16",
        "batch": 32, "tile": 512, "forward_ms": forward_ms,
        "tiles_per_s": 32 / forward_ms * 1e3, "peak_mem_gib": peak_gib,
        "f32_fused_vs_plain_max_abs_err": f32_err, "card": card}}), flush=True)

    # 5. results
    entry = {
        "name": "conv_bn_relu", "route": "cuda",
        "source": "uda_aerial_semantic_segmentation_research_tpu_torch/csrc/conv_bn_relu.cu",
        "replaces": "uda_aerial_semantic_segmentation_research_tpu/ops/pallas_conv.py:173",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in results),
        # per forward: the two decoder launches at B=32, bf16, with the affine
        "ms": sum(r["kernel_ms"] for r in path_cases),
        "plain_ms": sum(r["plain_ms"] for r in path_cases),
        "bound_ms": sum(r["bound_ms"] for r in path_cases),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in path_cases)
        else "operations",
        "library_ms": sum(r["library_ms"] for r in path_cases),
    }
    print(json.dumps({"kernels": [entry]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
