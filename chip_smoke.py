"""Chip smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py                  # everything below, on one card
    python3 chip_smoke.py --probe-batch N  # only: does a train step fit at batch N?
    python3 chip_smoke.py --compare-sums-source OLD.cu
        # only: the sums kernels against those built from an older
        # channel_sums.cu, at the train step's 7 BatchNorm shapes, in turns
    python3 chip_smoke.py --compare-dihedral-source OLD.cu
        # only: dihedral_normalize against the one built from an older
        # dihedral_normalize.cu, at the train step's shape, in turns

1. prints the card (``nvidia-smi`` name and power limit);
2. builds the port's four CUDA libraries from ``csrc/`` with nvcc, all
   compilers started together;
3. holds every kernel against its plain PyTorch version on the card, at
   the shapes the main paths give it, with the tolerance beside it, and
   times kernel, plain version, the one PyTorch call that computes the same
   function (where there is one) and the roofline bound:
   - ``conv_bn_relu`` at the serving shapes (B=32: 256x256x32->32 and
     512x512x16->16, bf16 and f32, with and without the BN affine, with
     moments, two launches bit-identical) and at the edges of the bf16
     tensor-core tiling (Cin 3 and 24, Cout 8 and 20, H and W off the tile
     grid, B=1 at both serving shapes); kernel, plain version and library
     call are timed as 20 launches between two CUDA events, so the host's
     launch overhead is not counted (the single-launch time stands beside);
   - ``channel_sums`` / ``channel_dual_sums`` at every BatchNorm input of
     the train step (B=32, 7 shapes from 16x16x512 to 512x512x16), bf16,
     three of them in f32, timed as 20 launches per event pair over rotating
     input copies larger than twice the L2 and as the profiler's kernel
     duration; untimed at the edges (C=3, 16, 24, 512, M=1, ragged rows,
     mixed bf16/f32 duals, an unaligned view); one device kernel per call,
     1,000 calls in a row and two streams at once give the same bits; the
     wrapper's host time per call;
   - ``dihedral_normalize`` at (32, 512, 512, 3) uint8 with uint8 masks, for
     a batch of all eight group elements, one of identity and flips only and
     one of transposes only, ``normalize`` both ways, bit-exact, two launches
     bit-identical, one device kernel a call; bit-exact at the edges (generic
     path, partial units, unaligned view, int64 flags with high bits, wide
     masks); timed per batch as 20 launches per event pair on rotating cold
     copies and as the profiler's kernel duration, the single-launch time and
     the wrapper's host time beside; then ``augment_batch`` at the step's
     shape for the dihedral-only pipeline, ``WEAK`` and ``STRONG`` (draws
     from a generator on the card), one line each: ms as 20 calls per event
     pair on cold copies, device ms and launches by kind and by stage
     (draws, dihedral kernel + cast, warps, noise, blur, colour, HSV,
     normalize), the peak memory a call adds, and one call under
     ``torch.cuda.set_sync_debug_mode("error")`` (no host sync);
   - the sums kernels also at the discriminator's three BatchNorm inputs
     of phases 2 and 3 ((32·128², 128), (32·64², 256), (32·32², 512), bf16,
     forward and dual, timed as above), at phase 11's BatchNorm inputs that
     the resnet34 step lacks (the resnet50 U-Net's seven, C from 128 to 2048,
     and the feature discriminator's (32·16², 256) and (32·16², 128); timed
     as above; float32 at C=1024 and 2048 untimed), and ``dihedral_normalize`` without
     masks (the target batches of phases 2 and 3) at (32, 512, 512, 3) for
     each batch class, bit-exact, timed for the mixed class;
   - ``fused_cross_entropy`` at (32, 512, 512, 23) f32 and bf16, forward
     and backward;
4. drives the serving path -- resnet34 U-Net, 23 classes, 512 px tiles,
   bf16, seeded random weights -- through ``predict_batch`` (B=32) and
   ``predict_raster`` (2000x1500 raster), checks that every forward
   launched ``conv_bn_relu`` exactly twice, times the forward (CUDA events)
   and breaks its device time down by kernel (``torch.profiler``), and
   checks the fused path against the plain one in f32;
5. drives the train path at the same width -- ``make_supervised_train_step``
   with its default augmentation (``WEAK``, every stage, as in the JAX
   package), ``fused_ce=True`` and ``adam(1e-4)``, B=32 uint8 tiles and
   masks, 5 steps from seeded weights and batches --
   and checks finite losses, changed parameters and BatchNorm buffers,
   ``hist.sum()``, and the exact launch counts per step (one
   ``channel_sums`` and one ``channel_dual_sums`` per BatchNorm, one
   ``dihedral_normalize``, two ``fused_cross_entropy``); times the step,
   reads the peak memory and breaks the device time down by kind, with
   launches per kind; counts the incoming BatchNorm gradients that
   ``bn_train`` has to copy before the dual sums; then times the same step
   with the dihedral-only augmentation on its own line;
6. runs ``make_eval_step`` on the trained model (2 ``conv_bn_relu``
   launches, finite loss);
7. holds every augmentation stage of WEAK and STRONG (float32, every gate
   on) on the card against the CPU, stage by stage, and one float32 train
   step on the card (kernels) against the same step on a CPU copy of the
   model (plain versions), WEAK in float32 with the same seeded draws
   (made once on the host);
8. prints one JSON line of kernel results (launches summed over the main
   paths of 4, 5, 6, 9, 10 and 11), the card line again, and last
   ``{"ok": true, "device": {...}}``.
9. (after 7, before 8 prints; in a spawned process of its own, whose
   launch counts 8 adds in) drives the phase-1 trainer,
   ``SegmentationTrainer.train``, for 2 epochs on the same model width with
   the trainer's own step (``WEAK``, plain CE, ``adam(1e-4)``): an in-memory dataset of 80 seeded 512 px
   tiles with the ``load_raw`` contract, ``random_split`` 64 / 16, a
   ``WeightedRandomSampler`` from ``class_balance``, ``DataLoader``s at
   B=32 (2 worker threads), logs and checkpoints in a temporary directory,
   the early stopper's ``min_epochs`` lowered to 1 so that the run saves a
   best model.  Checks, per train step, 46 ``channel_sums``, 46
   ``channel_dual_sums``, 1 ``dihedral_normalize`` and 0 other launches
   (and none outside the steps); uint8 images and masks on the card; in the
   last epoch's profile, H2D copies of exactly the batches' bytes, pinned,
   on a stream other than the compute stream; the best checkpoint reloaded
   through ``from_jax_state_dict`` gives bit-identical logits; the event
   file's CRCs and the JAX trainer's tags.  Prints a ``trainer`` line:
   ``StepTimer`` p50 / p95 and tiles/s, the bare step time, H2D ms per
   batch and its overlapped share, the device busy share of the last epoch,
   validation ms, the host ms of each figure-logging batch, checkpoint bytes
   and write ms, host syncs per train step, peak memory, and which of
   cv2 / PIL / pandas / tqdm / matplotlib / seaborn / sklearn / tensorboard
   / g++ / libjpeg / libpng the machine has.
10. (after 9, in a spawned process of its own) drives the three-phase
   pipeline, ``run_pipeline(phase1_epochs=1, phase2_epochs=1,
   phase3_epochs=1, batch_size=32, force_transitions=True)``, on the same
   model width with the JAX defaults (phase 2: ``WEAK``, ``lambda_adv``
   0.001, per-domain discriminator forwards; phase 3: ``STRONG`` views,
   ``adam(lr * 0.1, clip_norm=1.0)`` over both models, no remat), its
   ``_build_loaders`` replaced in that process by in-memory loaders (the
   80 source tiles split 64 / 16, 64 seeded target tiles with another
   photometric offset, shuffled, ``drop_last``): 2 steps a phase.  Checks
   the launches of every step (phase 1: 46 / 46 / 1 / 0; phase 2: 52 / 52
   / 2 / 0, the U-Net and the discriminator on both domains; phase 3: 95 /
   95 / 2 / 0, the U-Net on two views and the discriminator once) and none
   outside the steps; the summary's three phases and
   ``training_metadata.json``; every phase's best checkpoint reloaded
   through ``from_jax_state_dict`` (U-Net, and the discriminator of phases
   2 and 3) gives bit-identical logits; the discriminator's BatchNorm input
   shapes; one phase-3 step with a NaN in the discriminator's classifier
   bias leaves every element of the state bit-identical and reports
   ``finite`` false.  Prints a ``pipeline`` line: per phase the bare step
   (p50 of 5 after a warm-up, CUDA events, batches on the card), tiles/s,
   launches per step, peak memory, host syncs per step, device ms by kind
   (profiler); phase 3's consistency KL alone (forward + backward, chunked
   and whole, with its byte bound); checkpoint MB and write ms per phase;
   the pipeline's wall time.
11. (after 10, in a spawned process of its own) drives the GRL stack's
   ``MultiPhaseTrainer`` over ``create_uda_model``'s default model -- a
   resnet50 U-Net (23 classes, 512 px, bf16, seeded random weights) whose
   bottleneck feeds the feature discriminator (512 / 256 / 128 channels)
   through the gradient-reversal layer -- at B=32, one epoch a phase over
   the in-memory tiles of phase 10 (2 steps a phase): ``phase1_train``
   (dice), ``phase2_train`` (the sequential GRL step, ``lambda_domain``
   0.001, WEAK; target train batches stand in for target validation),
   ``phase3_train`` (two STRONG views, MSE + 0.1 * confusion); checkpoints in
   a temporary directory.  Checks the BatchNorm input shapes of a traversal
   against the census, the launches of every step (phase 1: 63 / 63 / 1 / 0;
   phase 2: 122 / 122 / 2 / 0, the source traversal 66 and the
   ``domain_only`` target traversal 56; phase 3: 192 / 182 / 2 / 0, ``x0``'s
   decoder getting no gradient) and none outside the steps, and the three
   ``phase{n}_best.pth`` reloaded through ``from_jax_state_dict`` to
   bit-identical segmentation and domain logits.  Prints a ``multiphase``
   line: per phase the bare step (p50 of 5 after a warm-up, CUDA events,
   batches on the card), tiles/s, peak memory, host syncs per step, device
   ms by kind (profiler) and the phase's wall time; checkpoint MB and write
   ms; the trainer's wall time and phase 11's with its process.  The
   script's own wall time is printed before the ``kernels`` line.

Any failed check raises and the script exits non-zero; without a CUDA
device it exits non-zero before printing any result.  It imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import copy
import dataclasses
import itertools
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
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
# bf16 tiles are 8x32 output pixels, K = Cin padded to 16 or 32, N = Cout to 8s
EDGE_SHAPES = [(3, 7, 9, 3, 16), (2, 33, 100, 16, 16), (1, 9, 70, 32, 8),
               (1, 256, 256, 32, 32), (1, 512, 512, 16, 16)]
SEED = 0
PORT = "uda_aerial_semantic_segmentation_research_tpu_torch"
JAX_OPS = "uda_aerial_semantic_segmentation_research_tpu/ops"
TRAIN_BATCH, TRAIN_STEPS, TILE, CLASSES = 32, 5, 512, 23
L2_BYTES = 50 * 2 ** 20                         # H100 L2
# BatchNorm inputs of the B=32 train step (NHWC shape: BatchNorms), checked
# against the step's own census in phase 5
BN_SHAPES = {(32, 16, 16, 512): 7, (32, 32, 32, 256): 15, (32, 64, 64, 128): 11,
             (32, 128, 128, 64): 8, (32, 256, 256, 32): 2, (32, 256, 256, 64): 1,
             (32, 512, 512, 16): 2}
# untimed sums checks: the generic path (C=24, C=3, ragged, odd row counts),
# M=1 on both paths, C=16 / 512 off the step's shapes, many rows
SUMS_EDGE_SHAPES = [(3, 7, 5, 24), (1, 16), (1, 512), (1, 24), (2, 1000, 24), (4, 9, 3),
                    (5, 3, 16), (70000, 32)]
# what the kernels line gives for each extra sums shape
PER_SHAPE_KEYS = ("shape", "sums_ms", "dual_ms", "sums_bound_ms", "dual_bound_ms",
                  "sums_kernel_ms", "dual_kernel_ms", "sums_plain_ms", "dual_plain_ms",
                  "sums_library_ms", "dual_library_ms", "max_rel_err")
# device functions grouped by name (first match wins)
PROFILE_CATEGORIES = [
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


def device_ms(fn, inner: int = 20, reps: int = 10, warmup: int = 3) -> float:
    """Median CUDA-event time per call of ``fn`` over ``reps`` runs of
    ``inner`` calls back to back: the device's time, not the host's launch
    overhead (as long as the host enqueues faster than the device runs)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
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
    """Kernel vs plain version on one case (y within one bf16 ulp or 1e-4 in
    f32, moments within 1e-3 * sum|y|, two launches bit-identical); returns a
    result dict, with times when ``timed``."""
    b, h, w, ci, co = shape
    x, k3, scale, shift = kernel_inputs(gen, *shape, dtype)
    sc, sh = (scale, shift) if affine else (None, None)
    y, mom = conv_bn_relu(x, k3, sc, sh, moments=True)
    y_plain = conv_bn_relu(x, k3, sc, sh)
    y_again, mom_again = conv_bn_relu(x, k3, sc, sh, moments=True)
    torch.cuda.synchronize()
    if not (torch.equal(y, y_again) and torch.equal(mom, mom_again)):
        raise AssertionError(f"two launches differ at {shape} {dtype}")
    y_ref, mom_ref = reference(x, k3, sc, sh, moments=True)
    tol = TOL[dtype]
    torch.testing.assert_close(y.float(), y_ref.float(), atol=tol, rtol=tol)
    if not torch.equal(y, y_plain):
        raise AssertionError("moments=True changed y")
    mom_bound = 1e-3 * y_ref.float().abs().sum((0, 1, 2))
    if not torch.all((mom - mom_ref).abs() <= mom_bound):
        raise AssertionError(f"moments off by {(mom - mom_ref).abs().max().item()}")
    res = dict(shape=list(shape), dtype=str(dtype).split(".")[-1], affine=affine,
               tolerance=f"{tol} (atol and rtol); moments 1e-3 * sum|y|; two launches "
                         "bit-identical",
               max_abs_err=(y.float() - y_ref.float()).abs().max().item(),
               moments_max_abs_err=(mom - mom_ref).abs().max().item())
    if timed:
        act = x if not affine else torch.relu(x.float() * scale + shift).to(dtype)
        act = act.permute(0, 3, 1, 2)                     # channels_last NCHW view
        w_oihw = k3.to(dtype).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        res["kernel_ms"] = device_ms(lambda: conv_bn_relu(x, k3, sc, sh))
        res["plain_ms"] = device_ms(lambda: reference(x, k3, sc, sh))
        res["library_ms"] = device_ms(lambda: F.conv2d(act, w_oihw, padding=1))
        res["bound_ms"], res["bound_by"] = bound(b, h, w, ci, co, dtype, affine)
        res["share_of_bound"] = res["bound_ms"] / res["kernel_ms"]
        res["kernel_single_launch_ms"] = time_ms(lambda: conv_bn_relu(x, k3, sc, sh))
        res["library_single_launch_ms"] = time_ms(lambda: F.conv2d(act, w_oihw, padding=1))
    print("kernel check", json.dumps(res), flush=True)
    return res


def profile_forward(fn, reps: int = 3, top: int = 8):
    """Device time by kernel over ``reps`` calls of ``fn`` (torch.profiler).

    Returns per-call device ms (kernels, copies and fills on the device),
    the device busy share (union of device intervals over the host wall
    time of the window), and the ``top`` device functions by time.
    """
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name, count = [], {}, collections.Counter()
    for e in prof.events():
        if on_device(e):
            start, end = e.time_range.start, e.time_range.end
            spans.append((start, end))
            by_name[e.name] = by_name.get(e.name, 0.0) + (end - start)
            count[e.name] += 1
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
    by_category, launches = {}, collections.Counter()
    for name, us in by_name.items():
        cat = next((c for c, keys in PROFILE_CATEGORIES
                    if any(k in name for k in keys)), "other")
        by_category[cat] = by_category.get(cat, 0.0) + us / 1e3 / reps
        launches[cat] += count[name]
    other = sorted(((us, name) for name, us in by_name.items()
                    if not any(k in name for _, keys in PROFILE_CATEGORIES for k in keys)),
                   reverse=True)[:4]
    return {"device_ms_per_call": total_us / 1e3 / reps,
            "other_top": [{"ms": us / 1e3 / reps, "launches": count[name] / reps,
                           "name": name[:80]} for us, name in other],
            "busy_share": busy_us / wall_us,
            "by_category_ms": dict(sorted(by_category.items(), key=lambda kv: -kv[1])),
            "by_category_launches": {c: n / reps for c, n in launches.most_common()},
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


def roofline(nbytes, ops, dtype=torch.float32):
    """Least time (ms): bytes over the memory rate vs operations over the
    peak rate of ``dtype``; and which of the two it is."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def rotation(make, call_bytes):
    """Copies of one call's inputs (the first from ``make`` as well) that
    together exceed twice the L2, so a run through them reads from HBM."""
    return [make() for _ in range(max(1, -(-2 * L2_BYTES // call_bytes)))]


def cycling(fn, inputs):
    """``fn`` on the next tuple of ``inputs`` at each call."""
    it = itertools.cycle(inputs)
    return lambda: fn(*next(it))


def sums_inputs(gen, shape, dtype, dy_dtype=None):
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    dy = torch.randn(shape, generator=gen, device="cuda").to(dy_dtype or dtype)
    return dy, x


def check_sums(ops, gen, shape, dtype, timed, dy_dtype=None, parent=None):
    """channel_sums / channel_dual_sums vs their plain versions on one
    (..., C) shape; ``dy_dtype`` other than ``dtype`` for the mixed dual
    form.  Tolerance: 1e-5 of sum|terms| per channel (float32 sums taken in
    another order); two launches bit-identical.  Timed: 20 launches per event
    pair over rotating copies of the inputs (> 2x the L2: cold, as in the
    step), the single-launch time beside; ``parent`` (the parent commit's
    kernels) timed the same way, in turns with the new ones."""
    dy, x = sums_inputs(gen, shape, dtype, dy_dtype)
    dims = tuple(range(len(shape) - 1))
    got, dual = ops.channel_sums(x), ops.channel_dual_sums(dy, x)
    again, dual_again = ops.channel_sums(x), ops.channel_dual_sums(dy, x)
    torch.cuda.synchronize()
    if not (torch.equal(got, again) and torch.equal(dual, dual_again)):
        raise AssertionError(f"two launches differ at {shape} {dtype}")
    ref, dual_ref = ops.channel_sums_reference(x), ops.channel_dual_sums_reference(dy, x)
    x32, dy32 = x.float(), dy.float()
    terms = torch.stack([x32.abs().sum(dims), (x32 * x32).sum(dims)])
    dual_terms = torch.stack([dy32.abs().sum(dims), (dy32 * x32).abs().sum(dims)])
    del x32, dy32
    rel = lambda a, r, t: ((a - r).abs() / (t + 1e-6)).max().item()
    err = max(rel(got, ref, terms), rel(dual, dual_ref, dual_terms))
    if not err <= 1e-5:
        raise AssertionError(f"channel sums off by {err} of sum|terms| at {shape} {dtype}")
    res = dict(kernel="channel_sums", shape=list(shape), dtype=dtype_name(dtype),
               dy_dtype=dtype_name(dy.dtype),
               tolerance="1e-5 * sum|terms|; two launches bit-identical", max_rel_err=err,
               max_abs_err=max((got - ref).abs().max().item(),
                               (dual - dual_ref).abs().max().item()))
    if parent is not None:
        p_got, p_dual = parent(x), parent(dy, x)
        res["parent_max_rel_err"] = max(rel(p_got, ref, terms), rel(p_dual, dual_ref, dual_terms))
    if timed:
        n, c = x.numel(), shape[-1]
        sums_in = [(x,)] + rotation(lambda: (x.clone(),), n * x.element_size())[1:]
        dual_in = [(dy, x)] + rotation(lambda: (dy.clone(), x.clone()),
                                       n * (x.element_size() + dy.element_size()))[1:]
        if parent is not None:       # parent, new, new, parent
            for key, new_fn, inputs in (("sums", ops.channel_sums, sums_in),
                                        ("dual", ops.channel_dual_sums, dual_in)):
                t = [device_ms(cycling(f, inputs))
                     for f in (parent, new_fn, new_fn, parent)]
                res[f"{key}_parent_ms"] = (t[0] + t[3]) / 2
                res[f"{key}_ms"] = (t[1] + t[2]) / 2
                res[f"{key}_turns_ms"] = t
        else:
            res["sums_ms"] = device_ms(cycling(ops.channel_sums, sums_in))
            res["dual_ms"] = device_ms(cycling(ops.channel_dual_sums, dual_in))
            res["sums_plain_ms"] = device_ms(cycling(ops.channel_sums_reference, sums_in))
            res["dual_plain_ms"] = device_ms(cycling(ops.channel_dual_sums_reference, dual_in))
            res["sums_library_ms"] = device_ms(
                cycling(lambda t: torch.var_mean(t, dim=dims), sums_in))
            res["dual_library_ms"] = device_ms(cycling(
                lambda d, t: (d.sum(dims, dtype=torch.float32),
                              (d * t).sum(dims, dtype=torch.float32)), dual_in))
            res["sums_single_launch_ms"] = time_ms(lambda: ops.channel_sums(x))
            res["dual_single_launch_ms"] = time_ms(lambda: ops.channel_dual_sums(dy, x))
        res["sums_kernel_ms"] = kernel_ms(cycling(ops.channel_sums, sums_in))
        res["dual_kernel_ms"] = kernel_ms(cycling(ops.channel_dual_sums, dual_in))
        if parent is not None:
            res["sums_parent_kernel_ms"] = kernel_ms(cycling(parent, sums_in))
            res["dual_parent_kernel_ms"] = kernel_ms(cycling(parent, dual_in))
        del sums_in, dual_in
        res["sums_bound_ms"], res["bound_by"] = roofline(n * x.element_size() + 8 * c, 4 * n)
        res["dual_bound_ms"], _ = roofline(n * (x.element_size() + dy.element_size()) + 8 * c,
                                           4 * n)
        res["sums_share_of_bound"] = res["sums_bound_ms"] / res["sums_ms"]
        res["dual_share_of_bound"] = res["dual_bound_ms"] / res["dual_ms"]
    print("kernel check", json.dumps(res), flush=True)
    return res


def on_device(event) -> bool:
    """A kernel, copy or fill on the device; not a user annotation that the
    profiler mirrors onto the device's timeline (``Optimizer.step#...``)."""
    from torch.autograd import DeviceType

    return (event.device_type == DeviceType.CUDA
            and not getattr(event, "is_user_annotation", False))


def device_events(fn, calls: int = 20, windows: int = 4):
    """(name, µs) of every device event (kernels, copies, fills) of ``calls``
    calls of ``fn`` under torch.profiler, after one call outside the window.
    A spin kernel on each side of the calls is left out.  The profiler can
    drop events (a whole window's, at times) but never adds any: a window
    is taken again, up to ``windows`` times, until its count is a whole
    number of events per call, and the fullest window is returned."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(20000)
            for _ in range(calls):
                fn()
            torch.cuda._sleep(20000)
            torch.cuda.synchronize()
        events = [(e.name, e.time_range.end - e.time_range.start) for e in prof.events()
                  if on_device(e) and "spin_kernel" not in e.name]
        if len(events) > len(best):
            best = events
        if best and len(best) % calls == 0:
            break
    return best


def host_us_per_call(fn, calls: int = 200) -> float:
    """Host time (µs) to enqueue one call of ``fn``: the wrapper's checks,
    plan, allocation and launch, with the device far from saturated."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def kernel_ms(fn, calls: int = 20) -> float:
    """Device time per call of ``fn`` from the profiler's kernel durations
    (no host launch overhead, no gaps between launches): the mean duration
    of each device function, summed over the functions of a call."""
    by_name = collections.defaultdict(list)
    for name, us in device_events(fn, calls):
        by_name[name].append(us)
    if not by_name:
        raise AssertionError("the profiler saw no device event in any window")
    return sum(statistics.fmean(v) for v in by_name.values()) / 1e3


def device_kernels_per_call(fn, prefix, calls: int = 20) -> float:
    """Device events per call of ``fn``; each must be a kernel named ``prefix``..."""
    names = [name for name, _ in device_events(fn, calls)]
    if not all(prefix in name for name in names):
        raise AssertionError(f"other device work in {prefix} calls: {set(names)}")
    return len(names) / calls


def check_sums_launches(ops, gen):
    """One device kernel per call (profiler), 1,000 calls in a row give the
    same bits (the ticket counter is re-armed), and two streams at once
    (one counter each) agree with the plain versions."""
    dy, x = sums_inputs(gen, (32, 32, 32, 256), torch.bfloat16)
    _, odd = sums_inputs(gen, (3, 7, 5, 24), torch.float32)       # generic path
    per_call = {name: device_kernels_per_call(fn, "channel_sums_") for name, fn in (
        ("channel_sums", lambda: ops.channel_sums(x)),
        ("channel_dual_sums", lambda: ops.channel_dual_sums(dy, x)),
        ("channel_sums generic", lambda: ops.channel_sums(odd)))}
    if any(v != 1 for v in per_call.values()):
        raise AssertionError(f"device kernels per call: {per_call}")
    host_us = {name: host_us_per_call(fn) for name, fn in (
        ("channel_sums", lambda: ops.channel_sums(x)),
        ("channel_dual_sums", lambda: ops.channel_dual_sums(dy, x)))}
    first, first_dual = ops.channel_sums(x), ops.channel_dual_sums(dy, x)
    runs = [(ops.channel_sums(x), ops.channel_dual_sums(dy, x)) for _ in range(500)]
    torch.cuda.synchronize()
    if not all(torch.equal(a, first) and torch.equal(b, first_dual) for a, b in runs):
        raise AssertionError("1,000 calls in a row do not give the same bits")
    dy2, x2 = sums_inputs(gen, (32, 64, 64, 128), torch.bfloat16)
    streams = [torch.cuda.Stream() for _ in range(2)]
    outs = [[], []]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(50):
        with torch.cuda.stream(streams[0]):
            outs[0].append(ops.channel_sums(x))
        with torch.cuda.stream(streams[1]):
            outs[1].append(ops.channel_dual_sums(dy2, x2))
    torch.cuda.synchronize()
    ref = ops.channel_sums_reference(x)
    ref_dual = ops.channel_dual_sums_reference(dy2, x2)
    for got, r in ((outs[0], ref), (outs[1], ref_dual)):
        if not all(torch.equal(g, got[0]) for g in got):
            raise AssertionError("two streams: calls on one stream differ")
        torch.testing.assert_close(got[0], r, rtol=1e-5, atol=1e-2)
    res = {"device_kernels_per_call": per_call, "host_us_per_call": host_us,
           "calls_in_a_row": 1000,
           "two_streams": "50 channel_sums + 50 channel_dual_sums, bit-identical per stream"}
    print("kernel check", json.dumps({"kernel": "channel_sums launches", **res}), flush=True)
    return res


def parent_sums(source):
    """The parent commit's channel_sums.cu (two launches a call, partials
    of ``channel_sums_max_blocks()`` rows), built with the port's nvcc flags
    and called through its own C interface: fn(x) or fn(dy, x)."""
    import ctypes
    import os

    from uda_aerial_semantic_segmentation_research_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "parent" / "libchannel_sums_parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    include = _build.CSRC_DIR
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(include), "-o", str(out),
                    os.fspath(source)], check=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    lib.channel_sums_max_blocks.restype = ctypes.c_int
    lib.channel_sums_launch.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    rows = lib.channel_sums_max_blocks()

    def call(a, b=None):
        c = a.shape[-1]
        partials = torch.empty((rows, 2, c), dtype=torch.float32, device=a.device)
        res = torch.empty((2, c), dtype=torch.float32, device=a.device)
        err = lib.channel_sums_launch(
            a.data_ptr(), None if b is None else b.data_ptr(), partials.data_ptr(),
            res.data_ptr(), int(a.dtype == torch.bfloat16),
            int(b is not None and b.dtype == torch.bfloat16), a.numel() // c, c,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent channel_sums failed: CUDA error {err}")
        return res

    return call


def compare_sums_with_parent(sums_ops, source, card):
    """The new and the parent's sums kernels at the train step's 7 BatchNorm
    shapes (bf16), same inputs, 20 launches per event pair on rotating cold
    copies, in turns (parent, new, new, parent)."""
    parent = parent_sums(source)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = [check_sums(sums_ops, gen, shape, torch.bfloat16, timed=True, parent=parent)
            for shape in sorted(BN_SHAPES)]
    step = lambda key: sum(r[key] * BN_SHAPES[tuple(r["shape"])] for r in rows)
    bound = step("sums_bound_ms") + step("dual_bound_ms")
    new_ms = step("sums_ms") + step("dual_ms")
    old_ms = step("sums_parent_ms") + step("dual_parent_ms")
    print(json.dumps({"sums_vs_parent": {
        "per_step_ms": new_ms, "parent_per_step_ms": old_ms, "bound_ms": bound,
        "share_of_bound": bound / new_ms, "parent_share_of_bound": bound / old_ms,
        "kernel_per_step_ms": step("sums_kernel_ms") + step("dual_kernel_ms"),
        "parent_kernel_per_step_ms": step("sums_parent_kernel_ms") + step("dual_parent_kernel_ms"),
        "per_shape": [{k: r[k] for k in ("shape", "sums_ms", "sums_parent_ms", "dual_ms",
                                         "dual_parent_ms", "sums_share_of_bound",
                                         "dual_share_of_bound", "sums_turns_ms",
                                         "dual_turns_ms", "sums_kernel_ms",
                                         "sums_parent_kernel_ms", "dual_kernel_ms",
                                         "dual_parent_kernel_ms")} for r in rows],
        "card": card}}), flush=True)


# flags of each batch class at the train step's shape (B=32): every group
# element, only identity and flips (no shared-memory transpose), only transposes
DIHEDRAL_CLASSES = {"mixed": tuple(range(8)), "untransposed": (0, 2, 4, 6),
                    "transposed": (1, 3, 5, 7)}
# untimed dihedral checks: (B, S, C, mask dtype, unaligned view, int64 flags
# with high bits): the generic path (S off 16, C other than 3, wide masks, an
# unaligned pointer), units cut by the image's edge (S=80: a 16-row band;
# S=1040: a 16-column unit), blocks that reuse their stages (B=70), B=1, S=1
DIHEDRAL_EDGES = [(33, 50, 3, torch.uint8, False, False), (1, 512, 3, torch.uint8, True, False),
                  (2, 1040, 3, torch.uint8, False, True), (3, 80, 3, None, False, False),
                  (4, 33, 1, torch.int32, False, False), (2, 16, 8, torch.int64, False, True),
                  (1, 1, 3, torch.uint8, False, False), (70, 512, 3, torch.uint8, False, True)]


def dihedral_flags(host_rng, cls, b):
    """int32 (b,) flags of class ``cls``, each of its elements present."""
    pick = np.asarray(DIHEDRAL_CLASSES[cls], np.int32)
    flags = pick[host_rng.permutation(b) % len(pick)]
    if set(flags.tolist()) != set(pick.tolist()):
        raise AssertionError(f"not every element of {cls} is present")
    return torch.from_numpy(flags).cuda()


def dihedral_case(host_rng, b, s, c, mask_dtype, unaligned, wide_flags):
    """Images (an unaligned view when asked), flags, masks for one check."""
    n = b * s * s * c
    base = torch.from_numpy(host_rng.integers(0, 256, n + 1, dtype=np.uint8)).cuda()
    images = (base[1:] if unaligned else base[:n]).view(b, s, s, c)
    flags = torch.from_numpy(host_rng.integers(0, 8, b).astype(np.int32)).cuda()
    if wide_flags:  # bits above the third are ignored, in either word
        flags = flags.long() + (torch.arange(b, device="cuda") % 5 << 3) + (1 << 40)
    masks = None if mask_dtype is None else torch.from_numpy(
        host_rng.integers(0, CLASSES, (b, s, s)).astype(np.int32)).cuda().to(mask_dtype)
    return images, flags, masks


def check_dihedral(ops, host_rng, parent=None):
    """dihedral_normalize vs its plain version at the train step's shape with
    uint8 masks, for a batch of every group element, of identity and flips
    only, and of transposes only, ``normalize`` both ways: bit-exact images
    and masks, two launches bit-identical; then the edges (DIHEDRAL_EDGES).
    Timed per class: 20 launches per event pair over rotating input copies
    larger than twice the L2 (cold, as in the step), the profiler's kernel
    duration, one launch per event pair, and the plain version; ``parent``
    (an older kernel) timed the same way, in turns with the new one."""
    b = TRAIN_BATCH
    images = torch.from_numpy(host_rng.integers(0, 256, (b, TILE, TILE, 3), dtype=np.uint8)).cuda()
    masks = torch.from_numpy(host_rng.integers(0, CLASSES, (b, TILE, TILE), dtype=np.uint8)).cuda()
    flag_sets = {cls: dihedral_flags(host_rng, cls, b) for cls in DIHEDRAL_CLASSES}
    max_err = 0.0
    for cls, flags in flag_sets.items():
        for normalize in (False, True):
            x, m = ops.dihedral_normalize(images, flags, masks, normalize=normalize)
            x2, m2 = ops.dihedral_normalize(images, flags, masks, normalize=normalize)
            torch.cuda.synchronize()
            if not (torch.equal(x, x2) and torch.equal(m, m2)):
                raise AssertionError(f"two dihedral_normalize launches differ ({cls})")
            x_ref, m_ref = ops.dihedral_normalize_reference(images, flags, masks,
                                                            normalize=normalize)
            if not (torch.equal(x, x_ref) and torch.equal(m, m_ref)):
                raise AssertionError(f"dihedral_normalize({cls}, normalize={normalize}) "
                                     "is not bit-exact")
            max_err = max(max_err, (x - x_ref).abs().max().item())
            if parent is not None:
                px, pm = parent(images, flags, masks, normalize)
                if not (torch.equal(px, x_ref) and torch.equal(pm, m_ref)):
                    raise AssertionError(f"the parent kernel is not bit-exact ({cls})")
            del x, m, x2, m2, x_ref, m_ref
    edges = []
    for case in DIHEDRAL_EDGES:
        im, fl, mk = dihedral_case(host_rng, *case)
        for normalize in (False, True) if im.shape[-1] == 3 else (False,):
            x, m = ops.dihedral_normalize(im, fl, mk, normalize=normalize)
            x_ref, m_ref = ops.dihedral_normalize_reference(im, fl, mk, normalize=normalize)
            if not (torch.equal(x, x_ref) and (mk is None or torch.equal(m, m_ref))):
                raise AssertionError(f"dihedral_normalize is not bit-exact at {case}")
        edges.append([*case[:3], dtype_name(case[3]) if case[3] else None, *case[4:]])
    n_img, n_mask = images.numel(), masks.numel()
    res = dict(kernel="dihedral_normalize", shape=list(images.shape), dtype="uint8",
               masks="uint8", tolerance="bit-exact; two launches bit-identical",
               max_abs_err=max_err, edges_bit_exact=edges, library_ms=None)
    res["bound_ms"], res["bound_by"] = roofline(5 * n_img + 5 * n_mask + 4 * b, 2 * n_img)
    copies = rotation(lambda: (images.clone(), masks.clone()), n_img + n_mask)
    new_fn = lambda fl: lambda im, mk: ops.dihedral_normalize(im, fl, mk)
    for cls, flags in flag_sets.items():
        inputs = [(images, masks)] + copies[1:]
        r = {}
        if parent is not None:       # parent, new, new, parent
            old_fn = lambda im, mk, fl=flags: parent(im, fl, mk)
            t = [device_ms(cycling(f, inputs))
                 for f in (old_fn, new_fn(flags), new_fn(flags), old_fn)]
            r["ms"], r["parent_ms"], r["turns_ms"] = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2, t
            r["parent_kernel_ms"] = kernel_ms(cycling(old_fn, inputs))
        else:
            r["ms"] = device_ms(cycling(new_fn(flags), inputs))
            r["plain_ms"] = device_ms(cycling(
                lambda im, mk, fl=flags: ops.dihedral_normalize_reference(im, fl, mk), inputs))
        r["kernel_ms"] = kernel_ms(cycling(new_fn(flags), inputs))
        r["single_launch_ms"] = time_ms(lambda: ops.dihedral_normalize(images, flags, masks))
        r["share_of_bound"] = res["bound_ms"] / r["ms"]
        r["share_of_bound_kernel_time"] = res["bound_ms"] / r["kernel_ms"]
        res[cls] = r
    del copies
    mixed = flag_sets["mixed"]
    odd_images, odd_masks = images[:, :50, :50].contiguous(), masks[:, :50, :50].contiguous()
    res["device_kernels_per_call"] = {
        "bulk": device_kernels_per_call(lambda: ops.dihedral_normalize(images, mixed, masks),
                                        "dihedral_normalize_"),
        "generic": device_kernels_per_call(
            lambda: ops.dihedral_normalize(odd_images, mixed, odd_masks), "dihedral_normalize_")}
    if any(v != 1 for v in res["device_kernels_per_call"].values()):
        raise AssertionError(f"device kernels per call: {res['device_kernels_per_call']}")
    res["host_us_per_call"] = host_us_per_call(
        lambda: ops.dihedral_normalize(images, mixed, masks))
    print("kernel check", json.dumps(res), flush=True)
    return res


def check_dihedral_no_masks(ops, host_rng) -> dict:
    """dihedral_normalize without masks (the target batches of phases 2 and
    3) at the train step's shape, for each batch class and ``normalize``
    both ways: bit-exact against the plain version, no mask returned; timed
    for the mixed class as 20 launches per event pair on rotating cold
    copies, beside its plain version and its byte bound."""
    b = TRAIN_BATCH
    images = torch.from_numpy(host_rng.integers(0, 256, (b, TILE, TILE, 3), dtype=np.uint8)).cuda()
    for cls in DIHEDRAL_CLASSES:
        flags = dihedral_flags(host_rng, cls, b)
        for normalize in (False, True):
            x, m = ops.dihedral_normalize(images, flags, None, normalize=normalize)
            x_ref, _ = ops.dihedral_normalize_reference(images, flags, None, normalize=normalize)
            if m is not None or not torch.equal(x, x_ref):
                raise AssertionError(f"dihedral_normalize without masks ({cls}, "
                                     f"normalize={normalize}) is not bit-exact")
    flags = dihedral_flags(host_rng, "mixed", b)
    n = images.numel()
    inputs = [(images,)] + rotation(lambda: (images.clone(),), n)[1:]
    res = dict(shape=list(images.shape), masks=None, tolerance="bit-exact", max_abs_err=0.0,
               ms=device_ms(cycling(lambda im: ops.dihedral_normalize(im, flags, None), inputs)),
               plain_ms=device_ms(cycling(
                   lambda im: ops.dihedral_normalize_reference(im, flags, None), inputs)))
    res["bound_ms"], res["bound_by"] = roofline(5 * n + 4 * b, 2 * n)
    res["share_of_bound"] = res["bound_ms"] / res["ms"]
    print("kernel check", json.dumps({"dihedral_normalize_no_masks": res}), flush=True)
    return res


def parent_dihedral(source):
    """An older dihedral_normalize.cu with the parent's C interface (int32
    flags, no plan), built with the port's nvcc flags: fn(images, flags,
    masks, normalize=False) with uint8 masks."""
    import ctypes
    import os

    from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "parent" / "libdihedral_normalize_parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o",
                    str(out), os.fspath(source)], check=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dihedral_normalize_launch.argtypes = [ptr] * 5 + [i32] * 5 + [f32] * 6 + [ptr]
    lib.dihedral_normalize_launch.restype = i32

    def call(images, flags, masks, normalize=False):
        b, s, _, c = images.shape
        x = torch.empty(images.shape, dtype=torch.float32, device=images.device)
        m = torch.empty(masks.shape, dtype=torch.int32, device=images.device)
        err = lib.dihedral_normalize_launch(
            images.data_ptr(), flags.data_ptr(), x.data_ptr(), masks.data_ptr(), m.data_ptr(),
            0, b, s, c, int(normalize), *Config.NORMALIZE_MEAN, *Config.NORMALIZE_STD,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent dihedral_normalize failed: CUDA error {err}")
        return x, m

    return call


def compare_dihedral_with_parent(ops, source, card):
    """The new and an older dihedral kernel at the train step's shape, same
    inputs, per batch class, 20 launches per event pair on rotating cold
    copies, in turns (parent, new, new, parent), and by kernel time."""
    res = check_dihedral(ops, np.random.default_rng(SEED), parent=parent_dihedral(source))
    print(json.dumps({"dihedral_vs_parent": {
        "bound_ms": res["bound_ms"],
        **{cls: res[cls] | {"parent_share_of_bound_kernel_time":
                            res["bound_ms"] / res[cls]["parent_kernel_ms"]}
           for cls in DIHEDRAL_CLASSES},
        "card": card}}), flush=True)


def augment_stages(augment, ops, cfg, images, masks, gen):
    """(stage name, function) of ``augment_batch``'s pieces in order, each on
    the previous piece's output (computed once here) and on the same draws:
    the draws themselves, the dihedral kernel with the cast to the compute
    dtype, the warps, each photometric stage, the float32 normalize."""
    n, shape = images.shape[0], tuple(images.shape)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.compute_dtype]

    def draws():
        return (augment._sample_dihedral(gen, n, cfg),
                augment.sample_params(gen, shape, cfg, has_masks=True))

    abc, params = draws()
    flags = ops.flags_from_abc(*abc)
    front = lambda: ops.dihedral_normalize(images, flags, masks)
    x, m = front()
    x = x.to(dt)
    stages = [("draws", draws), ("dihedral kernel + cast", lambda: front()[0].to(dt))]
    if cfg.p_ssr > 0 or cfg.p_distort > 0:
        stages.append(("warps", lambda x=x, m=m: augment._warp_stage(x, m, params.warp, cfg)))
        x, m = stages[-1][1]()
    photometric = params.photometric
    for name, p, fn, d in (("noise", cfg.p_noise, augment._noise_stage, photometric.noise),
                           ("blur", cfg.p_blur, augment._blur_stage, photometric.blur),
                           ("colour", cfg.p_color, augment._color_stage, photometric.color),
                           ("hsv", cfg.p_hsv, augment._hsv_stage, photometric.hsv)):
        if p > 0:
            stages.append((name, lambda x=x, fn=fn, d=d: fn(x, d, cfg)))
            x = stages[-1][1]()
    mean, std = ops.imagenet_stats(images.device)
    stages.append(("normalize", lambda x=x: (x.float() - mean) / std))
    return stages


def time_augment_batch(augment, ops, host_rng, card):
    """The train step's front end at its shape, (32, 512, 512, 3) uint8 with
    uint8 masks, for the dihedral-only pipeline, WEAK and STRONG: draws from
    a generator on the card, as the step makes them.  Per pipeline: ms as 20
    calls per event pair on rotating cold copies, the profiler's device ms
    and launches of the whole call by kind and by stage (``augment_stages``),
    the peak memory a call adds, and one call under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises if anything
    in the call waits on the host."""
    images = torch.from_numpy(host_rng.integers(0, 256, (TRAIN_BATCH, TILE, TILE, 3),
                                                dtype=np.uint8)).cuda()
    masks = torch.from_numpy(host_rng.integers(0, CLASSES, (TRAIN_BATCH, TILE, TILE),
                                               dtype=np.uint8)).cuda()
    inputs = [(images, masks)] + rotation(lambda: (images.clone(), masks.clone()),
                                          images.numel() + masks.numel())[1:]
    n_img, n_mask = images.numel(), masks.numel()
    results = {}
    for name, cfg in (("dihedral only", dihedral_only(augment)), ("WEAK", augment.WEAK),
                      ("STRONG", augment.STRONG)):
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        fn = lambda im, mk, cfg=cfg, gen=gen: augment.augment_batch(gen, im, mk, cfg=cfg)
        ms = device_ms(cycling(fn, inputs))
        calls = 10
        by_kind, kind_launches = collections.defaultdict(float), collections.Counter()
        for ev, us in device_events(cycling(fn, inputs), calls):
            kind = next((c for c, keys in PROFILE_CATEGORIES if any(k in ev for k in keys)),
                        "other")
            by_kind[kind] += us / 1e3 / calls
            kind_launches[kind] += 1
        by_stage = {}
        for stage, stage_fn in augment_stages(augment, ops, cfg, images, masks, gen):
            events = device_events(stage_fn, calls)
            by_stage[stage] = {"device_ms": sum(us for _, us in events) / 1e3 / calls,
                               "launches": len(events) / calls}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn(images, masks)
        torch.cuda.synchronize()
        peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        torch.cuda.set_sync_debug_mode("error")
        try:
            x, m = fn(images, masks)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        if (tuple(x.shape) != tuple(images.shape) or x.dtype != torch.float32
                or m.dtype != torch.int32 or not torch.isfinite(x).all()
                or m.min() < 0 or m.max() >= CLASSES):
            raise AssertionError(f"augment_batch {name} gave wrong images or masks")
        results[name] = {
            "shape": [TRAIN_BATCH, TILE, TILE, 3], "masks": "uint8",
            "compute_dtype": cfg.compute_dtype, "ms": ms,
            "device_ms": sum(by_kind.values()), "device_ms_by_kind": dict(by_kind),
            "launches": sum(kind_launches.values()) / calls,
            "launches_by_kind": {k: c / calls for k, c in kind_launches.items()},
            "by_stage": by_stage, "peak_added_gib": peak_gib,
            "sync_debug_call": "no host sync (set_sync_debug_mode('error') raised nothing)",
            # the function's least bytes: uint8 images and masks in, f32
            # images and int32 masks out
            "bound_ms": roofline(5 * n_img + 5 * n_mask, 0)[0],
            "timed_with": "20 calls per event pair, rotating copies > 2x L2", "card": card}
        print(json.dumps({"augment_batch": {name: results[name]}}), flush=True)
    return results


def check_clahe_card_vs_cpu(augment, x, clip, tiles):
    """CLAHE's pieces on the card against the CPU on the same float32 images
    ``x`` (on the card): LAB within 1e-4; the levels ``round(L * 255 /
    100)`` equal, or one apart where the CPU's ``L * 255 / 100`` lies within
    1e-3 of a half level (a one-ulp L decides such a tie; one level moves
    the tile's histogram, and so its LUT); then, fed the card's levels on
    both devices, the LUTs equal and the blended L within 1e-4.  Returns
    the images whose levels differ at a tie."""
    x = torch.clamp(x, 0.0, 1.0)
    lab = augment._rgb_to_lab(x)
    lab_cpu = augment._rgb_to_lab(x.cpu())
    for got, ref in zip(lab, lab_cpu):
        if not (got.cpu() - ref).abs().max().item() <= 1e-4:
            raise AssertionError("LAB on the card differs from the CPU")
    level = lambda L: torch.clamp(torch.round(L * (255.0 / 100.0)), 0, 255).to(torch.int32)
    levels, levels_cpu = level(lab[0]), level(lab_cpu[0])
    off = levels.cpu() != levels_cpu
    half = lab_cpu[0][off] * (255.0 / 100.0)
    if not (bool(((levels.cpu() - levels_cpu).abs() <= 1).all())
            and bool(((half - torch.floor(half) - 0.5).abs() < 1e-3).all())):
        raise AssertionError("CLAHE levels differ off a tie between the card and the CPU")
    lut = augment._clahe_lut(levels, clip, tiles)
    lut_cpu = augment._clahe_lut(levels.cpu(), clip.cpu(), tiles)
    if not torch.equal(lut.cpu(), lut_cpu):
        raise AssertionError("CLAHE LUTs differ between the card and the CPU")
    newl = augment._clahe_apply(levels, lut, tiles)
    newl_cpu = augment._clahe_apply(levels.cpu(), lut_cpu, tiles)
    if not (newl.cpu() - newl_cpu).abs().max() <= 1e-4:
        raise AssertionError("CLAHE blend differs between the card and the CPU")
    rgb = augment._lab_to_rgb(newl * (100.0 / 255.0), *lab[1:])
    rgb_cpu = augment._lab_to_rgb(newl.cpu() * (100.0 / 255.0), *(t.cpu() for t in lab[1:]))
    if not (rgb.cpu() - rgb_cpu).abs().max() <= 1e-4:
        raise AssertionError("LAB to RGB differs between the card and the CPU")
    return off.flatten(1).any(1), int(off.sum())


def check_augment_card_vs_cpu(augment, ops, host_rng):
    """Every stage of WEAK and STRONG (float32 pixel math) on the card against
    the same stage on the CPU, each fed the card's previous output, with the
    same draws (made on the host, every gate on: both images take every
    stage).  Tolerances: images 1e-4 after each stage up to colour, 1e-3
    after HSV (its hue divides by max - min, which is small for greyish
    pixels, so a 1e-5 input difference can move it by ~1e-4); masks may
    differ at nearest-neighbour ties of the warp coordinates (one float32
    ulp apart on the two devices), at most 1e-4 of the pixels.  CLAHE is
    held piece by piece (``check_clahe_card_vs_cpu``); an image whose CLAHE
    levels differ at a tie is left out of the colour stage's comparison."""
    images, masks = (torch.from_numpy(a) for a in train_batches(host_rng, 1, batch=2,
                                                                 tile=256)[0])
    result = {}
    for name in ("WEAK", "STRONG"):
        cfg = dataclasses.replace(getattr(augment, name), compute_dtype="float32")
        gen = torch.Generator().manual_seed(SEED)
        flags = ops.flags_from_abc(*augment._sample_dihedral(gen, 2, cfg))
        params = augment.sample_params(gen, tuple(images.shape), cfg, has_masks=True)
        every = lambda d: None if d is None else d._replace(do=torch.ones(2, dtype=torch.bool))
        host = augment.AugmentDraws(augment.WarpDraws(*(every(d) for d in params.warp)),
                                    augment.PhotometricDraws(*(every(d) for d in
                                                               params.photometric)))
        card = augment.draws_to(host, "cuda")
        photo = lambda p, stage: getattr(p.photometric, stage)
        stages = [("warps", lambda x, m, p: augment._warp_stage(x, m, p.warp, cfg), 1e-4),
                  ("noise", lambda x, m, p: (augment._noise_stage(x, photo(p, "noise"), cfg), m),
                   1e-4),
                  ("blur", lambda x, m, p: (augment._blur_stage(x, photo(p, "blur"), cfg), m),
                   1e-4),
                  ("colour", lambda x, m, p: (augment._color_stage(x, photo(p, "color"), cfg),
                                              m), 1e-4),
                  ("hsv", lambda x, m, p: (augment._hsv_stage(x, photo(p, "hsv"), cfg), m),
                   1e-3)]
        x, m = ops.dihedral_normalize(images.cuda(), flags.cuda(), masks.cuda())
        errors = {}
        for stage, fn, tol in stages:
            kept = torch.ones(2, dtype=torch.bool)
            if stage == "colour":
                tie, errors["clahe_levels_off_at_ties"] = check_clahe_card_vs_cpu(
                    augment, x, card.photometric.color.clahe_clip, cfg.clahe_tiles)
                kept &= ~(tie & (host.photometric.color.choice < 0.25))
            ref_x, ref_m = fn(x.cpu(), m.cpu(), host)
            x, m = fn(x, m, card)
            err = (x.cpu() - ref_x)[kept].abs().max().item() if kept.any() else 0.0
            off = (m.cpu() != ref_m).float().mean().item()
            errors[stage] = {"max_abs_err": err, "mask_share_off": off,
                             "images_compared": int(kept.sum())}
            if not (err <= tol and off <= 1e-4):
                raise AssertionError(f"{name} {stage} on the card vs the CPU: {errors[stage]}")
        result[name] = errors
    print(json.dumps({"augment_card_vs_cpu": result}), flush=True)
    return result


def check_fused_ce(ops, gen, dtype):
    """fused_cross_entropy forward and backward vs the plain versions at the
    train step's shape.  Tolerance: loss 1e-5 relative; dlogits 1e-5 of the
    largest entry in float32, one bfloat16 ulp (2^-7 of it) in bfloat16."""
    shape = (TRAIN_BATCH, TILE, TILE, CLASSES)
    logits = (3 * torch.randn(shape, generator=gen, device="cuda")).to(dtype)
    labels = torch.randint(0, CLASSES, shape[:-1], generator=gen, device="cuda",
                           dtype=torch.int32)
    x = logits.clone().requires_grad_()
    loss = ops.fused_cross_entropy(x, labels)
    loss.backward()
    torch.cuda.synchronize()
    ref = ops.fused_cross_entropy_reference(logits, labels)
    g_ref = ops.fused_cross_entropy_grad_reference(logits, labels,
                                                   torch.ones((), device="cuda"))
    torch.testing.assert_close(loss.detach(), ref, rtol=1e-5, atol=1e-5)
    peak = g_ref.float().abs().max().item()
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    grad_err = (x.grad.float() - g_ref.float()).abs().max().item()
    if not grad_err <= tol * peak:
        raise AssertionError(f"dlogits off by {grad_err} (largest entry {peak}) in {dtype}")
    del g_ref

    def fwd_bwd(loss_fn):
        x.grad = None
        loss_fn(x).backward()

    n, elt = logits.numel(), logits.element_size()
    rows = n // CLASSES
    flat_labels = labels.reshape(-1).long()
    library = lambda t: F.cross_entropy(t.reshape(-1, CLASSES), flat_labels)
    res = dict(kernel="fused_cross_entropy", shape=list(shape), dtype=dtype_name(dtype),
               tolerance="loss 1e-5, dlogits 1e-5 (f32) / 2^-7 (bf16) of the largest entry",
               max_abs_err=abs(loss.item() - ref.item()), grad_max_abs_err=grad_err,
               fwd_ms=time_ms(lambda: ops.fused_cross_entropy(logits, labels)),
               fwd_bwd_ms=time_ms(lambda: fwd_bwd(lambda t: ops.fused_cross_entropy(t, labels))),
               plain_fwd_bwd_ms=time_ms(lambda: (
                   ops.fused_cross_entropy_reference(logits, labels),
                   ops.fused_cross_entropy_grad_reference(logits, labels, loss.detach()))),
               library_fwd_ms=time_ms(lambda: library(logits)),
               library_fwd_bwd_ms=time_ms(lambda: fwd_bwd(library)))
    # forward: logits and labels read once; backward: read again, dlogits written
    res["bound_ms"], res["bound_by"] = roofline(3 * n * elt + 8 * rows + 8, 30 * n)
    print("kernel check", json.dumps(res), flush=True)
    return res


def dihedral_only(augment):
    """The weak pipeline with every stage after the dihedral one switched off."""
    return dataclasses.replace(augment.WEAK, p_ssr=0.0, p_distort=0.0, p_noise=0.0,
                               p_blur=0.0, p_color=0.0, p_hsv=0.0)


def train_batches(host_rng, n, batch=TRAIN_BATCH, tile=TILE):
    return [(host_rng.integers(0, 256, (batch, tile, tile, 3), dtype=np.uint8),
             host_rng.integers(0, CLASSES, (batch, tile, tile), dtype=np.uint8))
            for _ in range(n)]


def kernel_counters():
    """name -> the wrapper function carrying that kernel's ``launches`` count."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops import (
        channel_sums,
        conv_bn_relu,
        dihedral,
        fused_ce,
    )

    return {"conv_bn_relu": conv_bn_relu.conv_bn_relu,
            "channel_sums": channel_sums.channel_sums,
            "channel_dual_sums": channel_sums.channel_dual_sums,
            "dihedral_normalize": dihedral.dihedral_normalize,
            "fused_cross_entropy": fused_ce.fused_cross_entropy}


def reset_counts(counters):
    for fn in counters.values():
        fn.launches = 0


def read_counts(counters):
    return {name: fn.launches for name, fn in counters.items()}


def probe_batch(batch: int) -> int:
    """Does a bf16 train step of the full-width model fit at ``batch``?
    Prints one JSON line with the answer, the peak memory and the step time."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.models import create_unet
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops import augment
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import (
        TrainState,
        adam,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.steps import (
        make_supervised_train_step,
    )

    model = create_unet("resnet34", classes=CLASSES, seed=SEED, dtype=torch.bfloat16,
                        device="cuda")
    state = TrainState(model, adam(1e-4))
    step = make_supervised_train_step(model, CLASSES, fused_ce=True)          # WEAK
    images, masks = (torch.from_numpy(a).cuda() for a in
                     train_batches(np.random.default_rng(SEED), 1, batch)[0])
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    result = {"batch": batch, "tile": TILE, "dtype": "bfloat16", "card": card_line()}
    torch.cuda.reset_peak_memory_stats()
    try:
        step(state, gen, images, masks)
        torch.cuda.synchronize()
        result["step_ms"] = time_ms(lambda: step(state, gen, images, masks), reps=3, warmup=0)
        result["fits"] = True
    except torch.cuda.OutOfMemoryError as e:
        result["fits"] = False
        result["error"] = str(e).splitlines()[0][:200]
    result["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(json.dumps({"probe": result}), flush=True)
    return 0


# the trainer phase: an in-memory dataset of seeded 512 px tiles, split 64 / 16
TRAINER_TILES, TRAINER_TRAIN, TRAINER_EPOCHS = 80, 64, 2
# what the JAX trainer writes as scalars (train / validate / early stopping)
TRAINER_SCALAR_TAGS = (
    ["train/loss", "train/iou", "train/accuracy", "train/learning_rate",
     "perf/steps_per_sec", "perf/tiles_per_sec", "perf/step_ms_p50",
     "val/loss", "val/iou", "val/accuracy", "val/iou_epoch",
     "early_stopping/score", "early_stopping/counter"]
    + [f"train/iou_class_{c}" for c in range(CLASSES)])
TRAINER_IMAGE_TAGS = [f"{p}/{k}" for p in ("train", "val")
                      for k in ("image", "ground_truth", "prediction", "overlay",
                                "confusion_matrix", "roc_curves", "pr_curves")]
# installation facts printed with the trainer line: the modules the JAX
# trainer path imports, and the toolchain the native decoder needs
INSTALL_MODULES = ("cv2", "PIL", "pandas", "tqdm", "matplotlib", "seaborn", "sklearn",
                   "tensorboard", "triton", "jax")
INSTALL_FILES = ("/usr/include/jpeglib.h", "/usr/include/png.h")


class InMemoryTiles:
    """Seeded uint8 tiles and int32 masks in host memory, with the
    ``load_raw`` contract of ``DroneDataset`` (the card's machine has no
    image decoder; file decoding is held against the JAX package on the
    CPU, in tests/test_torch_data.py)."""

    def __init__(self, images, masks):
        self.images, self.masks = images, masks

    def __len__(self):
        return len(self.images)

    def load_raw(self, idx):
        return self.images[idx], self.masks[idx]

    __getitem__ = load_raw


def installation() -> dict:
    """Which of the JAX trainer path's imports and of the native decoder's
    toolchain this machine has, and whether the native decoder builds."""
    import importlib.util
    import shutil

    from uda_aerial_semantic_segmentation_research_tpu_torch.data import native

    return {"modules": {m: importlib.util.find_spec(m) is not None for m in INSTALL_MODULES},
            "g++": shutil.which("g++") is not None,
            "headers": {f: os.path.exists(f) for f in INSTALL_FILES},
            "native_decoder_builds": native.available()}


def trace_events(prof):
    """The device events of a profile as dicts (name, cat, stream, ts, dur,
    bytes), read from its Chrome trace."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)
    events = raw["traceEvents"] if isinstance(raw, dict) else raw
    out = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            args = e.get("args", {})
            out.append({"name": e["name"], "cat": e["cat"], "stream": args.get("stream"),
                        "ts": float(e["ts"]), "dur": float(e["dur"]),
                        "bytes": args.get("bytes")})
    return out


def union_us(spans) -> float:
    total, cur = 0.0, None
    for start, end in sorted(spans):
        if cur is None or start > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    return total + (cur[1] - cur[0] if cur else 0.0)


def overlap_us(span, spans) -> float:
    """Time of ``span`` covered by the union of ``spans``."""
    start, end = span
    return union_us([(max(s, start), min(e, end)) for s, e in spans
                     if e > start and s < end])


def drive_trainer(counters, card, host_rng) -> dict:
    """Phase 9: ``SegmentationTrainer.train`` on the card (see main)."""
    import warnings

    from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
    from uda_aerial_semantic_segmentation_research_tpu_torch.data.dataset import (
        WeightedRandomSampler,
        class_balance,
        random_split,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.data.loader import DataLoader
    from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
        create_model,
        from_jax_state_dict,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.training import train as train_mod
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.steps import (
        make_predict_step,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.utils.checkpoint import (
        load_checkpoint,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.visualization.tensorboard_logger import (
        read_events,
    )

    install = installation()
    images = host_rng.integers(0, 256, (TRAINER_TILES, TILE, TILE, 3), dtype=np.uint8)
    masks = host_rng.integers(0, CLASSES, (TRAINER_TILES, TILE, TILE)).astype(np.int32)
    dataset = InMemoryTiles(images, masks)
    counts = [np.bincount(m.reshape(-1), minlength=CLASSES) for m in masks]
    _, weights = class_balance([{c: int(n[c]) for c in np.nonzero(n)[0]} for n in counts],
                               [m.size for m in masks])
    train_ds, val_ds = random_split(dataset, [TRAINER_TRAIN, TRAINER_TILES - TRAINER_TRAIN],
                                    seed=SEED)
    w = weights[train_ds.indices]
    sampler = WeightedRandomSampler(w / w.sum(), num_samples=len(w))
    train_loader = DataLoader(train_ds, batch_size=TRAIN_BATCH, sampler=sampler,
                              num_workers=Config.NUM_WORKERS)
    val_loader = DataLoader(val_ds, batch_size=TRAIN_BATCH)
    steps_per_epoch = len(train_loader)

    model = create_model("Unet", "resnet34", encoder_weights=None, classes=CLASSES,
                         seed=SEED, dtype=torch.bfloat16, device="cuda")
    probe = torch.from_numpy(images[-2:]).cuda()          # two validation tiles

    class EarlyStoppingFromEpochOne(train_mod.EarlyStopping):
        """The trainer's early stopper, with min_epochs=1 so that a 2-epoch
        run selects and saves a best model (the trainer keeps 10)."""

        def __init__(self, **kw):
            super().__init__(**{**kw, "min_epochs": 1})

    saved, per_step, batch_kinds, figure_ms, val_ms, epoch_times = [], [], [], [], [], []
    record = {}
    real_save, real_early = train_mod.save_checkpoint, train_mod.EarlyStopping
    with tempfile.TemporaryDirectory() as tmp:
        old_dirs = Config.LOGS_DIR, Config.CHECKPOINTS_DIR
        Config.LOGS_DIR, Config.CHECKPOINTS_DIR = os.path.join(tmp, "logs"), os.path.join(tmp, "ckpt")
        trainer = train_mod.SegmentationTrainer(model, device="cuda")

        def save_and_snapshot(obj, path):
            t0 = time.perf_counter()
            real_save(obj, path)
            write_ms = (time.perf_counter() - t0) * 1e3
            saved.append({"path": str(path), "epoch": obj["epoch"], "write_ms": write_ms,
                          "bytes": os.path.getsize(path),
                          "logits": make_predict_step(trainer.model)(probe).clone()})

        trainer._build_steps()
        train_step, log_figures = trainer._train_step, trainer._log_figures
        validate, train_epoch = trainer.validate, trainer.train_epoch

        def counted_step(state, gen, imgs, msks):
            before = read_counts(counters)
            out = train_step(state, gen, imgs, msks)
            after = read_counts(counters)
            per_step.append({k: after[k] - before[k] for k in after})
            batch_kinds.append({"images": str(imgs.dtype), "masks": str(msks.dtype),
                                "on_card": imgs.is_cuda and msks.is_cuda})
            return out

        def timed_figures(*args, **kw):
            caught = record.get("caught")                  # the observed epoch's
            n0, t0 = len(caught or ()), time.perf_counter()
            log_figures(*args, **kw)          # ends on host copies: nothing left queued
            figure_ms.append((time.perf_counter() - t0) * 1e3)
            if caught is not None:
                record["figure_syncs"].update(range(n0, len(caught)))

        def timed_validate(loader):
            t0 = time.perf_counter()
            out = validate(loader)
            torch.cuda.synchronize()
            val_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        def observed_epoch(loader, state, epoch):
            if epoch != TRAINER_EPOCHS:
                out = train_epoch(loader, state, epoch)
                epoch_times.extend(trainer.timer.times)
                return out
            # the last epoch: its device trace and its host syncs
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                record["caught"], record["figure_syncs"] = caught, set()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        out = train_epoch(loader, state, epoch)
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                    torch.cuda.synchronize()
                    wall_us = (time.perf_counter() - t0) * 1e6
            epoch_times.extend(trainer.timer.times)
            del record["caught"]
            syncs = [i for i, w in enumerate(caught) if "called a synchronizing" in str(w.message)]
            in_figures = record["figure_syncs"]
            record["syncs"] = len(syncs)
            record["figure_syncs"] = len(in_figures.intersection(syncs))
            record["sync_sites"] = collections.Counter(
                f"{pathlib.Path(caught[i].filename).name}:{caught[i].lineno}" for i in syncs
                if i not in in_figures)
            record["events"], record["wall_us"] = trace_events(prof), wall_us
            return out

        trainer._train_step, trainer._log_figures = counted_step, timed_figures
        trainer.validate, trainer.train_epoch = timed_validate, observed_epoch
        train_mod.save_checkpoint = save_and_snapshot
        train_mod.EarlyStopping = EarlyStoppingFromEpochOne
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            reset_counts(counters)
            best = trainer.train(train_loader, val_loader, epochs=TRAINER_EPOCHS,
                                 learning_rate=1e-4)
            torch.cuda.synchronize()
            run_counts = read_counts(counters)
        finally:
            train_mod.save_checkpoint, train_mod.EarlyStopping = real_save, real_early
            Config.LOGS_DIR, Config.CHECKPOINTS_DIR = old_dirs
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

        n_steps = TRAINER_EPOCHS * steps_per_epoch
        expected = {"conv_bn_relu": 0, "channel_sums": 46, "channel_dual_sums": 46,
                    "dihedral_normalize": 1, "fused_cross_entropy": 0}
        print(f"main path (trainer): {TRAINER_EPOCHS} epochs, {n_steps} steps, launches "
              f"{json.dumps(run_counts)}", flush=True)
        if len(per_step) != n_steps or any(c != expected for c in per_step):
            raise AssertionError(f"trainer launches per step {per_step}, expected {expected}")
        if run_counts != {k: v * n_steps for k, v in expected.items()}:
            raise AssertionError(f"kernel launches outside the train steps: {run_counts}")
        if any(b != {"images": "torch.uint8", "masks": "torch.uint8", "on_card": True}
               for b in batch_kinds):
            raise AssertionError(f"prefetched batches {batch_kinds}")
        if not best or not saved:
            raise AssertionError("the trainer selected or saved no best model")

        # the best checkpoint: JAX layout, back through from_jax_state_dict
        ckpt = load_checkpoint(saved[-1]["path"])
        if set(ckpt) != {"epoch", "model_state_dict", "optimizer_state_dict", "metrics",
                         "improvement_rates"} or ckpt["epoch"] != saved[-1]["epoch"]:
            raise AssertionError(f"best checkpoint holds {sorted(ckpt)}")
        reloaded = create_model("Unet", "resnet34", encoder_weights=None, classes=CLASSES,
                                seed=SEED + 1, dtype=torch.bfloat16, device="cuda")
        reloaded.load_state_dict(from_jax_state_dict(ckpt["model_state_dict"]), strict=True)
        if not torch.equal(make_predict_step(reloaded)(probe), saved[-1]["logits"]):
            raise AssertionError("logits of the reloaded best checkpoint differ")
        del reloaded, ckpt

        # the event file: every record's CRCs, the JAX trainer's tags
        event_files = list(pathlib.Path(tmp, "logs").rglob("events.out.tfevents.*"))
        if len(event_files) != 1:
            raise AssertionError(f"event files {event_files}")
        tb_events = read_events(event_files[0])
        found = {(v["tag"], v["kind"]) for e in tb_events for v in e["values"]}
        missing = ([t for t in TRAINER_SCALAR_TAGS if (t, "scalar") not in found]
                   + [t for t in TRAINER_IMAGE_TAGS if (t, "image") not in found])
        if missing:
            raise AssertionError(f"tags missing from the event file: {missing}")

    # the last epoch's trace: H2D copies (pinned, on their own stream,
    # overlapped with the compute stream's kernels) and the busy share
    events = record["events"]
    kernels = [e for e in events if e["cat"] == "kernel"]
    compute_streams = collections.Counter(e["stream"] for e in kernels)
    compute_stream = compute_streams.most_common(1)[0][0]
    batch_bytes = TRAIN_BATCH * TILE * TILE * 4             # images + uint8 masks
    h2d = [e for e in events if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]
           and (e["bytes"] or 0) >= TRAIN_BATCH * TILE * TILE]
    h2d_bytes = sum(e["bytes"] for e in h2d)
    if h2d_bytes != steps_per_epoch * batch_bytes:
        raise AssertionError(f"H2D copies of the training batches: {h2d_bytes} bytes, "
                             f"expected {steps_per_epoch * batch_bytes}")
    if not all("Pinned" in e["name"] and e["stream"] != compute_stream for e in h2d):
        raise AssertionError(f"H2D copies not pinned or on the compute stream: "
                             f"{[(e['name'], e['stream']) for e in h2d]}")
    compute_spans = [(e["ts"], e["ts"] + e["dur"]) for e in kernels
                     if e["stream"] == compute_stream]
    h2d_us = sum(e["dur"] for e in h2d)
    covered_us = sum(overlap_us((e["ts"], e["ts"] + e["dur"]), compute_spans) for e in h2d)
    busy_us = union_us([(e["ts"], e["ts"] + e["dur"]) for e in events])
    step_times = np.asarray(epoch_times) * 1e3

    # the bare train step (the trainer's: WEAK, plain CE), batches on the card
    dev = [tuple(torch.from_numpy(a).cuda() for a in (images[i:i + TRAIN_BATCH],
                                                       masks[i:i + TRAIN_BATCH].astype(np.uint8)))
           for i in (0, TRAIN_BATCH)]
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import (
        TrainState,
        adam,
    )

    state = TrainState(trainer.model, adam(1e-4))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    turn = iter(range(10 ** 9))
    bare_ms = time_ms(lambda: train_step(state, gen, *dev[next(turn) % 2]), reps=5, warmup=1)
    result = {
        "model": "resnet34 U-Net, 23 classes", "dtype": "bfloat16", "batch": TRAIN_BATCH,
        "tile": TILE, "augmentation": "WEAK (the trainer's default)", "fused_ce": False,
        "epochs": TRAINER_EPOCHS, "train_steps": n_steps, "validations": len(val_ms),
        "launches_per_step": per_step[0], "launches": run_counts,
        "step_timer_ms_p50": float(np.percentile(step_times, 50)),
        "step_timer_ms_p95": float(np.percentile(step_times, 95)),
        "step_timer_steps": len(step_times),
        "tiles_per_s": TRAIN_BATCH / float(np.mean(step_times)) * 1e3,
        "bare_step_ms": bare_ms, "bare_tiles_per_s": TRAIN_BATCH / bare_ms * 1e3,
        "h2d_ms_per_batch": h2d_us / 1e3 / steps_per_epoch,
        "h2d_bytes_per_batch": batch_bytes, "h2d_pinned": True,
        "h2d_overlapped_share": covered_us / h2d_us if h2d_us else "not measured",
        "h2d_streams": sorted({e["stream"] for e in h2d}), "compute_stream": compute_stream,
        "device_busy_share_epoch": busy_us / record["wall_us"],
        "epoch_wall_ms": record["wall_us"] / 1e3,
        "validation_ms": val_ms, "figure_logging_host_ms": figure_ms,
        "checkpoint_bytes": saved[-1]["bytes"],
        "checkpoint_write_ms": [s["write_ms"] for s in saved],
        "best_epoch": saved[-1]["epoch"],
        "host_syncs_last_epoch": record["syncs"],
        "host_syncs_in_figure_logging": record["figure_syncs"],
        "host_syncs_per_train_step": (record["syncs"] - record["figure_syncs"])
        / steps_per_epoch,
        "host_sync_sites_outside_figures": dict(record["sync_sites"]),
        "peak_mem_gib": peak_gib, "event_records": len(tb_events),
        "installation": install, "card": card}
    del trainer, model, state, dev, train_step
    torch.cuda.empty_cache()
    return result


def _trainer_child(card) -> dict:
    return drive_trainer(kernel_counters(), card, np.random.default_rng(SEED + 9))


def trainer_phase(card) -> dict:
    """Phase 9 in a fresh process (spawned, one card, kernels loaded from the
    libraries this process built): in a process that has taken many
    profiler windows, a later trace lost events on the H100 -- the trainer's
    H2D copies after phase 3b's windows, and one sums kernel in 20 of every
    3b window after the trainer's profiled epoch."""
    import multiprocessing

    torch.cuda.empty_cache()
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        return pool.apply(_trainer_child, (card,))


# the pipeline phase: run_pipeline over in-memory source tiles (80, split
# 64 / 16) and target tiles (64, another photometric offset), one epoch a
# phase at B=32: 2 steps in each phase
PIPE_TARGETS, PIPE_DEVICE, PIPE_ENCODER = 64, "cuda", "resnet34"
# the discriminator's BatchNorm inputs at 512 px, B=32 (NHWC)
DISC_BN_SHAPES = [(32, 128, 128, 128), (32, 64, 64, 256), (32, 32, 32, 512)]
STEP_FACTORIES = ("make_supervised_train_step", "make_adversarial_train_step",
                  "make_unsupervised_train_step")


class InMemoryTargets:
    """Seeded uint8 target tiles with ``TargetDataset``'s ``load_raw``."""

    def __init__(self, images):
        self.images = images

    def __len__(self):
        return len(self.images)

    def load_raw(self, idx):
        return self.images[idx]

    __getitem__ = load_raw


def pipeline_expected_launches(n_unet_bn: int, n_disc_bn: int) -> dict:
    """Kernel launches per train step of each phase: one ``channel_sums``
    and one ``channel_dual_sums`` per train-mode BatchNorm forward, one
    ``dihedral_normalize`` per augmented batch (eval-mode BatchNorm and the
    discriminator's eval forward in phase 2's G-step launch nothing)."""
    def counts(bn, dihedral):
        return {"conv_bn_relu": 0, "channel_sums": bn, "channel_dual_sums": bn,
                "dihedral_normalize": dihedral, "fused_cross_entropy": 0}
    return {"make_supervised_train_step": counts(n_unet_bn, 1),
            # U-Net on the source batch; D on the source and on the target batch
            "make_adversarial_train_step": counts(n_unet_bn + 2 * n_disc_bn, 2),
            # U-Net on two target views; D on the un-augmented target batch
            "make_unsupervised_train_step": counts(2 * n_unet_bn + n_disc_bn, 2)}


def bits(t):
    """A tensor's bits, so that NaN compares equal to the same NaN."""
    t = t.detach()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def state_snapshot(state) -> dict:
    """Every element of a phase-3 state: parameters, BatchNorm buffers, Adam
    moments and counts, the step counter (clones)."""
    snap = {f"model/{k}": bits(v).clone() for k, v in
            itertools.chain(state.model.named_parameters(), state.model.named_buffers())}
    names = {id(p): k for k, p in state.model.named_parameters()}
    for p, st in state.optimizer.state.items():
        for k, v in st.items():
            snap[f"adam/{names[id(p)]}/{k}"] = bits(v).clone()
    snap["step"] = state.step.clone()
    return snap


def counted(step, counters, record):
    """``step`` that appends the kernel launches of each call to ``record``."""
    def run(*a, **k):
        before = read_counts(counters)
        out = step(*a, **k)
        after = read_counts(counters)
        record.append({key: after[key] - before[key] for key in after})
        return out
    return run


def check_step_launches(label, per_step, expected, n_steps, run_counts):
    """``n_steps[name]`` steps in each phase (the length of the loader the
    phase iterates), exactly ``expected[name]`` launches in each, and none
    outside the steps; prints the census."""
    steps_run = {name: len(v) for name, v in per_step.items()}
    print(f"main path ({label}): steps {json.dumps(steps_run)}, launches "
          f"{json.dumps(run_counts)}", flush=True)
    for name, runs in per_step.items():
        if len(runs) != n_steps[name] or any(c != expected[name] for c in runs):
            raise AssertionError(f"{name} launches per step {runs}, expected {n_steps[name]} "
                                 f"steps of {expected[name]}")
    outside = {k: run_counts[k] - sum(c[k] for runs in per_step.values() for c in runs)
               for k in run_counts}
    if any(outside.values()):
        raise AssertionError(f"kernel launches outside the train steps: {outside}")
    return steps_run


def bare_step_report(fn, batches, turn) -> dict:
    """One bare train step ``fn(batch)`` on batches already on the card: p50 of
    5 steps after one warm-up (CUDA events), peak memory, host syncs per step
    under ``set_sync_debug_mode("warn")``, device ms by kind (profiler)."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(lambda: fn(batches[next(turn) % 2]), reps=5, warmup=1)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(2):
                fn(batches[next(turn) % 2])
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = [f"{pathlib.Path(w.filename).name}:{w.lineno}" for w in caught
             if "called a synchronizing" in str(w.message)]
    prof = profile_forward(lambda: fn(batches[next(turn) % 2]), reps=2)
    return {"bare_step_ms_p50": ms, "tiles_per_s": TRAIN_BATCH / ms * 1e3,
            "peak_mem_gib": peak_gib, "host_syncs_per_step": len(syncs) / 2,
            "host_sync_sites": sorted(set(syncs)), "device_ms": prof.get("device_ms_per_call"),
            "busy_share": prof.get("busy_share"), "by_category_ms": prof.get("by_category_ms")}


def drive_pipeline(counters, card, host_rng) -> dict:
    """Phase 10: ``run_pipeline`` on the card (see main)."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
    from uda_aerial_semantic_segmentation_research_tpu_torch.data.dataset import (
        WeightedRandomSampler,
        class_balance,
        random_split,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.data.loader import DataLoader
    from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
        DomainAdaptationModel,
        create_discriminator,
        create_unet,
        from_jax_state_dict,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops.augment import (
        normalize_images,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops.batch_norm import BatchNorm
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops.losses import (
        ConsistencyLoss,
        FineTuningLoss,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.training import (
        phase_manager as pm_mod,
        pipeline,
        steps as step_lib,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import (
        AdversarialState,
        TrainState,
        adam,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.utils.checkpoint import (
        load_checkpoint,
    )

    device = torch.device(PIPE_DEVICE)
    images = host_rng.integers(0, 256, (TRAINER_TILES, TILE, TILE, 3), dtype=np.uint8)
    masks = host_rng.integers(0, CLASSES, (TRAINER_TILES, TILE, TILE)).astype(np.int32)
    targets = np.clip(host_rng.integers(0, 256, (PIPE_TARGETS, TILE, TILE, 3))
                      * 0.7 + 40.0, 0, 255).astype(np.uint8)
    source = InMemoryTiles(images, masks)
    counts = [np.bincount(m.reshape(-1), minlength=CLASSES) for m in masks]
    _, weights = class_balance([{c: int(n[c]) for c in np.nonzero(n)[0]} for n in counts],
                               [m.size for m in masks])

    built = []

    def build_loaders(batch_size):
        """What ``_build_loaders`` builds from files, from the tiles above."""
        train_ds, val_ds = random_split(source, [TRAINER_TRAIN, TRAINER_TILES - TRAINER_TRAIN],
                                        seed=Config.SEED)
        w = weights[train_ds.indices]
        sampler = WeightedRandomSampler(w / w.sum(), num_samples=len(w))
        built[:] = (DataLoader(train_ds, batch_size=batch_size, sampler=sampler, drop_last=True,
                               num_workers=Config.NUM_WORKERS),
                    DataLoader(val_ds, batch_size=batch_size),
                    DataLoader(InMemoryTargets(targets), batch_size=batch_size, shuffle=True,
                               drop_last=True, num_workers=Config.NUM_WORKERS))
        return tuple(built)

    model = create_unet(PIPE_ENCODER, classes=CLASSES, seed=SEED, dtype=torch.bfloat16,
                        device=device)
    n_unet_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    n_disc_bn = sum(isinstance(m, BatchNorm) for m in
                    create_discriminator(device="cpu", dtype=torch.float32).modules())
    expected = pipeline_expected_launches(n_unet_bn, n_disc_bn)
    probe = torch.from_numpy(images[-2:]).to(device)             # two validation tiles

    per_step = {name: [] for name in STEP_FACTORIES}
    real_factories = {name: getattr(step_lib, name) for name in STEP_FACTORIES}

    def counted_factory(name):
        return lambda *args, **kw: counted(real_factories[name](*args, **kw), counters,
                                           per_step[name])

    saved = []
    real_save = pm_mod.PhaseManager.save_checkpoint

    def save_and_snapshot(self, trainer, metrics, phase, is_best=False):
        """The phase checkpoint, timed, with the live models' logits on the
        probe tiles at that moment."""
        t0 = time.perf_counter()
        real_save(self, trainer, metrics, phase, is_best=is_best)
        write_ms = (time.perf_counter() - t0) * 1e3
        path = self.phase_dirs[phase] / ("best_model.pth" if is_best else "latest_model.pth")
        disc = getattr(trainer, "discriminator", None) if phase.name != "SEGMENTATION" else None
        entry = {"phase": phase.name, "path": str(path), "write_ms": write_ms,
                 "mb": os.path.getsize(path) / 1e6,
                 "logits": step_lib.make_predict_step(self.model)(probe).clone()}
        if disc is not None:
            disc.eval()
            with torch.inference_mode():
                entry["disc_logits"] = disc(normalize_images(probe), return_logits=True).clone()
            entry["disc_dtype"] = disc.dtype
        saved.append(entry)

    with tempfile.TemporaryDirectory() as tmp:
        old = (Config.LOGS_DIR, Config.CHECKPOINTS_DIR, Config.DEVICE, Config.ENCODER_WEIGHTS,
               pipeline._build_loaders)
        Config.LOGS_DIR, Config.CHECKPOINTS_DIR = os.path.join(tmp, "logs"), os.path.join(tmp, "ckpt")
        Config.DEVICE, Config.ENCODER_WEIGHTS = PIPE_DEVICE, None
        pipeline._build_loaders = build_loaders
        pm_mod.PhaseManager.save_checkpoint = save_and_snapshot
        for name in STEP_FACTORIES:
            setattr(step_lib, name, counted_factory(name))
        try:
            torch.cuda.synchronize()
            reset_counts(counters)
            t0 = time.perf_counter()
            summary = pipeline.run_pipeline(phase1_epochs=1, phase2_epochs=1, phase3_epochs=1,
                                            batch_size=TRAIN_BATCH, force_transitions=True,
                                            checkpoints_dir=os.path.join(tmp, "ckpt"),
                                            model=model)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            run_counts = read_counts(counters)
        finally:
            (Config.LOGS_DIR, Config.CHECKPOINTS_DIR, Config.DEVICE, Config.ENCODER_WEIGHTS,
             pipeline._build_loaders) = old
            pm_mod.PhaseManager.save_checkpoint = real_save
            for name, fn in real_factories.items():
                setattr(step_lib, name, fn)

        # phases 1 and 2 iterate the source train loader, phase 3 the target one
        n_steps = dict(zip(STEP_FACTORIES, (len(built[0]), len(built[0]), len(built[2]))))
        steps_run = check_step_launches("pipeline", per_step, expected, n_steps, run_counts)

        # the summary and the experiment's metadata
        if set(summary["phases"]) != {"segmentation", "adversarial", "fine_tuning"} \
                or summary.get("final_phase") != "FINE_TUNING":
            raise AssertionError(f"pipeline summary {summary}")
        with open(pathlib.Path(summary["experiment_dir"]) / "training_metadata.json") as f:
            metadata = json.load(f)
        phases = ["SEGMENTATION", "ADVERSARIAL", "FINE_TUNING"]
        if (sorted(metadata["best_metrics"]) != sorted(phases)
                or metadata["phases_completed"] != phases[:2]
                or metadata["current_phase"] != phases[2]
                or [(t["from_phase"], t["to_phase"]) for t in metadata["phase_transitions"]]
                != list(zip(phases, phases[1:]))):
            raise AssertionError(f"training_metadata.json {metadata}")

        # every phase's best checkpoint reloads bit for bit
        if [s["phase"] for s in saved] != phases:
            raise AssertionError(f"phase checkpoints {[s['phase'] for s in saved]}")
        for s in saved:
            ckpt = load_checkpoint(s["path"])
            has_disc = "discriminator_state_dict" in ckpt
            if has_disc != (s["phase"] != "SEGMENTATION"):
                raise AssertionError(f"{s['phase']} checkpoint holds {sorted(ckpt)}")
            unet = create_unet(PIPE_ENCODER, classes=CLASSES, seed=SEED + 1,
                               dtype=torch.bfloat16, device=device)
            unet.load_state_dict(from_jax_state_dict(ckpt["model_state_dict"]), strict=True)
            if not torch.equal(step_lib.make_predict_step(unet)(probe), s["logits"]):
                raise AssertionError(f"{s['phase']}: the reloaded U-Net's logits differ")
            if has_disc:
                disc = create_discriminator(seed=SEED + 2, dtype=s["disc_dtype"], device=device)
                disc.load_state_dict(from_jax_state_dict(ckpt["discriminator_state_dict"]),
                                     strict=True)
                with torch.inference_mode():
                    got = disc(normalize_images(probe), return_logits=True)
                if not torch.equal(got, s["disc_logits"]):
                    raise AssertionError(f"{s['phase']}: the reloaded discriminator differs")
            del unet, ckpt
        # the final discriminator (phase 3's), for the bare steps below
        disc = create_discriminator(seed=SEED, dtype=saved[-1]["disc_dtype"], device=device)
        disc.load_state_dict(from_jax_state_dict(load_checkpoint(saved[-1]["path"])[
            "discriminator_state_dict"]), strict=True)

    # the bare step of each phase on the final models (bare_step_report)
    dev = [tuple(torch.from_numpy(a).to(device) for a in (
        images[i:i + TRAIN_BATCH], masks[i:i + TRAIN_BATCH].astype(np.uint8),
        targets[i:i + TRAIN_BATCH])) for i in (0, TRAIN_BATCH)]
    gen = torch.Generator(device=device).manual_seed(SEED)
    # the census of the discriminator's BatchNorm inputs (the shapes 3b checks)
    disc_bn_shapes = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, inp: disc_bn_shapes.append(tuple(inp[0].permute(0, 2, 3, 1).shape)))
        for m in disc.modules() if isinstance(m, BatchNorm)]
    with torch.inference_mode():
        disc(normalize_images(dev[0][2]), return_logits=True)
    for h in hooks:
        h.remove()
    if disc_bn_shapes != [(TRAIN_BATCH, *s[1:]) for s in DISC_BN_SHAPES]:
        raise AssertionError(f"discriminator BatchNorm inputs {disc_bn_shapes}")
    turn = itertools.count()
    sup_state = TrainState(model, adam(1e-4))
    adv_state = AdversarialState(TrainState(model, adam(1e-4)), TrainState(disc, adam(1e-4)))
    unsup_state = TrainState(DomainAdaptationModel(model, disc), adam(1e-5, clip_norm=1.0),
                             skip_nonfinite=True)
    sup = step_lib.make_supervised_train_step(model, CLASSES)
    adv = step_lib.make_adversarial_train_step(model, disc, CLASSES)
    unsup = step_lib.make_unsupervised_train_step(model, disc, CLASSES, FineTuningLoss())
    bare = {
        "make_supervised_train_step": lambda b: sup(sup_state, gen, b[0], b[1]),
        "make_adversarial_train_step": lambda b: adv(adv_state, gen, b[0], b[1], b[2]),
        "make_unsupervised_train_step": lambda b: unsup(unsup_state, gen, b[2], 1.0)}
    phase_of = dict(zip(STEP_FACTORIES, ("phase1", "phase2", "phase3")))
    per_phase = {phase_of[name]: bare_step_report(fn, dev, turn)
                 | {"launches_per_step": per_step[name][0]} for name, fn in bare.items()}

    # phase 3's consistency KL alone, forward and backward at the step's
    # logits shape: chunked (as the step runs it) and whole; its byte bound
    # reads both float32 logits and writes both gradients once
    z = [torch.randn((TRAIN_BATCH, TILE, TILE, CLASSES), device=device,
                     generator=torch.Generator(device=device).manual_seed(SEED + i),
                     requires_grad=True) for i in range(2)]
    kl = {}
    for label, fn in (("chunked", step_lib.chunked_consistency(ConsistencyLoss())),
                      ("whole", ConsistencyLoss())):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        kl[f"{label}_ms"] = time_ms(lambda: fn(*z).backward(), reps=5, warmup=1)
        kl[f"{label}_peak_added_gib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    kl["bound_ms"], kl["bound_by"] = roofline(4 * z[0].numel() * 4, 0)
    kl["shape"] = list(z[0].shape)
    del z

    # the non-finite guard: one phase-3 step with a NaN in D's classifier bias
    bias = disc.classifier.bias
    with torch.no_grad():
        bias.fill_(float("nan"))
    before = state_snapshot(unsup_state)
    _, nan_metrics = unsup(unsup_state, gen, dev[0][2], 1.0)
    torch.cuda.synchronize()
    after = state_snapshot(unsup_state)
    if nan_metrics["finite"].item() or set(before) != set(after):
        raise AssertionError("the NaN step reported a finite loss")
    moved = [k for k in before if not torch.equal(before[k], after[k])]
    if moved:
        raise AssertionError(f"the NaN step changed the state: {moved[:5]}")

    for s in saved:
        s.pop("logits")
        s.pop("disc_logits", None)
        s.pop("disc_dtype", None)
    result = {
        "model": f"{PIPE_ENCODER} U-Net, {CLASSES} classes, + DomainDiscriminator",
        "dtype": "bfloat16", "batch": TRAIN_BATCH, "tile": TILE,
        "data": f"{TRAINER_TILES} source tiles (split {TRAINER_TRAIN} / "
                f"{TRAINER_TILES - TRAINER_TRAIN}), {PIPE_TARGETS} target tiles, in memory",
        "epochs_per_phase": 1, "steps": steps_run,
        "phase3_remat": False, "phase3_step": "joint (not sequential)",
        "phases": per_phase, "consistency_kl": kl, "launches": run_counts,
        "checkpoints": [{k: s[k] for k in ("phase", "mb", "write_ms")} for s in saved],
        "pipeline_wall_s": wall_s,
        "nan_step_state_bit_identical": True,
        "summary_phases": sorted(summary["phases"]), "card": card}
    del model, disc, sup_state, adv_state, unsup_state, dev
    torch.cuda.empty_cache()
    return result


def _pipeline_child(card) -> dict:
    return drive_pipeline(kernel_counters(), card, np.random.default_rng(SEED + 10))


def pipeline_phase(card) -> dict:
    """Phase 10 in a fresh process of its own (spawned, as phase 9)."""
    import multiprocessing

    torch.cuda.empty_cache()
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        return pool.apply(_pipeline_child, (card,))


# the multi-phase phase: MultiPhaseTrainer over the GRL model at its default
# width (resnet50 U-Net + feature discriminator), one epoch a phase at B=32
# over the in-memory tiles of phase 10: 2 steps in each phase
MULTI_ENCODER = "resnet50"
# the BatchNorm inputs of the resnet50 U-Net (NHWC shape: BatchNorms, encoder
# and decoder) and of the feature discriminator at 512 px, B=32
UDA_UNET_BN_SHAPES = {
    (32, 256, 256, 64): 1, (32, 128, 128, 64): 8, (32, 128, 128, 256): 4,
    (32, 128, 128, 128): 1, (32, 64, 64, 128): 9, (32, 64, 64, 512): 5,
    (32, 64, 64, 256): 1, (32, 32, 32, 256): 13, (32, 32, 32, 1024): 7,
    (32, 32, 32, 512): 1, (32, 16, 16, 512): 5, (32, 16, 16, 2048): 4,
    (32, 256, 256, 32): 2, (32, 512, 512, 16): 2}
UDA_HEAD_BN_SHAPES = [(32, 16, 16, 512), (32, 16, 16, 256), (32, 16, 16, 128)]
MULTI_PHASES = ("phase1", "phase2", "phase3")


def multiphase_expected_launches(n_encoder_bn: int, n_decoder_bn: int, n_head_bn: int) -> dict:
    """Kernel launches per train step of each phase of ``MultiPhaseTrainer``:
    one ``channel_sums`` per train-mode BatchNorm forward, one
    ``channel_dual_sums`` per BatchNorm that the backward reaches, one
    ``dihedral_normalize`` per augmented batch (phase 3's ``x0`` is
    normalized without it)."""
    unet, head = n_encoder_bn + n_decoder_bn, n_head_bn

    def counts(forward, backward, dihedral):
        return {"conv_bn_relu": 0, "channel_sums": forward, "channel_dual_sums": backward,
                "dihedral_normalize": dihedral, "fused_cross_entropy": 0}
    return {
        # the U-Net on the source batch, dice
        "phase1": counts(unet, unet, 1),
        # source: U-Net + head; target: encoder + head (domain_only)
        "phase2": counts(unet + head + n_encoder_bn + head,
                         unet + head + n_encoder_bn + head, 2),
        # v1, v2: U-Net; x0: U-Net + head forward, its decoder gets no gradient
        "phase3": counts(3 * unet + head, 2 * unet + n_encoder_bn + head, 2)}


def drive_multiphase(counters, card, host_rng) -> dict:
    """Phase 11: ``MultiPhaseTrainer`` on the card (see main)."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
    from uda_aerial_semantic_segmentation_research_tpu_torch.data.dataset import random_split
    from uda_aerial_semantic_segmentation_research_tpu_torch.data.loader import DataLoader
    from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
        create_uda_model,
        from_jax_state_dict,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops.augment import (
        normalize_images,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops.batch_norm import BatchNorm
    from uda_aerial_semantic_segmentation_research_tpu_torch.training import (
        MultiPhaseTrainer,
        steps as step_lib,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import (
        TrainState,
        adam,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.utils.checkpoint import (
        load_checkpoint,
    )

    device = torch.device(PIPE_DEVICE)
    images = host_rng.integers(0, 256, (TRAINER_TILES, TILE, TILE, 3), dtype=np.uint8)
    masks = host_rng.integers(0, CLASSES, (TRAINER_TILES, TILE, TILE)).astype(np.int32)
    targets = np.clip(host_rng.integers(0, 256, (PIPE_TARGETS, TILE, TILE, 3))
                      * 0.7 + 40.0, 0, 255).astype(np.uint8)
    train_ds, val_ds = random_split(InMemoryTiles(images, masks),
                                    [TRAINER_TRAIN, TRAINER_TILES - TRAINER_TRAIN],
                                    seed=Config.SEED)
    train_loader = DataLoader(train_ds, batch_size=TRAIN_BATCH, shuffle=True, drop_last=True,
                              num_workers=Config.NUM_WORKERS)
    val_loader = DataLoader(val_ds, batch_size=TRAIN_BATCH)
    target_loader = DataLoader(InMemoryTargets(targets), batch_size=TRAIN_BATCH, shuffle=True,
                               drop_last=True, num_workers=Config.NUM_WORKERS)

    model = create_uda_model(MULTI_ENCODER, classes=CLASSES, seed=SEED, dtype=torch.bfloat16,
                             device=device)
    n_bn = {part: sum(isinstance(m, BatchNorm) for m in module.modules()) for part, module in
            (("encoder", model.net.encoder), ("decoder", model.net.decoder),
             ("head", model.domain_discriminator))}
    expected = multiphase_expected_launches(n_bn["encoder"], n_bn["decoder"], n_bn["head"])
    probe = torch.from_numpy(images[-2:]).to(device)             # two validation tiles

    def outputs(m):
        """Eval-mode segmentation and domain logits of ``m`` on the probe tiles."""
        seg = step_lib.make_predict_step(m)(probe)
        with torch.inference_mode():
            d = m(normalize_images(probe), domain_adaptation=True, domain_only=True)[1]
        return seg.clone(), d.clone()

    # the BatchNorm input shapes of one traversal (eval mode: the same shapes
    # as a train-mode one, and no statistics move)
    unet_shapes, head_shapes = collections.Counter(), []
    nhwc = lambda inp: tuple(inp[0].permute(0, 2, 3, 1).shape)
    hooks = [m.register_forward_pre_hook(lambda mod, inp: unet_shapes.update([nhwc(inp)]))
             for m in model.net.modules() if isinstance(m, BatchNorm)]
    hooks += [m.register_forward_pre_hook(lambda mod, inp: head_shapes.append(nhwc(inp)))
              for m in model.domain_discriminator.modules() if isinstance(m, BatchNorm)]
    with torch.inference_mode():
        model.eval()(normalize_images(torch.from_numpy(images[:TRAIN_BATCH]).to(device)),
                     domain_adaptation=True)
    for h in hooks:
        h.remove()
    if dict(unet_shapes) != UDA_UNET_BN_SHAPES or head_shapes != UDA_HEAD_BN_SHAPES:
        raise AssertionError(f"BatchNorm inputs {dict(unet_shapes)} {head_shapes}")

    per_step = {name: [] for name in MULTI_PHASES}
    saved, phase_wall_s = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        trainer = MultiPhaseTrainer(model, device=device, checkpoint_dir=os.path.join(tmp, "ckpt"),
                                    num_classes=CLASSES, log_dir=os.path.join(tmp, "logs"))

        raw_builders = (trainer._phase1_step, trainer._phase2_step, trainer._phase3_step)
        for name, build in zip(MULTI_PHASES, raw_builders):
            setattr(trainer, f"_{name}_step",
                    lambda _b=build, _n=name: counted(_b(), counters, per_step[_n]))
        real_save = trainer._save_best

        def save_and_snapshot(phase, metrics):
            """The phase checkpoint, timed, with the live model's outputs on the
            probe tiles at that moment."""
            t0 = time.perf_counter()
            real_save(phase, metrics)
            write_ms = (time.perf_counter() - t0) * 1e3
            path = trainer.checkpoint_dir / f"phase{phase}_best.pth"
            saved.append({"phase": phase, "path": str(path), "write_ms": write_ms,
                          "mb": os.path.getsize(path) / 1e6, "outputs": outputs(model)})

        trainer._save_best = save_and_snapshot
        torch.cuda.synchronize()
        reset_counts(counters)
        t_start = time.perf_counter()
        results = {}
        for name, run in (
                ("phase1", lambda: trainer.phase1_train(train_loader, val_loader, epochs=1,
                                                        learning_rate=1e-4)),
                ("phase2", lambda: trainer.phase2_train(train_loader, target_loader,
                                                        val_loader, epochs=1,
                                                        learning_rate=5e-5)),
                ("phase3", lambda: trainer.phase3_train(target_loader, val_loader, epochs=1,
                                                        learning_rate=1e-5))):
            t0 = time.perf_counter()
            results[name] = run()
            torch.cuda.synchronize()
            phase_wall_s[name] = time.perf_counter() - t0
        wall_s = time.perf_counter() - t_start
        run_counts = read_counts(counters)

        # phases 1 and 2 iterate the source train loader, phase 3 the target one
        n_steps = dict(zip(MULTI_PHASES, (len(train_loader), len(train_loader),
                                          len(target_loader))))
        steps_run = check_step_launches("multiphase", per_step, expected, n_steps, run_counts)
        if not all(np.isfinite(v) for v in results.values()) or not 0 <= results["phase1"] <= 1:
            raise AssertionError(f"phase results {results}")

        # every phase's best checkpoint reloads bit for bit
        if [s["phase"] for s in saved] != [1, 2, 3]:
            raise AssertionError(f"phase checkpoints {[s['phase'] for s in saved]}")
        for s in saved:
            ckpt = load_checkpoint(s["path"])
            if set(ckpt) != {"model_state_dict", "metrics", "phase"} or ckpt["phase"] != s["phase"]:
                raise AssertionError(f"phase {s['phase']} checkpoint holds {sorted(ckpt)}")
            reloaded = create_uda_model(MULTI_ENCODER, classes=CLASSES, seed=SEED + 1,
                                        dtype=torch.bfloat16, device=device)
            reloaded.load_state_dict(from_jax_state_dict(ckpt["model_state_dict"]), strict=True)
            got = outputs(reloaded)
            if not all(torch.equal(a, b) for a, b in zip(got, s.pop("outputs"))):
                raise AssertionError(f"phase {s['phase']}: the reloaded model's outputs differ")
            del reloaded, ckpt

        # the bare step of each phase on the final model (bare_step_report)
        dev = [tuple(torch.from_numpy(a).to(device) for a in (
            images[i:i + TRAIN_BATCH], masks[i:i + TRAIN_BATCH].astype(np.uint8),
            targets[i:i + TRAIN_BATCH])) for i in (0, TRAIN_BATCH)]
        gen = torch.Generator(device=device).manual_seed(SEED)
        turn = itertools.count()
        raw = {name: build() for name, build in zip(MULTI_PHASES, raw_builders)}
        lrs = {"phase1": 1e-4, "phase2": 5e-5, "phase3": 1e-5}
        states = {name: TrainState(model, adam(lr)) for name, lr in lrs.items()}
        bare = {
            "phase1": lambda b: raw["phase1"](states["phase1"], gen, b[0], b[1]),
            "phase2": lambda b: raw["phase2"](states["phase2"], gen, b[0], b[1], b[2], 1.0),
            "phase3": lambda b: raw["phase3"](states["phase3"], gen, b[2])}
        per_phase = {name: bare_step_report(fn, dev, turn)
                     | {"launches_per_step": per_step[name][0], "wall_s": phase_wall_s[name]}
                     for name, fn in bare.items()}

    result = {
        "model": f"UDASegmentationModel: {MULTI_ENCODER} U-Net, {CLASSES} classes, "
                 f"+ FeatureDomainDiscriminator (512/256/128)",
        "dtype": "bfloat16", "batch": TRAIN_BATCH, "tile": TILE,
        "data": f"{TRAINER_TILES} source tiles (split {TRAINER_TRAIN} / "
                f"{TRAINER_TILES - TRAINER_TRAIN}), {PIPE_TARGETS} target tiles, in memory",
        "epochs_per_phase": 1, "steps": steps_run,
        "phase2_step": "make_grl_sequential_step (lambda_domain 0.001, WEAK)",
        "phase3_step": "MultiPhaseTrainer._phase3_step (STRONG, mse + 0.1 * confusion)",
        "batch_norms": n_bn, "expected_launches_per_step": expected,
        "phases": per_phase, "phase_results": results, "launches": run_counts,
        "checkpoints": [{k: s[k] for k in ("phase", "mb", "write_ms")} for s in saved],
        "checkpoints_reload_bit_identical": True,
        "multiphase_wall_s": wall_s, "card": card}
    del model, trainer, states, raw, bare, dev
    torch.cuda.empty_cache()
    return result


def _multiphase_child(card) -> dict:
    return drive_multiphase(kernel_counters(), card, np.random.default_rng(SEED + 11))


def multiphase_phase(card) -> dict:
    """Phase 11 in a fresh process of its own (spawned, as phases 9 and 10)."""
    import multiprocessing

    torch.cuda.empty_cache()
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        return pool.apply(_multiphase_child, (card,))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--probe-batch", type=int, default=None,
                        help="only run train steps at this batch size and report "
                             "whether they fit in device memory")
    parser.add_argument("--compare-sums-source", default=None, metavar="CU_FILE",
                        help="only time the channel_sums kernels against the ones "
                             "built from this (older) source, at the train step's "
                             "BatchNorm shapes")
    parser.add_argument("--compare-dihedral-source", default=None, metavar="CU_FILE",
                        help="only time the dihedral_normalize kernel against the one "
                             "built from this (older) source, at the train step's shape")
    args = parser.parse_args(argv)
    t_script = time.perf_counter()
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
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops import (
        _build,
        augment,
        channel_sums as sums_ops,
        dihedral as dihedral_ops,
        fused_ce as ce_ops,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops import conv_bn_relu as cbr
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops.batch_norm import (
        BatchNorm,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import (
        TrainState,
        adam,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.steps import (
        make_eval_step,
        make_predict_step,
        make_supervised_train_step,
    )

    conv_bn_relu, reference = cbr.conv_bn_relu, cbr.conv_bn_relu_reference
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 1. device
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {kind}", flush=True)

    # 2. build: one nvcc per source, all started together
    libraries = ("conv_bn_relu", "channel_sums", "dihedral_normalize", "fused_cross_entropy")
    t0 = time.perf_counter()
    _build.build_libraries(libraries)
    for module in (cbr, sums_ops, dihedral_ops, ce_ops):
        module._library()
    print("build: " + ", ".join(f"{n} nvcc {_build.build_seconds[n]:.1f} s" for n in libraries)
          + f"; all built and loaded in {time.perf_counter() - t0:.1f} s", flush=True)
    if args.probe_batch is not None:
        return probe_batch(args.probe_batch)
    if args.compare_sums_source is not None:
        compare_sums_with_parent(sums_ops, args.compare_sums_source, card)
        print(card_line())
        return 0
    if args.compare_dihedral_source is not None:
        compare_dihedral_with_parent(dihedral_ops, args.compare_dihedral_source, card)
        print(card_line())
        return 0
    counters = kernel_counters()

    # 3a. conv_bn_relu vs plain version on the card
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = []
    for shape in SLICE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            for affine in (True, False):
                results.append(check_kernel(conv_bn_relu, reference, gen, shape,
                                            dtype, affine, timed=True))
    for shape in [RAGGED_SHAPE] + EDGE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            results.append(check_kernel(conv_bn_relu, reference, gen, shape,
                                        dtype, True, timed=False))
    path_cases = [r for r in results
                  if r["dtype"] == "bfloat16" and r["affine"] and "kernel_ms" in r]
    assert len(path_cases) == len(SLICE_SHAPES)

    # 4. the serving path: resnet34 U-Net, 23 classes, 512 px, bf16
    host_rng = np.random.default_rng(SEED)
    model = create_unet("resnet34", classes=CLASSES, seed=SEED, dtype=torch.bfloat16,
                        device="cuda", fused_eval=True)
    randomize_batch_norms_(model, torch.Generator().manual_seed(SEED))
    batch = host_rng.integers(0, 256, (32, TILE, TILE, 3), dtype=np.uint8)
    raster = host_rng.integers(0, 256, (1500, 2000, 3), dtype=np.uint8)
    n_raster_tiles = len(tile_grid(1500, 2000, TILE, 64))
    raster_forwards = -(-n_raster_tiles // 8)

    reset_counts(counters)
    preds = predict_batch(model, batch)
    torch.cuda.synchronize()
    batch_launches = conv_bn_relu.launches
    label_map = predict_raster(model, raster, tile=TILE, overlap=64, batch_size=8)
    torch.cuda.synchronize()
    serving_counts = read_counts(counters)
    launches = serving_counts["conv_bn_relu"]
    print(f"main path (serving): predict_batch launches {batch_launches}, predict_raster "
          f"launches {launches - batch_launches} over {raster_forwards} forwards "
          f"({n_raster_tiles} tiles)", flush=True)
    if batch_launches != 2 or launches - batch_launches != 2 * raster_forwards:
        raise AssertionError("the kernel did not run exactly twice per forward")
    if preds.shape != (32, TILE, TILE) or preds.dtype != np.int32:
        raise AssertionError(f"predict_batch gave {preds.shape} {preds.dtype}")
    if label_map.shape != (1500, 2000) or label_map.dtype != np.int32:
        raise AssertionError(f"predict_raster gave {label_map.shape} {label_map.dtype}")
    for labels in (preds, label_map):
        if labels.min() < 0 or labels.max() >= CLASSES:
            raise AssertionError("labels out of range")

    step = make_predict_step(model)
    batch_dev = torch.from_numpy(batch).cuda()
    logits = step(batch_dev)
    if not torch.isfinite(logits).all() or tuple(logits.shape) != (32, TILE, TILE, CLASSES):
        raise AssertionError("bf16 logits not finite or of the wrong shape")
    torch.cuda.reset_peak_memory_stats()
    forward_ms = time_ms(lambda: step(batch_dev), reps=10)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(json.dumps({"profile": profile_forward(lambda: step(batch_dev)),
                      "card": card}), flush=True)

    # fused vs plain decoder in f32 (TF32 off), same weights
    state_dict = model.state_dict()
    logits32 = {}
    for fused in (True, False):
        m32 = create_unet("resnet34", classes=CLASSES, seed=SEED, dtype=torch.float32,
                          device="cuda", fused_eval=fused)
        m32.load_state_dict(state_dict, strict=True)
        logits32[fused] = make_predict_step(m32)(batch_dev[:4])
        del m32
    torch.testing.assert_close(logits32[True], logits32[False], atol=1e-3, rtol=1e-3)
    f32_err = (logits32[True] - logits32[False]).abs().max().item()
    print(json.dumps({"serving": {
        "model": "resnet34 U-Net, 23 classes, fused_eval", "dtype": "bfloat16",
        "batch": 32, "tile": TILE, "forward_ms": forward_ms,
        "tiles_per_s": 32 / forward_ms * 1e3, "peak_mem_gib": peak_gib,
        "f32_fused_vs_plain_max_abs_err": f32_err, "card": card}}), flush=True)
    del model, step, logits, logits32, state_dict, batch_dev
    torch.cuda.empty_cache()

    # 5. the train path: same width, B=32, bf16, the JAX default augmentation
    #    (WEAK: every stage), fused CE, Adam; 5 steps from seeded weights and
    #    seeded numpy batches
    model = create_unet("resnet34", classes=CLASSES, seed=SEED, dtype=torch.bfloat16,
                        device="cuda", fused_eval=True)
    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    batches = train_batches(host_rng, TRAIN_STEPS)
    train_gen = torch.Generator(device="cuda").manual_seed(SEED)

    # one step on a copy: warms the allocator and cuDNN, takes the census of
    # BatchNorm input shapes, and counts the incoming gradients whose NHWC
    # view is not contiguous (bn_train's backward copies those before the
    # dual sums)
    bn_shapes, dy_copies = collections.Counter(), collections.Counter()
    warm = copy.deepcopy(model)

    def count_dy_copy(mod, grad_out):
        g = grad_out[0]
        if g is not None and not g.movedim(1, -1).is_contiguous():
            dy_copies[(tuple(g.movedim(1, -1).shape), g.element_size())] += 1

    for m in warm.modules():
        if isinstance(m, BatchNorm):
            m.register_forward_pre_hook(
                lambda mod, inp: bn_shapes.update([tuple(inp[0].permute(0, 2, 3, 1).shape)]))
            m.register_full_backward_pre_hook(count_dy_copy)
    make_supervised_train_step(warm, CLASSES, fused_ce=True)(
        TrainState(warm, adam(1e-4)), torch.Generator(device="cuda").manual_seed(SEED + 1),
        *batches[0])
    torch.cuda.synchronize()
    del warm
    torch.cuda.empty_cache()
    if sum(bn_shapes.values()) != n_bn or dict(bn_shapes) != BN_SHAPES:
        raise AssertionError(f"BatchNorm census {dict(bn_shapes)}, expected {BN_SHAPES}")
    print("BatchNorm inputs of a train step (NHWC shape: count): "
          + ", ".join(f"{s}: {n}" for s, n in sorted(bn_shapes.items())), flush=True)
    copy_bytes = sum(2 * math.prod(shape) * elt * n for (shape, elt), n in dy_copies.items())
    dy_copy_report = {
        "copies_per_step": sum(dy_copies.values()),
        "shapes": {str(shape): n for (shape, _), n in sorted(dy_copies.items())},
        "bytes_per_step": copy_bytes,
        "bound_ms_per_step": roofline(copy_bytes, 0)[0]}
    print(json.dumps({"bn_backward_dy_copies": dy_copy_report, "card": card}), flush=True)

    state = TrainState(model, adam(1e-4))
    train_step = make_supervised_train_step(model, CLASSES, fused_ce=True)   # WEAK
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    reset_counts(counters)
    step_metrics = []
    for images, masks in batches:
        state, metrics = train_step(state, train_gen, images, masks)
        step_metrics.append(metrics)
    torch.cuda.synchronize()
    train_counts = read_counts(counters)
    expected = {"conv_bn_relu": 0, "channel_sums": n_bn * TRAIN_STEPS,
                "channel_dual_sums": n_bn * TRAIN_STEPS,
                "dihedral_normalize": TRAIN_STEPS, "fused_cross_entropy": 2 * TRAIN_STEPS}
    print(f"main path (training): {TRAIN_STEPS} steps, {n_bn} BatchNorm modules, "
          f"launches {json.dumps(train_counts)}", flush=True)
    if train_counts != expected:
        raise AssertionError(f"launch counts {train_counts}, expected {expected}")
    losses = [m["loss"].item() for m in step_metrics]
    if not all(np.isfinite(losses)) or state.step != TRAIN_STEPS or not model.training:
        raise AssertionError(f"train losses {losses}, step {state.step}")
    for m in step_metrics:
        if m["hist"].sum().item() != TRAIN_BATCH * TILE * TILE:
            raise AssertionError("hist does not count every pixel")
        if not all(torch.isfinite(m[k]).all() for k in ("iou", "accuracy", "per_class_iou")):
            raise AssertionError("metrics not finite")
    after = model.state_dict()
    unchanged = [k for k, v in before.items() if torch.equal(v, after[k])]
    # a zero-initialised last BatchNorm scale of a residual block gets a
    # gradient, so every parameter and every buffer must have moved
    if unchanged:
        raise AssertionError(f"left unchanged by training: {unchanged[:5]}")
    del before

    dev_batches = [tuple(torch.from_numpy(a).cuda() for a in b) for b in batches]
    turn = iter(range(10 ** 9))
    timed_step = lambda: train_step(state, train_gen, *dev_batches[next(turn) % TRAIN_STEPS])
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(timed_step, reps=5, warmup=1)
    train_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    train_profile = profile_forward(timed_step)
    print(json.dumps({"train_profile": train_profile, "card": card}), flush=True)
    # the step's census: one dihedral_normalize kernel a step (a window the
    # profiler dropped reads "not measured" and is checked per call in 3b)
    census = train_profile.get("by_category_launches", {}).get("dihedral_normalize kernel")
    if "by_category_launches" in train_profile and census != 1:
        raise AssertionError(f"dihedral_normalize kernels per train step: {census}")
    print(json.dumps({"train": {
        "model": "resnet34 U-Net, 23 classes", "dtype": "bfloat16", "batch": TRAIN_BATCH,
        "tile": TILE, "augmentation": "WEAK (the default)", "fused_ce": True,
        "optimizer": "adam(1e-4)", "batch_norm_modules": n_bn, "losses": losses,
        "step_ms": step_ms, "tiles_per_s": TRAIN_BATCH / step_ms * 1e3,
        "peak_mem_gib": train_peak_gib, "timed_with": "batches already on the device",
        "card": card}}), flush=True)

    # the same step with the dihedral-only augmentation, timed the same way,
    # so that the difference is what the stages after the dihedral one cost
    dihedral_step = make_supervised_train_step(model, CLASSES, aug_cfg=dihedral_only(augment),
                                               fused_ce=True)
    timed_dihedral = lambda: dihedral_step(state, train_gen,
                                           *dev_batches[next(turn) % TRAIN_STEPS])
    torch.cuda.reset_peak_memory_stats()
    dihedral_step_ms = time_ms(timed_dihedral, reps=5, warmup=1)
    dihedral_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    dihedral_profile = profile_forward(timed_dihedral)
    print(json.dumps({"train_dihedral_only": {
        "augmentation": "dihedral only", "step_ms": dihedral_step_ms,
        "tiles_per_s": TRAIN_BATCH / dihedral_step_ms * 1e3, "peak_mem_gib": dihedral_peak_gib,
        "device_ms": dihedral_profile.get("device_ms_per_call"),
        "busy_share": dihedral_profile.get("busy_share"),
        "weak_minus_dihedral_only_ms": step_ms - dihedral_step_ms,
        "weak_minus_dihedral_only_device_ms": (
            train_profile["device_ms_per_call"] - dihedral_profile["device_ms_per_call"]
            if "by_category_ms" in train_profile and "by_category_ms" in dihedral_profile
            else "not measured"),
        "card": card}}), flush=True)

    # 6. the eval step on the trained model: fused decoder, 2 kernel launches
    reset_counts(counters)
    eval_metrics = make_eval_step(model, CLASSES)(*batches[0])
    torch.cuda.synchronize()
    eval_counts = read_counts(counters)
    print(f"main path (eval step): launches {json.dumps(eval_counts)}, "
          f"loss {eval_metrics['loss'].item():.4f}", flush=True)
    if eval_counts["conv_bn_relu"] != 2 or sum(eval_counts.values()) != 2:
        raise AssertionError(f"eval step launch counts {eval_counts}")
    if (not torch.isfinite(eval_metrics["loss"])
            or eval_metrics["hist"].sum().item() != TRAIN_BATCH * TILE * TILE):
        raise AssertionError("eval step metrics are off")
    del model, state, train_step, dihedral_step, dev_batches, step_metrics, eval_metrics
    torch.cuda.empty_cache()

    # 3b. the three training kernels vs their plain versions at the step's shapes
    sums_results = [check_sums(sums_ops, gen, shape, torch.bfloat16, timed=True)
                    for shape in sorted(BN_SHAPES)]
    for shape in [(32, 512, 512, 16), (32, 256, 256, 32), (32, 16, 16, 512)]:
        check_sums(sums_ops, gen, shape, torch.float32, timed=True)
    for shape in SUMS_EDGE_SHAPES:
        for dtype, dy_dtype in ((torch.bfloat16, None), (torch.float32, None),
                                (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)):
            check_sums(sums_ops, gen, shape, dtype, timed=False, dy_dtype=dy_dtype)
    check_sums(sums_ops, gen, (32, 64, 64, 128), torch.float32, timed=False,
               dy_dtype=torch.bfloat16)
    base = torch.randn(4 * 33 * 16 + 1, generator=gen, device="cuda")
    unaligned = base[1:].view(4, 33, 16)                 # 4 bytes off: the generic path
    torch.testing.assert_close(sums_ops.channel_sums(unaligned),
                               sums_ops.channel_sums_reference(unaligned), rtol=1e-5, atol=1e-4)
    sums_launch_checks = check_sums_launches(sums_ops, gen)
    disc_sums_results = [check_sums(sums_ops, gen, shape, torch.bfloat16, timed=True)
                         for shape in DISC_BN_SHAPES]
    # phase 11's BatchNorm inputs that the resnet34 step does not have: the
    # resnet50 U-Net's and the feature discriminator's (its 512-channel input
    # is the resnet34 step's (32, 16, 16, 512), timed above); float32 at
    # C >= 1024 takes the generic path
    sums_by_shape = {tuple(r["shape"]): r for r in sums_results}
    for shape in sorted(set(UDA_UNET_BN_SHAPES) | set(UDA_HEAD_BN_SHAPES)):
        if shape not in sums_by_shape:
            sums_by_shape[shape] = check_sums(sums_ops, gen, shape, torch.bfloat16, timed=True)
    resnet50_sums_results = [sums_by_shape[s] for s in sorted(UDA_UNET_BN_SHAPES)
                             if s not in BN_SHAPES]
    head_sums_results = [sums_by_shape[s] for s in UDA_HEAD_BN_SHAPES]
    for shape in [(32, 16, 16, 2048), (32, 32, 32, 1024)]:
        check_sums(sums_ops, gen, shape, torch.float32, timed=False)
    dihedral_result = check_dihedral(dihedral_ops, host_rng)
    dihedral_no_masks = check_dihedral_no_masks(dihedral_ops, host_rng)
    augment_results = time_augment_batch(augment, dihedral_ops, host_rng, card)
    check_augment_card_vs_cpu(augment, dihedral_ops, host_rng)
    ce_results = {dt: check_fused_ce(ce_ops, gen, dt) for dt in (torch.float32, torch.bfloat16)}

    # 7. one float32 train step on the card (kernels) against the same step on
    #    a CPU copy of the model (plain versions), same flags.  Tolerances:
    #    loss 1e-4 relative; hist may differ by 0.1% of the pixels (argmax of
    #    near-ties); all gradients together 5e-2 relative in L2 and the head's
    #    kernel 1e-3 of its largest entry -- through the whole network single
    #    ReLU units flip under float32 noise (tests/test_torch_train_step.py).
    #    The augmentation is WEAK in float32; a CUDA and a CPU generator draw
    #    different numbers, so the draws are made once on the host and given
    #    to both (these seeded draws blur and HSV-shift the first image).
    #    Every stage on both devices is held in ``check_augment_card_vs_cpu``.
    small = train_batches(host_rng, 1, batch=2, tile=256)[0]
    cfg32 = dataclasses.replace(augment.WEAK, compute_dtype="float32")
    host_gen = torch.Generator().manual_seed(SEED)
    abc = augment._sample_dihedral(host_gen, 2, cfg32)
    params = augment.sample_params(host_gen, small[0].shape, cfg32, has_masks=True)
    if not any(d.do.any() for d in (*params.warp, *params.photometric) if d is not None):
        raise AssertionError("the f32 step's draws select no augmentation stage")
    runs = {}
    for device in ("cuda", "cpu"):
        m32 = create_unet("resnet34", classes=CLASSES, seed=SEED, dtype=torch.float32,
                          device=device)
        s32 = TrainState(m32, adam(1e-4))
        reset_counts(counters)
        _, met = make_supervised_train_step(m32, CLASSES, aug_cfg=cfg32, fused_ce=True)(
            s32, None, *small, abc=abc, params=params)
        if device == "cuda":
            torch.cuda.synchronize()
        if (sum(read_counts(counters).values()) > 0) != (device == "cuda"):
            raise AssertionError(f"kernel launches on {device}: {read_counts(counters)}")
        runs[device] = (met["loss"].item(), met["hist"].cpu(),
                        {k: p.grad.detach().cpu() for k, p in m32.named_parameters()})
        del m32, s32
    (loss_gpu, hist_gpu, g_gpu), (loss_cpu, hist_cpu, g_cpu) = runs["cuda"], runs["cpu"]
    flat = lambda g: torch.cat([g[k].reshape(-1) for k in sorted(g)])
    grad_rel_l2 = ((flat(g_gpu) - flat(g_cpu)).norm() / flat(g_cpu).norm()).item()
    head = "segmentation_head.weight"
    head_err = ((g_gpu[head] - g_cpu[head]).abs().max() / g_cpu[head].abs().max()).item()
    hist_l1 = (hist_gpu - hist_cpu).abs().sum().item()
    print(json.dumps({"f32_step_gpu_vs_cpu": {
        "loss_gpu": loss_gpu, "loss_cpu": loss_cpu, "hist_l1_diff": hist_l1,
        "grad_rel_l2": grad_rel_l2, "head_kernel_grad_max_rel_err": head_err}}), flush=True)
    if (abs(loss_gpu - loss_cpu) > 1e-4 * abs(loss_cpu) or grad_rel_l2 > 5e-2
            or head_err > 1e-3 or hist_l1 > 2 * 0.001 * 2 * 256 * 256):
        raise AssertionError("float32 train step on the card disagrees with the CPU")

    # 9. the trainer: SegmentationTrainer.train, 2 epochs over an in-memory
    #    dataset (80 tiles, split 64 / 16, weighted sampler, B=32), in a
    #    process of its own (``trainer_phase``)
    trainer_result = trainer_phase(card)
    trainer_counts = trainer_result["launches"]
    print(json.dumps({"trainer": trainer_result}), flush=True)

    # 10. the three-phase pipeline: run_pipeline, one epoch a phase over
    #     in-memory source and target tiles, in a process of its own
    pipeline_result = pipeline_phase(card)
    pipeline_counts = pipeline_result["launches"]
    print(json.dumps({"pipeline": pipeline_result}), flush=True)

    # 11. the GRL stack: MultiPhaseTrainer at resnet50, one epoch a phase over
    #     the same in-memory tiles, in a process of its own
    t0 = time.perf_counter()
    multiphase_result = multiphase_phase(card)
    multiphase_result["process_wall_s"] = time.perf_counter() - t0      # spawn to result
    multiphase_counts = multiphase_result["launches"]
    print(json.dumps({"multiphase": multiphase_result}), flush=True)

    # 8. results
    total = {k: serving_counts[k] + train_counts[k] + eval_counts[k] + trainer_counts[k]
             + pipeline_counts[k] + multiphase_counts[k] for k in counters}
    if min(total.values()) == 0:
        raise AssertionError(f"a kernel never launched on the main paths: {total}")
    src = f"{PORT}/csrc"
    per_step = lambda key: sum(r[key] * BN_SHAPES[tuple(r["shape"])] for r in sums_results)
    ce32 = ce_results[torch.float32]
    entries = [{
        "name": "conv_bn_relu", "route": "cuda", "source": f"{src}/conv_bn_relu.cu",
        "replaces": f"{JAX_OPS}/pallas_conv.py:173", "launches": total["conv_bn_relu"],
        "max_abs_err": max(r["max_abs_err"] for r in results),
        # per forward: the two decoder launches at B=32, bf16, with the affine
        "ms": sum(r["kernel_ms"] for r in path_cases),
        "plain_ms": sum(r["plain_ms"] for r in path_cases),
        "bound_ms": sum(r["bound_ms"] for r in path_cases),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in path_cases)
        else "operations",
        "library_ms": sum(r["library_ms"] for r in path_cases),
        "share_of_bound": (sum(r["bound_ms"] for r in path_cases)
                           / sum(r["kernel_ms"] for r in path_cases)),
        "per_shape": [{k: r[k] for k in ("shape", "kernel_ms", "plain_ms", "library_ms",
                                         "bound_ms", "share_of_bound",
                                         "kernel_single_launch_ms",
                                         "library_single_launch_ms")}
                      for r in path_cases],
    }, {
        # per train step: one forward and one backward launch per BatchNorm
        "name": "channel_sums", "route": "cuda", "source": f"{src}/channel_sums.cu",
        "replaces": f"{JAX_OPS}/pallas_moments.py:75 and :91",
        "launches": total["channel_sums"] + total["channel_dual_sums"],
        "launches_forward": total["channel_sums"],
        "launches_backward": total["channel_dual_sums"],
        "device_kernels_per_call": sums_launch_checks["device_kernels_per_call"],
        "host_us_per_call": sums_launch_checks["host_us_per_call"],
        "max_abs_err": max(r["max_abs_err"] for r in
                           sums_results + disc_sums_results + list(sums_by_shape.values())),
        "max_rel_err": max(r["max_rel_err"] for r in
                           sums_results + disc_sums_results + list(sums_by_shape.values())),
        # 20 launches per event pair over rotating cold copies of the inputs
        "ms": per_step("sums_ms") + per_step("dual_ms"),
        "forward_ms": per_step("sums_ms"), "backward_ms": per_step("dual_ms"),
        "single_launch_ms": per_step("sums_single_launch_ms")
        + per_step("dual_single_launch_ms"),
        # the profiler's kernel durations (no host launch overhead)
        "kernel_ms": per_step("sums_kernel_ms") + per_step("dual_kernel_ms"),
        "plain_ms": per_step("sums_plain_ms") + per_step("dual_plain_ms"),
        "forward_plain_ms": per_step("sums_plain_ms"),
        "backward_plain_ms": per_step("dual_plain_ms"),
        "bound_ms": per_step("sums_bound_ms") + per_step("dual_bound_ms"),
        "forward_bound_ms": per_step("sums_bound_ms"),
        "backward_bound_ms": per_step("dual_bound_ms"),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in sums_results)
        else "operations",
        "library_ms": per_step("sums_library_ms") + per_step("dual_library_ms"),
        "forward_library_ms": per_step("sums_library_ms"),
        "backward_library_ms": per_step("dual_library_ms"),
        "share_of_bound": ((per_step("sums_bound_ms") + per_step("dual_bound_ms"))
                           / (per_step("sums_ms") + per_step("dual_ms"))),
        "per_shape": [{k: r[k] for k in (
            "shape", "sums_ms", "dual_ms", "sums_bound_ms", "dual_bound_ms",
            "sums_share_of_bound", "dual_share_of_bound", "sums_kernel_ms",
            "dual_kernel_ms", "sums_single_launch_ms",
            "dual_single_launch_ms", "sums_plain_ms", "dual_plain_ms", "sums_library_ms",
            "dual_library_ms")} | {"batch_norms": BN_SHAPES[tuple(r["shape"])]}
            for r in sums_results],
        # the discriminator's three BatchNorm inputs (phases 2 and 3), one each
        "discriminator_per_shape": [{k: r[k] for k in PER_SHAPE_KEYS}
                                    for r in disc_sums_results],
        # phase 11: the resnet50 U-Net's BatchNorm inputs that the resnet34 step
        # lacks, and the feature discriminator's three
        "resnet50_per_shape": [{k: r[k] for k in PER_SHAPE_KEYS}
                               | {"batch_norms": UDA_UNET_BN_SHAPES[tuple(r["shape"])]}
                               for r in resnet50_sums_results],
        "feature_discriminator_per_shape": [{k: r[k] for k in PER_SHAPE_KEYS}
                                            for r in head_sums_results],
    }, {
        "name": "dihedral_normalize", "route": "cuda",
        "source": f"{src}/dihedral_normalize.cu",
        "replaces": f"{JAX_OPS}/pallas_ops.py:138", "launches": total["dihedral_normalize"],
        "max_abs_err": dihedral_result["max_abs_err"],
        # the mixed batch (all eight elements), 20 launches per event pair, cold
        "ms": dihedral_result["mixed"]["ms"],
        "kernel_ms": dihedral_result["mixed"]["kernel_ms"],
        "single_launch_ms": dihedral_result["mixed"]["single_launch_ms"],
        "plain_ms": dihedral_result["mixed"]["plain_ms"], "bound_ms": dihedral_result["bound_ms"],
        "bound_by": dihedral_result["bound_by"], "library_ms": None,
        "share_of_bound": dihedral_result["mixed"]["share_of_bound"],
        "share_of_bound_kernel_time": dihedral_result["mixed"]["share_of_bound_kernel_time"],
        "device_kernels_per_call": dihedral_result["device_kernels_per_call"],
        "host_us_per_call": dihedral_result["host_us_per_call"],
        "per_class": {cls: dihedral_result[cls] for cls in DIHEDRAL_CLASSES},
        "no_masks": dihedral_no_masks,
    }, {
        # per train step: forward + backward on the f32 logits the model returns
        "name": "fused_cross_entropy", "route": "cuda",
        "source": f"{src}/fused_cross_entropy.cu",
        "replaces": f"{JAX_OPS}/pallas_ops.py:267", "launches": total["fused_cross_entropy"],
        "max_abs_err": max(ce32["max_abs_err"], ce32["grad_max_abs_err"]),
        "ms": ce32["fwd_bwd_ms"], "forward_ms": ce32["fwd_ms"],
        "plain_ms": ce32["plain_fwd_bwd_ms"], "bound_ms": ce32["bound_ms"],
        "bound_by": ce32["bound_by"], "library_ms": ce32["library_fwd_bwd_ms"],
    }]
    print(f"chip_smoke wall time: {time.perf_counter() - t_script:.1f} s (phase 11 with "
          f"its process: {multiphase_result['process_wall_s']:.1f} s)", flush=True)
    print(json.dumps({"kernels": entries}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
