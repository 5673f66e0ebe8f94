"""Step factories of the PyTorch port.

Counterpart of the JAX package's ``training/steps.py``.  Ported so far:
the phase-1 supervised train step, the eval step and the serving step
(``make_supervised_train_step``, ``make_eval_step``, ``make_predict_step``),
the phase-2 adversarial step (``make_adversarial_train_step``, with
``make_adversarial_sequential_step`` its alias), the phase-3
unsupervised step (``make_unsupervised_train_step``) and its
memory-decomposed twin (``make_unsupervised_sequential_step``), and the GRL
stack's steps (``make_grl_sequential_step``, with ``make_grl_train_step``
its alias, and ``make_grl_eval_step``), and the scan driver
(``make_scan_driver``: S steps in one call, a CUDA graph of them on the
card).  Each factory closes over the static pieces and returns an eager
function.
Properties shared by the steps:

- raw uint8 batches go straight to the device; dequantization,
  augmentation and normalization run there;
- the train step updates the model, its BatchNorm buffers and the
  optimizer in place;
- metrics (loss scalars and the confusion matrix) are returned as device
  tensors, and a step reads nothing back to the host itself.

Under a process group (``parallel.distributed``: one process per device,
each with its rows of the global batch, the JAX package's mesh) a train step
makes the update of one process with the global batch, as the JAX step under
a mesh does:

- the augmentation's draws are the global batch's, drawn from the shared
  generator (seeded alike on every process) in ``augment_batch``'s order,
  and each process applies its rows' (``augment.sample_rows``); explicit
  ``abc`` / ``params`` / ``draws`` are this process's rows' own;
- BatchNorm statistics are the global batch's (``ops.batch_norm``), the
  gradients are averaged before the clip (``TrainState.apply_gradients``),
  and a loss that is not a mean over rows takes its sums over the processes
  (the dice's per-class sums, the class-weighted CE);
- the returned metrics are the global batch's
  (``distributed.reduce_metrics``: loss scalars averaged, ``hist`` summed
  and the scores recomputed from it), per-row outputs (the discriminator's
  probabilities) stay this process's rows, and phase 3's ``finite`` is that
  of the global loss, so every process keeps or drops the same update.

The eval steps run on the batch they are given, with no collective: the
trainers validate the whole set on every process, so their metrics are the
global ones already.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch
import torch.utils.checkpoint

from uda_aerial_semantic_segmentation_research_tpu_torch.ops.augment import (
    STRONG,
    WEAK,
    AugmentConfig,
    augment_batch,
    normalize_images,
    sample_rows,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.batch_norm import (
    frozen_statistics,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.fused_ce import (
    fused_cross_entropy,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.losses import (
    AdversarialLoss,
    FineTuningLoss,
    SMPDiceLoss,
    sigmoid_bce_with_logits,
    softmax_cross_entropy,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.metrics import (
    accuracy_from_hist,
    confusion_matrix,
    iou_from_hist,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.parallel import distributed as dist
from uda_aerial_semantic_segmentation_research_tpu_torch.utils.profiling import annotate


def model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _seg_metrics(logits, masks, num_classes: int):
    preds = logits.argmax(dim=-1)
    hist = confusion_matrix(preds, masks, num_classes)
    per_class_iou, mean_iou = iou_from_hist(hist)
    return {
        "iou": mean_iou,
        "accuracy": accuracy_from_hist(hist),
        "per_class_iou": per_class_iou,
        "hist": hist,
    }


def _check_seg_loss(seg_loss: str) -> None:
    if seg_loss not in ("ce", "dice"):
        raise ValueError(f"seg_loss must be 'ce' or 'dice', got {seg_loss!r}")


def _augment(generator, images, masks, cfg, abc=None, params=None):
    """``augment_batch`` of this process's rows: with several processes and
    no explicit draws, the global batch's draws restricted to them
    (``sample_rows``); otherwise ``augment_batch`` itself."""
    if abc is None and params is None and generator is not None and dist.process_count() > 1:
        abc, params = sample_rows(generator, tuple(images.shape), cfg, masks is not None,
                                  dist.process_index(), dist.process_count())
    return augment_batch(generator, images, masks, cfg=cfg, abc=abc, params=params)


# ---------------------------------------------------------------------------
# phase 1: supervised segmentation
# ---------------------------------------------------------------------------
def make_supervised_train_step(model: torch.nn.Module, num_classes: int,
                               aug_cfg: AugmentConfig = WEAK,
                               class_weights=None, fused_ce: bool = False,
                               seg_loss: str = "ce"):
    """``step(state, generator, images, masks, abc=None, params=None) -> (state, metrics)``.

    ``images`` uint8 NHWC, ``masks`` uint8/int NHW (numpy arrays or
    tensors; moved to the model's device).  One step: augmentation
    (``augment_batch`` with ``aug_cfg``, ``WEAK`` by default as in the JAX
    package: its draws come from ``generator``, a ``torch.Generator`` on the
    model's device that the caller owns, or are given as ``abc`` and
    ``params``), train-mode forward, loss, backward, Adam update of
    ``state`` (a ``TrainState`` over ``model``) in place, metrics.  Metrics:
    ``loss``, ``iou``, ``accuracy``, ``per_class_iou``, ``hist``, all
    device tensors.  After a step the parameters' ``.grad`` hold that
    step's gradients (clipped, when the state clips).

    ``fused_ce`` swaps ``softmax_cross_entropy`` for the fused kernels
    (``ops.fused_ce.fused_cross_entropy``): one read of the logits
    forward, one read and one write backward, no float32 softmax or
    per-pixel loss in device memory; requires ``class_weights=None``.

    ``seg_loss``: ``"ce"`` (softmax cross-entropy) or ``"dice"``
    (``SMPDiceLoss``, the GRL stack's phase-1 criterion).
    """
    _check_seg_loss(seg_loss)
    if fused_ce and class_weights is not None:
        raise ValueError("fused_ce does not support class_weights")
    if seg_loss == "dice":
        if fused_ce or class_weights is not None:
            raise ValueError(
                "seg_loss='dice' supports neither fused_ce nor class_weights")
        dice = SMPDiceLoss()

        def ce(logits, m):
            return dice(logits, m, over_ranks=True)
    elif fused_ce:
        ce = fused_cross_entropy
    else:
        def ce(logits, m):
            return softmax_cross_entropy(logits, m, class_weights, over_ranks=True)

    def step(state, generator, images, masks, abc=None, params=None):
        with annotate("uda.step.train"):
            if state.model is not model:
                raise ValueError("the state belongs to another model than the step")
            device = model_device(model)
            images = torch.as_tensor(images, device=device)
            masks = torch.as_tensor(masks, device=device)
            with torch.no_grad(), annotate("uda.step.augment"):
                x, m = _augment(generator, images, masks, aug_cfg, abc, params)
            model.train()
            state.optimizer.zero_grad(set_to_none=True)
            logits = model(x)
            loss = ce(logits, m)
            loss.backward()
            state.apply_gradients()
            with torch.no_grad():
                metrics = _seg_metrics(logits.detach(), m, num_classes)
            metrics["loss"] = loss.detach()
            return state, dist.reduce_metrics(metrics)

    return step


class _Captured:
    """One CUDA graph of ``unroll`` steps and what it reads and writes: the
    static per-step inputs (``(unroll, ...)`` each), the per-step metrics
    (in the graph's pool, overwritten by every replay), and the state and
    generator it was captured over (kept, so that the key's ids stay theirs)."""

    def __init__(self, graph, inputs, metrics, state, generator, warmup_s, capture_s):
        self.graph, self.inputs, self.metrics = graph, inputs, metrics
        self.state, self.generator = state, generator
        self.warmup_s, self.capture_s = warmup_s, capture_s


def _train_states(state):
    """The ``TrainState``s of ``state`` (a ``TrainState`` or an
    ``AdversarialState``)."""
    if hasattr(state, "optimizer"):
        return [state]
    if hasattr(state, "seg") and hasattr(state, "disc"):
        return [state.seg, state.disc]
    raise TypeError(f"make_scan_driver drives a TrainState or an AdversarialState, not "
                    f"{type(state).__name__}")


def _state_tensors(states):
    """Every tensor that a train step updates in place, once each: parameters,
    buffers, Adam state and device step counters."""
    found = {}
    for st in states:
        tensors = [*st.model.parameters(), *st.model.buffers()]
        for per_param in st.optimizer.state.values():
            tensors += [v for v in per_param.values() if isinstance(v, torch.Tensor)]
        if isinstance(st.step, torch.Tensor):
            tensors.append(st.step)
        for t in tensors:
            found.setdefault(id(t), t)
    return list(found.values())


def _stacked_inputs(batches, device):
    """The batch arguments as tensors on ``device`` and their common leading
    length S.  Each must be an array or tensor with a leading ``(S,)`` axis:
    a per-step scalar is an ``(S,)`` array, never a Python number."""
    if not batches:
        raise ValueError("make_scan_driver's call needs at least one stacked batch")
    stacked = []
    for i, b in enumerate(batches):
        if not isinstance(b, (torch.Tensor, np.ndarray)) or b.ndim == 0:
            raise TypeError(f"batch argument {i} is {type(b).__name__}: every argument after "
                            "the generator needs a leading (S,) axis (a per-step scalar is "
                            "an (S,) array)")
        stacked.append(torch.as_tensor(b, device=device))
    lengths = {t.shape[0] for t in stacked}
    if len(lengths) != 1:
        raise ValueError(f"the batch arguments' leading axes differ: "
                         f"{[tuple(t.shape) for t in stacked]}")
    return stacked, lengths.pop()


def _capture(step, unroll, state, generator, stacked, stream):
    """Warm up ``unroll`` steps on ``stream``, put the state and the generator
    back as they were, and capture the ``unroll`` steps into a CUDA graph on
    the same stream."""
    states = _train_states(state)
    device = stacked[0].device
    inputs = [torch.empty((unroll, *b.shape[1:]), dtype=b.dtype, device=device)
              for b in stacked]
    t0 = time.perf_counter()
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        with torch.no_grad():
            for buf, b in zip(inputs, stacked):
                buf.copy_(b[:unroll])
            before = _state_tensors(states)
            kept = [t.clone() for t in before]
        gen_state = None if generator is None else generator.get_state()
        # the warm-up: Adam's state, channel_sums' scratch for this stream,
        # cuDNN plans, the kernels' libraries and cached device constants
        for j in range(unroll):
            step(state, generator, *(buf[j] for buf in inputs))
        with torch.no_grad():
            for t, k in zip(before, kept):
                t.copy_(k)
            seen = {id(t) for t in before}
            # Adam state made by the warm-up: a fresh one is zeros
            made = [t for t in _state_tensors(states) if id(t) not in seen]
            if made:
                torch._foreach_zero_(made)
        if generator is not None:
            generator.set_state(gen_state)
        del kept
    stream.synchronize()
    warmup_s = time.perf_counter() - t0

    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    t0 = time.perf_counter()
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
        metrics = [step(state, generator, *(buf[j] for buf in inputs))[1]
                   for j in range(unroll)]
    return _Captured(graph, inputs, metrics, state, generator, warmup_s,
                     time.perf_counter() - t0)


def make_scan_driver(step, unroll: int = 1):
    """``multi(state, generator, *batches) -> (state, metrics)``: S calls of a
    train step ``step(state, generator, *per_step_batches)`` in one call.
    Counterpart of the JAX ``make_scan_driver`` (``jax.lax.scan`` of the step
    in one compiled program).

    Every batch argument has a leading ``(S,)`` axis, and step ``i`` gets its
    ``i``-th slice; per-step scalars (phase 3's ``epoch``, the GRL step's
    ``alpha``) are ``(S,)`` arrays, so that step gets a 0-d tensor.  The
    metrics come back stacked, ``(S, ...)`` per entry.  ``state`` (a
    ``TrainState`` or ``AdversarialState``) advances by S steps in place and
    its step counter reads S more.  Numpy batches are moved to the state's
    device first, in one copy each.

    On the CPU (the caller put the model there) the S calls run one after
    another.  On the card the steps run as a CUDA graph of ``unroll`` steps
    (JAX's ``unroll``), replayed ``S / unroll`` times; before each replay the
    next slices of the stacked batches are copied on the device into the
    graph's static inputs, and after it the metrics are copied out (the
    returned metrics are copies, never views of the graph's buffers).  The
    graphs are kept per scan driver in ``multi.graphs``, keyed by the per-step
    shapes and dtypes, the device, the state and the generator (the step and
    ``unroll`` are the scan driver's).  A new key is captured on its first call:
    ``unroll`` steps run eagerly on a capture stream of the scan driver's own
    (which builds Adam's state, ``channel_sums``' scratch for that stream,
    cuDNN plans and cached constants), then the state -- parameters,
    buffers, Adam's moments and counts, step counters, in the same storages
    -- and the generator are put back as they were, and the ``unroll``
    steps are captured.  So the first call's S steps are replays too, and
    leave the state that S eager steps leave.  The generator (a CUDA
    ``torch.Generator``; a CPU one raises) is registered with each graph, so
    every replay draws what the eager steps would.  The card needs states
    built with ``capturable=True`` (``TrainState``); a capture that fails
    raises, and nothing falls back to eager calls.  Graphs of one scan driver
    share its capture stream's ``channel_sums`` scratch, so they replay one
    after another, on the caller's current stream.

    Under a process group the graph holds the step's collectives: that needs
    the NCCL backend, whose collectives a CUDA graph captures (the warm-up
    runs them once eagerly, which sets up the communicator); under gloo,
    which stages CUDA tensors through the host, the card raises.  Every
    process must call the scan driver alike: replays run the collectives too.
    """
    if not isinstance(unroll, int) or unroll < 1:
        raise ValueError(f"unroll must be a positive int, got {unroll!r}")
    graphs: dict = {}
    streams: dict = {}

    def multi(state, generator, *batches):
        states = _train_states(state)
        device = model_device(states[0].model)
        stacked, s = _stacked_inputs(batches, device)
        if device.type != "cuda":
            per_step = []
            for i in range(s):
                state, metrics = step(state, generator, *(b[i] for b in stacked))
                per_step.append(metrics)
            return state, {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}

        if s % unroll:
            raise ValueError(f"S={s} steps are not a whole number of unroll={unroll} graphs")
        if generator is not None and generator.device.type != "cuda":
            raise ValueError(f"the steps run on {device}: the generator must be a CUDA "
                             f"generator, not one on {generator.device}")
        if not all(st.capturable for st in states):
            raise ValueError("a CUDA graph of the steps needs states built with "
                             "TrainState(..., capturable=True)")
        if dist.is_initialized() and torch.distributed.get_backend() != "nccl":
            raise RuntimeError(
                f"a CUDA graph of data-parallel steps captures their collectives, which "
                f"needs the NCCL backend; the {torch.distributed.get_backend()} backend "
                "stages CUDA tensors through the host and cannot be captured")
        key = (tuple((tuple(b.shape[1:]), b.dtype) for b in stacked), device, id(state),
               id(generator))
        entry = graphs.get(key)
        if entry is None:
            stream = streams.get(device)
            if stream is None:
                stream = streams[device] = torch.cuda.Stream(device)
            entry = graphs[key] = _capture(step, unroll, state, generator, stacked, stream)
        out = {k: torch.empty((s, *v.shape), dtype=v.dtype, device=device)
               for k, v in entry.metrics[0].items()}
        with torch.no_grad():
            for r in range(s // unroll):
                for buf, b in zip(entry.inputs, stacked):
                    buf.copy_(b[r * unroll:(r + 1) * unroll])
                entry.graph.replay()
                for j, metrics in enumerate(entry.metrics):
                    for k, v in metrics.items():
                        out[k][r * unroll + j].copy_(v)
        return state, out

    multi.graphs = graphs
    return multi


def make_eval_step(model: torch.nn.Module, num_classes: int, class_weights=None,
                   seg_loss: str = "ce"):
    """``step(images, masks) -> metrics`` (loss / iou / accuracy /
    per_class_iou / hist, device tensors): normalize, eval-mode forward
    with the running BatchNorm statistics, then ``softmax_cross_entropy``
    or, with ``seg_loss="dice"``, ``SMPDiceLoss``.
    """
    _check_seg_loss(seg_loss)
    if seg_loss == "dice":
        if class_weights is not None:
            raise ValueError("seg_loss='dice' does not support class_weights")
        loss_fn = SMPDiceLoss()
    else:
        def loss_fn(logits, m):
            return softmax_cross_entropy(logits, m, class_weights)

    def step(images, masks):
        device = model_device(model)
        model.eval()
        with torch.inference_mode():
            x = normalize_images(torch.as_tensor(images, device=device))
            m = torch.as_tensor(masks, device=device).to(torch.int32)
            logits = model(x)
            metrics = _seg_metrics(logits, m, num_classes)
            metrics["loss"] = loss_fn(logits, m)
        return metrics

    return step


def make_predict_step(model: torch.nn.Module):
    """``step(images)``: uint8/float NHWC images -> float32 NHWC logits.

    Normalizes (ImageNet statistics; integers divided by 255), then runs
    the model's eval-mode forward under ``torch.inference_mode``.  Images
    may be a numpy array or a tensor; they are moved to the model's
    device.
    """
    device = model_device(model)

    def step(images):
        model.eval()
        with torch.inference_mode():
            x = normalize_images(torch.as_tensor(images, device=device))
            return model(x).float()

    return step


# ---------------------------------------------------------------------------
# phase 2: adversarial domain adaptation (two optimizers, D then G)
# ---------------------------------------------------------------------------
def _to_device(device, *arrays):
    return tuple(None if a is None else torch.as_tensor(a, device=device) for a in arrays)


def _draws(draws, i):
    """``(abc, params)`` of the ``i``-th augmented batch of ``draws``, or
    ``(None, None)`` (draw from the generator)."""
    return (None, None) if draws is None or draws[i] is None else draws[i]


def _cast(x, dtype):
    return x if x is None or dtype is None else x.to(dtype)


def _source_target_inputs(model, generator, src_images, src_masks, tgt_images, aug_cfg,
                          draws, xs_dtype=None, xt_dtype=None):
    """The source batch (with masks) and the target batch (without) on the
    model's device, each through ``augment_batch``, drawing in that order;
    the images cast to ``xs_dtype`` / ``xt_dtype`` where given."""
    src_images, src_masks, tgt_images = _to_device(model_device(model), src_images,
                                                   src_masks, tgt_images)
    with torch.no_grad():
        xs, ms = _augment(generator, src_images, src_masks, aug_cfg, *_draws(draws, 0))
        xt, _ = _augment(generator, tgt_images, None, aug_cfg, *_draws(draws, 1))
    return _cast(xs, xs_dtype), ms, _cast(xt, xt_dtype)


def make_adversarial_train_step(seg: torch.nn.Module, disc: torch.nn.Module,
                                num_classes: int, lambda_adv: float = 0.001,
                                aug_cfg: AugmentConfig = WEAK, concat_disc: bool = False):
    """``step(state, generator, src_images, src_masks, tgt_images, draws=None)
    -> (state, metrics)``: one discriminator update, then one segmentation
    update, on an ``AdversarialState`` in place.

    Augmentation: the source batch (with its masks), then the target batch
    (without), each by ``augment_batch`` with ``aug_cfg``; their draws come
    from ``generator`` in that order, or from ``draws = ((abc, params) of
    the source, (abc, params) of the target)``.

    Step A (the discriminator): D(src) then D(tgt) in train mode, so D's
    BatchNorm statistics move twice, once per domain (``concat_disc=True``:
    one forward over the concatenated batch, joint statistics, one move);
    ``AdversarialLoss.discriminator_loss`` (labels 1 / 0); D's Adam update.

    Step B (the generator): the U-Net in train mode on the source batch and
    the softmax CE; D(tgt) in eval mode with the UPDATED D under
    ``no_grad`` -- no gradient reaches D and its statistics do not move --
    for ``generator_loss``; backward of the sum; the segmentation Adam
    update.  As in the JAX package the discriminator sees raw images, so
    the generator term has no gradient with respect to the segmentation
    parameters: the U-Net's update is that of ``lambda_adv=0``.

    The step runs as the JAX memory-decomposed step's three programs, which
    ``step.programs`` names: ``prep`` (both augmentations), ``d_step``
    (step A), ``g_step`` (step B).  Eagerly D's graph is freed before G's
    forward, so this is also the JAX joint step's update: only the
    augmented batches live between the phases, ``xs`` in the modules'
    compute dtype when the two modules' dtypes agree (float32 otherwise),
    ``xt`` in the discriminator's.  Each module casts its input at its
    first conv, so the cast changes no value.

    Metrics (device tensors): ``loss``, ``seg_loss``, ``adv_loss``,
    ``d_loss``, ``source_domain_prob`` / ``target_domain_prob`` (step A's
    logits through a sigmoid, (B, 1)), and the segmentation metrics.
    """
    adv = AdversarialLoss(lambda_adv)
    seg_dtype, disc_dtype = getattr(seg, "dtype", None), getattr(disc, "dtype", None)
    xs_dtype = seg_dtype if seg_dtype == disc_dtype else None

    def prep(generator, src_images, src_masks, tgt_images, draws):
        return _source_target_inputs(seg, generator, src_images, src_masks, tgt_images,
                                     aug_cfg, draws, xs_dtype, disc_dtype)

    def d_step(disc_state, xs, xt):
        return _adv_d_update(adv, disc, disc_state, xs, xt, concat_disc)

    def g_step(seg_state, xs, ms, xt):
        return _adv_g_update(adv, seg, disc, num_classes, seg_state, xs, ms, xt)

    def step(state, generator, src_images, src_masks, tgt_images, draws=None):
        if state.seg.model is not seg or state.disc.model is not disc:
            raise ValueError("the state belongs to other models than the step")
        xs, ms, xt = prep(generator, src_images, src_masks, tgt_images, draws)
        d_loss, s_logit, t_logit = d_step(state.disc, xs, xt)
        metrics = g_step(state.seg, xs, ms, xt)
        metrics.update({"d_loss": d_loss, "source_domain_prob": torch.sigmoid(s_logit),
                        "target_domain_prob": torch.sigmoid(t_logit)})
        return state, dist.reduce_metrics(metrics)

    step.programs = {"prep": prep, "d_step": d_step, "g_step": g_step}
    return step


# the JAX package's memory-decomposed phase-2 step: eagerly the same update
make_adversarial_sequential_step = make_adversarial_train_step


def _adv_d_update(adv, disc, disc_state, xs, xt, concat_disc=False):
    """Step A: one discriminator update on D(src) vs D(tgt), labels 1 / 0,
    train mode (per-domain statistics unless ``concat_disc``).  Returns the
    detached ``(d_loss, source logits, target logits)``."""
    disc.train()
    disc_state.optimizer.zero_grad(set_to_none=True)
    if concat_disc:
        s_logit, t_logit = disc(torch.cat([xs, xt]), return_logits=True).chunk(2)
    else:
        s_logit = disc(xs, return_logits=True)
        t_logit = disc(xt, return_logits=True)
    d_loss = adv.discriminator_loss(s_logit, t_logit)
    d_loss.backward()
    disc_state.apply_gradients()
    return d_loss.detach(), s_logit.detach(), t_logit.detach()


def _adv_g_update(adv, seg, disc, num_classes, seg_state, xs, ms, xt):
    """Step B: one segmentation update on CE(source) + the generator BCE of
    the UPDATED discriminator's eval-mode D(tgt), under ``no_grad``.
    Returns the segmentation metrics with ``loss``, ``seg_loss``,
    ``adv_loss``."""
    seg.train()
    seg_state.optimizer.zero_grad(set_to_none=True)
    logits = seg(xs)
    seg_loss = softmax_cross_entropy(logits, ms)
    disc.eval()
    with torch.no_grad():
        adv_loss = adv.generator_loss(disc(xt, return_logits=True))
    total = seg_loss + adv_loss
    total.backward()
    seg_state.apply_gradients()
    with torch.no_grad():
        metrics = _seg_metrics(logits.detach(), ms, num_classes)
    metrics.update({"loss": total.detach(), "seg_loss": seg_loss.detach(),
                    "adv_loss": adv_loss})
    return metrics


# ---------------------------------------------------------------------------
# phase 3: unsupervised consistency fine-tuning
# ---------------------------------------------------------------------------
def chunked_consistency(cons_fn, rows: int = 32):
    """``cons_fn(z1, z2)`` summed over row chunks of ``rows``, each chunk's
    softmax transients recomputed in the backward (``torch.utils.checkpoint``).

    The consistency KL is a batchmean sum over every pixel (divided by B,
    whatever H), so the per-pixel terms add over chunks of the H axis and
    the chunk losses sum to the whole loss to float reassociation.  The
    region holds no BatchNorm, so recomputing it is exact.  Without chunks
    (H <= ``rows``, or H not a multiple of it) the whole loss is one
    checkpointed region.  The KL draws nothing, so the recompute keeps no
    RNG state (``preserve_rng_state=False``: reading the CUDA RNG state is
    not allowed inside a captured backward).  Counterpart of the JAX
    ``_chunked_consistency``.
    """

    def run(a, b):
        return torch.utils.checkpoint.checkpoint(cons_fn, a, b, use_reentrant=False,
                                                 preserve_rng_state=False)

    def f(z1, z2):
        h = z1.shape[1]
        if h <= rows or h % rows:
            return run(z1, z2)
        acc = torch.zeros((), dtype=torch.float32, device=z1.device)
        for a, b in zip(z1.split(rows, dim=1), z2.split(rows, dim=1)):
            acc = acc + run(a, b)
        return acc

    return f


def _unsup_inputs(state, seg, disc, generator, tgt_images, sup_images, sup_masks, draws,
                  aug_cfg, with_supervised, view_dtype=None):
    """Checks a phase-3 state, then ``(tgt_images, v1, v2, xs, ms)`` on the
    U-Net's device: the two target views, then with ``with_supervised`` the
    ``WEAK`` view of the supervised batch (``None`` otherwise), drawn in
    that order, the views cast to ``view_dtype``."""
    held = {id(p) for p in state.model.parameters()}
    if not all(id(p) in held for m in (seg, disc) for p in m.parameters()):
        raise ValueError("the state does not hold both models' parameters")
    if not state.skip_nonfinite:
        raise ValueError("the phase-3 state must be built with skip_nonfinite=True")
    if with_supervised and (sup_images is None or sup_masks is None):
        raise ValueError("with_supervised needs sup_images and sup_masks")
    tgt_images, sup_images, sup_masks = _to_device(model_device(seg), tgt_images, sup_images,
                                                   sup_masks)
    with torch.no_grad():
        views = [_cast(_augment(generator, tgt_images, None, aug_cfg, *_draws(draws, i))[0],
                       view_dtype) for i in range(2)]
        xs = ms = None
        if with_supervised:
            xs, ms = _augment(generator, sup_images, sup_masks, WEAK, *_draws(draws, 2))
    return tgt_images, views[0], views[1], _cast(xs, view_dtype), ms


def _kept_buffers(seg, disc):
    """Both models' buffers and exact copies of them (one launch)."""
    with torch.no_grad():
        buffers = [*seg.buffers(), *disc.buffers()]
        return buffers, torch._foreach_mul(buffers, 1.0)


def _finish_unsup(state, finite, buffers, kept):
    """The non-finite guard's update: Adam skipped and the buffers put back
    where ``finite`` is false, without a host read."""
    state.apply_gradients(finite)
    with torch.no_grad():
        for b, k in zip(buffers, kept):
            torch.where(finite, b, k, out=b)


def make_unsupervised_train_step(seg: torch.nn.Module, disc: torch.nn.Module,
                                 num_classes: int, fine_tuning_loss: FineTuningLoss,
                                 aug_cfg: AugmentConfig = STRONG,
                                 with_supervised: bool = False):
    """``step(state, generator, tgt_images, epoch, sup_images=None,
    sup_masks=None, draws=None) -> (state, metrics)``: one fine-tuning
    update of a ``TrainState`` over both models (a ``DomainAdaptationModel``,
    ``skip_nonfinite=True``, the JAX recipe's ``adam(lr, clip_norm=1.0)``).

    Inputs: two views v1, v2 of the target batch by ``augment_batch`` with
    ``aug_cfg`` (no masks), ``x0 = normalize_images(tgt_images)``
    un-augmented for the discriminator, and with ``with_supervised`` a
    ``WEAK`` view of the supervised batch.  Draws from ``generator`` in the
    order v1, v2, supervised (the JAX step's keys k1, k2, k3), or from
    ``draws`` (a tuple of ``(abc, params)`` in that order).

    Forwards, all in train mode: U-Net(v1), U-Net(v2) (its statistics move
    twice), D(x0), and U-Net(supervised view) for the dice term.  Then
    ``fine_tuning_loss`` (its consistency term chunked by
    ``chunked_consistency``), one backward through both models, one clipped
    Adam update over both.

    When ``total`` is not finite, every element of the state stays
    bit-identical: parameters, Adam moments and count, both models' BatchNorm
    statistics (kept from before the forwards and put back by a
    ``torch.where``), and ``state.step``.  Nothing is read back to the host.

    Metrics (device tensors): the loss components, ``finite`` (a bool) and
    ``domain_prob`` (sigmoid of D(x0), (B, 1)).
    """
    loss_fn = copy.copy(fine_tuning_loss)
    loss_fn.consistency_loss = chunked_consistency(fine_tuning_loss.consistency_loss)

    def step(state, generator, tgt_images, epoch, sup_images=None, sup_masks=None,
             draws=None):
        tgt_images, v1, v2, xs, ms = _unsup_inputs(
            state, seg, disc, generator, tgt_images, sup_images, sup_masks, draws, aug_cfg,
            with_supervised)
        x0 = normalize_images(tgt_images)
        buffers, kept = _kept_buffers(seg, disc)

        seg.train()
        disc.train()
        state.optimizer.zero_grad(set_to_none=True)
        p1 = seg(v1)
        p2 = seg(v2)
        domain_logits = disc(x0, return_logits=True)
        sup_pred = seg(xs) if with_supervised else None
        losses = loss_fn(p1, p2, domain_logits, epoch, supervised_pred=sup_pred,
                         supervised_target=ms)
        losses["total"].backward()
        metrics = dist.reduce_metrics({k: v.detach() for k, v in losses.items()})
        finite = torch.isfinite(metrics["total"])
        _finish_unsup(state, finite, buffers, kept)

        metrics["finite"] = finite
        metrics["domain_prob"] = torch.sigmoid(domain_logits.detach())
        return state, metrics

    return step


def make_unsupervised_sequential_step(seg: torch.nn.Module, disc: torch.nn.Module,
                                      num_classes: int, fine_tuning_loss: FineTuningLoss,
                                      aug_cfg: AugmentConfig = STRONG,
                                      with_supervised: bool = False, carry_dtype=None):
    """The memory-decomposed phase-3 update: ``make_unsupervised_train_step``'s
    contract, draws, metrics and non-finite guard, with the same total
    gradient computed as a sum of partials, one forward and backward at a
    time (the JAX ``make_unsupervised_sequential_step``):

    - the consistency term obeys ``d cons(z1(p), z2(p)) = d cons(z1(p),
      sg(z2)) + d cons(sg(z1), z2(p))``, so two single-view backward passes
      against the other view's frozen logits give the joint gradient; the
      domain-confusion and supervised terms touch their own forwards;
    - the passes, in the JAX step's order: ``grad_disc`` (D on ``x0``,
      normalized inside the pass); ``fwd_view1`` (train mode, no gradient:
      the view-1 logits ``z1``; it moves the statistics); ``grad_view2``
      (``cons(sg(z1), p2) * w``, ``w = consistency_weight * rampup``; moves
      them); ``grad_view1`` (``cons(p1, sg(z2)) * w`` under
      ``frozen_statistics``: the statistics stay as ``fwd_view1`` left
      them); ``grad_sup`` (the supervised dice; moves them); then one clipped
      Adam update over the gradients summed in ``.grad`` (the clip sees the
      sum);
    - the statistics chain v1 -> v2 -> supervised as in the joint step, so
      the buffers end bit-identical to its.

    Carried between passes: the views in the U-Net's compute dtype (its
    first conv casts there anyway) and ``z1``, ``z2`` in ``carry_dtype``
    (``None``: the logits' dtype, numerically the joint step; bfloat16 halves
    the largest carries at a small divergence in the KL targets).  Each is
    dropped after its last use, where the JAX step donates it, so the peak
    is one forward and backward plus the carries.  ``step.programs`` names
    the passes.
    """
    ftl = fine_tuning_loss
    cons = chunked_consistency(ftl.consistency_loss)
    view_dtype, disc_dtype = getattr(seg, "dtype", None), getattr(disc, "dtype", None)

    def carry(z):
        return _cast(z.detach(), carry_dtype)

    def prep(state, generator, tgt_images, sup_images, sup_masks, draws):
        return _unsup_inputs(state, seg, disc, generator, tgt_images, sup_images, sup_masks,
                             draws, aug_cfg, with_supervised, view_dtype)

    def grad_disc(tgt_images, r):
        logits = disc(_cast(normalize_images(tgt_images), disc_dtype), return_logits=True)
        dom = ftl.domain_loss.generator_loss(logits)
        (dom * ftl.domain_weight * r).backward()
        return dom.detach(), logits.detach()

    def fwd_view1(v1):
        with torch.no_grad():
            return carry(seg(v1))

    def grad_view2(v2, z1, w):
        p2 = seg(v2)
        c = cons(z1, p2)
        (c * w).backward()
        return c.detach(), carry(p2)

    def grad_view1(v1, z2, w):
        with frozen_statistics():
            p1 = seg(v1)
        (cons(p1, z2) * w).backward()

    def grad_sup(xs, ms):
        s = ftl.supervised_loss(seg(xs), ms)
        (s * ftl.supervised_weight).backward()
        return s.detach()

    def combine(state, cons_v, dom_v, sup_v, r, domain_logits, buffers, kept):
        total = cons_v * ftl.consistency_weight * r + dom_v * ftl.domain_weight * r
        if with_supervised:
            total = total + sup_v * ftl.supervised_weight
        metrics = dist.reduce_metrics({"total": total, "consistency": cons_v,
                                       "domain_confusion": dom_v, "supervised": sup_v,
                                       "rampup_weight": r})
        finite = torch.isfinite(metrics["total"])
        _finish_unsup(state, finite, buffers, kept)
        metrics.update(finite=finite, domain_prob=torch.sigmoid(domain_logits))
        return metrics

    def step(state, generator, tgt_images, epoch, sup_images=None, sup_masks=None,
             draws=None):
        tgt_images, v1, v2, xs, ms = prep(state, generator, tgt_images, sup_images, sup_masks,
                                          draws)
        buffers, kept = _kept_buffers(seg, disc)
        r = ftl.rampup(epoch, tgt_images.device)
        w = ftl.consistency_weight * r
        seg.train()
        disc.train()
        state.optimizer.zero_grad(set_to_none=True)
        # the discriminator first: its buffers die before the view passes
        dom_v, domain_logits = grad_disc(tgt_images, r)
        z1 = fwd_view1(v1)
        cons_v, z2 = grad_view2(v2, z1, w)
        del v2, z1
        grad_view1(v1, z2, w)
        del v1, z2
        if with_supervised:
            sup_v = grad_sup(xs, ms)
            del xs, ms
        else:
            sup_v = torch.zeros((), dtype=torch.float32, device=r.device)
        return state, combine(state, cons_v, dom_v, sup_v, r, domain_logits, buffers, kept)

    step.programs = {"prep": prep, "grad_disc": grad_disc, "fwd_view1": fwd_view1,
                     "grad_view2": grad_view2, "grad_view1": grad_view1, "combine": combine}
    if with_supervised:
        step.programs["grad_sup"] = grad_sup
    return step


# ---------------------------------------------------------------------------
# the GRL stack: one model, one optimizer, the domain head behind a GRL
# ---------------------------------------------------------------------------
def _grl_seg_loss(seg_loss: str, over_ranks: bool = False):
    _check_seg_loss(seg_loss)
    if seg_loss == "ce":
        return softmax_cross_entropy
    dice = SMPDiceLoss()
    return lambda logits, m: dice(logits, m, over_ranks=over_ranks)


def _domain_acc(d_src, d_tgt):
    """Logit-sign accuracy over both domains; ``d_src >= 0`` counts as
    correct for the source (the JAX steps' rule)."""
    return 0.5 * ((d_src >= 0).float().mean() + (d_tgt < 0).float().mean())


def _grl_metrics(seg, ms, num_classes, total, seg_loss, domain_loss, domain_acc):
    with torch.no_grad():
        metrics = _seg_metrics(seg.detach(), ms, num_classes)
    metrics.update({"loss": total.detach(), "seg_loss": seg_loss.detach(),
                    "domain_loss": domain_loss.detach(), "domain_acc": domain_acc})
    return metrics


def make_grl_sequential_step(model: torch.nn.Module, num_classes: int,
                             lambda_domain: float = 1.0, aug_cfg: AugmentConfig = WEAK,
                             seg_loss: str = "dice"):
    """``step(state, generator, src_images, src_masks, tgt_images, alpha,
    draws=None) -> (state, metrics)``: one Adam update of a ``TrainState``
    over a ``UDASegmentationModel`` on ``seg + lambda_domain * (bce(d_src, 1)
    + bce(d_tgt, 0)) / 2``.

    The loss is additive across the two traversals, ``seg(src) + lam/2 *
    bce(d_src, 1) + lam/2 * bce(d_tgt, 0)``, so the source terms' backward
    runs (and frees the source graph) before the target traversal, whose
    backward accumulates into the same ``.grad``; then one Adam step.  Peak
    memory holds one traversal's activations.  Both traversals run in
    train mode, so the BatchNorm statistics move source first, then target.
    The target traversal is ``domain_only``: its segmentation would enter
    no loss, so skipping the decoder leaves the update exact and only the
    decoder's statistics miss the target batch.  ``alpha`` (a float or a
    0-d device tensor) scales the reversed gradient.  ``seg_loss``:
    ``"dice"`` (``SMPDiceLoss``, the default) or ``"ce"``.  Draws: source
    then target from ``generator``, or ``draws = ((abc, params) of the
    source, (abc, params) of the target)``.

    Metrics (device tensors): ``loss``, ``seg_loss``, ``domain_loss``,
    ``domain_acc`` and the segmentation metrics.
    """
    seg_loss_fn = _grl_seg_loss(seg_loss, over_ranks=True)
    lam = lambda_domain

    def step(state, generator, src_images, src_masks, tgt_images, alpha, draws=None):
        if state.model is not model:
            raise ValueError("the state belongs to another model than the step")
        xs, ms, xt = _source_target_inputs(model, generator, src_images, src_masks,
                                           tgt_images, aug_cfg, draws)
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        seg, d_src = model(xs, domain_adaptation=True, alpha=alpha)
        sl = seg_loss_fn(seg, ms)
        dl_src = sigmoid_bce_with_logits(d_src, torch.ones_like(d_src))
        (sl + (lam / 2.0) * dl_src).backward()
        seg, d_src, sl, dl_src = seg.detach(), d_src.detach(), sl.detach(), dl_src.detach()

        d_tgt = model(xt, domain_adaptation=True, alpha=alpha, domain_only=True)[1]
        dl_tgt = sigmoid_bce_with_logits(d_tgt, torch.zeros_like(d_tgt))
        ((lam / 2.0) * dl_tgt).backward()
        state.apply_gradients()
        domain_loss = (dl_src + dl_tgt.detach()) / 2.0
        return state, dist.reduce_metrics(_grl_metrics(
            seg, ms, num_classes, sl + lam * domain_loss, sl, domain_loss,
            _domain_acc(d_src, d_tgt.detach())))

    return step


# The JAX package's single-backward GRL step exists beside its sequential
# twin because XLA compiles the two differently; eagerly they are one
# update (up to float reassociation), so the port keeps one body.
make_grl_train_step = make_grl_sequential_step


def make_grl_eval_step(model: torch.nn.Module, num_classes: int, lambda_domain: float = 0.001,
                       seg_loss: str = "dice"):
    """``step(src_images, src_masks, tgt_images) -> metrics``: the GRL
    stack's phase-2 validation.  Eval mode throughout (no statistics
    move); the source batch runs the whole model, the target batch runs
    ``domain_only``.  ``loss = seg + lambda_domain * (bce(d_src, 1) +
    bce(d_tgt, 0)) / 2``; metrics as ``make_grl_train_step``'s, with
    ``domain_acc`` over both validation batches.
    """
    seg_loss_fn = _grl_seg_loss(seg_loss)
    lam = lambda_domain

    def step(src_images, src_masks, tgt_images):
        src_images, src_masks, tgt_images = _to_device(model_device(model), src_images,
                                                       src_masks, tgt_images)
        model.eval()
        with torch.inference_mode():
            seg, d_src = model(normalize_images(src_images), domain_adaptation=True)
            d_tgt = model(normalize_images(tgt_images), domain_adaptation=True,
                          domain_only=True)[1]
            ms = src_masks.to(torch.int32)
            sl = seg_loss_fn(seg, ms)
            domain_loss = (sigmoid_bce_with_logits(d_src, torch.ones_like(d_src))
                           + sigmoid_bce_with_logits(d_tgt, torch.zeros_like(d_tgt))) / 2.0
            return _grl_metrics(seg, ms, num_classes, sl + lam * domain_loss, sl, domain_loss,
                                _domain_acc(d_src, d_tgt))

    return step
