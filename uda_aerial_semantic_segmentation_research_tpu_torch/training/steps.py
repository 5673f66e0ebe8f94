"""Step factories of the PyTorch port.

Counterpart of the JAX package's ``training/steps.py``.  Ported so far:
the phase-1 supervised train step, the eval step and the serving step
(``make_supervised_train_step``, ``make_eval_step``, ``make_predict_step``),
the phase-2 adversarial step (``make_adversarial_train_step``), the
phase-3 unsupervised step (``make_unsupervised_train_step``) and the GRL
stack's steps (``make_grl_sequential_step``, with ``make_grl_train_step``
its alias, and ``make_grl_eval_step``); the JAX package's sequential twins of the
adversarial and unsupervised steps are not ported.  Each factory
closes over the static pieces and returns an eager function.
Properties shared by the steps:

- raw uint8 batches go straight to the device; dequantization,
  augmentation and normalization run there;
- the train step updates the model, its BatchNorm buffers and the
  optimizer in place;
- metrics (loss scalars and the confusion matrix) are returned as device
  tensors, and a step reads nothing back to the host itself.
"""

from __future__ import annotations

import copy

import torch
import torch.utils.checkpoint

from uda_aerial_semantic_segmentation_research_tpu_torch.ops.augment import (
    STRONG,
    WEAK,
    AugmentConfig,
    augment_batch,
    normalize_images,
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
        ce = SMPDiceLoss()
    elif fused_ce:
        ce = fused_cross_entropy
    else:
        def ce(logits, m):
            return softmax_cross_entropy(logits, m, class_weights)

    def step(state, generator, images, masks, abc=None, params=None):
        if state.model is not model:
            raise ValueError("the state belongs to another model than the step")
        device = model_device(model)
        images = torch.as_tensor(images, device=device)
        masks = torch.as_tensor(masks, device=device)
        with torch.no_grad():
            x, m = augment_batch(generator, images, masks, cfg=aug_cfg, abc=abc,
                                 params=params)
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        logits = model(x)
        loss = ce(logits, m)
        loss.backward()
        state.apply_gradients()
        with torch.no_grad():
            metrics = _seg_metrics(logits.detach(), m, num_classes)
        metrics["loss"] = loss.detach()
        return state, metrics

    return step


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

    Metrics (device tensors): ``loss``, ``seg_loss``, ``adv_loss``,
    ``d_loss``, ``source_domain_prob`` / ``target_domain_prob`` (step A's
    logits through a sigmoid, (B, 1)), and the segmentation metrics.
    """
    adv = AdversarialLoss(lambda_adv)

    def step(state, generator, src_images, src_masks, tgt_images, draws=None):
        if state.seg.model is not seg or state.disc.model is not disc:
            raise ValueError("the state belongs to other models than the step")
        src_images, src_masks, tgt_images = _to_device(model_device(seg), src_images,
                                                       src_masks, tgt_images)
        with torch.no_grad():
            abc, params = _draws(draws, 0)
            xs, ms = augment_batch(generator, src_images, src_masks, cfg=aug_cfg, abc=abc,
                                   params=params)
            abc, params = _draws(draws, 1)
            xt, _ = augment_batch(generator, tgt_images, None, cfg=aug_cfg, abc=abc,
                                  params=params)

        d_loss, s_logit, t_logit = _adv_d_update(adv, disc, state.disc, xs, xt, concat_disc)
        metrics = _adv_g_update(adv, seg, disc, num_classes, state.seg, xs, ms, xt)
        metrics.update({"d_loss": d_loss, "source_domain_prob": torch.sigmoid(s_logit),
                        "target_domain_prob": torch.sigmoid(t_logit)})
        return state, metrics

    return step


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
    checkpointed region.  Counterpart of the JAX ``_chunked_consistency``.
    """

    def run(a, b):
        return torch.utils.checkpoint.checkpoint(cons_fn, a, b, use_reentrant=False)

    def f(z1, z2):
        h = z1.shape[1]
        if h <= rows or h % rows:
            return run(z1, z2)
        acc = torch.zeros((), dtype=torch.float32, device=z1.device)
        for a, b in zip(z1.split(rows, dim=1), z2.split(rows, dim=1)):
            acc = acc + run(a, b)
        return acc

    return f


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
        held = {id(p) for p in state.model.parameters()}
        if not all(id(p) in held for m in (seg, disc) for p in m.parameters()):
            raise ValueError("the state does not hold both models' parameters")
        if not state.skip_nonfinite:
            raise ValueError("the phase-3 state must be built with skip_nonfinite=True")
        if with_supervised and (sup_images is None or sup_masks is None):
            raise ValueError("with_supervised needs sup_images and sup_masks")
        device = model_device(seg)
        tgt_images, sup_images, sup_masks = _to_device(device, tgt_images, sup_images,
                                                       sup_masks)
        with torch.no_grad():
            views = []
            for i in range(2):
                abc, params = _draws(draws, i)
                views.append(augment_batch(generator, tgt_images, None, cfg=aug_cfg, abc=abc,
                                           params=params)[0])
            x0 = normalize_images(tgt_images)
            xs = ms = None
            if with_supervised:
                abc, params = _draws(draws, 2)
                xs, ms = augment_batch(generator, sup_images, sup_masks, cfg=WEAK, abc=abc,
                                       params=params)
            buffers = [*seg.buffers(), *disc.buffers()]
            kept = torch._foreach_mul(buffers, 1.0)       # exact copies, one launch

        seg.train()
        disc.train()
        state.optimizer.zero_grad(set_to_none=True)
        p1 = seg(views[0])
        p2 = seg(views[1])
        domain_logits = disc(x0, return_logits=True)
        sup_pred = seg(xs) if with_supervised else None
        losses = loss_fn(p1, p2, domain_logits, epoch, supervised_pred=sup_pred,
                         supervised_target=ms)
        losses["total"].backward()
        finite = torch.isfinite(losses["total"])
        state.apply_gradients(finite)
        with torch.no_grad():
            for b, k in zip(buffers, kept):
                torch.where(finite, b, k, out=b)

        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["finite"] = finite
        metrics["domain_prob"] = torch.sigmoid(domain_logits.detach())
        return state, metrics

    return step


# ---------------------------------------------------------------------------
# the GRL stack: one model, one optimizer, the domain head behind a GRL
# ---------------------------------------------------------------------------
def _grl_seg_loss(seg_loss: str):
    _check_seg_loss(seg_loss)
    return SMPDiceLoss() if seg_loss == "dice" else softmax_cross_entropy


def _grl_inputs(model, generator, src_images, src_masks, tgt_images, aug_cfg, draws):
    """The source batch (with masks) and the target batch (without) on the
    model's device, each through ``augment_batch``, drawing in that order."""
    src_images, src_masks, tgt_images = _to_device(model_device(model), src_images,
                                                   src_masks, tgt_images)
    with torch.no_grad():
        abc, params = _draws(draws, 0)
        xs, ms = augment_batch(generator, src_images, src_masks, cfg=aug_cfg, abc=abc,
                               params=params)
        abc, params = _draws(draws, 1)
        xt, _ = augment_batch(generator, tgt_images, None, cfg=aug_cfg, abc=abc,
                              params=params)
    return xs, ms, xt


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
    seg_loss_fn = _grl_seg_loss(seg_loss)
    lam = lambda_domain

    def step(state, generator, src_images, src_masks, tgt_images, alpha, draws=None):
        if state.model is not model:
            raise ValueError("the state belongs to another model than the step")
        xs, ms, xt = _grl_inputs(model, generator, src_images, src_masks, tgt_images,
                                 aug_cfg, draws)
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
        return state, _grl_metrics(seg, ms, num_classes, sl + lam * domain_loss, sl,
                                   domain_loss, _domain_acc(d_src, d_tgt.detach()))

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
