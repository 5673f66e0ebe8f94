"""One process of the port's data-parallel tests (``tests/test_torch_parallel.py``).

Imports torch and the port only.  The test writes ``inputs.pkl`` (weights in
the JAX layout, the global batch, the augmentation draws) and starts
``python -m tests.torch_parallel_worker <dir> <rank> <world>`` once per
rank; the ranks meet through a ``file://`` store in ``<dir>`` and each
writes ``rank<r>.pkl``.  ``... collectives <dir> <rank> <world>`` runs the
helpers of ``parallel.distributed`` and ``parallel.mesh`` instead
(:func:`collectives`, ``tests/test_torch_distributed.py``).  :func:`run_case` is also what the test runs in its
own process, without a process group, for the one-process reference.

Cases (``CASES``): every train-step family at resnet18, 64 px, 7 classes,
float32, on the CPU, one Adam step from the same weights with the
dihedral-only draws that the JAX step makes from its key (``jax``, the rows
of the global batch's draws); the supervised (WEAK) and phase-3 joint
(STRONG) steps with the augmentation drawn from a generator seeded alike
everywhere (``generator``: each rank draws the global batch's draws and
applies its rows'); one train-mode BatchNorm alone (``bn``); two epochs of
``SegmentationTrainer`` (``trainer``).  Rank 0 writes its results whole,
the other ranks crc32 digests of their states and gradients.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import sys
import zlib

import numpy as np
import torch

from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
    create_discriminator,
    create_uda_model,
    create_unet,
    from_jax_state_dict,
    to_jax_state_dict,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.models.domain_model import (
    DomainAdaptationModel,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops import augment
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.batch_norm import BatchNorm
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.losses import FineTuningLoss
from uda_aerial_semantic_segmentation_research_tpu_torch.parallel import distributed as dist
from uda_aerial_semantic_segmentation_research_tpu_torch.training import steps
from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import (
    AdversarialState,
    TrainState,
    adam,
)

CLASSES = 7
LR, LAMBDA, ALPHA, EPOCH = 1e-6, 0.5, 0.7, 20.0
FAMILIES = ("supervised", "adversarial", "grl", "unsupervised", "sequential")
CASES = ([(f, "jax") for f in FAMILIES] + [("supervised", "generator"),
                                          ("unsupervised", "generator"), ("bn", None),
                                          ("trainer", None)])
NO_STAGES = dict(p_ssr=0.0, p_distort=0.0, p_noise=0.0, p_blur=0.0, p_color=0.0, p_hsv=0.0)
DIHEDRAL_F32 = dataclasses.replace(augment.WEAK, compute_dtype="float32", **NO_STAGES)
GENERATOR_SEED = 11
BN_CHANNELS = 8


def _model(kind, flat):
    make = {"seg": lambda: create_unet("resnet18", classes=CLASSES, dtype=torch.float32,
                                       device="cpu"),
            "disc": lambda: create_discriminator(dtype=torch.float32, device="cpu"),
            "uda": lambda: create_uda_model("resnet18", classes=CLASSES, dtype=torch.float32,
                                            device="cpu")}[kind]
    model = make()
    model.load_state_dict(from_jax_state_dict(flat), strict=True)
    return model


def _cfgs(mode):
    """(cfg of the source / target views, cfg of the phase-3 views)."""
    if mode == "jax":
        return DIHEDRAL_F32, DIHEDRAL_F32
    return (dataclasses.replace(augment.WEAK, compute_dtype="float32"),
            dataclasses.replace(augment.STRONG, compute_dtype="float32"))


def rows(batch, rank, world):
    """This rank's rows of every array of ``batch``."""
    out = {}
    for k, v in batch.items():
        b = v.shape[0] // world
        out[k] = v[rank * b:(rank + 1) * b]
    return out


def run_case(case, mode, inputs, batch, draws):
    """One case on ``batch`` (this process's rows) with ``draws`` (its rows'
    draws in the ``jax`` mode; None otherwise).  Returns numpy results:
    ``metrics``, the models' ``state`` and ``grads`` in the JAX layout."""
    w = inputs["weights"]
    if case == "bn":
        return _run_bn(batch)
    if case == "trainer":
        return _run_trainer(inputs, batch)
    view_cfg, strong_cfg = _cfgs(mode)
    generator = torch.Generator().manual_seed(GENERATOR_SEED) if mode == "generator" else None
    if case == "supervised":
        seg = _model("seg", w["seg"])
        state = TrainState(seg, adam(LR))
        step = steps.make_supervised_train_step(seg, CLASSES, aug_cfg=view_cfg)
        abc, params = draws[0] if draws else (None, None)
        _, metrics = step(state, generator, batch["src"], batch["msk"], abc=abc, params=params)
        models = {"seg": seg}
    elif case == "adversarial":
        seg, disc = _model("seg", w["seg"]), _model("disc", w["disc"])
        state = AdversarialState(TrainState(seg, adam(LR)), TrainState(disc, adam(LR)))
        step = steps.make_adversarial_train_step(seg, disc, CLASSES, LAMBDA, aug_cfg=view_cfg)
        _, metrics = step(state, generator, batch["src"], batch["msk"], batch["tgt"],
                          draws=draws)
        models = {"seg": seg, "disc": disc}
    elif case == "grl":
        model = _model("uda", w["uda"])
        step = steps.make_grl_sequential_step(model, CLASSES, lambda_domain=LAMBDA,
                                              aug_cfg=view_cfg)
        _, metrics = step(TrainState(model, adam(LR)), generator, batch["src"], batch["msk"],
                          batch["tgt"], ALPHA, draws=draws)
        models = {"uda": model}
    else:
        seg, disc = _model("seg", w["seg"]), _model("disc", w["disc"])
        state = TrainState(DomainAdaptationModel(seg, disc), adam(LR, clip_norm=1.0),
                           skip_nonfinite=True)
        make = (steps.make_unsupervised_train_step if case == "unsupervised"
                else steps.make_unsupervised_sequential_step)
        step = make(seg, disc, CLASSES, FineTuningLoss(), aug_cfg=strong_cfg)
        _, metrics = step(state, generator, batch["tgt"], EPOCH, draws=draws)
        models = {"seg": seg, "disc": disc}
    return {"metrics": {k: v.detach().numpy() for k, v in metrics.items()},
            "state": {k: to_jax_state_dict(m) for k, m in models.items()},
            "grads": {k: to_jax_state_dict(m, grads=True) for k, m in models.items()}}


def _run_bn(batch):
    """A train-mode BatchNorm alone: y = BN(x), loss = mean(y * weight)
    over this process's rows, backward, gradients averaged."""
    torch.manual_seed(0)
    bn = BatchNorm(BN_CHANNELS, dtype=torch.float32)
    with torch.no_grad():
        bn.scale.copy_(torch.linspace(0.5, 1.5, BN_CHANNELS))
        bn.bias.copy_(torch.linspace(-0.2, 0.3, BN_CHANNELS))
    x = torch.from_numpy(batch["bn_x"]).to(memory_format=torch.channels_last).requires_grad_()
    weight = torch.from_numpy(batch["bn_w"])
    bn.train()
    (bn(x) * weight).mean().backward()
    dist.average_gradients([bn.scale.grad, bn.bias.grad])
    return {"scale_grad": bn.scale.grad.numpy(), "bias_grad": bn.bias.grad.numpy(),
            "x_grad": x.grad.numpy(), "mean": bn.mean.numpy(), "var": bn.var.numpy()}


def _run_trainer(inputs, batch):
    """Two epochs of ``SegmentationTrainer.train`` over this process's rows
    (two batches an epoch) with the whole validation set; events under
    ``<dir>/logs<rank>``."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.train import (
        SegmentationTrainer,
    )

    seg = _model("seg", inputs["weights"]["seg"])
    log_dir = os.path.join(inputs["dir"], f"logs{dist.process_index()}")
    trainer = SegmentationTrainer(seg, device="cpu", log_dir=log_dir)
    half = batch["src"].shape[0] // 2
    train = [(batch["src"][:half], batch["msk"][:half]), (batch["src"][half:],
                                                         batch["msk"][half:])]
    val = [(inputs["batch"]["src"], inputs["batch"]["msk"])]
    trainer.train(train, val, epochs=2, learning_rate=LR)
    return {"engaged": trainer._mesh is not None, "state": to_jax_state_dict(seg),
            "val": trainer.validate(val), "files": sorted(
                os.path.relpath(os.path.join(d, f), log_dir)
                for d, _, files in os.walk(log_dir) for f in files)}


def _digests(result):
    """``result`` with every array of its states and gradients replaced by a
    crc32 of its bytes (the other ranks only need to be compared with rank
    0's bit for bit)."""
    def crc(tree):
        if isinstance(tree, dict):
            return {k: crc(v) for k, v in tree.items()}
        return zlib.crc32(np.ascontiguousarray(tree).tobytes())

    return {k: crc(v) if k in ("state", "grads") else v for k, v in result.items()}


def collectives(out_dir, rank, world):
    """The helpers of ``parallel.distributed`` and ``parallel.mesh`` across
    the ranks (``tests/test_torch_distributed.py``); returns what each
    gave on this rank."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops.metrics import (
        DomainAdaptationMetrics,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.parallel import mesh

    out = {"count": dist.process_count(), "index": dist.process_index(),
           "primary": dist.is_primary(), "local_batch": dist.local_batch_size(8)}
    out["broadcast"] = dist.broadcast_from_primary(
        {"a": np.full(3, rank, np.int64), "b": [float(rank), "x"]})
    rows_ = torch.arange(6, dtype=torch.float32).reshape(3, 2) + 10 * rank
    out["host_rows"] = dist.host_array(rows_)
    out["host_numpy"] = dist.host_array(np.full(2, rank))
    out["gather_bool"] = dist.gather_rows(torch.tensor([rank == 0, True])).numpy()
    out["gather_bf16"] = dist.gather_rows(torch.full((1, 2), rank + 0.5,
                                                     dtype=torch.bfloat16)).float().numpy()
    same = {"w": torch.ones(2, 3), "n": np.arange(4)}
    out["replicated"] = dist.replicate_global(same)["w"].device.type
    try:
        dist.replicate_global({"w": torch.full((2,), float(rank))})
        out["divergence"] = None
    except RuntimeError as e:
        out["divergence"] = str(e)
    dist.barrier()
    m = mesh.default_mesh()
    out["mesh"] = (m.axis_names, m.size, m.rank, str(m.device),
                   mesh.global_batch_size(2, m), mesh.batch_sharding(m).axis,
                   mesh.replicated_sharding(m).is_fully_replicated)
    batch = np.arange(8 * 3).reshape(8, 3)
    out["shard_batch"] = mesh.shard_batch(batch, m).numpy()
    try:
        mesh.shard_batch(np.zeros((3, 2)), m)
        out["shard_error"] = None
    except ValueError as e:
        out["shard_error"] = str(e)
    out["global_batch"] = [t.numpy() for t in dist.global_batch((batch[:2], batch[2:4]), m)]
    metrics = DomainAdaptationMetrics()
    metrics.update(torch.tensor([[0.9], [0.2]]) if rank == 0 else torch.tensor([[0.7], [0.6]]),
                   torch.tensor([[0.1], [0.8]]) if rank == 0 else torch.tensor([[0.3], [0.4]]))
    out["domain_metrics"] = metrics.get_metrics()
    step_metrics = {"loss": torch.tensor(1.0 + rank), "rampup_weight": torch.tensor(0.25),
                    "hist": torch.tensor([[2 + rank, 1], [0, 3]], dtype=torch.int32),
                    "iou": torch.tensor(0.0), "prob": torch.full((2, 1), float(rank))}
    out["reduced"] = {k: v.numpy() for k, v in dist.reduce_metrics(step_metrics).items()}
    x = torch.tensor([1.0 + rank, 2.0], requires_grad=True)
    total = dist.sum_over_ranks(x * x)
    (total * torch.tensor([1.0, 3.0])).sum().backward()
    out["sum_over_ranks"] = (total.detach().numpy(), x.grad.numpy())
    grads = [torch.full((5,), float(rank + 1)), torch.full((3, 2), 2.0 * rank),
             torch.full((4,), 1.0, dtype=torch.float64)]
    dist.all_reduce_.counts.clear()
    dist.GRADIENT_BUCKET_BYTES = 24
    dist.average_gradients(grads)
    out["averaged"] = [g.numpy() for g in grads]
    out["buckets"] = dist.all_reduce_.counts["gradients"]
    return out


def main(argv) -> None:
    if argv[0] == "collectives":
        out_dir, rank, world = argv[1], int(argv[2]), int(argv[3])
        dist.initialize(coordinator_address="file://" + os.path.join(out_dir, "store"),
                        num_processes=world, process_id=rank, device="cpu", timeout=60.0)
        try:
            result = collectives(out_dir, rank, world)
        finally:
            dist.shutdown()
        with open(os.path.join(out_dir, f"collectives{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        return
    out_dir, rank, world = argv[0], int(argv[1]), int(argv[2])
    torch.set_num_threads(2)
    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    inputs["dir"] = out_dir
    dist.initialize(coordinator_address="file://" + os.path.join(out_dir, "store"),
                    num_processes=world, process_id=rank, device="cpu", timeout=120.0)
    try:
        batch = rows(inputs["batch"], rank, world)
        results = {}
        for case, mode in CASES:
            dist.all_reduce_.counts.clear()
            draws = inputs["rank_draws"][rank].get(case) if mode == "jax" else None
            results[(case, mode)] = run_case(case, mode, inputs, batch, draws)
            results[(case, mode)]["collectives"] = dict(dist.all_reduce_.counts)
            if rank:
                results[(case, mode)] = _digests(results[(case, mode)])
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f, protocol=pickle.HIGHEST_PROTOCOL)
    finally:
        dist.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
