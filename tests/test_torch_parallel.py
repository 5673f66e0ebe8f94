"""The port's data parallelism across processes against one process and
against the JAX package's 2-device mesh (CPU, float32, two gloo ranks).

The module spawns two ranks once (``tests/torch_parallel_worker.py``: torch
and the port only; a ``file://`` store in a temporary directory; each rank
waited on with a timeout and killed after it) and computes its references
while they run.  Each rank takes its two rows of a global batch of four and
runs, from the same weights, one Adam step of every train-step family --
supervised, adversarial, GRL (dice: its per-class sums taken over the
ranks), phase 3 joint and sequential -- with the draws that the JAX step
makes from its key (``jax``: the dihedral stage, float32, each rank given
its rows of the global batch's draws); the supervised (WEAK) and phase-3
joint (STRONG) steps again with the augmentation drawn from a generator
seeded alike on both ranks (``generator``: each rank draws the global
batch's draws and applies its rows'); a train-mode BatchNorm alone; and two
epochs of ``SegmentationTrainer``.  Size: resnet18, 64 px, 7 classes.

Checks, and their tolerances:

- the two ranks hold the same parameters, gradients, buffers and global
  metrics, bit for bit, and ran the expected collectives: one forward and
  one backward all-reduce per train-mode BatchNorm, the gradient buckets,
  the metrics;
- two ranks against one process with the whole batch and the same draws:
  the loss scalars within 1e-5 (``tests/test_distributed.py``'s bound;
  1e-6 relative for phase 3's losses of order 1e3), the confusion matrix
  within 0.1% of the pixels (a pixel whose two best logits are within
  float32 noise flips), BatchNorm buffers 1e-5, the parameters by the
  Adam-sign rule of ``tests/test_torch_adversarial.py`` (every entry within
  ``2.5 * lr``, entries whose gradient is at least 10% of their tensor's
  largest within ``0.02 * lr`` plus one ulp), and the averaged, clipped
  gradients within 5e-2 of each tensor's largest (measured: up to 1.9e-2,
  GRL), the noise tensors' (largest below 1e-6 of the network's: a conv
  bias in front of a BatchNorm, exactly zero in exact arithmetic) within
  1e-6 of the network's largest.  That gradient gap is not the all-reduce:
  the global BatchNorm sums of two half-batches differ from one process's
  in the last float32 bit, and at 64 px (2x2 features at the bottom of the
  U-Net, 16 values a channel) the network carries that far; one process
  whose sums kernels add the two halves' sums, as the all-reduce does, is
  within 1e-4 of the ranks (measured: 4e-6), every family
  (``test_two_ranks_are_one_process_with_split_sums``);
- two ranks against the JAX step under a 2-device mesh
  (``create_mesh(jax.devices()[:2])`` + ``shard_batch``, the same global
  batch and bridged weights): the tolerances of the single-process parity
  tests (``tests/test_torch_adversarial.py``: losses 1e-5, buffers 1e-5,
  the Adam-sign rule);
- the BatchNorm alone: the scale and bias gradients, the input gradient
  and the running statistics of one process within 1e-5 (a scale gradient
  taken from the reduced sums would be twice as large);
- ``SegmentationTrainer`` engages its mesh at two processes, both end with
  the same weights and validation metrics, and only rank 0 writes events.

``dryrun_multihost`` (the pipeline across two processes on fixture files)
and the helpers of ``parallel.distributed`` are in
``tests/test_torch_distributed.py``.
"""

import functools
import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax.traverse_util import flatten_dict
from jax.sharding import NamedSharding, PartitionSpec as P

from tests import torch_parallel_worker as worker
from tests.test_torch_adversarial import (  # noqa: F401  (few_torch_threads: autouse)
    JCFG,
    _jax_train_state,
    _weights,
    few_torch_threads,
)
from tests.test_torch_models import jax_variables
from tests.test_torch_uda import _uda_weights
from tests.torch_augment_draws import augment_draws
from uda_aerial_semantic_segmentation_research_tpu.ops.losses import (
    FineTuningLoss as JaxFineTuningLoss,
)
from uda_aerial_semantic_segmentation_research_tpu.parallel import mesh as jax_mesh
from uda_aerial_semantic_segmentation_research_tpu.training import state as jax_state
from uda_aerial_semantic_segmentation_research_tpu.training import steps as jax_steps
from uda_aerial_semantic_segmentation_research_tpu_torch.ops import augment
from uda_aerial_semantic_segmentation_research_tpu_torch.ops import batch_norm
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.batch_norm import BatchNorm

REPO = Path(__file__).resolve().parents[1]
SIZE, CLASSES, BATCH, WORLD, KEY = 64, worker.CLASSES, 4, 2, 5
LR, ULP = worker.LR, 1.2e-7
RANK_TIMEOUT_S = 240.0
LOSSES = {"supervised": ("loss",), "adversarial": ("loss", "seg_loss", "adv_loss", "d_loss"),
          "grl": ("loss", "seg_loss", "domain_loss", "domain_acc"),
          "unsupervised": ("total", "consistency", "domain_confusion"),
          "sequential": ("total", "consistency", "domain_confusion")}
GRAD_TOL = 5e-2
NOISE_FLOOR = 1e-6    # of the network's largest gradient entry: a conv bias in
                      # front of a BatchNorm (exactly zero in exact arithmetic)
                      # sits at 1e-8 to 1e-7 of it
NOISE_TOL = 1e-6      # its entries' difference, of the network's largest


def _global_batch():
    rng = np.random.default_rng(3)
    return {"src": rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8),
            "msk": rng.integers(0, CLASSES, (BATCH, SIZE, SIZE)).astype(np.uint8),
            "tgt": np.clip(rng.integers(0, 256, (BATCH, SIZE, SIZE, 3)) * 0.7 + 40, 0,
                           255).astype(np.uint8),
            "bn_x": rng.normal(0.3, 2.0, (BATCH, worker.BN_CHANNELS, 5, 6)).astype(np.float32),
            "bn_w": rng.normal(0.0, 1.0, (BATCH, worker.BN_CHANNELS, 5, 6)).astype(np.float32)}


def _jax_draws(batch):
    """Per family, the port's form of the draws the JAX step makes at step 0
    from ``KEY`` for the whole batch (``tests/torch_augment_draws.py``)."""
    key = jax.random.fold_in(jax.random.key(KEY), 0)
    k1, k2 = jax.random.split(key)
    u1, u2, _ = jax.random.split(key, 3)
    src, tgt = batch["src"].shape, batch["tgt"].shape
    pair = (augment_draws(k1, src, JCFG, has_masks=True),
            augment_draws(k2, tgt, JCFG, has_masks=False))
    views = (augment_draws(u1, tgt, JCFG, has_masks=False),
             augment_draws(u2, tgt, JCFG, has_masks=False), None)
    return {"supervised": [augment_draws(key, src, JCFG, has_masks=True)],
            "adversarial": pair, "grl": pair, "unsupervised": views, "sequential": views}


def _rows_of(draws, rank):
    b = BATCH // WORLD
    return {case: tuple(None if d is None else augment.rows_of_draws(
        d[0], d[1], BATCH, slice(rank * b, (rank + 1) * b), worker.DIHEDRAL_F32)
        for d in per_case) for case, per_case in draws.items()}


def _inputs():
    _, seg_flat, _, disc_flat = _weights()
    batch = _global_batch()
    draws = _jax_draws(batch)
    return {"weights": {"seg": seg_flat, "disc": disc_flat,
                        "uda": _uda_weights("resnet18", SIZE)[1]},
            "batch": batch, "draws": draws,
            "rank_draws": [_rows_of(draws, r) for r in range(WORLD)]}


def _run_compiled(step, *args):
    """``step(*args)`` as one XLA program compiled without LLVM's
    optimizations (``tests/test_torch_architectures.py``'s ``run_compiled``):
    a third of the compile time, the same float32 arithmetic to rounding."""
    return jax.jit(step).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def _jax_mesh_runs(batch):
    """One step of each JAX family under a 2-device mesh on the global batch:
    ``{family: (metrics, {model: flat state})}``."""
    seg_module, seg_flat, disc_module, disc_flat = _weights()
    uda_module, uda_flat = _uda_weights("resnet18", SIZE)
    mesh = jax_mesh.create_mesh(jax.devices()[:WORLD])
    key = jax.device_put(jax.random.key(KEY), NamedSharding(mesh, P()))

    def sharded(*names):
        return [jax_mesh.shard_batch(batch[n], mesh) for n in names]

    def flat(st):
        return _flat({"params": st.params, "batch_stats": st.batch_stats})

    out = {}
    step = jax_steps.make_supervised_train_step(seg_module, CLASSES, aug_cfg=JCFG)
    st, m = _run_compiled(step, jax_mesh.replicate(_jax_train_state(seg_flat, LR), mesh), key,
                          *sharded("src", "msk"))
    out["supervised"] = m, {"seg": flat(st)}

    step = jax_steps.make_adversarial_train_step(seg_module, disc_module, CLASSES,
                                                 worker.LAMBDA, aug_cfg=JCFG)
    st = jax_state.AdversarialState(seg=_jax_train_state(seg_flat, LR),
                                    disc=_jax_train_state(disc_flat, LR))
    st, m = _run_compiled(step, jax_mesh.replicate(st, mesh), key,
                          *sharded("src", "msk", "tgt"))
    out["adversarial"] = m, {"seg": flat(st.seg), "disc": flat(st.disc)}

    step = jax_steps.make_grl_train_step(uda_module, CLASSES, lambda_domain=worker.LAMBDA,
                                         aug_cfg=JCFG)
    st, m = _run_compiled(step, jax_mesh.replicate(_jax_train_state(uda_flat, LR), mesh), key,
                          *sharded("src", "msk", "tgt"), jnp.float32(worker.ALPHA))
    out["grl"] = m, {"uda": flat(st)}

    step = jax_steps.make_unsupervised_train_step(seg_module, disc_module, CLASSES,
                                                  JaxFineTuningLoss(), aug_cfg=JCFG)
    st, m = _run_compiled(step, jax_mesh.replicate(_jax_unsup_state(seg_flat, disc_flat), mesh),
                          key, *sharded("tgt"), jnp.float32(worker.EPOCH))
    out["unsupervised"] = out["sequential"] = m, _split(flat(st))
    return {k: ({n: np.array(v) for n, v in m.items()}, s) for k, (m, s) in out.items()}


def _split_sums(fn):
    """A sums function that adds the sums of the ranks' row blocks, as the
    all-reduce does, in one process."""
    def split(*ts):
        b = ts[0].shape[0] // WORLD
        parts = [fn(*(t[r * b:(r + 1) * b] for t in ts)) for r in range(WORLD)]
        return tuple(sum(p[i] for p in parts) for i in range(2))
    return split


def _references(inputs):
    """What this process computes while the ranks run: every case on the
    whole batch without a process group (``one``), the families again with
    the BatchNorm sums split as the ranks split them (``split``), and the
    JAX steps under the 2-device mesh (``jax``)."""
    one = {}
    for case, mode in worker.CASES:
        if case != "trainer":
            draws = inputs["draws"].get(case) if mode == "jax" else None
            one[(case, mode)] = worker.run_case(case, mode, inputs, inputs["batch"], draws)
    split = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(batch_norm, "channel_sums", _split_sums(batch_norm.channel_sums))
        mp.setattr(batch_norm, "channel_dual_sums", _split_sums(batch_norm.channel_dual_sums))
        for family in worker.FAMILIES:
            split[family] = worker.run_case(family, "jax", inputs, inputs["batch"],
                                            inputs["draws"][family])
    return {"one": one, "split": split, "jax": _jax_mesh_runs(inputs["batch"])}


@pytest.fixture(scope="module")
def runs():
    """Both ranks' results (spawned once; this process computes its
    references meanwhile), the inputs and the references."""
    inputs = _inputs()
    with tempfile.TemporaryDirectory(prefix="uda_parallel_") as d:
        with open(os.path.join(d, "inputs.pkl"), "wb") as f:
            pickle.dump(inputs, f, protocol=pickle.HIGHEST_PROTOCOL)
        env = {k: v for k, v in os.environ.items() if not k.startswith("UDA_TPU_")}
        env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
        env["OMP_NUM_THREADS"] = "2"
        procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_parallel_worker", d,
                                   str(r), str(WORLD)], cwd=REPO, env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(WORLD)]
        outputs = []
        try:
            refs = _references(inputs)
            for p in procs:
                outputs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, out) in enumerate(zip(procs, outputs)):
            assert p.returncode == 0, f"rank {r} failed (rc={p.returncode}):\n{out[-4000:]}"
        ranks = []
        for r in range(WORLD):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        return {"ranks": ranks, "inputs": inputs, **refs}


def _hold_update(label, ref, got, grads, lr=LR):
    """The Adam-sign rule (module docstring) for every model of a case."""
    for name in ref:
        keys = [k for k in ref[name] if k.startswith("params/")]
        largest = max(np.abs(grads[name][k]).max() for k in keys)
        for k in keys:
            excess = (np.abs(got[name][k] - ref[name][k])
                      - ULP * np.abs(ref[name][k])) / lr
            assert excess.max() <= 2.5, (label, name, k, excess.max())
            g = np.abs(grads[name][k])
            if g.max() >= 1e-6 * largest:
                mask = g >= 0.1 * g.max()
                assert excess[mask].max() <= 0.02, (label, name, k, excess[mask].max())
        for k in ref[name]:
            if k.startswith("batch_stats/"):
                np.testing.assert_allclose(got[name][k], ref[name][k], rtol=1e-5, atol=1e-5,
                                           err_msg=f"{label} {name} {k}")


def _grad_errors(ref, got):
    """Per model of a case: the worst gradient difference of the tensors
    that carry a gradient, over their own largest entry, and that of the
    noise tensors (largest below ``NOISE_FLOOR`` of the network's: a conv
    bias in front of a BatchNorm, exactly zero in exact arithmetic), over
    the network's largest."""
    out = {}
    for name, grads in ref.items():
        largest = max(np.abs(g).max() for g in grads.values())
        real = noise = 0.0
        for k, g in grads.items():
            diff = np.abs(got[name][k] - g).max()
            if np.abs(g).max() >= NOISE_FLOOR * largest:
                real = max(real, diff / np.abs(g).max())
            else:
                noise = max(noise, diff / largest)
        out[name] = real, noise
    return out


@functools.cache
def _bn_count():
    seg = sum(isinstance(m, BatchNorm) for m in worker._model(
        "seg", _weights()[1]).modules())
    disc = sum(isinstance(m, BatchNorm) for m in worker._model(
        "disc", _weights()[3]).modules())
    return seg, disc


# ---------------------------------------------------------------------------
# the ranks against each other
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", worker.CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_ranks_agree_bit_for_bit(runs, case):
    """Rank 1's states and gradients (as digests) are rank 0's, and so are
    its global metrics; the per-row outputs are each rank's own rows."""
    a, b = (r[case] for r in runs["ranks"])
    if case[0] == "bn":
        for k in ("scale_grad", "bias_grad", "mean", "var"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        return
    assert worker._digests(a)["state"] == b["state"]
    if case[0] == "trainer":
        assert a["val"] == b["val"]
        return
    assert worker._digests(a)["grads"] == b["grads"]
    per_row = {"source_domain_prob", "target_domain_prob", "domain_prob"}
    for k, v in a["metrics"].items():
        if k not in per_row:
            np.testing.assert_array_equal(v, b["metrics"][k], err_msg=k)


@pytest.mark.parametrize("family", worker.FAMILIES)
def test_collectives_per_step(runs, family):
    """One forward and one backward BatchNorm all-reduce per train-mode
    BatchNorm input of the step, the gradient buckets, the metrics."""
    n_seg, n_disc = _bn_count()
    counts = runs["ranks"][0][(family, "jax")]["collectives"]
    # (forward, backward): the sequential step's view-1 forward without
    # gradients runs before its two single-view passes
    expected = {"supervised": (n_seg, n_seg),
                "adversarial": (n_seg + 2 * n_disc, n_seg + 2 * n_disc),
                "unsupervised": (2 * n_seg + n_disc, 2 * n_seg + n_disc),
                "sequential": (3 * n_seg + n_disc, 2 * n_seg + n_disc)}
    if family == "grl":
        assert counts["bn_forward"][0] == counts["bn_backward"][0] > n_seg
        assert counts["loss_sums"][0] == 2        # the dice's per-class sums, both ways
    else:
        assert (counts["bn_forward"][0], counts["bn_backward"][0]) == expected[family], counts
    assert counts["gradients"][0] >= 1
    assert counts["metrics"][0] == (1 if family in ("unsupervised", "sequential") else 2)
    assert set(counts) <= {"bn_forward", "bn_backward", "gradients", "metrics", "loss_sums"}


# ---------------------------------------------------------------------------
# two ranks against one process
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", [c for c in worker.CASES if c[0] in worker.FAMILIES],
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_two_ranks_match_one_process(runs, case):
    family = case[0]
    got = runs["ranks"][0][case]
    ref = runs["one"][case]
    for k in LOSSES[family]:
        np.testing.assert_allclose(got["metrics"][k], ref["metrics"][k], rtol=1e-6, atol=1e-5,
                                   err_msg=k)
    if "hist" in ref["metrics"]:
        assert (np.abs(got["metrics"]["hist"] - ref["metrics"]["hist"]).sum()
                <= 1e-3 * BATCH * SIZE * SIZE)
    for name, (real, noise) in _grad_errors(ref["grads"], got["grads"]).items():
        assert real <= GRAD_TOL and noise <= NOISE_TOL, (name, real, noise)
    _hold_update(family, ref["state"], got["state"], ref["grads"])


@pytest.mark.parametrize("family", worker.FAMILIES)
def test_two_ranks_are_one_process_with_split_sums(runs, family):
    """One process whose BatchNorm sums add the two half-batches' sums, as
    the all-reduce does: the ranks' gradients within 1e-4 of each tensor's
    largest."""
    got = runs["ranks"][0][(family, "jax")]
    for name, (real, noise) in _grad_errors(runs["split"][family]["grads"],
                                            got["grads"]).items():
        assert real <= 1e-4 and noise <= NOISE_TOL, (name, real, noise)


def test_batch_norm_gradients_are_not_scaled_by_the_ranks(runs):
    ref = runs["one"][("bn", None)]
    b = BATCH // WORLD
    for r, rank in enumerate(runs["ranks"]):
        got = rank[("bn", None)]
        for k in ("scale_grad", "bias_grad", "mean", "var"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-7, err_msg=k)
        # the input gradient of this rank's rows: the global loss's, N times
        # (each rank's loss is the mean over its own rows)
        np.testing.assert_allclose(got["x_grad"], WORLD * ref["x_grad"][r * b:(r + 1) * b],
                                   rtol=1e-5, atol=1e-7)
        # a scale gradient from the reduced sums would be WORLD times the mean
        assert not np.allclose(got["scale_grad"], WORLD * ref["scale_grad"], rtol=0.1)
    counts = runs["ranks"][0][("bn", None)]["collectives"]
    assert counts["bn_forward"] == (1, 2 * worker.BN_CHANNELS * 4)
    assert counts["bn_backward"] == (1, 2 * worker.BN_CHANNELS * 4)


# ---------------------------------------------------------------------------
# two ranks against the JAX step under a 2-device mesh
# ---------------------------------------------------------------------------
def _flat(tree):
    return {"/".join(k): np.array(v) for k, v in flatten_dict(tree).items()}


def _jax_unsup_state(seg_flat, disc_flat):
    seg, disc = jax_variables(seg_flat), jax_variables(disc_flat)
    params = {"seg": seg["params"], "disc": disc["params"]}
    tx = jax_state.adam(LR, clip_norm=1.0)
    return jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                batch_stats={"seg": seg["batch_stats"],
                                             "disc": disc["batch_stats"]},
                                opt_state=tx.init(params), tx=tx)


def _split(flat):
    out = {"seg": {}, "disc": {}}
    for k, v in flat.items():
        coll, model, rest = k.split("/", 2)
        out[model][f"{coll}/{rest}"] = v
    return out


@pytest.mark.parametrize("family", worker.FAMILIES)
def test_two_ranks_match_the_jax_mesh_step(runs, family):
    jm, jstate = runs["jax"][family]
    got = runs["ranks"][0][(family, "jax")]
    for k in LOSSES[family]:
        np.testing.assert_allclose(got["metrics"][k], jm[k], rtol=1e-5, atol=1e-5, err_msg=k)
    if "hist" in jm:
        assert np.abs(got["metrics"]["hist"] - jm["hist"]).sum() <= 1e-3 * BATCH * SIZE * SIZE
    _hold_update(f"{family} vs JAX", jstate, got["state"], got["grads"])


# ---------------------------------------------------------------------------
# the trainer and the pipeline across processes
# ---------------------------------------------------------------------------
def test_segmentation_trainer_engages_at_two_processes(runs):
    a, b = (r[("trainer", None)] for r in runs["ranks"])
    assert a["engaged"] and b["engaged"]
    assert any(f.startswith("events.out.tfevents") or "/events.out.tfevents" in f
               for f in a["files"])
    assert b["files"] == []                   # only process 0 writes events
