"""The port's ``parallel.distributed`` and ``parallel.mesh`` (CPU).

Mirrors ``tests/test_distributed.py``: the pure topology helpers held
against the JAX package's functions over a grid of ``(num_items, count,
index, even)``; ``align_local_batch`` and the replica fingerprint against
the JAX functions on the same arrays; ``initialize`` as a no-op without
configuration and as an error where the backend or device it asks for is
missing; the helpers that communicate (``broadcast_from_primary``,
``host_array``, ``replicate_global``'s divergence check, ``reduce_metrics``,
``sum_over_ranks``, the gradient buckets, the mesh) across two gloo ranks
(``tests/torch_parallel_worker.py collectives``); and ``dryrun_multihost``
in both modes on the CPU: one supervised step across two processes against
the same step in this process (loss 1e-5, every parameter within 2.5
Adam steps: the Adam-sign rule of ``tests/test_torch_parallel.py``, whose
gradients this result does not carry) with the height-sharded forward's
check across them (``spatial_ok``), and the three-phase pipeline on
fixture files.
"""

import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from uda_aerial_semantic_segmentation_research_tpu.parallel import distributed as jax_dist
from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
from uda_aerial_semantic_segmentation_research_tpu_torch.models.convert import (
    to_jax_state_dict,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.parallel import distributed as dist

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
TIMEOUT_S = 240.0


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads (the tier-1 run has six workers on eight cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# pure helpers against the JAX functions
# ---------------------------------------------------------------------------
GRID = [(n, count, index, even) for n, count in [(10, 2), (11, 4), (63, 2), (3, 4), (8, 1),
                                                 (0, 3), (17, 5)]
        for index in range(count) for even in (False, True)]


@pytest.mark.parametrize("num_items,count,index,even", GRID)
def test_process_shard_indices_match_jax(num_items, count, index, even):
    ours = dist.process_shard_indices(num_items, index=index, count=count, even=even)
    assert ours == jax_dist.process_shard_indices(num_items, index=index, count=count,
                                                  even=even)


@pytest.mark.parametrize("count,index", [(2, 0), (2, 1), (3, 2), (1, 0)])
def test_shard_dataset_matches_jax(count, index):
    class DS:
        def __len__(self):
            return 10

    ds = DS()
    ours = dist.shard_dataset(ds, index=index, count=count, even=True)
    theirs = jax_dist.shard_dataset(ds, index=index, count=count, even=True)
    assert (ours is ds) == (theirs is ds)
    if ours is not ds:
        assert ours.indices == theirs.indices


def test_single_process_defaults():
    assert dist.process_count() == 1
    assert dist.process_index() == 0
    assert dist.is_primary()
    assert not dist.is_initialized()
    assert dist.local_batch_size(128) == 128
    vals = np.asarray([1.0, 2.0, 3.0])
    assert dist.broadcast_from_primary(vals) is vals
    assert dist.gather_rows(torch.ones(2)) is not None
    metrics = {"loss": torch.tensor(1.0)}
    assert dist.reduce_metrics(metrics) is metrics
    t = torch.ones(3)
    assert dist.sum_over_ranks(t) is t and dist.all_reduce_(t, "x") is t


def test_local_batch_size_divisibility(monkeypatch):
    monkeypatch.setattr(dist, "process_count", lambda: 3)
    monkeypatch.setattr(jax_dist, "process_count", lambda: 3)
    assert dist.local_batch_size(9) == jax_dist.local_batch_size(9) == 3
    for mod in (dist, jax_dist):
        with pytest.raises(ValueError):
            mod.local_batch_size(7)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_align_local_batch_matches_jax(n):
    rng = np.random.default_rng(n)
    for shapes in [((7, 2), (7,)), ((3, 2), None), ((16,), (5,)), ((5,), (16,)), ((8,), (8,))]:
        arrays = tuple(None if s is None else rng.normal(size=s) for s in shapes)
        ours = dist.align_local_batch(n, arrays)
        theirs = jax_dist.align_local_batch(n, arrays)
        for a, o, t in zip(arrays, ours, theirs):
            if a is None:
                assert o is None and t is None
                continue
            np.testing.assert_array_equal(o, t)
            assert (o is a) == (t is a)


def test_tree_fingerprint_matches_jax_and_detects_divergence():
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": np.zeros(3, np.float32)}
    np.testing.assert_array_equal(dist._tree_fingerprint(tree),
                                  jax_dist._tree_fingerprint(tree))
    same = {"w": tree["w"].copy(), "b": tree["b"].copy()}
    np.testing.assert_array_equal(dist._tree_fingerprint(tree), dist._tree_fingerprint(same))
    diff = {"w": tree["w"].copy(), "b": tree["b"].copy()}
    diff["w"][0, 0] += 1e-3
    assert (dist._tree_fingerprint(tree) != dist._tree_fingerprint(diff)).any()
    recast = {"w": tree["w"].astype(np.float64), "b": tree["b"].copy()}
    assert (dist._tree_fingerprint(tree) != dist._tree_fingerprint(recast)).any()
    # tensors, modules and train states: one digest per leaf, bf16 by its bits
    t = {"w": torch.arange(6, dtype=torch.bfloat16), "m": torch.nn.Linear(2, 3)}
    fp = dist._tree_fingerprint(t)
    assert fp.shape == (3,)
    with torch.no_grad():
        t["m"].weight[0, 0] += 1
    assert (dist._tree_fingerprint(t) != fp).sum() == 1


def test_initialize_is_a_no_op_without_configuration():
    assert dist.initialize(env={}) is False
    assert not dist.is_initialized()
    assert jax_dist.initialize(env={}) is False


def test_initialize_refuses_what_it_cannot_have(tmp_path):
    """A missing backend or device raises; nothing switches to another."""
    store = "file://" + str(tmp_path / "store")
    with pytest.raises(RuntimeError, match="torchrun"):
        dist.initialize(env={"UDA_TPU_MULTIHOST": "1"}, device="cpu")
    with pytest.raises(ValueError, match="NCCL"):
        dist.initialize(store, 1, 0, env={}, device="cpu", backend="nccl")
    with pytest.raises(ValueError):
        dist.initialize(store, 1, 0, env={}, device="cpu", backend="mpi")
    with pytest.raises(ValueError):
        dist.initialize(store, 1, 0, [0], env={}, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            dist.initialize(store, 1, 0, env={}, device="cuda")
    assert not dist.is_initialized()


def test_initialize_reads_the_coordinator_variables(tmp_path):
    """``UDA_TPU_COORDINATOR`` / ``_NUM_PROCESSES`` / ``_PROCESS_ID`` make a
    group of one here; idempotent; the collectives of one process change
    nothing."""
    env = {"UDA_TPU_COORDINATOR": "file://" + str(tmp_path / "store"),
           "UDA_TPU_NUM_PROCESSES": "1", "UDA_TPU_PROCESS_ID": "0"}
    try:
        assert dist.initialize(env=env, device="cpu") is True
        assert dist.initialize(env=env, device="cpu") is True
        assert dist.is_initialized() and dist.process_count() == 1
        assert dist.process_device() == torch.device("cpu")
        t = torch.tensor([1.5, -2.0])
        assert torch.equal(dist.all_reduce_(t.clone(), "x"), t)
        grads = [torch.tensor([0.1, 0.3])]
        dist.average_gradients(grads)
        assert torch.equal(grads[0], torch.tensor([0.1, 0.3]))
    finally:
        dist.shutdown()
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# the helpers that communicate, across two gloo ranks
# ---------------------------------------------------------------------------
def _spawn(args, d):
    env = {k: v for k, v in os.environ.items() if not k.startswith("UDA_TPU_")}
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "2"
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_parallel_worker", *args, d,
                               str(r), str(WORLD)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"rank {r} failed (rc={p.returncode}):\n{out[-4000:]}"


@pytest.fixture(scope="module")
def collectives():
    with tempfile.TemporaryDirectory(prefix="uda_collectives_") as d:
        _spawn(["collectives"], d)
        out = []
        for r in range(WORLD):
            with open(os.path.join(d, f"collectives{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def test_topology_across_two_ranks(collectives):
    for r, out in enumerate(collectives):
        assert (out["count"], out["index"], out["primary"]) == (WORLD, r, r == 0)
        assert out["local_batch"] == 4
        axis, size, rank, device, gbs, split, replicated = out["mesh"]
        assert (axis, size, rank, device) == (("data",), WORLD, r, "cpu")
        assert (gbs, split, replicated) == (4, "data", True)


def test_broadcast_from_primary_across_two_ranks(collectives):
    for out in collectives:
        np.testing.assert_array_equal(out["broadcast"]["a"], np.zeros(3, np.int64))
        assert out["broadcast"]["b"] == [0.0, "x"]


def test_host_array_gathers_rows_across_two_ranks(collectives):
    rows = np.concatenate([np.arange(6, dtype=np.float32).reshape(3, 2) + 10 * r
                           for r in range(WORLD)])
    for r, out in enumerate(collectives):
        np.testing.assert_array_equal(out["host_rows"], rows)
        np.testing.assert_array_equal(out["host_numpy"], np.full(2, r))   # numpy: as it is
        np.testing.assert_array_equal(out["gather_bool"], [True, True, False, True])
        np.testing.assert_array_equal(out["gather_bf16"], [[0.5, 0.5], [1.5, 1.5]])


def test_replicate_global_checks_the_replicas(collectives):
    for out in collectives:
        assert out["replicated"] == "cpu"
        # a divergent tree raises on every rank, not only on the one that differs
        assert out["divergence"] is not None and "differ" in out["divergence"]


def test_mesh_placement_across_two_ranks(collectives):
    batch = np.arange(8 * 3).reshape(8, 3)
    for r, out in enumerate(collectives):
        np.testing.assert_array_equal(out["shard_batch"], batch[4 * r:4 * r + 4])
        assert "not divisible by mesh size 2" in out["shard_error"]
        np.testing.assert_array_equal(out["global_batch"][0], batch[:2])
        np.testing.assert_array_equal(out["global_batch"][1], batch[2:4])


def test_domain_metrics_and_step_metrics_are_global(collectives):
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops.metrics import (
        DomainAdaptationMetrics,
        iou_from_hist,
    )

    whole = DomainAdaptationMetrics()
    whole.update(np.float32([0.9, 0.2, 0.7, 0.6]), np.float32([0.1, 0.8, 0.3, 0.4]))
    hist = torch.tensor([[5, 2], [0, 6]], dtype=torch.int32)
    for r, out in enumerate(collectives):
        assert out["domain_metrics"] == whole.get_metrics()
        red = out["reduced"]
        assert red["loss"] == np.float32(1.5) and red["rampup_weight"] == np.float32(0.25)
        np.testing.assert_array_equal(red["hist"], hist.numpy())
        assert red["iou"] == iou_from_hist(hist)[1].numpy()
        np.testing.assert_array_equal(red["prob"], np.full((2, 1), float(r)))   # per row


def test_sum_over_ranks_and_gradient_buckets(collectives):
    for r, out in enumerate(collectives):
        total, grad = out["sum_over_ranks"]
        np.testing.assert_array_equal(total, [5.0, 8.0])
        np.testing.assert_array_equal(grad, [2.0 * (1 + r) * 2.0, 2.0 * 2.0 * 6.0])
        averaged = out["averaged"]
        np.testing.assert_array_equal(averaged[0], np.full(5, 1.5, np.float32))
        np.testing.assert_array_equal(averaged[1], np.full((3, 2), 1.0, np.float32))
        np.testing.assert_array_equal(averaged[2], np.full(4, 1.0))
        assert out["buckets"] == (3, 20 + 24 + 32)     # 24-byte buckets, one dtype each


# ---------------------------------------------------------------------------
# dryrun_multihost
# ---------------------------------------------------------------------------
def test_dryrun_multihost_step_matches_one_process(tmp_path):
    result = dist.dryrun_multihost(num_processes=WORLD, global_batch_size=8, device="cpu",
                                   out_dir=str(tmp_path), timeout=TIMEOUT_S)
    assert result["spatial_ok"] is True              # the height-sharded forward held
    model, metrics = dist._equivalence_step(8, "cpu")
    assert abs(float(metrics["loss"]) - result["loss"]) < 1e-5
    ref = to_jax_state_dict(model)
    assert set(ref) == set(result["params"])
    lr = 1e-3
    for k, v in ref.items():
        excess = (np.abs(result["params"][k] - v) - 1.2e-7 * np.abs(v)).max() / lr
        assert excess <= 2.5, (k, excess)


def test_dryrun_multihost_pipeline_on_fixtures(tmp_path, monkeypatch):
    from uda_aerial_semantic_segmentation_research_tpu_torch.data.setup_test_data import (
        setup_test_data,
    )

    classes = 7
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(Config, "NUM_CLASSES", classes)
    setup_test_data(num_source=6, num_holyrood=4, image_size=40, force=True)
    for var in ("UDA_TPU_IMAGE_SIZE", "UDA_TPU_ENCODER", "UDA_TPU_BATCH_SIZE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("UDA_TPU_NUM_CLASSES", str(classes))
    result = dist.dryrun_multihost(num_processes=WORLD, mode="pipeline", device="cpu",
                                   out_dir=str(tmp_path / "out"), timeout=TIMEOUT_S)
    assert result == {"final_phase": "FINE_TUNING",
                      "phases": ["adversarial", "fine_tuning", "segmentation"]}
    experiments = [p for p in (tmp_path / "out" / "ckpt").iterdir() if p.is_dir()]
    assert len(experiments) == 1              # process 0's; process 1 creates nothing
    assert (experiments[0] / "training_metadata.json").exists()
    assert sorted(p.name for p in experiments[0].glob("phase*/*.pth")) == ["best_model.pth"] * 3
