"""The port's height-sharded forward (``parallel/spatial.py``) against the
JAX package's ``spatial_forward`` and against the port's whole forward (CPU,
float32, eight gloo ranks).

The module spawns eight ranks once (``tests/torch_spatial_worker.py``: torch
and the port only; a ``file://`` store in a temporary directory; each rank
waited on with a timeout and killed after it) and computes its references
while they run.  Each rank runs every case of ``worker.cases`` through
``spatial_forward`` and returns its block, the exchanges it made and the
``conv_bn_relu`` calls.  Cases: the resnet18 U-Net (7 classes) at 32 px with
the JAX bundle's weights over a (2, 4) mesh (the JAX test's), at 128 px over
4 space ranks (every level split), at 32 px over 2 (whole levels), a
``"dilated"`` module (the naive-decoder rule), ``fused_eval=True`` at 128
and 32 px (the kernel's plain version on rows with the neighbours' rows
attached), and the mobilenet_v2 U-Net at 64 px over 2.

Checks, and their tolerances:

- the blocks, put together by their mesh coordinates, against the port's
  whole forward at rtol / atol 1e-5 (the JAX test's bound;
  ``tests/test_parallel.py::test_spatial_partition_*``); a ``"dilated"``
  module against the naive one's whole forward;
- against the JAX ``spatial_forward`` at 2e-4 (the repo's bound between
  packages): the JAX case's blocks over ``spatial_mesh(2, 4)`` (and rank 0's
  ``gather_blocks`` against the blocks bit for bit), and on the seeded
  weights (``to_jax_state_dict``) the 128 px case over (2, 4), every level
  split with the stem's 3 / 2 halo, and the mobilenet_v2 U-Net over (4, 2),
  its depthwise stride-2 halos;
- the halo and whole-level all-reduces of a forward, calls and bytes,
  against those worked out from the layers of a whole forward (hooks on
  every convolution; the rule of the module docstring);
- ``fused_eval``: two ``conv_bn_relu`` calls a forward on every rank, each
  on its rows plus one attached row a neighbour (one at the edge ranks);
- a 3x3 ``Conv2d`` at dilation 2 and 5 on the ranks' rows (16 a rank) put
  together against the whole conv at 1e-5, and a dilation of 17 raising on
  every rank (a neighbour holds fewer rows than its halo);
- in this process, without a group: the errors (a bad mesh, a height the
  space axis does not divide, ``train=True``, a discriminator), the 1x1
  mesh's forward bit for bit the module's, every submodule's train / eval
  mode set back after a forward, the level plan, and
  ``Unet.clone(fused_decoder=False)``.
"""

import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from tests import torch_spatial_worker as worker
from tests.test_torch_adversarial import few_torch_threads  # noqa: F401  (autouse)
from tests.test_torch_models import jax_variables
from uda_aerial_semantic_segmentation_research_tpu.models.unet import Unet as JaxUnet
from uda_aerial_semantic_segmentation_research_tpu.parallel import spatial as jax_spatial
from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
    create_discriminator,
    to_jax_state_dict,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.models.resnet import Conv2d
from uda_aerial_semantic_segmentation_research_tpu_torch.parallel import spatial

REPO = Path(__file__).resolve().parents[1]
WORLD = 8
RANK_TIMEOUT_S = 240.0
TOL = 1e-5          # the JAX test's bound, sharded against whole
JAX_TOL = 2e-4      # the repo's bound between the packages
CASES = worker.cases(WORLD)
SEEDED_JAX_CASES = ("px128", "mobilenet")   # also run by the JAX spatial_forward


def _jax_flat(bundle):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(bundle.variables).items()}


def _references(jax_flat, bundle):
    """The port's whole forward of every case (naive decoder), and the JAX
    ``spatial_forward`` over the case's mesh of the JAX case (the bundle's
    module and weights) and of ``SEEDED_JAX_CASES`` (a JAX U-Net on the
    port's seeded weights)."""
    whole = {}
    for name, case in CASES.items():
        net = worker.model(case, jax_flat, fused_decoder=False)
        with torch.inference_mode():
            whole[name] = net(torch.from_numpy(worker.images(name, case))).numpy()
    jax_runs = {"jax": (bundle.module, bundle.variables)}
    for name in SEEDED_JAX_CASES:
        case = CASES[name]
        jax_runs[name] = (JaxUnet(encoder_name=case["encoder"], classes=worker.CLASSES,
                                  dtype=jnp.float32),
                          jax_variables(to_jax_state_dict(worker.model(case))))
    jax_out = {}
    for name, (module, variables) in jax_runs.items():
        x = jnp.asarray(worker.images(name, CASES[name]))
        jax_out[name] = np.asarray(jax_spatial.spatial_forward(
            module, variables, x, jax_spatial.spatial_mesh(*CASES[name]["mesh"])))
    return whole, jax_out


@pytest.fixture(scope="module")
def runs(seg_bundle):
    """Every rank's results (spawned once; this process computes its
    references meanwhile) and the references."""
    jax_flat = _jax_flat(seg_bundle)
    with tempfile.TemporaryDirectory(prefix="uda_spatial_") as d:
        with open(os.path.join(d, "inputs.pkl"), "wb") as f:
            pickle.dump(jax_flat, f, protocol=pickle.HIGHEST_PROTOCOL)
        env = {k: v for k, v in os.environ.items() if not k.startswith("UDA_TPU_")}
        env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
        env["OMP_NUM_THREADS"] = "1"
        procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_spatial_worker", d,
                                   str(r), str(WORLD)], cwd=REPO, env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(WORLD)]
        outputs = []
        try:
            whole, jax_out = _references(jax_flat, seg_bundle)
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
    return {"ranks": ranks, "whole": whole, "jax": jax_out}


def _assemble(ranks, name):
    """The case's blocks put together by their mesh coordinates."""
    case = CASES[name]
    nd, ns = case["mesh"]
    b, h = ranks[0][name]["block"].shape[:2]
    out = np.zeros((nd * b, ns * h, *ranks[0][name]["block"].shape[2:]), np.float32)
    seen = set()
    for r in ranks:
        d, s = r[name]["coords"]
        seen.add((d, s))
        out[d * b:(d + 1) * b, s * h:(s + 1) * h] = r[name]["block"]
    assert seen == {(d, s) for d in range(nd) for s in range(ns)}
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_blocks_make_the_whole_forward(runs, name):
    got = _assemble(runs["ranks"], name)
    assert got.shape == runs["whole"][name].shape
    np.testing.assert_allclose(got, runs["whole"][name], rtol=TOL, atol=TOL)


def test_blocks_match_the_jax_spatial_forward(runs):
    got = _assemble(runs["ranks"], "jax")
    np.testing.assert_allclose(got, runs["jax"]["jax"], rtol=JAX_TOL, atol=JAX_TOL)
    np.testing.assert_array_equal(runs["ranks"][0]["jax"]["gathered"], got)


@pytest.mark.parametrize("name", SEEDED_JAX_CASES)
def test_seeded_blocks_match_the_jax_spatial_forward(runs, name):
    got = _assemble(runs["ranks"], name)
    assert got.shape == runs["jax"][name].shape
    np.testing.assert_allclose(got, runs["jax"][name], rtol=JAX_TOL, atol=JAX_TOL)


def _plan(size, n, first_halo):
    """Level ``k`` split: ``n`` divides its rows, a rank holds the rows its
    readers fetch, and the level above it is split."""
    split = []
    for k in range(6):
        rows = size >> k
        split.append(rows % n == 0 and rows // n >= (first_halo if k == 0 else 1)
                     and (k == 0 or split[-1]))
    return split


def _expected_exchanges(case):
    """``{"halo": (calls, bytes), "level": (calls, bytes)}`` of one rank's
    forward, from the window layers of a whole forward (float32, the rank's
    batch rows): a layer reading a split level exchanges the rows its window
    reads beyond its own, unless it is a stride-2 layer into a whole level,
    which gathers its input (once per tensor)."""
    nd, n = case["mesh"]
    b, size = case["batch"] // nd, case["size"]
    net = worker.model({**case, "fused_eval": False, "weights": "seed"}, fused_decoder=False)
    split = _plan(size, n, net.encoder.stem_conv.padding[0])
    counts = {"halo": [0, 0], "level": [0, 0]}
    gathered = []

    def read(x, kernel, stride, pad):
        _, c, h, w = x.shape
        k = (size // w).bit_length() - 1
        if not split[k]:
            return
        if stride == 2 and not split[k + 1]:
            if not any(x is g for g in gathered):
                gathered.append(x)
                counts["level"][0] += 1
                counts["level"][1] += b * h * w * c * 4
            return
        rows = kernel - 1 if stride == 1 else pad + max(0, kernel - pad - 2)
        if rows:
            counts["halo"][0] += 1
            counts["halo"][1] += n * b * rows * w * c * 4

    hooks = [m.register_forward_pre_hook(
        lambda m, inp: read(inp[0], m.kernel_size[0], m.stride[0], m.padding[0]))
        for m in net.modules() if isinstance(m, Conv2d)]
    stem = []
    if case["encoder"].startswith("resnet"):      # the 3x3/2 max-pool reads the stem's output
        hooks.append(net.encoder.stem_norm.register_forward_hook(
            lambda m, inp, out: stem.append(out)))
    with torch.inference_mode():
        net(torch.zeros(1, size, size, 3))
    for h in hooks:
        h.remove()
    if stem:
        read(torch.relu(stem[0]), 3, 2, 1)
    return {k: tuple(v) for k, v in counts.items() if v[0]}


@pytest.mark.parametrize("name", sorted(CASES))
def test_exchanges_match_the_layers(runs, name):
    expected = _expected_exchanges(CASES[name])
    for r in runs["ranks"]:
        assert r[name]["collectives"] == expected
    if name == "px128":     # every level split: one exchange a 3x3 conv, the stem, the pool
        convs = sum(isinstance(m, Conv2d) and m.kernel_size[0] > 1
                    for m in worker.model(CASES[name]).modules())
        assert expected == {"halo": (convs + 1, expected["halo"][1])}


@pytest.mark.parametrize("name", ["fused_eval", "fused_eval_px32"])
def test_conv_bn_relu_gets_its_rows_and_the_neighbours(runs, name):
    case = CASES[name]
    n = case["mesh"][1]
    for r in runs["ranks"]:
        s = r[name]["coords"][1]
        attached = (s > 0) + (s < n - 1)
        # decoder blocks 3 and 4: levels 1 and 0
        assert r[name]["kernel_rows"] == [case["size"] // 2 // n + attached,
                                          case["size"] // n + attached]
    for r in runs["ranks"]:
        assert r["px128"]["kernel_rows"] == []


@pytest.mark.parametrize("dilation", worker.DILATIONS)
def test_dilated_conv_makes_the_whole_conv(runs, dilation):
    """Each rank's rows of a dilated conv (``dilation`` rows of halo above and
    below), put together, are the whole conv's."""
    b, c, h, w = worker.DILATED_INPUT
    n_data, n_space = WORLD // 4, 4
    got = np.zeros((b, c, h, w), np.float32)
    for r in runs["ranks"]:
        d, s = r["dilated_convs"]["coords"]
        rows = (slice(d * b // n_data, (d + 1) * b // n_data),
                slice(None), slice(s * h // n_space, (s + 1) * h // n_space))
        got[rows] = r["dilated_convs"][dilation]
    conv, x = worker.dilated_conv(dilation)
    with torch.inference_mode():
        ref = conv(x).numpy()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_dilated_conv_beyond_a_rank_rows_raises(runs):
    for r in runs["ranks"]:
        assert "halo rows from neighbours of 16 rows" in r["dilated_convs"][17]


# ---------------------------------------------------------------------------
# one process, no group
# ---------------------------------------------------------------------------
def _cpu_mesh(n_data=1, n_space=1, space_index=0):
    return spatial.SpatialMesh(n_data, n_space, 0, space_index, torch.device("cpu"))


def test_spatial_mesh_needs_one_process_a_device():
    with pytest.raises(ValueError, match="needs 8 devices, have 1"):
        spatial.spatial_mesh(2, 4)
    with pytest.raises(ValueError, match="each process drives one device"):
        spatial.spatial_mesh(1, 2, devices=["cpu", "cpu"])
    mesh = spatial.spatial_mesh(1, 1, devices=["cpu"])
    assert mesh.axis_names == ("data", "space") and mesh.shape == {"data": 1, "space": 1}
    assert mesh.device == torch.device("cpu") and mesh.space_group is None
    sharding = spatial.spatial_image_sharding(mesh)
    assert sharding.spec == ("data", "space")
    assert sharding.block((2, 32, 16, 3)) == (slice(0, 2), slice(0, 32))


def test_sharding_block():
    sharding = spatial.spatial_image_sharding(spatial.SpatialMesh(
        2, 4, 1, 2, torch.device("cpu")))
    assert sharding.block((4, 32, 32, 3)) == (slice(2, 4), slice(16, 24))
    with pytest.raises(ValueError, match="not divisible by the data axis"):
        sharding.block((3, 32, 32, 3))


def test_spatial_forward_refuses_what_it_cannot_run():
    net = worker.model(CASES["px128"])
    x = np.zeros((2, 30, 32, 3), np.float32)
    with pytest.raises(ValueError, match="eval forward only"):
        spatial.spatial_forward(net, None, x, _cpu_mesh(1, 4), train=True)
    with pytest.raises(ValueError, match="height 30 not divisible by the space axis"):
        spatial.spatial_forward(net, None, x, _cpu_mesh(1, 4))
    disc = create_discriminator(worker.CLASSES, dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match="DomainDiscriminator"):
        spatial.spatial_forward(disc, None, np.zeros((2, 32, 32, 3), np.float32),
                                _cpu_mesh(1, 2))


def test_one_device_mesh_is_the_plain_forward():
    case = CASES["px128"]
    net = worker.model(case)
    x = worker.images("px128", case)
    with torch.inference_mode():
        ref = net(torch.from_numpy(x))
    mesh = spatial.spatial_mesh(1, 1, devices=["cpu"])
    out = spatial.spatial_forward(net, None, x, mesh)
    assert out.dtype == torch.float32 and out.device == torch.device("cpu")
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert spatial.gather_blocks(out, mesh) is out


def test_forward_sets_every_mode_back():
    """A module in train mode (a submodule in eval mode within it) comes back
    in the modes it had, and its forward is the eval forward."""
    case = CASES["px128"]
    net = worker.model(case)
    x = worker.images("px128", case)
    with torch.inference_mode():
        ref = net(torch.from_numpy(x))
    net.train()
    net.encoder.eval()
    modes = {name: m.training for name, m in net.named_modules()}
    out = spatial.spatial_forward(net, None, x, spatial.spatial_mesh(1, 1, devices=["cpu"]))
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert {name: m.training for name, m in net.named_modules()} == modes
    assert net.training and not net.encoder.training and net.decoder.training
    dilated = worker.model({**case, "fused_decoder": "dilated"}).train()
    spatial.spatial_forward(dilated, None, x, _cpu_mesh())
    assert all(m.training for m in dilated.modules())


@pytest.mark.parametrize("size,n,split", [
    (32, 4, [True] * 4 + [False] * 2), (32, 2, [True] * 5 + [False]),
    (128, 4, [True] * 6), (96, 3, [True] * 6), (32, 16, [False] * 6),
    (64, 8, [True] * 4 + [False] * 2)])
def test_level_plan(size, n, split):
    shard = spatial.Shard(_cpu_mesh(1, n), size, size, first_halo=3)
    assert shard.split == split
    assert shard.heights == [-(-size // 2 ** k) for k in range(6)]


def test_clone_to_the_naive_decoder_shares_the_weights():
    case = {**CASES["px128"], "fused_decoder": "dilated"}
    dilated = worker.model(case)
    naive = worker.model(case, fused_decoder=False)
    clone = dilated.clone(fused_decoder=False)
    x = torch.from_numpy(worker.images("px128", case))
    with torch.inference_mode():
        torch.testing.assert_close(clone(x), naive(x), rtol=0, atol=0)
        before = dilated(x)
    assert dilated.fused_decoder == "dilated" and dilated.decoder.fused == "dilated"
    assert clone.fused_decoder is False and clone.decoder.fused is False
    assert clone.decoder.block0.conv1.weight is dilated.decoder.block0.conv1.weight
    with torch.inference_mode():
        torch.testing.assert_close(dilated(x), before, rtol=0, atol=0)
        assert not torch.equal(before, naive(x))       # the schedules round differently
