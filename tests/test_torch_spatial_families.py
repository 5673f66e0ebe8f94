"""The height-sharded forward (``parallel/spatial.py``) of the other
``create_model`` families and of ``UDASegmentationModel``, against the port's
whole forward and the JAX package's ``spatial_forward`` (CPU, float32, eight
gloo ranks over a (2, 4) mesh).

The module spawns eight ranks once (``tests/torch_spatial_families_worker.py``:
torch and the port only; a ``file://`` store in a temporary directory; each
rank waited on with a timeout and killed after it) and computes its
references while they run.  Cases (``worker.CASES``): the seven families on
resnet18, 7 classes, at 128 px (every level split, the /32 level 1 row a
rank) and at 64 px (the /32 level whole); DeepLabV3Plus at 256 px (the
rate-2 ASPP conv on a 2-row halo, rates 4 and 6 whole) and on mobilenet_v2;
``UDASegmentationModel`` on resnet50 at 64 px, run with its JAX-layout
variables.  Seeded weights, random BatchNorm statistics.

Checks, and their tolerances:

- the blocks, put together by their mesh coordinates, against the port's
  whole forward at rtol / atol 1e-5 (the JAX test's bound,
  ``tests/test_parallel.py::test_spatial_partition_*``);
- against the JAX ``spatial_forward`` over ``spatial_mesh(2, 4)`` on the same
  weights (``to_jax_state_dict``) at 2e-4 (the repo's bound between
  packages);
- the halo, whole-level and mean all-reduces of a forward, calls and bytes,
  against those worked out from the layers of a whole forward (hooks on
  every convolution and the stem's max-pool, and on the families' resizes,
  means and whole-level calls; the rule of ``parallel/spatial.py``'s
  docstring);
- in this process, without a group: the discriminators refused by name, a
  rank's rows mixed with a whole level raising, a tensor on no level
  raising, and the resize from a whole level to a split one against the
  whole resize's rows.
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

from tests import torch_spatial_families_worker as worker
from tests.test_torch_adversarial import few_torch_threads  # noqa: F401  (autouse)
from tests.test_torch_architectures import jax_module
from tests.test_torch_models import jax_variables
from uda_aerial_semantic_segmentation_research_tpu.models.uda import (
    UDASegmentationModel as JaxUDASegmentationModel,
)
from uda_aerial_semantic_segmentation_research_tpu.parallel import spatial as jax_spatial
from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
    architectures,
    create_discriminator,
    to_jax_state_dict,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.models.resnet import Conv2d
from uda_aerial_semantic_segmentation_research_tpu_torch.models.uda import (
    FeatureDomainDiscriminator,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.parallel import spatial

REPO = Path(__file__).resolve().parents[1]
WORLD = 8
MESH = (2, WORLD // 2)
RANK_TIMEOUT_S = 240.0
TOL = 1e-5          # the JAX test's bound, sharded against whole
JAX_TOL = 2e-4      # the repo's bound between the packages
CASES = sorted(worker.CASES)


def _jax_module(case):
    name, encoder, _ = worker.CASES[case]
    if name == "UDA":
        return JaxUDASegmentationModel(encoder_name=encoder, classes=worker.CLASSES,
                                       dtype=jnp.float32)
    return jax_module(name, encoder)


def _references():
    """The port's whole forward and the JAX ``spatial_forward`` over
    ``spatial_mesh(2, 4)`` of every case, on the case's weights."""
    whole, jax_out = {}, {}
    for case in CASES:
        net = worker.model(case)
        x = worker.images(case)
        with torch.inference_mode():
            whole[case] = net(torch.from_numpy(x)).numpy()
        jax_out[case] = np.asarray(jax_spatial.spatial_forward(
            _jax_module(case), jax_variables(to_jax_state_dict(net)), jnp.asarray(x),
            jax_spatial.spatial_mesh(*MESH)))
    return whole, jax_out


@pytest.fixture(scope="module")
def runs():
    """Every rank's results (spawned once; this process computes its
    references meanwhile) and the references.  The ranks and the whole
    forward run PyTorch's own CPU convolution (oneDNN off): oneDNN sums a
    float32 conv in an order that depends on the input's row count, which
    moved FPN's 128 px logits by 2.4e-5 at a largest |logit| of 19; with it
    off the blocks are the whole forward's bit for bit."""
    mkldnn = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield _spawn_and_reference()
    finally:
        torch.backends.mkldnn.enabled = mkldnn


def _spawn_and_reference():
    with tempfile.TemporaryDirectory(prefix="uda_spatial_families_") as d:
        env = {k: v for k, v in os.environ.items() if not k.startswith("UDA_TPU_")}
        env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
        env["OMP_NUM_THREADS"] = "1"
        procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_spatial_families_worker",
                                   d, str(r), str(WORLD)], cwd=REPO, env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(WORLD)]
        outputs = []
        try:
            whole, jax_out = _references()
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


def _assemble(ranks, case):
    """The case's blocks put together by their mesh coordinates."""
    nd, ns = MESH
    block = ranks[0][case]["block"]
    b, h = block.shape[:2]
    out = np.zeros((nd * b, ns * h, *block.shape[2:]), np.float32)
    seen = set()
    for r in ranks:
        d, s = r[case]["coords"]
        seen.add((d, s))
        out[d * b:(d + 1) * b, s * h:(s + 1) * h] = r[case]["block"]
    assert seen == {(d, s) for d in range(nd) for s in range(ns)}
    return out


@pytest.mark.parametrize("case", CASES)
def test_blocks_make_the_whole_forward(runs, case):
    got = _assemble(runs["ranks"], case)
    size = worker.CASES[case][2]
    assert got.shape == runs["whole"][case].shape == (worker.BATCH, size, size, worker.CLASSES)
    np.testing.assert_allclose(got, runs["whole"][case], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", CASES)
def test_blocks_match_the_jax_spatial_forward(runs, case):
    got = _assemble(runs["ranks"], case)
    assert got.shape == runs["jax"][case].shape
    np.testing.assert_allclose(got, runs["jax"][case], rtol=JAX_TOL, atol=JAX_TOL)


# ---------------------------------------------------------------------------
# the exchanges, worked out from the layers of a whole forward
# ---------------------------------------------------------------------------
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
    """``{kind: (calls, bytes)}`` of one rank's forward (float32, the rank's
    batch rows), from a whole forward:

    - a window layer (conv, the stem's max-pool) on a split level exchanges
      the rows its window reads beyond its own, unless it is a stride-2
      layer into a whole level or a window wider than a rank's rows (the
      ASPP's rates), which gather the level (once a tensor);
    - a half-pixel bilinear resize from a split level exchanges one row
      above and one below; a nearest one, or one from a whole level, none;
    - a mean over H and W of a split level is one all-reduce of (B, C)
      float32 sums;
    - ``spatial.whole`` of a split level gathers it (once a tensor), and
      what runs inside exchanges nothing."""
    n_data, n = MESH
    b, size = worker.BATCH // n_data, worker.CASES[case][2]
    net = worker.model(case)
    encoder = net.net.encoder if worker.CASES[case][0] == "UDA" else net.encoder
    split = _plan(size, n, encoder.stem_conv.padding[0])
    counts = {"halo": [0, 0], "level": [0, 0], "mean": [0, 0]}
    gathered, depth = [], [0]

    def level(x):
        return (size // x.shape[3]).bit_length() - 1

    def gather(x):
        if not any(x is g for g in gathered):
            gathered.append(x)
            counts["level"][0] += 1
            counts["level"][1] += b * x[0].numel() * 4

    def halo(x, rows):
        counts["halo"][0] += 1
        counts["halo"][1] += n * b * rows * x.shape[3] * x.shape[1] * 4

    def window(x, kernel, stride, pad, dilation):
        if depth[0] or not split[level(x)]:
            return
        k = level(x)
        above, below = ((pad, dilation * (kernel - 1) - pad) if stride == 1
                        else (pad, max(0, kernel - pad - 2)))
        if (stride == 2 and not split[k + 1]) or max(above, below) > x.shape[2] // n:
            gather(x)
        elif above + below:
            halo(x, above + below)

    def resize(x, h, w, method="nearest"):
        if not depth[0] and split[level(x)] and method != "nearest" and x.shape[2:] != (h, w):
            halo(x, 2)
        return real_resize(x, h, w, method)

    def inside(fn):
        """``fn`` with the exchanges of what it runs not counted."""
        def run(*args):
            depth[0] += 1
            try:
                return fn(*args)
            finally:
                depth[0] -= 1
        return run

    def pooled(fn, x):
        if not depth[0] and split[level(x)]:
            counts["mean"][0] += 1
            counts["mean"][1] += b * x.shape[1] * 4
        return real_pooled(inside(fn), x)

    def whole(fn, x):
        if not depth[0] and split[level(x)]:
            gather(x)
        return real_whole(inside(fn), x)

    hooks = [m.register_forward_pre_hook(
        lambda m, inp: window(inp[0], m.kernel_size[0], m.stride[0], m.padding[0],
                              m.dilation[0]))
        for m in net.modules() if isinstance(m, Conv2d)]
    stem = []
    if worker.CASES[case][1].startswith("resnet"):    # the 3x3/2 max-pool of the stem's output
        hooks.append(encoder.stem_norm.register_forward_hook(
            lambda m, inp, out: stem.append(torch.relu(out))))
    real_resize, real_pooled, real_whole = architectures._resize, spatial.pooled, spatial.whole
    architectures._resize, spatial.pooled, spatial.whole = resize, pooled, whole
    try:
        with torch.inference_mode():
            net(torch.zeros(1, size, size, 3))
    finally:
        architectures._resize, spatial.pooled, spatial.whole = (real_resize, real_pooled,
                                                                real_whole)
        for h in hooks:
            h.remove()
    if stem:
        window(stem[0], 3, 2, 1, 1)
    return {k: tuple(v) for k, v in counts.items() if v[0]}


@pytest.mark.parametrize("case", CASES)
def test_exchanges_match_the_layers(runs, case):
    expected = _expected_exchanges(case)
    for r in runs["ranks"]:
        assert r[case]["collectives"] == expected
    name, _, size = worker.CASES[case]
    if size == 128 and name in ("FPN", "Linknet", "UnetPlusPlus"):
        # every level split, no mean, nothing whole: halos only
        assert set(expected) == {"halo"}


# ---------------------------------------------------------------------------
# one process, no group
# ---------------------------------------------------------------------------
def _shard(size=64, n_space=4, space_index=0):
    mesh = spatial.SpatialMesh(1, n_space, 0, space_index, torch.device("cpu"))
    return spatial.Shard(mesh, size, size, first_halo=3)


@pytest.mark.parametrize("make", [
    lambda: create_discriminator(worker.CLASSES, dtype=torch.float32, device="cpu"),
    lambda: FeatureDomainDiscriminator(64, dtype=torch.float32)],
    ids=["DomainDiscriminator", "FeatureDomainDiscriminator"])
def test_spatial_forward_refuses_the_discriminators(make):
    module = make()
    mesh = spatial.SpatialMesh(1, 2, 0, 0, torch.device("cpu"))
    with pytest.raises(NotImplementedError, match=type(module).__name__):
        spatial.spatial_forward(module, None, np.zeros((2, 32, 32, 3), np.float32), mesh)


def test_a_rank_rows_never_meet_a_whole_level():
    """Under a sharded forward (128 px over 4 ranks: the /32 level 4 rows, 1 a
    rank) a rank's row and the whole level raise where plain broadcasting
    would pass; without one they add."""
    local, whole_level = torch.ones(1, 3, 1, 4), torch.ones(1, 3, 4, 4)
    with spatial._sharded(_shard(128)):
        with pytest.raises(ValueError, match="meet under a sharded forward"):
            architectures._add(local, whole_level)
        with pytest.raises(ValueError, match="meet under a sharded forward"):
            architectures._cat([local, whole_level])
    assert architectures._add(local, whole_level).shape == whole_level.shape


def test_a_tensor_on_no_level_raises():
    """A pooled (B, C, 1, 1) tensor (64 px: no level is 1 wide) or a PSPNet
    bin reaching a conv under the shard raises: it runs whole only through
    ``spatial.pooled`` / ``spatial.whole``."""
    conv = Conv2d(3, 3, 1)
    with spatial._sharded(_shard(64)):
        with pytest.raises(ValueError, match="on no level"):
            conv(torch.ones(1, 3, 1, 1))
        with pytest.raises(ValueError, match="on no level"):
            architectures._resize(torch.ones(1, 3, 3, 3), 2, 2)
        # the /32 level (2 x 2) is whole: its plain mean, the conv unsharded
        pooled = spatial.pooled(conv, torch.ones(1, 3, 2, 2))
    assert pooled.shape == (1, 3, 1, 1)


@pytest.mark.parametrize("method", ["nearest", "bilinear"])
@pytest.mark.parametrize("size,src", [(64, 2), (32, 2), (32, 1)])
def test_resize_from_a_whole_level_is_the_whole_resize(method, size, src):
    """Over 4 ranks, 64 px splits levels 0-4 and keeps the /32 level (2
    rows) whole; 32 px splits levels 0-3 and keeps /16 (2 rows) and /32 (1)
    whole.  Each rank's rows of a resize of a whole level to every split level
    are those rows of the whole resize, bit for bit (no exchange: the window
    is a slice of the whole level)."""
    n = 4
    shard = _shard(size, n)
    x = torch.randn(2, 5, src, src, generator=torch.Generator().manual_seed(size + src))
    targets = [size >> k for k in range(6) if shard.split[k]]
    assert not shard.split[shard.level(x)] and targets
    for target in targets:
        ref = architectures._upsample_to(x, target, target, method)
        for s in range(n):
            with spatial._sharded(_shard(size, n, s)):
                got = architectures._resize(x, target, target, method)
            rows = slice(s * target // n, (s + 1) * target // n)
            torch.testing.assert_close(got, ref[:, :, rows], rtol=0, atol=0)
