"""One process of the height-sharded forward's tests (``tests/test_torch_spatial.py``).

Imports torch and the port only.  The test writes ``inputs.pkl`` (the JAX
case's weights in the JAX layout) and starts ``python -m
tests.torch_spatial_worker <dir> <rank> <world>`` once per rank; the ranks
meet through a ``file://`` store in ``<dir>``, each runs every case of
:func:`cases` through ``parallel.spatial.spatial_forward`` on the CPU (gloo)
and writes ``rank<r>.pkl``: per case its block of the logits, its mesh
coordinates, the collectives it made by kind and the ``conv_bn_relu`` calls
with the heights they were given; and this rank's rows of the dilated
convs of :func:`run_dilated_convs`.  :func:`model`, :func:`images` and
:func:`dilated_conv` are what the test builds its references from, in its
own process.
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import torch

from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
    create_unet,
    from_jax_state_dict,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.models import unet as unet_module
from uda_aerial_semantic_segmentation_research_tpu_torch.models.resnet import Conv2d
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.batch_norm import BatchNorm
from uda_aerial_semantic_segmentation_research_tpu_torch.parallel import distributed as dist
from uda_aerial_semantic_segmentation_research_tpu_torch.parallel import spatial

CLASSES = 7
SEED = 4
DILATIONS = (2, 5)          # the dilated convs' check; 17 exceeds a rank's 16 rows
DILATED_INPUT = (2, 8, 64, 32)


def cases(world: int) -> dict:
    """name -> case: the encoder, the tile size, the mesh ``(n_data, n_space)``,
    the global batch, the U-Net's options and where the weights come from
    (``"jax"``: the JAX bundle's, handed in as ``variables``; else seeded,
    with random BatchNorm statistics)."""
    space4, space2 = (world // 4, 4), (world // 2, 2)
    base = dict(encoder="resnet18", fused_eval=False, fused_decoder="auto", weights="seed")
    return {
        "jax": {**base, "size": 32, "mesh": space4, "batch": 2, "weights": "jax"},
        "px128": {**base, "size": 128, "mesh": space4, "batch": 2},
        "px32_space2": {**base, "size": 32, "mesh": space2, "batch": space2[0]},
        "dilated": {**base, "size": 128, "mesh": space4, "batch": 2,
                    "fused_decoder": "dilated"},
        "mobilenet": {**base, "encoder": "mobilenet_v2", "size": 64, "mesh": space2,
                      "batch": space2[0]},
        "fused_eval": {**base, "size": 128, "mesh": space4, "batch": 2, "fused_eval": True},
        "fused_eval_px32": {**base, "size": 32, "mesh": space4, "batch": 2,
                            "fused_eval": True},
    }


def images(name: str, case: dict) -> np.ndarray:
    """The case's float32 input (the JAX test's ``default_rng(2)`` for ``jax``)."""
    seed = 2 if name == "jax" else 100 + sorted(cases(4)).index(name)
    size = case["size"]
    return np.random.default_rng(seed).normal(0, 1, (case["batch"], size, size, 3)).astype(
        np.float32)


def model(case: dict, jax_flat=None, fused_decoder=None):
    """The case's U-Net on the CPU in float32 (``fused_decoder`` overrides
    the case's)."""
    net = create_unet(case["encoder"], classes=CLASSES, seed=SEED, dtype=torch.float32,
                      device="cpu", fused_eval=case["fused_eval"],
                      fused_decoder=case["fused_decoder"] if fused_decoder is None
                      else fused_decoder)
    if case["weights"] == "jax":
        net.load_state_dict(from_jax_state_dict(jax_flat), strict=True)
    else:
        gen = torch.Generator().manual_seed(SEED)
        with torch.no_grad():
            for m in net.modules():
                if isinstance(m, BatchNorm):
                    n = m.scale.numel()
                    m.scale.copy_(0.5 + torch.rand(n, generator=gen))
                    m.bias.copy_(0.1 * torch.randn(n, generator=gen))
                    m.mean.copy_(0.1 * torch.randn(n, generator=gen))
                    m.var.copy_(0.5 + torch.rand(n, generator=gen))
    return net


def run_case(name: str, case: dict, jax_flat) -> dict:
    """This rank's block of the case's sharded forward and what it ran."""
    mesh = spatial.spatial_mesh(*case["mesh"])
    if case["weights"] == "jax":    # the module's own weights differ: variables decide
        net, variables = model({**case, "weights": "seed"}), jax_flat
    else:
        net, variables = model(case), None
    calls = []
    real = unet_module.conv_bn_relu

    def counted(x, *args, **kwargs):
        calls.append(x.shape[1])
        return real(x, *args, **kwargs)

    dist.all_reduce_.counts.clear()
    unet_module.conv_bn_relu = counted
    try:
        block = spatial.spatial_forward(net, variables, images(name, case), mesh)
    finally:
        unet_module.conv_bn_relu = real
    gathered = spatial.gather_blocks(block, mesh) if name == "jax" else None
    return {"block": block.numpy(), "coords": (mesh.data_index, mesh.space_index),
            "collectives": {k: v for k, v in dist.all_reduce_.counts.items()
                            if k in ("halo", "level")},
            "kernel_rows": calls,
            "gathered": None if gathered is None else gathered.numpy()}


def dilated_conv(dilation: int):
    """A seeded 3x3 ``Conv2d`` at ``dilation`` (SAME padding) and its seeded
    ``DILATED_INPUT`` (NCHW, channels_last)."""
    gen = torch.Generator().manual_seed(SEED + dilation)
    c = DILATED_INPUT[1]
    conv = Conv2d(c, c, 3, padding=dilation, dilation=dilation, bias=True)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen) / 8)
        conv.bias.copy_(0.1 * torch.randn(c, generator=gen))
    x = torch.randn(DILATED_INPUT, generator=gen)
    return conv, x.contiguous(memory_format=torch.channels_last)


def run_dilated_convs(mesh) -> dict:
    """This rank's rows of each dilated conv of ``DILATIONS`` under a sharded
    forward (level 0 of the input split, 16 rows a rank over 4), and the
    error a dilation wider than a rank's rows raises."""
    b, _, h, w = DILATED_INPUT
    rows_b, rows_h = spatial.spatial_image_sharding(mesh).block((b, h, w, 1))
    out = {"coords": (mesh.data_index, mesh.space_index)}
    with torch.inference_mode(), spatial._sharded(spatial.Shard(mesh, h, w, 1)):
        for d in DILATIONS + (17,):
            conv, x = dilated_conv(d)
            try:
                out[d] = conv(x[rows_b, :, rows_h]).numpy()
            except ValueError as e:
                out[d] = str(e)
    return out


def main(argv) -> None:
    out_dir, rank, world = argv[0], int(argv[1]), int(argv[2])
    torch.set_num_threads(1)
    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
        jax_flat = pickle.load(f)
    dist.initialize(coordinator_address="file://" + os.path.join(out_dir, "store"),
                    num_processes=world, process_id=rank, device="cpu", timeout=120.0)
    try:
        results = {name: run_case(name, case, jax_flat)
                   for name, case in cases(world).items()}
        results["dilated_convs"] = run_dilated_convs(spatial.spatial_mesh(world // 4, 4))
    finally:
        dist.shutdown()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f, protocol=pickle.HIGHEST_PROTOCOL)


if __name__ == "__main__":
    main(sys.argv[1:])
