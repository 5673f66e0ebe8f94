"""One process of the families' height-sharded forward tests
(``tests/test_torch_spatial_families.py``).

Imports torch and the port only.  The test starts ``python -m
tests.torch_spatial_families_worker <dir> <rank> <world>`` once per rank;
the ranks meet through a ``file://`` store in ``<dir>``, each runs every
case of :data:`CASES` through ``parallel.spatial.spatial_forward`` on the
CPU (gloo) over a ``(2, world // 2)`` mesh and writes ``rank<r>.pkl``: per
case its block of the logits, its mesh coordinates and the collectives it
made by kind.  :func:`model` and :func:`images` are what the test builds its
references from, in its own process.
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import torch

from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
    create_model,
    create_uda_model,
    to_jax_state_dict,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.batch_norm import BatchNorm
from uda_aerial_semantic_segmentation_research_tpu_torch.parallel import distributed as dist
from uda_aerial_semantic_segmentation_research_tpu_torch.parallel import spatial

CLASSES = 7
SEED = 5
BATCH = 2
FAMILIES = ("FPN", "PSPNet", "Linknet", "UnetPlusPlus", "DeepLabV3Plus", "PAN", "MAnet")
# name -> (create_model name, or "UDA" for create_uda_model; encoder; tile px).
# 128 px over 4 space ranks: every level split, the /32 level 1 row a rank;
# 64 px: the /32 level whole; DeepLabV3Plus at 256 px: the /32 level 2 rows
# a rank, so the rate-2 ASPP conv takes a halo and rates 4 and 6 run whole.
CASES = {
    **{f"{f}_128": (f, "resnet18", 128) for f in FAMILIES},
    **{f"{f}_64": (f, "resnet18", 64) for f in FAMILIES},
    "DeepLabV3Plus_256": ("DeepLabV3Plus", "resnet18", 256),
    "DeepLabV3Plus_mobilenet_128": ("DeepLabV3Plus", "mobilenet_v2", 128),
    "UDA_64": ("UDA", "resnet50", 64),
}
VARIABLES_CASES = ("UDA_64",)   # run with the JAX-layout variables, not the module's own


def model(case: str, seed: int = SEED):
    """The case's model on the CPU in float32, eval mode, seeded weights and
    random BatchNorm statistics."""
    name, encoder, _ = CASES[case]
    if name == "UDA":
        net = create_uda_model(encoder, classes=CLASSES, seed=seed, dtype=torch.float32,
                               device="cpu")
    else:
        net = create_model(name, encoder, None, 3, CLASSES, seed=seed, dtype=torch.float32,
                           device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BatchNorm):
                n = m.scale.numel()
                m.scale.copy_(0.5 + torch.rand(n, generator=gen))
                m.bias.copy_(0.1 * torch.randn(n, generator=gen))
                m.mean.copy_(0.1 * torch.randn(n, generator=gen))
                m.var.copy_(0.5 + torch.rand(n, generator=gen))
    return net


def images(case: str) -> np.ndarray:
    """The case's float32 input."""
    size = CASES[case][2]
    rng = np.random.default_rng(200 + sorted(CASES).index(case))
    return rng.normal(0, 1, (BATCH, size, size, 3)).astype(np.float32)


def run_case(case: str, mesh) -> dict:
    """This rank's block of the case's sharded forward and what it ran."""
    if case in VARIABLES_CASES:     # the module's own weights differ: variables decide
        net, variables = model(case, SEED + 1), to_jax_state_dict(model(case))
    else:
        net, variables = model(case), None
    dist.all_reduce_.counts.clear()
    block = spatial.spatial_forward(net, variables, images(case), mesh)
    return {"block": block.numpy(), "coords": (mesh.data_index, mesh.space_index),
            "collectives": dict(dist.all_reduce_.counts)}


def main(argv) -> None:
    out_dir, rank, world = argv[0], int(argv[1]), int(argv[2])
    torch.set_num_threads(1)
    torch.backends.mkldnn.enabled = False       # see tests/test_torch_spatial_families.py
    dist.initialize(coordinator_address="file://" + os.path.join(out_dir, "store"),
                    num_processes=world, process_id=rank, device="cpu", timeout=120.0)
    try:
        mesh = spatial.spatial_mesh(2, world // 2)
        results = {case: run_case(case, mesh) for case in CASES}
    finally:
        dist.shutdown()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f, protocol=pickle.HIGHEST_PROTOCOL)


if __name__ == "__main__":
    main(sys.argv[1:])
