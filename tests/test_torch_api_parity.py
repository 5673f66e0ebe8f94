"""The port's public signatures and exports against the JAX package's.

- ``create_model``, ``DataLoader`` and ``tile_image`` take the JAX
  package's arguments in the JAX positions (``image_size``, ``pin_memory``,
  ``pad_value``): the JAX calls, made positionally and by keyword, give the
  JAX functions' results (the same batches, tiles and origins; for
  ``create_model`` the same parameter tree, and the seed where JAX has it);
- every package whose JAX counterpart has an ``__all__`` exports the same
  names, less those ``ROADMAP.md`` lists as not ported (``ModelBundle``,
  ``AsyncPytreeCheckpointer``, ``pallas_ops``).
"""

import importlib
import importlib.util
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
from flax.traverse_util import flatten_dict

from uda_aerial_semantic_segmentation_research_tpu.data import loader as jax_loader
from uda_aerial_semantic_segmentation_research_tpu.data import tiling as jax_tiling
from uda_aerial_semantic_segmentation_research_tpu.models import (
    create_model as jax_create_model,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.data import loader, tiling
from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
    create_model,
    to_jax_state_dict,
)

JAX = "uda_aerial_semantic_segmentation_research_tpu"
PORT = f"{JAX}_torch"
NOT_PORTED = {"ModelBundle", "AsyncPytreeCheckpointer", "pallas_ops"}
PACKAGES = ["", "training", "inference", "data", "utils", "visualization", "models", "ops",
            "analysis", "parallel"]


def test_create_model_takes_image_size_in_the_jax_position():
    """``create_model("Unet", "resnet18", None, 3, 5, 64)``: 64 is the image
    size in both packages, not the seed."""
    theirs = jax_create_model("Unet", "resnet18", None, 3, 5, 64, dtype=jnp.float32)
    tree = {"/".join(k): v.shape for k, v in flatten_dict(theirs.variables).items()}
    seeded = create_model("Unet", "resnet18", None, 3, 5, seed=0, device="cpu")
    for ours in (create_model("Unet", "resnet18", None, 3, 5, 64, device="cpu"),
                 create_model("Unet", "resnet18", None, 3, 5, image_size=64, device="cpu")):
        flat = to_jax_state_dict(ours)
        assert {k: v.shape for k, v in flat.items()} == tree
        assert ours.classes == 5
        for k, v in to_jax_state_dict(seeded).items():
            np.testing.assert_array_equal(flat[k], v, err_msg=k)
    other = to_jax_state_dict(create_model("Unet", "resnet18", None, 3, 5, 64, 1, device="cpu"))
    assert not np.array_equal(other["params/segmentation_head/kernel"],
                              to_jax_state_dict(seeded)["params/segmentation_head/kernel"])


class _Items:
    def __init__(self, n):
        self.x = np.arange(n * 6, dtype=np.float32).reshape(n, 2, 3)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], np.int64(i)


@pytest.mark.parametrize("num_workers", [0, 1])
def test_data_loader_takes_pin_memory_in_the_jax_position(num_workers):
    """``DataLoader(ds, 3, True, None, False, workers, True, seed)``: the 7th
    argument is ``pin_memory`` (accepted, ignored), the 8th the seed."""
    ds = _Items(10)
    theirs = list(jax_loader.DataLoader(ds, 3, True, None, False, num_workers, True, 7))
    for ours in (loader.DataLoader(ds, 3, True, None, False, num_workers, True, 7),
                 loader.DataLoader(ds, batch_size=3, shuffle=True, num_workers=num_workers,
                                   pin_memory=True, seed=7)):
        batches = list(ours)
        assert len(batches) == len(theirs) == 4
        for (x, i), (jx, ji) in zip(batches, theirs):
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(i, ji)


@pytest.mark.parametrize("shape", [(100, 150, 3), (40, 50), (20, 90, 3)])
def test_tile_image_takes_pad_value_as_jax(shape):
    """``tile_image(image, tile, overlap, pad_value)``, positionally and by
    keyword: the JAX tiles, origins and padded size (edge padding)."""
    image = np.random.default_rng(len(shape)).integers(0, 256, shape).astype(np.uint8)
    theirs = jax_tiling.tile_image(image, 64, 16, 7)
    for ours in (tiling.tile_image(image, 64, 16, 7),
                 tiling.tile_image(image, 64, overlap=16, pad_value=7)):
        np.testing.assert_array_equal(ours[0], theirs[0])
        assert ours[1] == theirs[1] and ours[2] == theirs[2]


@pytest.mark.parametrize("package", PACKAGES)
def test_package_exports_the_jax_names(package):
    theirs = importlib.import_module(f"{JAX}.{package}".rstrip("."))
    ours = importlib.import_module(f"{PORT}.{package}".rstrip("."))
    wanted = set(theirs.__all__) - NOT_PORTED
    assert wanted <= set(ours.__all__), sorted(wanted - set(ours.__all__))
    for name in ours.__all__:
        value = getattr(ours, name)
        if isinstance(value, types.ModuleType) or callable(value):
            home = value.__name__ if isinstance(value, types.ModuleType) else value.__module__
            assert home.startswith(PORT), (name, home)


def test_run_pipeline_export_calls_the_pipeline(monkeypatch):
    """``training.run_pipeline`` imports the pipeline on its first call and
    hands every argument through."""
    from uda_aerial_semantic_segmentation_research_tpu_torch import training
    from uda_aerial_semantic_segmentation_research_tpu_torch.training import pipeline

    seen = []
    monkeypatch.setattr(pipeline, "run_pipeline", lambda *a, **k: seen.append((a, k)) or "ok")
    assert training.run_pipeline(1, 2, phase3_epochs=3) == "ok"
    assert seen == [((1, 2), {"phase3_epochs": 3})]


def test_every_jax_package_with_an_all_is_covered():
    """The JAX packages that declare ``__all__`` are those above, and the
    port has each of them."""
    root = Path(importlib.import_module(JAX).__file__).parent
    declared = {str(f.parent.relative_to(root)).replace(".", "") for f in root.rglob(
        "__init__.py") if "__all__" in f.read_text()}
    assert declared == set(PACKAGES)
    for package in PACKAGES:
        assert importlib.util.find_spec(f"{PORT}.{package}".rstrip(".")) is not None
