"""The port's ImageNet converter (``models/pretrained.py``) against the JAX
package's (CPU).

- ``convert_torch_resnet`` equals the JAX ``convert_torch_resnet`` key for
  key and bit for bit at resnet18, resnet34 and resnet50, on the seeded
  torchvision-layout trunks of ``tests/torch_resnet_ref.py`` (non-trivial
  BatchNorm statistics); no weights are downloaded;
- the port's command line (``python -m ...models.pretrained``, the
  arguments of ``tools/convert_imagenet.py``) writes the ``.npz`` that
  ``create_unet(..., encoder_weights="imagenet")`` loads through
  ``load_imagenet_encoder``, and the port's encoder then gives the
  reference trunk's feature pyramid within 1e-5 of each level's largest
  value (float32 on both sides, the port's channels_last convolutions and
  folded BatchNorm against ``nn.Conv2d`` and ``nn.BatchNorm2d``).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_adversarial import few_torch_threads  # noqa: F401  (autouse)
from tests.torch_resnet_ref import random_torch_encoder
from uda_aerial_semantic_segmentation_research_tpu.models import pretrained as jax_pretrained
from uda_aerial_semantic_segmentation_research_tpu_torch.models import create_unet, pretrained

ROOT = Path(__file__).resolve().parents[1]
MODULE = "uda_aerial_semantic_segmentation_research_tpu_torch.models.pretrained"


@pytest.mark.parametrize("name", ["resnet18", "resnet34", "resnet50"])
def test_convert_torch_resnet_is_the_jax_conversion(name):
    sd = random_torch_encoder(name, seed=7).state_dict()
    theirs = jax_pretrained.convert_torch_resnet(sd, name)
    ours = pretrained.convert_torch_resnet(sd, name)
    assert list(ours) == list(theirs)
    for k, v in theirs.items():
        assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
        np.testing.assert_array_equal(ours[k], v, err_msg=k)


def test_convert_torch_resnet_refuses_a_non_resnet():
    with pytest.raises(ValueError, match="ResNets"):
        pretrained.convert_torch_resnet({}, "mobilenet_v2")


def test_cli_file_loads_into_the_port_and_gives_the_reference_pyramid(tmp_path, monkeypatch):
    name = "resnet18"
    trunk = random_torch_encoder(name, seed=11)
    weights = tmp_path / "resnet18-weights.pth"
    # a training checkpoint's layout: the state dict under "state_dict",
    # keys behind a DataParallel prefix
    torch.save({"state_dict": {f"module.{k}": v for k, v in trunk.state_dict().items()}},
               weights)
    out_dir = tmp_path / "converted"
    run = subprocess.run([sys.executable, "-m", MODULE, name, str(weights), "--out-dir",
                          str(out_dir)], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert f"{name}_imagenet.npz" in run.stdout
    with np.load(out_dir / f"{name}_imagenet.npz") as blob:
        written = {k: blob[k] for k in blob.files}
    expected = jax_pretrained.convert_torch_resnet(trunk.state_dict(), name)
    assert set(written) == set(expected)
    for k, v in expected.items():
        np.testing.assert_array_equal(written[k], v, err_msg=k)

    monkeypatch.setenv("UDA_TPU_PRETRAINED", str(out_dir))
    monkeypatch.delenv("UDA_TPU_IMAGENET_NPZ", raising=False)
    model = create_unet(name, encoder_weights="imagenet", classes=5, dtype=torch.float32,
                        device="cpu")
    x = np.random.default_rng(1).normal(size=(2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        ours = model.encode(torch.from_numpy(x))
    theirs = trunk(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(ours) == len(theirs) == 6
    for level, (a, b) in enumerate(zip(ours, theirs)):
        assert a.shape == b.shape, (level, a.shape, b.shape)
        scale = b.abs().max().item()
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5 * scale,
                                   err_msg=f"pyramid level {level}")
