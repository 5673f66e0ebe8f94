"""A configuration, a traffic mix, a per-layer metric, a traffic kind (its
driver and faults), a model builder and a reference architecture are added
as new files only: in a temporary copy of the benchmark, each test adds
some of them and their entries in ``BENCHMARK.json``, runs the new cell
once on the CPU at a tiny size, and sees the new pieces in the result while
no file that was there has changed."""

import hashlib
import json
import shutil
import time
from pathlib import Path

import pytest

from port_bench import spec
from port_bench.run import run_cell

ROOT = Path(__file__).resolve().parents[2]

NEW_CONFIG = {"name": "unet_resnet18", "source": "https://github.com/qubvel-org/"
              "segmentation_models.pytorch", "architecture": "Unet",
              "builder": "unet", "reference": "unet", "encoder_name": "resnet18", "encoder_depth": 5, "encoder_weights": None,
              "block": "basic", "stage_sizes": [2, 2, 2, 2], "stem_channels": 64,
              "decoder_channels": [256, 128, 64, 32, 16], "in_channels": 3, "classes": 23,
              "compute_dtype": "bfloat16", "param_dtype": "float32",
              "reduced": ["encoder_weights"], "assumed": {}}
NEW_TRAFFIC = {"kind": "train_epoch", "batch": 2, "tile": 32, "ring_tiles": 8}
NEW_METRIC = '''"""Steps in the traced window."""


def read(t):
    return float(t.steps)
'''


def digests(root: Path) -> dict:
    files = [root / "BENCHMARK.json", *(root / "port_bench").rglob("*")]
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in files if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture()
def copy(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_new_files_make_a_new_cell(copy, tmp_path):
    before = digests(copy)
    bench_dir = copy / "port_bench"
    (bench_dir / "configs" / "unet_resnet18.json").write_text(json.dumps(NEW_CONFIG))
    (bench_dir / "traffic" / "tiny_train.json").write_text(json.dumps(NEW_TRAFFIC))
    (bench_dir / "metrics" / "steps_seen.train.py").write_text(NEW_METRIC)
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "unet_resnet18", "source": NEW_CONFIG["source"],
                             "file": "port_bench/configs/unet_resnet18.json",
                             "reduced": ["encoder_weights"], "why": "a test"})
    bench["workloads"].append({"name": "unet18.tiny", "config": "unet_resnet18",
                               "traffic": "tiny_train", "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("unet18.tiny")
    bench["per_layer"].append({"name": "steps_seen.train", "unit": "steps",
                               "better": "higher", "source": "program_counter",
                               "layer": "trainers (training/train.py)",
                               "moves": "train_tiles_per_s", "workloads": ["unet18.tiny"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.Cell(bench, "unet18.tiny", bench_dir=bench_dir, root=copy)
    assert cell.config["encoder_name"] == "resnet18"
    assert cell.traffic == NEW_TRAFFIC
    assert [m["name"] for m in cell.per_layer] == ["steps_seen.train"]
    (tmp_path / "run").mkdir()
    result = run_cell(cell, 2 ** 31 + 5, 1.0, True, "cpu", time.perf_counter(),
                      str(tmp_path / "run"))
    assert result["metrics"]["steps_seen.train"]["value"] == result["attempted"] > 0

    after = digests(copy)
    changed = [p for p in before if p != "BENCHMARK.json" and after[p] != before[p]]
    assert changed == []
    assert set(after) - set(before) == {"port_bench/configs/unet_resnet18.json",
                                        "port_bench/traffic/tiny_train.json",
                                        "port_bench/metrics/steps_seen.train.py"}


NEW_KIND = '''"""predict_batch, marked: a kind of its own for the test."""

from port_bench.kinds import predict_batch


class Driver(predict_batch.Driver):
    def setup(self):
        super().setup()
        self.result["info"]["kind_file"] = __file__


FAULTS = predict_batch.FAULTS
'''
NEW_BUILDER = '''"""create_unet by another name (a test)."""

CALLS = []


def build(cfg, device):
    from uda_aerial_semantic_segmentation_research_tpu_torch.models import create_unet

    CALLS.append(cfg["name"])
    return create_unet(encoder_name=cfg["encoder_name"], in_channels=cfg["in_channels"],
                       classes=cfg["classes"], device=device)
'''
NEW_REFERENCE = '''"""The U-Net reference by another name (a test)."""

from port_bench.reference.unet import Net, bn_inputs, conv_layers, weight_spec  # noqa: F401

CALLS = []


def Net(cfg, p, **kw):  # noqa: F811
    CALLS.append(cfg["name"])
    from port_bench.reference.unet import UNet

    return UNet(cfg, p, **kw)
'''


def test_a_new_kind_builder_and_reference_are_files(copy, tmp_path):
    before = digests(copy)
    bench_dir = copy / "port_bench"
    cfg = dict(NEW_CONFIG, name="unet_resnet18_plain", builder="unet_plain",
               reference="unet_plain")
    (bench_dir / "configs" / "unet_resnet18_plain.json").write_text(json.dumps(cfg))
    (bench_dir / "traffic" / "tiny_serve.json").write_text(json.dumps(
        {"kind": "predict_batch_marked", "batch": 2, "tile": 32, "ring_tiles": 4,
         "warmup_requests": 1}))
    (bench_dir / "kinds" / "predict_batch_marked.py").write_text(NEW_KIND)
    (bench_dir / "builders" / "unet_plain.py").write_text(NEW_BUILDER)
    (bench_dir / "reference" / "unet_plain.py").write_text(NEW_REFERENCE)
    (bench_dir / "limits" / "unet18.serve.tiny.json").write_text(json.dumps({"label_gap": 1.1}))
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "unet_resnet18_plain", "source": NEW_CONFIG["source"],
                             "file": "port_bench/configs/unet_resnet18_plain.json",
                             "reduced": ["encoder_weights"], "why": "a test"})
    bench["workloads"].append({"name": "unet18.serve.tiny", "config": "unet_resnet18_plain",
                               "traffic": "tiny_serve", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "unet34.serve.b32" in m.get("workloads", []):
            m["workloads"].append("unet18.serve.tiny")
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.Cell(bench, "unet18.serve.tiny", bench_dir=bench_dir, root=copy)
    assert set(cell.kind.FAULTS) == {"altered_labels"}
    (tmp_path / "run").mkdir()
    result = run_cell(cell, 2 ** 31 + 7, 1.0, True, "cpu", time.perf_counter(),
                      str(tmp_path / "run"))
    assert result["info"]["kind_file"] == str(bench_dir / "kinds" / "predict_batch_marked.py")
    assert cell.builder.CALLS == ["unet_resnet18_plain"]
    assert cell.arch.CALLS and set(cell.arch.CALLS) == {"unet_resnet18_plain"}
    assert set(result["checks"]) == {"label_gap"} and result["attempted"] > 0
    # the family reader serves the new cell's per-layer metrics
    assert {"conv_ms.serve", "mfu.serve", "device_idle_pct.serve"} <= set(result["metrics"])

    after = digests(copy)
    assert [p for p in before if p != "BENCHMARK.json" and after[p] != before[p]] == []
    assert set(after) - set(before) == {
        f"port_bench/{f}" for f in ("configs/unet_resnet18_plain.json",
                                    "traffic/tiny_serve.json", "kinds/predict_batch_marked.py",
                                    "builders/unet_plain.py", "reference/unet_plain.py",
                                    "limits/unet18.serve.tiny.json")}
