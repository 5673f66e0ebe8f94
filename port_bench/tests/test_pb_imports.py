"""No module that a cell runs loads JAX or the JAX package: each is imported
in a fresh process, and the top-level name of every module in
``sys.modules`` (the part before the first dot) is compared whole, since the
port's name begins with the JAX package's."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "uda_aerial_semantic_segmentation_research_tpu"}

PROBE = """
import importlib.util, json, sys
from pathlib import Path
import port_bench.run, port_bench.drivers, port_bench.calibrate
from port_bench import spec
bench = spec.load()
for w in bench["workloads"]:
    cell = spec.Cell(bench, w["name"])      # loads its kind, builder and reference
    for m in cell.per_layer:
        cell.reader(m["name"])
import uda_aerial_semantic_segmentation_research_tpu_torch.training.train
import uda_aerial_semantic_segmentation_research_tpu_torch.inference.predict
import uda_aerial_semantic_segmentation_research_tpu_torch.data.loader
import uda_aerial_semantic_segmentation_research_tpu_torch.models
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""


def test_no_cell_module_loads_jax():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "uda_aerial_semantic_segmentation_research_tpu_torch" in top
    assert "port_bench" in top
    assert not top & FORBIDDEN, sorted(top & FORBIDDEN)


def test_the_harness_sources_import_neither():
    for path in (ROOT / "port_bench").rglob("*.py"):
        if path.parent.name == "tests":
            continue
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0] not in FORBIDDEN, (path, line)
