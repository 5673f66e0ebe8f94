"""What one cell is, read from ``BENCHMARK.json`` and the files it names.

The harness is driven by data: a cell (an entry of ``workloads``) names a
configuration (``configs/<config>.json`` through its ``file``) and a traffic
mix (``traffic/<traffic>.json``); its limits for ``correct`` are
``limits/<workload>.json``.  Code is found by the names those files give,
each a module of its own:

- the mix's ``kind``: ``kinds/<kind>.py``, with its ``Driver`` (set-up,
  window, check) and the ``FAULTS`` the kind can have;
- the configuration's ``builder``: ``builders/<builder>.py``, whose
  ``build(cfg, device)`` makes the program's model;
- the configuration's ``reference``: ``reference/<reference>.py``, the
  plain model (``weight_spec``, ``Net``, ``conv_layers``, ``bn_inputs``);
- each per-layer metric: ``metrics/<metric>.py``, or, where there is none,
  ``metrics/<family>.py`` for the part of the name before its first dot
  (``conv_ms.py`` reads ``conv_ms.train`` and ``conv_ms.serve``).

A cell, a configuration, a mix, a kind, an architecture or a metric is
added by adding files and entries, never by editing one that is there.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, bench: dict, name: str, bench_dir: Path = BENCH_DIR,
                 root: Path = ROOT):
        work = {w["name"]: w for w in bench["workloads"]}
        if name not in work:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"there are {sorted(work)}")
        self.workload = work[name]
        self.name = name
        self.chips = int(self.workload["chips"])
        conf = {c["name"]: c for c in bench["configs"]}[self.workload["config"]]
        self.config = json.loads((root / conf["file"]).read_text())
        self.traffic_name = self.workload["traffic"]
        self.traffic = json.loads(
            (bench_dir / "traffic" / f"{self.traffic_name}.json").read_text())
        limits = bench_dir / "limits" / f"{name}.json"
        self.limits = json.loads(limits.read_text()) if limits.exists() else {}
        self.end_to_end = [m for m in bench["end_to_end"] if _applies(m, bench, name)]
        self.per_layer = [m for m in bench["per_layer"] if _applies(m, bench, name)]
        self.bench_dir = bench_dir
        self.kind = module(bench_dir, "kinds", self.traffic["kind"])
        self.builder = module(bench_dir, "builders", self.config["builder"])
        self.arch = module(bench_dir, "reference", self.config["reference"])

    def reader(self, metric: str):
        """The ``read(trace)`` function of ``metrics/<metric>.py``, or of
        ``metrics/<family>.py`` where the metric has no module of its own."""
        folder = self.bench_dir / "metrics"
        name = metric if (folder / f"{metric}.py").exists() else metric.split(".", 1)[0]
        return module(self.bench_dir, "metrics", name).read


_MODULES: dict = {}


def module(bench_dir: Path, folder: str, name: str):
    """The module of ``<bench_dir>/<folder>/<name>.py``, loaded once."""
    path = (Path(bench_dir) / folder / f"{name}.py").resolve()
    if path not in _MODULES:
        if not path.is_file():
            raise FileNotFoundError(f"no {folder} module {name!r}: {path} is missing")
        spec = importlib.util.spec_from_file_location(f"port_bench.{folder}.{name}", path)
        found = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(found)
        _MODULES[path] = found
    return _MODULES[path]


def _applies(metric: dict, bench: dict, cell: str) -> bool:
    """A metric with ``workloads`` is the listed cells'; a per-layer one
    without it is every cell's that reports the end-to-end metric it moves;
    an end-to-end one without it is every cell's."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        moved = {m["name"]: m for m in bench["end_to_end"]}[metric["moves"]]
        return _applies(moved, bench, cell)
    return True


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())
