"""``correct`` comes out false with the timed path broken underneath (each
fault that a cell's kind can have, its ``FAULTS``), and for the control
(the reference computed with float8 convolution inputs in the program's
place).  Each cell's own limits, at a tiny size on the CPU: the harness's
look for a card is skipped by calling ``run_cell``."""

import json
import shutil
import time
from pathlib import Path

import pytest

from port_bench import check, spec
from port_bench.run import run_cell
from port_bench.trace import Tracer

ROOT = Path(__file__).resolve().parents[2]
TINY = {"tile": 64, "batch": 4, "ring_tiles": 16}
BENCH = spec.load()
CELLS = [w["name"] for w in BENCH["workloads"]]
CELL_FAULTS = [(name, fault) for name in CELLS for fault in spec.Cell(BENCH, name).kind.FAULTS]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The benchmark's cells at a tiny size, limits as they are."""
    tmp = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "port_bench", tmp / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for f in (tmp / "port_bench" / "traffic").glob("*.json"):
        f.write_text(json.dumps({**json.loads(f.read_text()), **TINY}))
    return lambda name: spec.Cell(BENCH, name, bench_dir=tmp / "port_bench", root=ROOT)


def test_every_cell_has_faults_and_limits():
    assert {name for name, _ in CELL_FAULTS} == set(CELLS)
    for name in CELLS:
        assert spec.Cell(BENCH, name).limits, f"{name} has no limits"


@pytest.mark.parametrize("name, fault", CELL_FAULTS)
def test_a_planted_fault_is_not_correct(tiny, tmp_path, name, fault):
    cell = tiny(name)
    with cell.kind.FAULTS[fault]():
        result = run_cell(cell, 2 ** 31 + 3, 1.0, False, "cpu", time.perf_counter(),
                          str(tmp_path))
    assert result["correct"] is False
    assert any(isinstance(c["value"], str) or not c["value"] <= c["limit"]
               for c in result["checks"].values())


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(tiny, tmp_path, name):
    cell = tiny(name)
    driver = cell.kind.Driver(cell, 2 ** 31 + 9, "cpu", str(tmp_path))
    driver.setup()
    if driver.CHECK_NEEDS_WINDOW:
        driver.window(1.0, Tracer(False, str(tmp_path)))
    driver.free()
    correct, _ = check.judge(driver.check(control=True), cell.limits)
    assert correct is False
