"""Readings that the limits of ``correct`` are set from, on many seeds in
one process (no measured window where the kind's check reads set-up; a
short one where it reads a window), each judged by ``check.judge`` against
the cell's committed limits.

    python3 -m port_bench.calibrate --workload <name> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--fault-seeds 4,5,6]

For every seed the program's numbers (a sound run); for each control seed
the numbers of the control (the reference computed with float8 convolution
inputs, in the program's place); for each fault seed the numbers of each
fault the cell's kind can have (its ``FAULTS``), planted in the program.
One JSON line a reading on standard output, with its verdict
(``correct``), then one line that counts the verdicts of each reading.
On the card only, as ``run``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import sys
import tempfile

from port_bench import check, spec
from port_bench.trace import Tracer

WINDOW_S = 3.0      # a reading's window, where the kind's check judges a window


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def readings(cell, seed: int, tmpdir: str, control: bool, planted) -> list:
    """``[(what, numbers)]`` of one seed: the program's, then the
    control's and each planted fault's."""

    def run(fault=None):
        driver = cell.kind.Driver(cell, seed, "cuda", tmpdir)
        with cell.kind.FAULTS[fault]() if fault else contextlib.nullcontext():
            driver.setup()
            if driver.CHECK_NEEDS_WINDOW:
                driver.window(WINDOW_S, Tracer(False, tmpdir))
        driver.free()
        return driver

    shared = {}
    sound = run()
    out = [("program", sound.check(shared=shared))]
    if control:
        out.append(("control", sound.check(control=True, shared=shared)))
    for name in planted:
        out.append((name, run(name).check(shared=shared)))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--fault-seeds", default="")
    args = parser.parse_args(argv)
    cell = spec.Cell(spec.load(), args.workload)
    control_seeds, fault_seeds = set(_seeds(args.control_seeds)), set(_seeds(args.fault_seeds))
    seeds = list(dict.fromkeys(_seeds(args.seeds) + sorted(control_seeds | fault_seeds)))
    verdicts = {}
    for seed in seeds:
        tmpdir = tempfile.mkdtemp(prefix="port_bench-")
        try:
            for what, numbers in readings(cell, seed, tmpdir, seed in control_seeds,
                                          cell.kind.FAULTS if seed in fault_seeds else ()):
                correct, _ = check.judge(numbers, cell.limits)
                verdicts.setdefault(what, []).append(correct)
                print(json.dumps({"workload": args.workload, "seed": seed, "what": what,
                                  "correct": correct, **numbers}), flush=True)
        finally:
            shutil.rmtree(tmpdir, ignore_errors=True)
    print(json.dumps({"workload": args.workload, "limits": cell.limits, "correct_of": {
        what: f"{sum(v)}/{len(v)}" for what, v in verdicts.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
