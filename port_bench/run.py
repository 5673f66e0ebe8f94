"""Run one cell of the port's benchmark once and print its result line.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration and a traffic mix; the mix's ``kind`` names the
driver (``kinds/<kind>.py``).  A run makes its inputs and weights from
``--seed``, sets up and warms every shape it uses (``setup_s``), measures
for ``--seconds``, then frees the program's state and judges what the
timed path produced against the plain reference (``correct``).  With
``--trace 1`` the window is traced and the per-layer metrics are printed
instead of the end-to-end ones.

The last line of standard output is one JSON object; the numbers compared
and their limits are the last lines of standard error.  It exits with 3,
and prints no result, without the CUDA cards the cell asks for, and with 4
if the JAX package or JAX was imported.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "uda_aerial_semantic_segmentation_research_tpu")


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is forbidden."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, tmpdir: str) -> dict:
    """Set up, measure and judge ``cell`` once; the result's fields."""
    import torch

    from port_bench import check
    from port_bench.trace import Tracer

    driver = cell.kind.Driver(cell, seed, device, tmpdir)
    driver.setup_parts["start"] = driver._mark - t_start
    driver.setup()
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    driver.result["info"]["setup_parts"] = driver.setup_parts
    tracer = Tracer(trace, tmpdir)
    driver.window(seconds, tracer)
    info = driver.result["info"]
    metrics = {}
    if trace:
        read_start = time.perf_counter()
        t = tracer.read(info)
        for m in cell.per_layer:
            value = cell.reader(m["name"])(t)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        busy = {"busy_s": t.busy_s, "window_s": t.window_s}
        breakdown = t.breakdown()
        info["trace_export_s"] = tracer.export_s
        info["trace_read_s"] = time.perf_counter() - read_start
    else:
        measured = dict(driver.result["metrics"], setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": measured[m["name"]], "unit": m["unit"]}
        busy, breakdown = {}, None
    driver.free()
    numbers = driver.check()
    correct, checks = check.judge(numbers, cell.limits)
    if driver.result["failed"]:
        correct = False
    result = {"correct": correct, "attempted": driver.result["attempted"],
              "failed": driver.result["failed"], "metrics": metrics,
              "device": {"platform": "gpu" if device.startswith("cuda") else device,
                         "kind": (torch.cuda.get_device_name(0) if device.startswith("cuda")
                                  else device),
                         "count": cell.chips,
                         "memory_peak_bytes": info["memory_peak_bytes"], **busy}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["info"] = {k: v for k, v in info.items() if k != "memory_peak_bytes"}
    result["checks"] = {k: {"value": _plain(c["value"]), "limit": c["limit"]}
                        for k, c in checks.items()}
    return result


def _plain(x):
    """A number for the JSON line: non-finite values as strings."""
    return x if math.isfinite(x) else str(x)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from port_bench import spec

    cell = spec.Cell(spec.load(), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"port_bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    tmpdir = tempfile.mkdtemp(prefix="port_bench-")
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                          T_START, tmpdir)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    result["device"]["card"] = power_limit()
    found = forbidden_modules()
    if found:
        print(f"port_bench: forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        value = c["value"]
        ok = (c["limit"] is not None and not isinstance(value, str)
              and value <= c["limit"])
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {'ok' if ok else 'FAIL'}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
