"""The harness: one run of one cell, driven by `BENCHMARK.json`.

    python3 h100_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's entry names its configuration (`configs/<config>.json`, whose
`family` names the module that builds the port's config and counts the
model's FLOPs) and its traffic (`traffic/<traffic>.json`, whose `driver`
names the general generator in `drivers/` that reads it). Each metric is
read by `metrics/<metric>.py`; the limits of the comparison are in
`limits/<cell>.json`. Adding a cell or a metric adds files and entries and
edits none.

Set-up runs from process start to the window's start; the window then
measures for `--seconds`; after it, the peak memory is read, the
program's state is freed and the plain reference is run for the
comparison. The last line of standard output is the result, one JSON
object; the numbers compared and their limits are also the last lines of
standard error.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "multi_modal_regression_tpu")


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell's files, the run's arguments."""
    config: dict
    traffic: dict
    family: object  # configs/<family>.py
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float  # process start, perf_counter


@dataclasses.dataclass
class Run:
    """What a driver returns, and what the metric readers read."""
    kind: str  # 'train' | 'serve'
    setup_s: float
    window_s: float
    attempted: int  # steps or requests begun in the window
    failed: int
    images: int  # images of the completed steps or requests
    latencies_s: list  # per completed request (serve)
    memory_peak_bytes: int
    numbers: dict  # the comparison's numbers, by name
    flops_per_unit: float  # model FLOPs of one step or request
    kernel_calls: list  # (kernel, dims) of one step or request
    trace: object = None  # trace.Trace of the card's activity in the first traced sub-window
    host_trace: object = None  # trace.Trace of the second, with the host's operations
    detail: dict = dataclasses.field(default_factory=dict)  # what the numbers were read from


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(spec: dict, workload: str) -> tuple[dict, dict, dict, dict]:
    """(cell, config, traffic, limits) of a workload of BENCHMARK.json."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    config = next(c for c in spec["configs"] if c["name"] == cell["config"])
    return (cell, load_json(ROOT / config["file"]),
            load_json(BENCH / "traffic" / f"{cell['traffic']}.json"),
            load_json(BENCH / "limits" / f"{workload}.json"))


def cell_metrics(spec: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with trace its per-layer ones (each
    per-layer metric lists its cells)."""
    if not trace:
        return [m for m in spec["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    return [m for m in spec["per_layer"] if cell in m["workloads"]]


def read_metrics(metrics: list[dict], run: Run) -> dict:
    out = {}
    for m in metrics:
        reader = load_module(BENCH / "metrics" / f"{m['name']}.py",
                             f"h100_bench.metrics.{m['name'].replace('.', '_')}")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(spec: dict, workload: str, seed: int, seconds: float, trace: bool,
             device, t0: float) -> dict:
    """One run of a cell on `device`; the result line's object. The look
    for a card is the caller's (`main`)."""
    cell, config, traffic, limits = cell_files(spec, workload)
    family = importlib.import_module(f"h100_bench.configs.{config['family']}")
    driver = importlib.import_module(f"h100_bench.drivers.{traffic['driver']}")
    ctx = Context(config, traffic, family, seed, seconds, trace, torch.device(device), t0)
    run = driver.run(ctx)
    checks = {k: {"value": run.numbers[k], "limit": limits[k]} for k in limits}
    correct = (run.failed == 0 and run.attempted > 0
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in checks.values()))
    dev = torch.device(device)
    result = {
        "correct": bool(correct), "attempted": run.attempted, "failed": run.failed,
        "metrics": read_metrics(cell_metrics(spec, workload, trace), run),
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": cell["chips"], "memory_peak_bytes": run.memory_peak_bytes,
        },
    }
    if trace and run.trace is not None:
        busy_us, window_us = run.trace.busy_window_us()
        result["device"].update(busy_s=busy_us * 1e-6, window_s=window_us * 1e-6)
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": (run.host_trace or run.trace).idle_gaps()}
    if run.detail:
        result["detail"] = run.detail
    result["checks"] = checks
    return result


def loaded_forbidden() -> list[str]:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def main(argv: list[str], t0: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_json(ROOT / "BENCHMARK.json")
    cell = cell_files(spec, args.workload)[0]
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {cell['chips']} CUDA device(s); this machine has {n}", file=sys.stderr)
        return 2
    result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                      "cuda", t0)
    found = loaded_forbidden()
    if found:
        print(f"modules loaded that the benchmark must not load: {found}", file=sys.stderr)
        return 3
    for name, d in result.pop("detail", {}).items():
        print(f"detail {name} {d}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
