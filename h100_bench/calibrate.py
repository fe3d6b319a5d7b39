"""Readings that the comparison's limits are set from, for one cell, in one
process on the card:

    python3 h100_bench/calibrate.py --workload <name> --seeds 1 2 ... \\
        --control-seeds 1 2 3

For each of `--seeds`: the program's numbers, from a run of the cell with
no measured window for training (the checked steps are set-up's) and a
one-second window for serving (some tens of requests, of which the run
compares as many as a timed run does). For each of `--control-seeds`: the
control's numbers, the reference computed with fp8 products
(reference/precision.FP8) put in the program's place, and for training the
fault of half the batch left out (the loss's mean over the rest), planted
in the reference. One JSON line a reading, then a summary line: the
largest program reading and the smallest control and fault readings of
each number.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":  # run as a script: the checkout's root, and run.py's caches
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import h100_bench.run  # noqa: F401

import torch

from h100_bench import compare, core, inputs
from h100_bench.drivers import common
from h100_bench.drivers.train import on_device
from h100_bench.reference import bin_delta as ref
from h100_bench.reference.precision import BF16, FLOAT32, FP8, no_tf32

SERVE_SECONDS = 1.0


def _ctx(spec, workload, seed, device):
    _, config, traffic, _ = core.cell_files(spec, workload)
    family = importlib.import_module(f"h100_bench.configs.{config['family']}")
    return core.Context(config, traffic, family, seed, 0.0, False, torch.device(device),
                        time.perf_counter())


def program_reading(spec, workload, seed, device) -> tuple[dict, dict]:
    """The numbers of one run of the cell, and what they were read from."""
    traffic = core.cell_files(spec, workload)[2]
    seconds = SERVE_SECONDS if traffic["driver"] == "serve" else 0.0
    r = core.run_cell(spec, workload, seed, seconds, False, device, time.perf_counter())
    return {k: c["value"] for k, c in r["checks"].items()}, r.get("detail", {})


def control_readings(spec, workload, seed, device) -> dict:
    """{'control': numbers, and for training 'half_batch': numbers}."""
    ctx = _ctx(spec, workload, seed, device)
    c, t, dev = ctx.config, ctx.traffic, ctx.device
    atoms = inputs.draw_atoms(seed, c["dict_size"], dev)
    out = {}
    with no_tf32():
        if t["driver"] == "train":
            rings = [inputs.train_ring(seed, s, t["checked_steps"], t["items_per_batch"],
                                       c["num_classes"], c["image_size"], dev)
                     for s in ("real", "render")]
            batches = [tuple(on_device(r[i], dev) for r in rings)
                       for i in range(t["checked_steps"])]
            W = common.weights(ctx, eval_stats=False)
            lr = c["init_lr"]
            want = ref.train_steps(W, c, batches, atoms, lr, FLOAT32)
            for kind, prec in (("control", FP8), ("bf16_witness", BF16)):
                got = ref.train_steps(W, c, batches, atoms, lr, prec)
                out[kind], out[f"{kind}_detail"] = compare.train_readings(got, want)
                del got
            out["half_batch"] = compare.train_readings(
                ref.train_steps(W, c, batches, atoms, lr, FLOAT32, half_rows=True), want)[0]
        else:
            sizes = t["request_sizes"]
            n = min(t["ring"], t["check_requests"])
            ring = inputs.request_ring(seed, n, lambda i: sizes[i % len(sizes)],
                                       c["num_classes"], c["image_size"], dev)
            W = common.weights(ctx, eval_stats=True)
            rows = []
            for images, labels in ring:
                x, y = torch.as_tensor(images, device=dev), torch.as_tensor(labels, device=dev)
                scores, cands = ref.eval_candidates(W, c, x, y, atoms, FLOAT32)
                s8, c8 = ref.eval_candidates(W, c, x, y, atoms, FP8)
                k = torch.argmax(s8, dim=-1)
                poses = c8[torch.arange(k.shape[0], device=dev), k]
                rows.append((poses, scores, cands))
            out["control"] = compare.serve_numbers(rows)
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = core.load_json(core.ROOT / "BENCHMARK.json")
    if args.device == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    prog, ctl = [], {}
    for seed in args.seeds:
        r, detail = program_reading(spec, args.workload, seed, args.device)
        prog.append(r)
        print(json.dumps({"workload": args.workload, "seed": seed, "program": r,
                          "detail": detail}), flush=True)
        common.free(torch.device(args.device))
    for seed in args.control_seeds:
        r = control_readings(spec, args.workload, seed, args.device)
        for kind, nums in r.items():
            if not kind.endswith("_detail"):
                ctl.setdefault(kind, []).append(nums)
        print(json.dumps({"workload": args.workload, "seed": seed, **r}), flush=True)
        common.free(torch.device(args.device))
    summary = {"workload": args.workload}
    if prog:
        summary["program_max"] = {k: max(r[k] for r in prog) for k in prog[0]}
    for kind, rows in ctl.items():
        summary[f"{kind}_min"] = {k: min(r[k] for r in rows) for k in rows[0]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
