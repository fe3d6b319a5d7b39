"""Time the port's kernels at the main path's shapes on the card.

    python3 multi_modal_regression_tpu_torch/tools/time_fused.py [--root DIR]
    python3 multi_modal_regression_tpu_torch/tools/time_fused.py --against DIR

The first form times the four kernels of `ops/fused_conv_bn` (#4 `_mm_stats`,
#5 `_mm_stats_bwd`, #6 `_c3_fwd`, #7 `_c3_bwd`) of the port found under
--root (default: the checkout that holds this file) at every shape that one
fused training step of the `geodesic_bd` preset gives them (two 48-image
streams, `MM_SHAPES` and `C3_SHAPES`), and the two stem kernels of
`ops/stem_pool` (#2 forward, #8 backward, bf16) at theirs (`STEM_SHAPES`:
each stream's (48, 64, 112, 112), and a 64-image request's, which counts
in no step sum), and prints one JSON line: per shape and kernel the
CUDA-event medians `ms` (the events also take in the host's gaps between
launches) and `device_ms` (the card asleep while the host enqueues the
call), and `host_ms`, the host's time for one call; per kernel the step
sums of each (ms x calls per step). It also times the normalize kernel
(#1, `NORMALIZE_SHAPES`: a 64-image request, which counts in no step sum,
in bf16 and f32, and a 96-image training step's batch, one call a step) and
the assign kernel (#3, `ASSIGN_SHAPES`: 2,000,000 poses of 3 and of 4
dimensions against 200 centers). The assign kernel runs in no training
step; its sums are over a dictionary fit instead (`fit_ms`: ms x calls in
one fit_kmeans of chip_smoke.py's [7], 1 x (10 + 1) launches at D = 3).
Inputs come from a seed, the same in every run.

--against DIR compares two checkouts on one card: it runs the first form for
DIR, this checkout, this checkout and DIR, in that order, each in a process
of its own, and prints per shape and per kernel the median of each
checkout's two runs and their ratio. Run it from a machine with one CUDA card
and nvcc; each checkout builds its own kernels under its own build/.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

# (M, K, N, prologue, calls per step) of the 1x1 convolutions, and
# ((B, H, W, C), calls per step) of the stride-1 3x3 convolutions (C -> C,
# with prologue), for a step of two 48-image streams at 224 px
MM_SHAPES = (
    (150528, 64, 64, False, 2), (150528, 64, 256, True, 6), (150528, 64, 256, False, 2),
    (150528, 256, 64, False, 4), (150528, 256, 128, False, 2),
    (37632, 128, 512, True, 8), (37632, 256, 512, False, 2), (37632, 512, 128, False, 6),
    (37632, 512, 256, False, 2),
    (9408, 256, 1024, True, 12), (9408, 512, 1024, False, 2), (9408, 1024, 256, False, 10),
    (9408, 1024, 512, False, 2),
    (2352, 512, 2048, True, 6), (2352, 1024, 2048, False, 2), (2352, 2048, 512, False, 4),
)
C3_SHAPES = (((48, 56, 56, 64), 6), ((48, 28, 28, 128), 6), ((48, 14, 14, 256), 10),
             ((48, 7, 7, 512), 4))
# ((B, C, H, W), calls per training step, kernels) of the stem tail, bf16:
# a training stream's forward and backward, a serving request's forward
STEM_SHAPES = (((48, 64, 112, 112), 2, ("stem_pool", "stem_pool_bwd")),
               ((64, 64, 112, 112), 0, ("stem_pool",)))
# ((B, H, W, 3), output dtype, calls per training step) of the normalize
# kernel: a 64-image request in bf16 and f32, a 96-image step's batch
NORMALIZE_SHAPES = (((64, 224, 224, 3), "bfloat16", 0), ((64, 224, 224, 3), "float32", 0),
                    ((96, 224, 224, 3), "bfloat16", 1))
# ((N, D, K), calls per training step, calls per dictionary fit) of the
# assign kernel: chip_smoke.py [7]'s fit (1 x (10 + 1) launches at D = 3)
ASSIGN_SHAPES = (((2_000_000, 3, 200), 0, 11), ((2_000_000, 4, 200), 0, 0))
REPS = 30
# ~1 ms of device time at the H100's clocks: longer than the host takes to
# enqueue one call of a wrapper
SLEEP_CYCLES = 2_000_000


def cuda_ms(fn, flush: torch.Tensor, reps: int = REPS, held: bool = False) -> float:
    """Median time of fn() in ms between two CUDA events, the 50 MB L2
    flushed before each run. held False: the events also take in the host's
    gaps between fn's launches where the host enqueues them slower than the
    card runs them (chip_smoke.py's `ms`). held True: the card sleeps
    (SLEEP_CYCLES) while the host enqueues fn, so its launches run back to
    back: device time."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        if held:
            torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int = REPS) -> float:
    """Median host time in ms of one call of fn, the card asleep meanwhile so
    that the host never waits for it: what a wrapper costs the host."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(times)


def fused_inputs(x_shape, w_shape, prologue, dev, gen):
    """bf16 activations ~ N(0, 1), lecun-scaled weights, a BN-like affine,
    a small output gradient and stats cotangent."""
    k, n = x_shape[-1], w_shape[0]
    x = torch.randn(x_shape, device=dev, generator=gen).bfloat16()
    fan = 1
    for d in w_shape[1:]:
        fan *= d
    wb = (torch.randn(w_shape, device=dev, generator=gen) * fan**-0.5).bfloat16()
    ab = None
    if prologue:
        ab = torch.stack([torch.rand(k, device=dev, generator=gen) * 1.5 + 0.5,
                          torch.randn(k, device=dev, generator=gen) * 0.3])
    gy = (torch.randn((*x_shape[:-1], n), device=dev, generator=gen) * 0.1).bfloat16()
    gs = torch.randn((2, n), device=dev, generator=gen) * 0.01
    return x, wb, ab, gy, gs


def time_call(fn, flush, reps: int) -> dict:
    """A call's times in ms: `ms` and `device_ms` (cuda_ms with held False
    and True) and `host_ms`."""
    return {"ms": cuda_ms(fn, flush, reps), "device_ms": cuda_ms(fn, flush, reps, held=True),
            "host_ms": host_ms(fn, reps)}


def add_calls(total: dict, name: str, times: dict, calls: int) -> None:
    """Add calls x each of one call's times to total[name]: a kernel that
    takes no call there gets no entry."""
    if calls:
        acc = total.setdefault(name, dict.fromkeys(times, 0.0))
        for key, v in times.items():
            acc[key] += calls * v


def time_all(reps: int) -> dict:
    from multi_modal_regression_tpu_torch.ops import fused_conv_bn as fcb

    dev = torch.device("cuda", 0)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, sums = [], {}
    jobs = [(f"1x1 ({m}, {k} -> {n}){' prologue' if pro else ''}", (m, k), (n, k), pro, calls,
             fcb._mm_stats, fcb._mm_stats_bwd, "mm") for m, k, n, pro, calls in MM_SHAPES]
    jobs += [(f"3x3 {shape} prologue", shape, (shape[-1], shape[-1], 3, 3), True, calls,
              fcb._c3_fwd, fcb._c3_bwd, "c3") for shape, calls in C3_SHAPES]
    for tag, x_shape, w_shape, pro, calls, fwd, bwd, kind in jobs:
        x, wb, ab, gy, gs = fused_inputs(x_shape, w_shape, pro, dev, gen)
        y, _ = fwd(x, wb, ab, pro)
        names = ("mm_stats", "mm_stats_bwd") if kind == "mm" else ("c3_fwd", "c3_bwd")
        row = {"shape": tag, "calls": calls}
        for name, fn in ((names[0], lambda: fwd(x, wb, ab, pro)),
                         (names[1], lambda: bwd(gy, gs, y, x, wb, ab, pro))):
            row[name] = time_call(fn, flush, reps)
            add_calls(sums, name, row[name], calls)
        rows.append(row)
        del x, wb, ab, gy, gs, y
    for shape, calls, names in STEM_SHAPES:
        row = {"shape": f"stem {shape} bf16{'' if calls else ' (a request)'}", "calls": calls}
        for name, fn in zip(names, stem_calls(shape, dev, gen)):
            row[name] = time_call(fn, flush, reps)
            add_calls(sums, name, row[name], calls)
        rows.append(row)
    for shape, dtype, calls in NORMALIZE_SHAPES:
        row = {"shape": f"normalize {shape} {dtype}{'' if calls else ' (a request)'}",
               "calls": calls}
        row["normalize"] = time_call(normalize_call(shape, dtype, dev, gen), flush, reps)
        add_calls(sums, "normalize", row["normalize"], calls)
        rows.append(row)
    fit = {}
    for (n, d, k), calls, fit_calls in ASSIGN_SHAPES:
        row = {"shape": f"assign ({n}, {d}) x {k}", "calls": calls}
        row["assign"] = time_call(assign_call(n, d, k, dev, gen), flush, reps)
        add_calls(sums, "assign", row["assign"], calls)
        add_calls(fit, "assign", row["assign"], fit_calls)
        rows.append(row)
    return {"device": torch.cuda.get_device_name(0), "shapes": rows, "step_ms": sums,
            "fit_ms": fit}


def normalize_call(shape, dtype: str, dev, gen):
    """A call of the normalize kernel on uniform uint8 pixels."""
    from multi_modal_regression_tpu_torch.ops import preprocess

    x = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)
    return lambda: preprocess.normalize_images_cuda(x, getattr(torch, dtype))


def assign_call(n: int, d: int, k: int, dev, gen):
    """A call of the assign kernel on y, centers ~ N(0, 1) float32."""
    from multi_modal_regression_tpu_torch.ops import assign

    y = torch.randn((n, d), device=dev, generator=gen)
    c = torch.randn((k, d), device=dev, generator=gen)
    return lambda: assign.assign_bins(y, c)


def stem_calls(shape, dev, gen):
    """(forward, backward) calls of the stem kernels on bf16 y ~ N(0, 1)
    (channels-last), a BN-like affine and g ~ N(0, 1)."""
    from multi_modal_regression_tpu_torch.ops import stem_pool

    bsz, c, h, w = shape
    cl = torch.channels_last
    y = torch.randn(shape, device=dev, generator=gen).bfloat16().contiguous(memory_format=cl)
    g = torch.randn((bsz, c, h // 2, w // 2), device=dev, generator=gen).bfloat16()
    g = g.contiguous(memory_format=cl)
    a = torch.rand(c, device=dev, generator=gen) * 1.5 + 0.5
    b = torch.randn(c, device=dev, generator=gen) * 0.1
    return (lambda: stem_pool.stem_bn_relu_pool(y, a, b, "kernel"),
            lambda: stem_pool.stem_pool_bwd(g, y, a, b))


def run_one(root: Path, reps: int) -> dict:
    out = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--root", str(root), "--reps",
         str(reps)], capture_output=True, text=True, timeout=1800,
    )
    if out.returncode != 0:
        raise RuntimeError(f"timing {root} failed:\n{out.stdout}\n{out.stderr}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def compare(base: Path, reps: int) -> None:
    here = Path(__file__).resolve().parents[2]
    runs = [run_one(r, reps) for r in (base, here, here, base)]
    old, new = (runs[0], runs[3]), (runs[1], runs[2])

    def med(pair, get):
        return statistics.median(get(r) for r in pair)

    def parts(get_old_new, keys):
        out = []
        for key in keys:
            o, n = (med(pair, lambda r: get_old_new(r)[key]) for pair in (old, new))
            out.append(f"{key} old {o:.4f} new {n:.4f} ({n / o:.3f}x)")
        return ", ".join(out)

    print(f"device: {runs[0]['device']}; {base} (old) against {here} (new), "
          "runs old, new, new, old; ms, device_ms and host_ms per call")
    for i, row in enumerate(runs[0]["shapes"]):
        for name in (k for k in row if k not in ("shape", "calls")):
            line = parts(lambda r: r["shapes"][i][name], row[name])
            print(f"{row['shape']} x{row['calls']} {name}: {line}")
    summary = {}
    for total, what in (("step_ms", "step sum"), ("fit_ms", "fit sum")):
        for name, keys in runs[0][total].items():
            summary[f"{what} {name}"] = {
                key: {side: med(pair, lambda r: r[total][name][key])
                      for side, pair in (("old", old), ("new", new))} for key in keys}
            print(f"{what} {name} (ms x calls): " + parts(lambda r: r[total][name], keys))
    print(json.dumps({"runs": runs, "summary": summary}))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", type=Path, default=None,
                   help="checkout whose port to time (default: this one)")
    p.add_argument("--against", type=Path, default=None,
                   help="another checkout to compare with, run in turns")
    p.add_argument("--reps", type=int, default=REPS)
    args = p.parse_args()
    if args.against is not None:
        compare(args.against.resolve(), args.reps)
        return
    root = (args.root or Path(__file__).resolve().parents[2]).resolve()
    sys.path.insert(0, str(root))
    print(json.dumps(time_all(args.reps)))


if __name__ == "__main__":
    main()
