"""What both drivers share: the seeded model, and the device's clock-keeping."""

from __future__ import annotations

import gc
import resource
import time

import torch

from h100_bench import inputs
from h100_bench.reference import bin_delta as ref


def seeded_trainer(ctx, eval_stats: bool):
    """The port's Trainer of the cell's configuration (as `cli train` and
    `cli predict` build it), its weights, BN statistics and dictionary
    replaced by the benchmark's, drawn from the seed on the device. Returns
    (trainer, atoms)."""
    from multi_modal_regression_tpu_torch.train.trainer import Trainer

    c = ctx.config
    cfg = ctx.family.port_config(c, ctx.traffic, ctx.seed)
    atoms = inputs.draw_atoms(ctx.seed, c["dict_size"], ctx.device)
    trainer = Trainer(cfg, dictionary=atoms.cpu().numpy(), device=ctx.device)
    load_weights(trainer.model, weights(ctx, eval_stats))
    return trainer, atoms


def weights(ctx, eval_stats: bool) -> dict:
    """The cell's weights from the seed; with the traffic's `bin_margin`,
    one bin of each bin head raised by it (inputs.raise_bins)."""
    W = inputs.draw_weights(ref.param_specs(ctx.config), ctx.seed, ctx.device, eval_stats)
    if ctx.traffic.get("bin_margin"):
        inputs.raise_bins(W, ctx.seed, ctx.traffic["bin_margin"], ctx.device)
    return W


@torch.no_grad()
def load_weights(model: torch.nn.Module, W: dict) -> None:
    """Copy W into the model's parameters and BN statistics of the same
    names; every floating-point parameter and statistic must be among them."""
    state = dict(model.named_parameters()) | dict(model.named_buffers())
    missing = [n for n, t in state.items() if t.is_floating_point() and n not in W]
    unknown = [n for n in W if n not in state]
    if missing or unknown:
        raise ValueError(f"weights do not match the model: missing {missing[:5]}, "
                         f"unknown {unknown[:5]}")
    for n, t in W.items():
        if state[n].shape != t.shape:
            raise ValueError(f"{n}: the model has {tuple(state[n].shape)}, the weights "
                             f"{tuple(t.shape)}")
        state[n].copy_(t)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _proc_numbers(path: str, line: int = 0) -> list[int]:
    try:
        with open(path) as f:
            return [int(x) for x in f.read().splitlines()[line].split()
                    if x.isdigit()]
    except (OSError, IndexError, ValueError):
        return []


class HostClock:
    """What the host did from the start to `read`, for the causes of
    host-bound runs that spread: the main thread's share of the window on a
    CPU, how often it was preempted or blocked, the time the garbage
    collector took, and where the kernel reports them, the thread's waits
    to be scheduled and the machine's share of CPU time stolen by its
    hypervisor."""

    def __init__(self):
        self.gc_s, self.gc_runs, self._gc_t = 0.0, [0, 0, 0], None
        gc.callbacks.append(self._gc)
        self._ru = resource.getrusage(resource.RUSAGE_THREAD)
        self._sched = _proc_numbers("/proc/thread-self/schedstat")
        self._cpu = _proc_numbers("/proc/stat")

    def _gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_t = time.perf_counter()
        elif self._gc_t is not None:
            self.gc_s += time.perf_counter() - self._gc_t
            self.gc_runs[info["generation"]] += 1

    def read(self, window_s: float) -> dict:
        ru = resource.getrusage(resource.RUSAGE_THREAD)
        gc.callbacks.remove(self._gc)
        cpu = (ru.ru_utime + ru.ru_stime) - (self._ru.ru_utime + self._ru.ru_stime)
        window_s = max(window_s, 1e-9)
        out = {"cpu_share": cpu / window_s, "preempted": ru.ru_nivcsw - self._ru.ru_nivcsw,
               "blocked": ru.ru_nvcsw - self._ru.ru_nvcsw, "gc_s": self.gc_s,
               "gc_runs_by_generation": self.gc_runs}
        sched, stat = _proc_numbers("/proc/thread-self/schedstat"), _proc_numbers("/proc/stat")
        if len(sched) == len(self._sched) == 3:  # ns on a CPU, ns runnable and waiting
            out["run_share"] = (sched[0] - self._sched[0]) * 1e-9 / window_s
            out["runqueue_share"] = (sched[1] - self._sched[1]) * 1e-9 / window_s
        if len(stat) == len(self._cpu) >= 8:  # user nice system idle iowait irq softirq steal
            d = [b - a for a, b in zip(self._cpu, stat)]
            out["steal_share"] = d[7] / max(sum(d[:8]), 1)
        return out
