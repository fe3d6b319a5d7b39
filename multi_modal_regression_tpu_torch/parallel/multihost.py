"""Multi-process entry point over torch.distributed (port of the JAX
package's parallel/multihost.py).

One process per rank, each feeding one device:

  1. every process calls `initialize()` first: the rendezvous address, the
     world size and the rank come from the arguments, or from the
     variables that `python -m torch.distributed.run` sets (MASTER_ADDR,
     MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK, LOCAL_WORLD_SIZE);
  2. loaders take `host_count=world`, `host_index=rank`: each rank reads a
     disjoint stride of the shared seeded epoch order (data/loader.py);
  3. the Trainer's default mesh is then data-parallel over every rank
     (parallel.mesh), and each rank's step runs on its own rows.

CLI: `python -m torch.distributed.run --standalone --nproc-per-node N -m
multi_modal_regression_tpu_torch.cli train ... --distributed`, or the same
command on every rank with `--coordinator-address H:P --num-processes N
--process-id I`.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Mapping

import numpy as np
import torch
import torch.distributed as dist

_DEVICE: torch.device | None = None


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def choose_backend(device: str, local_world: int) -> str:
    """'nccl' when every local rank has a card of its own, else 'gloo'
    (ranks sharing a card, where NCCL refuses two ranks on one GPU, or
    ranks on the CPU)."""
    if device == "cpu":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= local_world else "gloo"


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_rank: int | None = None,
    device: str = "cuda",
    timeout_seconds: int = 600,
    warmup_collectives: bool = True,
) -> tuple[int, int]:
    """init_process_group for this process; returns (world, rank).

    coordinator_address 'host:port' (rank 0 listens there), num_processes
    and process_id default to torchrun's MASTER_ADDR:MASTER_PORT,
    WORLD_SIZE and RANK; local_rank to LOCAL_RANK, else the rank. device
    'cuda' puts this rank on cuda:(local_rank % device_count) and takes
    NCCL when every local rank (LOCAL_WORLD_SIZE, else the world) has a
    card of its own, gloo when they share one; 'cpu' takes gloo. A missing
    address or rank raises, as does a failed rendezvous: there is no
    single-process fallback.

    timeout_seconds bounds the rendezvous and every collective. After the
    handshake every rank meets at one barrier, then runs one all-reduce,
    so the transport is up on every rank before the first step (the JAX
    package's `_warmup_gloo_aligned`)."""
    global _DEVICE
    if coordinator_address is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        coordinator_address = f"{addr}:{port}" if addr and port else None
    num_processes = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    process_id = process_id if process_id is not None else _env_int("RANK")
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "initialize needs the coordinator address, the number of processes and "
            "this process's id: pass them, or launch with python -m "
            "torch.distributed.run (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside [0, {num_processes})")
    if local_rank is None:
        local_rank = _env_int("LOCAL_RANK")
        local_rank = process_id if local_rank is None else local_rank
    local_world = _env_int("LOCAL_WORLD_SIZE") or num_processes
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize(device='cuda') on a machine without CUDA")
        _DEVICE = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(_DEVICE)
    else:
        _DEVICE = torch.device("cpu")
    backend = choose_backend(device, local_world)
    timeout = datetime.timedelta(seconds=timeout_seconds)
    kwargs: dict[str, Any] = {}
    if backend == "nccl":
        kwargs["device_id"] = _DEVICE
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
        rank=process_id, timeout=timeout, **kwargs,
    )
    if warmup_collectives and num_processes > 1:
        if backend == "gloo":
            dist.monitored_barrier(timeout=timeout)
        else:
            dist.barrier(device_ids=[_DEVICE.index])
        probe = torch.ones(1, device=_DEVICE if backend == "nccl" else "cpu")
        dist.all_reduce(probe)
        if int(probe.item()) != num_processes:
            raise RuntimeError(f"warm-up all-reduce gave {probe.item()}, not {num_processes}")
    return num_processes, process_id


def shutdown() -> None:
    """Leave the process group (no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def local_device() -> torch.device:
    """This rank's device as `initialize` chose it, else the CPU."""
    return _DEVICE if _DEVICE is not None else torch.device("cpu")


def host_info() -> tuple[int, int]:
    """(process count, process index): (1, 0) in a one-process run."""
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def global_batch_from_local(
    batch: Mapping[str, Any], mesh, device: torch.device | None = None,
) -> tuple[dict, int]:
    """A rank's own stride's batch (the loaders' host_count/host_index
    slicing) on its device, with the global batch's row count: local rows
    x the data group's size. The rows stay where they are (each rank runs
    its own); the train step's collectives make the step the global
    batch's. Every rank must hold the same number of rows."""
    out = {k: torch.as_tensor(np.asarray(v)).to(device or mesh.device)
           for k, v in batch.items()}
    n = len(next(iter(out.values())))
    return out, n * mesh.n_data
