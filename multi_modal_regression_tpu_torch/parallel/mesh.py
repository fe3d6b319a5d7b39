"""Data parallelism over torch.distributed (port of the JAX package's
parallel/mesh.py).

The JAX package runs data parallelism as jit over a global array: every
BatchNorm mean and variance, every loss term and the gradient are those of
the GLOBAL batch, and XLA inserts the psum. Here each rank runs its own
local rows and the collectives are explicit:

  - parameters and buffers are broadcast from rank 0 when a Trainer is
    built (`broadcast_module`);
  - every training-mode BatchNorm all-reduces its sums over the data group
    (`global_sums`, differentiable: its backward all-reduces the
    cotangent), so its moments, its Bessel count and its running-statistics
    update are the global batch's; the train step enters
    `syncing_bn(modules, mesh)` for its forward and backward, which sets the
    mesh on the model's modules, and each BN site reads its own module's
    (`sync_mesh`);
  - after the backward, one all-reduce of the gradients over the data
    group, dtype by dtype in parameter order, divided by the group's size
    (`reduce_gradients`): each rank's loss is the mean over its rows, so
    the mean of the ranks' gradients is the global batch's (the BN
    cotangents having been summed over the ranks on the way); under
    tensor parallelism the replicated leaves' gradients take the mean
    over the model group first (parallel/tp);
  - batch-derived scalars (the loss terms that feed self-balance, the
    logged metrics) are means over the data group (`mean_over_data`).

Every rank must hold the same number of rows. Collectives are all-reduce,
broadcast and barrier only, which gloo runs on CPU and CUDA tensors and
NCCL on CUDA tensors; a gather is an all-reduce of a zero-padded buffer
(`all_gather_rows`), exact because every element is one rank's value plus
zeros.

A `Mesh` of world 1 (no process group) is the one-process run: nothing is
reduced and the step takes its one-process code path.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterable, Mapping

import numpy as np
import torch
import torch.distributed as dist
from torch import nn


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A rank's place in a ('data',) or ('data', 'model') mesh.

    Ranks are laid out data-major, as the JAX package's
    `devices.reshape(n_data, n_model)`: rank = data_rank * n_model +
    model_rank. `data_group` joins the ranks of one model index (they hold
    the same head shards and split the batch), `model_group` the ranks of
    one data index (they see the same rows and split the head banks). A
    group is None when its size is 1. `device` is this rank's device."""

    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    n_data: int = 1
    data_rank: int = 0
    data_group: object | None = None
    n_model: int = 1
    model_rank: int = 0
    model_group: object | None = None
    backend: str | None = None


def make_mesh(device: torch.device | str | None = None) -> Mesh:
    """A 1-D data-parallel mesh over every rank of the initialized process
    group (parallel.multihost.initialize), or the one-process mesh when
    there is none. device: this rank's device (default: the one
    `multihost.initialize` chose, else the CPU)."""
    from multi_modal_regression_tpu_torch.parallel import multihost

    device = torch.device(device) if device is not None else multihost.local_device()
    if not dist.is_initialized() or dist.get_world_size() == 1:
        backend = dist.get_backend() if dist.is_initialized() else None
        return Mesh(device=device, backend=backend)
    world, rank = dist.get_world_size(), dist.get_rank()
    return Mesh(rank=rank, world=world, device=device, n_data=world, data_rank=rank,
                data_group=dist.group.WORLD, backend=dist.get_backend())


def shard_batch(batch: Mapping[str, np.ndarray], mesh: Mesh, streams: int | None = None) -> dict:
    """This rank's rows of a GLOBAL host batch: each of `streams` equal
    consecutive parts (2 for the dual-loader layout [real, render], found
    from an `is_real` mask holding both; else 1) is cut into n_data blocks
    and the rank keeps its block of each, so its local batch keeps the
    [real, render] layout. Replicated across the model axis. Inverse of
    concatenating the ranks' local batches stream by stream."""
    if streams is None:
        m = batch.get("is_real")
        streams = 2 if m is not None and np.asarray(m).any() and not np.asarray(m).all() else 1
    n = len(next(iter(batch.values())))
    if n % (streams * mesh.n_data):
        raise ValueError(
            f"a batch of {n} rows does not split into {streams} stream(s) x "
            f"{mesh.n_data} data ranks")
    per = n // streams
    blk = per // mesh.n_data
    rows = np.concatenate([np.arange(s * per + mesh.data_rank * blk,
                                     s * per + (mesh.data_rank + 1) * blk)
                           for s in range(streams)])
    return {k: np.asarray(v)[rows] for k, v in batch.items()}


# --- collectives ----------------------------------------------------------------


def _comm_device(backend: str | None, t: torch.Tensor) -> torch.device:
    if backend == "nccl" and t.device.type != "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return t.device


def all_reduce_(t: torch.Tensor, group, backend: str | None) -> torch.Tensor:
    """Sum `t` over `group` in place (a copy through the card for a CPU
    tensor under NCCL); returns t."""
    dev = _comm_device(backend, t)
    if dev == t.device:
        dist.all_reduce(t, group=group)
        return t
    buf = t.to(dev)
    dist.all_reduce(buf, group=group)
    t.copy_(buf)
    return t


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; the backward sums the cotangent over it too."""

    @staticmethod
    def forward(ctx, x, group, backend):
        ctx.group, ctx.backend = group, backend
        return all_reduce_(x.clone(), group, backend)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group, ctx.backend), None, None


def all_reduce_sum(x: torch.Tensor, group, backend: str | None) -> torch.Tensor:
    """Differentiable sum of x over `group` (identity for no group)."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group, backend)


# --- global BatchNorm statistics --------------------------------------------------

@contextlib.contextmanager
def syncing_bn(modules: Iterable[nn.Module], mesh: Mesh | None):
    """Within: every training-mode BN of `modules` takes the moments of the
    global batch over mesh's data group (nothing changes for a mesh of one
    data rank). The mesh is set on each module (its `sync_mesh`), so the
    scope is the model's own and a checkpointed segment that the backward
    replays, on whatever thread, reads it too."""
    mesh = mesh if mesh is not None and mesh.n_data > 1 else None
    modules = list(modules)
    saved = [m.__dict__.get("sync_mesh") for m in modules]
    for m in modules:
        m.sync_mesh = mesh
    try:
        yield
    finally:
        for m, s in zip(modules, saved):
            m.sync_mesh = s


def sync_mesh(module: nn.Module) -> Mesh | None:
    """The mesh whose data group `module`'s training-mode statistics reduce
    over, or None (outside `syncing_bn`)."""
    return getattr(module, "sync_mesh", None)


def global_sums(sums: torch.Tensor, count: int, mesh: Mesh | None) -> tuple[torch.Tensor, int]:
    """Per-rank BN sums (any shape) of `count` elements a channel -> the
    data group's sums (differentiable) and count; as given for no mesh.
    Every rank holds `count` elements."""
    if mesh is None:
        return sums, count
    return all_reduce_sum(sums, mesh.data_group, mesh.backend), count * mesh.n_data


def global_rows(n: int, mesh: Mesh | None) -> tuple[int, int]:
    """(global rows, this rank's first row) for a per-rank draw of n rows
    under a data-parallel mesh: a rank draws for the global batch of its
    stream and keeps its own block, so every row gets the draw it gets in
    one process. (n, 0) for no mesh."""
    if mesh is None:
        return n, 0
    return n * mesh.n_data, n * mesh.data_rank


# --- the train step's reductions --------------------------------------------------


def mean_over_data(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean of a detached tensor over the data group."""
    if mesh.n_data == 1:
        return t
    out = all_reduce_(t.detach().clone(), mesh.data_group, mesh.backend)
    return out / mesh.n_data


def reduce_gradients(params: Iterable[torch.Tensor], mesh: Mesh, axis: str = "data") -> None:
    """The mean over mesh's `axis` group ('data' or 'model') of every
    gradient that is set: one all-reduce of a flat buffer per dtype,
    parameters in their given order (the same on every rank), so reruns
    repeat their bits."""
    group, n = ((mesh.data_group, mesh.n_data) if axis == "data" else
                (mesh.model_group, mesh.n_model))
    if n == 1:
        return
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        all_reduce_(flat, group, mesh.backend)
        flat /= n
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def broadcast_module(module: nn.Module, mesh: Mesh) -> None:
    """Every parameter and buffer of `module` from global rank 0."""
    if mesh.world == 1:
        return
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            dev = _comm_device(mesh.backend, t)
            buf = t.data if dev == t.device else t.data.to(dev)
            dist.broadcast(buf, src=0)
            if buf is not t.data:
                t.data.copy_(buf)


def barrier(mesh: Mesh) -> None:
    if mesh.world > 1:
        if mesh.backend == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


# --- gathers (predict, checkpoints) ----------------------------------------------


def all_gather_rows(arrays: Mapping[str, np.ndarray], mesh: Mesh) -> dict[str, np.ndarray]:
    """Each rank's host arrays (rows of any count, the same trailing shape
    and dtype on every rank) -> every rank's, concatenated in rank order;
    through one all-reduce of the counts and one of each zero-padded
    array."""
    if mesh.world == 1:
        return {k: np.asarray(v) for k, v in arrays.items()}
    n_local = len(next(iter(arrays.values())))
    counts = torch.zeros(mesh.world, dtype=torch.int64)
    counts[mesh.rank] = n_local
    counts = all_reduce_(counts, None, mesh.backend).tolist()
    n_max = max(counts)
    out = {}
    for k, v in arrays.items():
        v = np.asarray(v)
        wide = v.astype(np.int64) if v.dtype.kind in "biu" else v
        buf = torch.zeros((mesh.world, n_max, *v.shape[1:]), dtype=torch.from_numpy(wide).dtype)
        buf[mesh.rank, :n_local] = torch.from_numpy(np.ascontiguousarray(wide))
        buf = all_reduce_(buf, None, mesh.backend).numpy()
        out[k] = np.concatenate([buf[r, :c] for r, c in enumerate(counts)]).astype(v.dtype)
    return out
