"""Tensor parallelism of the per-class head banks (port of the JAX
package's parallel/tp.py).

The bin/delta head banks are block-diagonal over heads: (H, in, out)
stacks applied as one batched product (models.heads.MultiHeadMLP). On a
('data', 'model') mesh of n_data x n_model ranks, model rank r holds heads
[r H/n, (r+1) H/n) of every bank named in HEAD_BANK_NAMES, with their BN
parameters and statistics, and its optimizer holds their moments only. A
bank whose H does not divide n_model stays whole on every rank. The trunk
is data-parallel: replicated, its batch split over 'data'.

Where the JAX package lets XLA insert the collectives, the port places
them by hand (Megatron's f and g):

  f  features enter a sharded bank through `copy_to_model`: identity
     forward, all-reduce of the cotangent over the model group backward
     (each rank's bank sends back its own heads' share of d feat);
  g  the bank's outputs leave through `reduce_from_model` when the caller
     selects heads (the class-selected rows: each row's head lives on one
     rank, the others add zeros): all-reduce forward, identity backward.
     Every model rank computes the same loss from the same replicated
     values, so an all-reduce backward there would scale the bank's
     gradients by n_model. Without a selection the whole (B, H, O) output
     is gathered (`gather_heads`), whose backward keeps the rank's slice.

Gradients: with f in place the trunk's are complete on every model rank,
so no sum over the model group is needed; but cuDNN's weight gradients
are not deterministic, so the replicated leaves (the trunk, a bank left
whole) take their mean over the model group, which keeps the replicas one
copy, bit for bit. Then every gradient, replicated or bank shard, takes
the mean over the data group (parallel.mesh.reduce_gradients).

Use: mesh = make_2d_mesh(n_data, n_model); shard_state(model, mesh) (the
Trainer does both when given `mesh=`).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch import nn

from multi_modal_regression_tpu_torch.parallel.mesh import Mesh, all_reduce_

# the model's top-level modules whose parameters lead with a head axis
HEAD_BANK_NAMES = ("bin_models", "res_models", "pose_models")


@dataclasses.dataclass(frozen=True)
class HeadShard:
    """A bank's shard: heads [lo, lo + local) of `total`; the collectives run
    over the model `group` ('backend' picks the device of a CPU tensor under
    NCCL)."""

    lo: int
    local: int
    total: int
    group: object
    backend: str | None


def make_2d_mesh(n_data: int, n_model: int, device: torch.device | str | None = None) -> Mesh:
    """A ('data', 'model') mesh of n_data x n_model ranks over the
    initialized process group (its world must be n_data x n_model). Every
    rank creates every subgroup, in the same order, as torch requires."""
    from multi_modal_regression_tpu_torch.parallel import multihost

    device = torch.device(device) if device is not None else multihost.local_device()
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh needs {n_data * n_model} ranks, "
                         f"the process group has {world}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    d, m = divmod(rank, n_model)
    data_group = model_group = None
    for mi in range(n_model):  # ranks of one model index
        g = dist.new_group([di * n_model + mi for di in range(n_data)]) if n_data > 1 else None
        if mi == m:
            data_group = g
    for di in range(n_data):  # ranks of one data index
        g = dist.new_group([di * n_model + mi for mi in range(n_model)]) if n_model > 1 else None
        if di == d:
            model_group = g
    backend = dist.get_backend() if dist.is_initialized() else None
    return Mesh(rank=rank, world=world, device=device, n_data=n_data, data_rank=d,
                data_group=data_group, n_model=n_model, model_rank=m,
                model_group=model_group, backend=backend)


def _banks(model: nn.Module) -> list[tuple[str, nn.Module]]:
    return [(n, m) for n, m in model.named_children() if n in HEAD_BANK_NAMES]


def _head_count(bank: nn.Module) -> int:
    return next(iter(bank.parameters())).shape[0]


def shard_state(model: nn.Module, mesh: Mesh) -> list[str]:
    """Cut every bank of HEAD_BANK_NAMES whose head count divides n_model to
    this rank's heads, in place: each parameter and buffer with the head
    axis first (kernels (H, I, O), biases (H, O), BN parameters and
    statistics (H, F)) keeps rows [lo, lo + H/n), and the bank is marked
    with its `HeadShard` (`bank.tp`). Returns the sharded banks' names.
    Build the optimizer after this: it must hold the shards."""
    if mesh.n_model == 1:
        return []
    done = []
    for name, bank in _banks(model):
        h = _head_count(bank)
        if h % mesh.n_model:
            continue  # the JAX package keeps such a bank replicated
        local = h // mesh.n_model
        lo = mesh.model_rank * local
        with torch.no_grad():
            for mod in bank.modules():
                for pname, p in list(mod.named_parameters(recurse=False)):
                    setattr(mod, pname, nn.Parameter(p[lo:lo + local].clone(),
                                                     requires_grad=p.requires_grad))
                for bname, b in list(mod.named_buffers(recurse=False)):
                    if b is not None and b.ndim >= 1 and b.shape[0] == h:
                        setattr(mod, bname, b[lo:lo + local].clone())
        bank.tp = HeadShard(lo, local, h, mesh.model_group, mesh.backend)
        done.append(name)
    return done


def sharded_keys(model: nn.Module) -> dict[str, HeadShard]:
    """state_dict key -> its bank's shard, for every head-axis tensor of a
    sharded bank."""
    out = {}
    for name, bank in _banks(model):
        shard = getattr(bank, "tp", None)
        if shard is None:
            continue
        for k, v in bank.state_dict().items():
            if v.ndim >= 1 and v.shape[0] == shard.local:
                out[f"{name}.{k}"] = shard
    return out


def gather_heads_tensor(t: torch.Tensor, shard: HeadShard) -> torch.Tensor:
    """A shard (local, ...) -> the whole bank's tensor (total, ...), on
    every rank of the model group (an all-reduce of the zero-padded
    buffer: exact)."""
    full = torch.zeros((shard.total, *t.shape[1:]), dtype=t.dtype, device=t.device)
    full[shard.lo:shard.lo + shard.local] = t
    return all_reduce_(full, shard.group, shard.backend)


def full_state_dict(model: nn.Module) -> dict[str, torch.Tensor]:
    """The model's state_dict in the one-process layout: sharded banks'
    tensors gathered over the model group (a collective: every model rank
    calls it)."""
    keys = sharded_keys(model)
    sd = model.state_dict()
    return {k: gather_heads_tensor(v, keys[k]) if k in keys else v for k, v in sd.items()}


def slice_state_dict(model: nn.Module, sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A one-process state_dict cut to this rank's shards of `model`."""
    keys = sharded_keys(model)
    return {k: (v[keys[k].lo:keys[k].lo + keys[k].local] if k in keys else v)
            for k, v in sd.items()}


def param_shards(model: nn.Module) -> dict[int, HeadShard]:
    """id(parameter) -> its shard, for the parameters of sharded banks."""
    out = {}
    for _, bank in _banks(model):
        shard = getattr(bank, "tp", None)
        if shard is not None:
            for p in bank.parameters():
                out[id(p)] = shard
    return out


# --- f and g ---------------------------------------------------------------------


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.shard.group, ctx.shard.backend), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        return all_reduce_(x.contiguous().clone(), shard.group, shard.backend)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        full = torch.zeros((x.shape[0], shard.total, *x.shape[2:]), dtype=x.dtype,
                           device=x.device)
        full[:, shard.lo:shard.lo + shard.local] = x
        return all_reduce_(full, shard.group, shard.backend)

    @staticmethod
    def backward(ctx, g):
        s = ctx.shard
        return g[:, s.lo:s.lo + s.local].contiguous(), None


def copy_to_model(x: torch.Tensor, shard: HeadShard) -> torch.Tensor:
    """f: identity forward, sum of the cotangent over the model group."""
    return _CopyToModel.apply(x, shard)


def reduce_from_model(x: torch.Tensor, shard: HeadShard) -> torch.Tensor:
    """g: sum over the model group forward, identity backward."""
    return _ReduceFromModel.apply(x, shard)


def gather_heads(x: torch.Tensor, shard: HeadShard) -> torch.Tensor:
    """(B, local, ...) -> (B, total, ...) over the model group; the backward
    keeps this rank's slice of the (identical) cotangent."""
    return _GatherHeads.apply(x, shard)
