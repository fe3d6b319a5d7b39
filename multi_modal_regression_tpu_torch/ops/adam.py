"""Adam's update of many tensors: the foreach passes and the one-pass kernel.

`adam_update_plain` is train/presets.Adam's update as 16 torch._foreach
passes and a cast a parameter. `adam_update` takes it for CPU tensors; for
tensors on the card it launches csrc/adam.cu, or raises ValueError for a
parameter whose dtypes or layout the kernel cannot take (`fusable`: float32
with a float32 or bf16 mu, the four dense and laid out alike). The path
follows the device, with no setting. The kernel performs the same float32
operations in the same order in one pass over each element (p, g, nu and
mu read once, p, mu and nu written once: 24 bytes an element with a bf16
mu, where the foreach passes move ~136), for a whole list of tensors in one
launch. The two give the same bits.

The foreach division by a Python scalar (`torch._foreach_div(nus, bc2)`)
multiplies by the scalar's reciprocal on the card, computed in double and
rounded to float32 (torch 2.11, checked bit for bit there); the kernel takes
the same reciprocals, computed on the host (`kernel_step`) and read from the
card's memory, where the host writes them in stream order before each
launch: so a launch captured in a CUDA graph (`CapturedUpdate`) takes each
replay's rate and bias corrections. On the CPU the foreach passes round
otherwise (a true division, a vectorized square root); the kernel never
runs there.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from multi_modal_regression_tpu_torch.ops import _build
from multi_modal_regression_tpu_torch.utils.profiling import span

# the first-moment dtypes the kernel stores
MU_DTYPES = (torch.float32, torch.bfloat16)

# kernel launches in this process (one a call of adam_update for each device
# and mu dtype among its tensors, one more for each 640 tensors past the
# first 640), counted where the kernel is launched
launches = 0


def _steps(t: torch.Tensor) -> tuple[int, ...]:
    """t's strides over its dims longer than 1: where its elements lie (the
    stride of a dim of size 1 is never used, and autograd's gradients may
    give it another value than the parameter's)."""
    return tuple(st for st, n in zip(t.stride(), t.shape) if n != 1)


def _dense(t: torch.Tensor) -> bool:
    """Whether t's elements fill the span of t.numel() elements from
    t.data_ptr() with no gap and no overlap, its dims in any order
    (contiguous, channels-last, permuted)."""
    if t.is_contiguous() or t.is_contiguous(memory_format=torch.channels_last):
        return True
    span = 1
    for st, n in sorted((st, n) for st, n in zip(t.stride(), t.shape) if n != 1):
        if st != span:
            return False
        span *= n
    return True


def same_layout(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor) -> bool:
    """Whether the kernel can walk the four memory spans element by element:
    p, g, nu float32 and mu float32 or bfloat16, of one shape and the same
    strides over the dims longer than 1, dense. Equal strides and the
    two common layouts are asked first: Adam asks this of every parameter
    each step, and `_steps` and `_dense`'s sort alone take the host ~4x
    longer (~2.5 ms for geodesic_bd's 175 tensors on a CPU where the fast
    answers take 0.6)."""
    return (p.dtype == g.dtype == nu.dtype == torch.float32 and mu.dtype in MU_DTYPES
            and p.shape == g.shape == mu.shape == nu.shape
            and (p.stride() == g.stride() == mu.stride() == nu.stride()
                 or _steps(p) == _steps(g) == _steps(mu) == _steps(nu))
            and _dense(p))


def fusable(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor) -> bool:
    """Whether the kernel takes this parameter's update: the four on one
    CUDA device, in `same_layout`."""
    return (p.is_cuda and p.device == g.device == mu.device == nu.device
            and same_layout(p, g, mu, nu))


@functools.cache
def _b1_in(b1: float, dtype: torch.dtype) -> float:
    """b1 rounded to mu's dtype, as XLA's weak-typed scalar and Adam's
    foreach passes round it."""
    return float(torch.tensor(b1, dtype=dtype))


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def kernel_step(lr: float, bc1: float, bc2: float) -> torch.Tensor:
    """The scalars of one step as the kernel reads them from the card: -lr,
    1 / bc1 and 1 / bc2, each computed in double on the host and rounded
    once to float32 (a (3,) CPU tensor)."""
    return torch.tensor([-lr, 1.0 / bc1, 1.0 / bc2], dtype=torch.float32)


def write_step(dst: torch.Tensor, host: torch.Tensor) -> None:
    """Copy host scalars into dst on the card in stream order, through pinned
    memory that torch's host allocator keeps until the copy has run: the
    host does not wait for the card."""
    dst.copy_(host.pin_memory() if dst.is_cuda else host, non_blocking=True)


def check_fusable(params, grads, mus, nus, mu_dtype: torch.dtype | None) -> None:
    """ValueError naming the first parameter that is not `fusable` with its mu
    in mu_dtype (None: the parameter's dtype)."""
    for i, (p, g, mu, nu) in enumerate(zip(params, grads, mus, nus)):
        if mu.dtype != (mu_dtype or p.dtype) or not fusable(p, g, mu, nu):
            raise ValueError(
                f"adam_update: the kernel cannot take parameter {i} of the list: p "
                f"{tuple(p.shape)} {p.dtype} on {p.device} strides {p.stride()}, grad "
                f"{g.dtype} on {g.device} strides {g.stride()}, mu {mu.dtype} strides "
                f"{mu.stride()}, nu {nu.dtype} strides {nu.stride()} (it takes float32 on one "
                f"card, mu in {mu_dtype or p.dtype} (float32 or bfloat16), the four dense "
                f"with the same strides)")


def adam_update(params, grads, mus, nus, *, lr: float, b1: float, b2: float, eps: float,
                bc1: float, bc2: float, mu_dtype: torch.dtype | None) -> int:
    """One Adam step over the given tensors in place (bc1, bc2: the bias
    corrections 1 - b**count; mu_dtype as adam_update_plain's). CPU tensors
    take adam_update_plain. Any other list takes the kernel, through the op
    mmr::adam_ inside the span `mmr.optim.adam_fused`, one launch for each
    device and mu dtype among its tensors (and one more a 640 tensors past
    the first 640), with the step's scalars (`kernel_step`) written to the
    card before it; ValueError names the first parameter that is not
    `fusable` (`check_fusable`), before anything is written. Returns the
    number of elements the kernel updated."""
    if not len(params) == len(grads) == len(mus) == len(nus):
        raise ValueError("adam_update needs as many grads, mus and nus as params")
    if all(p.device.type == "cpu" for p in params):
        adam_update_plain(params, grads, mus, nus, lr=lr, b1=b1, b2=b2, eps=eps, bc1=bc1,
                          bc2=bc2, mu_dtype=mu_dtype)
        return 0
    check_fusable(params, grads, mus, nus, mu_dtype)
    step = torch.empty(3, dtype=torch.float32, device=params[0].device)
    write_step(step, kernel_step(lr, bc1, bc2))
    with span("mmr.optim.adam_fused"):
        torch.ops.mmr.adam_(params, grads, mus, nus, step, b1, b2, eps)
    # the kernel writes through raw pointers: move the version counters, as
    # an in-place torch op does, so that autograd refuses a saved tensor
    # that the step changed
    torch.autograd.graph.increment_version([*params, *mus, *nus])
    return sum(p.numel() for p in params)


class CapturedUpdate:
    """The kernel launches of Adam's update over the same tensors step after
    step, captured in one CUDA graph (train/steps.GraphedTrainStep: the
    gradients keep their addresses there), so that the layout checks and
    the tables of addresses are made once, at the capture.

    groups: (params, grads, mus, nus, b1, b2, eps, mu_dtype) of each param
    group, every parameter `fusable` (else ValueError, as adam_update). Each
    group's launch reads its row of `step`, which `replay` fills with that
    step's scalars before the graph runs. The capture runs nothing and
    leaves `launches` as it found it; a replay counts the launches it runs.
    pool: the memory pool of the graphs it is replayed with."""

    def __init__(self, groups: list[tuple], pool=None):
        global launches
        for params, grads, mus, nus, *_, mu_dtype in groups:
            check_fusable(params, grads, mus, nus, mu_dtype)
        self.tensors = [[list(t) for t in g[:4]] for g in groups]
        self.consts = [tuple(g[4:7]) for g in groups]
        self.step = torch.zeros(len(groups), 3, device=groups[0][0][0].device)
        self.graph = torch.cuda.CUDAGraph()
        before = launches
        try:
            with torch.cuda.graph(self.graph, pool=pool):
                for (params, grads, mus, nus), (b1, b2, eps), row in zip(
                        self.tensors, self.consts, self.step):
                    torch.ops.mmr.adam_(params, grads, mus, nus, row, b1, b2, eps)
        finally:
            self.launches, launches = launches - before, before

    def covers(self, groups: list[tuple]) -> bool:
        """Whether `groups` (as the constructor's) are the tensors and
        constants captured: then a replay is their update."""
        return len(groups) == len(self.tensors) and all(
            tuple(g[4:7]) == c and all(len(a) == len(b) and all(x is y for x, y in zip(a, b))
                                       for a, b in zip(g[:4], t))
            for g, t, c in zip(groups, self.tensors, self.consts))

    def replay(self, host_step: torch.Tensor) -> None:
        """One update, each group at its row of host_step ((groups, 3) as
        kernel_step gives them)."""
        global launches
        write_step(self.step, host_step)
        with span("mmr.optim.adam_fused"):
            self.graph.replay()
        torch.autograd.graph.increment_version(
            [t for params, _, mus, nus in self.tensors for t in (*params, *mus, *nus)])
        launches += self.launches


# The kernel runs as the op mmr::adam_, so that torch.profiler charges its
# device time to the op and to the ranges around it (Optimizer.step#Adam.step):
# a kernel launched under a record_function range alone is charged to none.
# The op is defined through torch.library.Library: a call with a group's four
# lists of ~170 tensors costs the host ~0.2 ms, a torch.library.custom_op's ~0.8.
_LIB = torch.library.Library("mmr", "FRAGMENT")
_LIB.define("adam_(Tensor(a!)[] params, Tensor[] grads, Tensor(b!)[] mus, Tensor(c!)[] nus, "
            "Tensor step, float b1, float b2, float eps) -> ()")


def _launch(params, grads, mus, nus, step: torch.Tensor, b1: float, b2: float,
            eps: float) -> None:
    """The kernel over tensors that `fusable` admits (the CUDA
    implementation of mmr::adam_, which has no other): a table of rows, the
    four addresses and the size, for each device and mu dtype among them;
    `step` holds -lr, 1 / bc1, 1 / bc2 as float32 (`kernel_step`), which the
    kernel reads when it runs."""
    global launches
    if step.dtype != torch.float32 or step.numel() != 3 or not step.is_contiguous():
        raise ValueError(f"the step's scalars are 3 contiguous float32, got {step.dtype} "
                         f"{tuple(step.shape)}")
    rows: dict[tuple, list[int]] = {}
    for p, g, mu, nu in zip(params, grads, mus, nus):
        rows.setdefault((p.device, mu.dtype), []).extend(
            (p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(), p.numel()))
    for (device, mu_dtype), row in rows.items():
        scalars = step if step.device == device else step.to(device)
        table = (ctypes.c_longlong * len(row))(*row)
        launched = ctypes.c_int(0)
        err = _build.load().mmr_adam(
            table, len(row) // 5, int(mu_dtype == torch.bfloat16), 1 - b1,
            _b1_in(b1, mu_dtype), b2, 1 - b2, eps, scalars.data_ptr(),
            _sms(device.index), ctypes.byref(launched), device.index,
            torch.cuda.current_stream(device).cuda_stream,
        )
        launches += launched.value
        _build.check(err, "Adam kernel")


_LIB.impl("adam_", _launch, "CUDA")


def adam_update_plain(params, grads, mus, nus, *, lr: float, b1: float, b2: float,
                      eps: float, bc1: float, bc2: float, mu_dtype: torch.dtype | None) -> None:
    """The same step as torch._foreach passes, on any device and dtype: the
    update in the parameters' dtype, b1 * mu in mu_dtype (None: the
    parameters' dtype) with b1 rounded to it, the new mu rounded to it once
    after the update used it."""
    mu = torch._foreach_mul(grads, 1 - b1)
    if mu_dtype is None:
        decayed = torch._foreach_mul(mus, b1)
    else:
        b1_mu = float(torch.tensor(b1, dtype=mu_dtype))
        decayed = [
            m.to(p.dtype) for m, p in zip(torch._foreach_mul(mus, b1_mu), params)
        ]
    torch._foreach_add_(mu, decayed)
    torch._foreach_mul_(nus, b2)
    torch._foreach_add_(
        nus, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2)
    )
    denom = torch._foreach_div(nus, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    upd = torch._foreach_div(mu, bc1)
    torch._foreach_div_(upd, denom)
    torch._foreach_mul_(upd, -lr)
    torch._foreach_add_(params, upd)
    torch._foreach_copy_(mus, mu)
