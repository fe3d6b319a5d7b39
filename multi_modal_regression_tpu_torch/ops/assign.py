"""Pose-bin assignment: rows of y (N, D) -> index of the nearest center.

Port of the JAX package's ops/assign.py, the dictionary lookup behind
`KMeansDictionary.predict` and the assignment step of kmeans fitting. The
kernel (csrc/assign.cu) ranks the K centers of each row by

    |c_k|^2 - 2 y . c_k        (|y|^2 is constant per row and dropped)

in float32 and writes the argmin as int32, lowest index on ties, without
ever holding an (N, K) matrix in device memory. A row whose distances hold
a NaN gets the index of the first NaN, as `jnp.argmin` and `torch.argmin`
give it.

`_assign_plan` picks the kernel's launch shape: persistent blocks that
share the rows out evenly in warp tiles, 8 rows a thread, and the centers
packed with their squared norms in shared memory (csrc/assign.cu says how
the kernel spends its issue slots and why its fast loop gives the same bits
as the careful one).

The plain version beside it performs the same float32 operations in the
same order (the cross term and the squared norms summed over d in index
order, each product and sum rounded on its own, then `c2 - 2 * cross`), so
on the card the two return equal indices, not merely close ones. It holds
(N, K) matrices and is used by the tests and for CPU tensors only.

An argmin has no gradient and the JAX function defines none: the output
never requires grad.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from multi_modal_regression_tpu_torch.ops import _build

# the kernel keeps its rows in registers and all centers in shared memory
MAX_D = 4
MAX_SHARED_FLOATS = 48 * 1024 // 4  # K * (D + 1) floats

# the kernel's launch shape (csrc/assign.cu holds the same constants): a
# warp tile of 32 lanes x 8 rows, blocks an SM (its __launch_bounds__: 3, 2
# at D = 4); 228 KB of shared memory an SM, 1 KB of it reserved per block
_TILE_ROWS = 32 * 8
_SMEM_SM, _SMEM_RESERVED = 228 * 1024, 1024

# kernel launches in this process, counted where the kernel is launched
launches = 0


class AssignPlan(NamedTuple):
    """Launch shape of the assign kernel: `tiles` warp tiles of 256 rows
    over all N rows, `blocks` blocks (block b takes the tiles [tiles * b //
    blocks, tiles * (b + 1) // blocks)), `smem` bytes of shared memory a
    block (one 16-byte slot a center, two at D = 4)."""

    blocks: int
    tiles: int
    smem: int


@functools.lru_cache(maxsize=None)  # a wrapper call costs the host only a lookup
def _assign_plan(n: int, d: int, k: int, sms: int) -> AssignPlan:
    """Launch shape for y (n, d) against k centers on a card of `sms` SMs.

    As many blocks as the card holds at once (3 an SM, 2 at D = 4, fewer
    where the centers' shared memory does not let so many share an SM), so
    that they all run in one wave, each with the same number of warp tiles
    give or take one: every SM gets the same rows. Never more blocks than
    tiles. Raises where the tiles number 2**31 or more (2**39 rows, far
    past what a card holds)."""
    if n < 1 or not 1 <= d <= MAX_D or k < 1 or sms < 1:
        raise ValueError(f"no assign plan for n = {n}, d = {d}, k = {k}, sms = {sms}")
    smem = k * 16 * (1 if d < 4 else 2)
    per_sm = min(3 if d < 4 else 2, _SMEM_SM // (smem + _SMEM_RESERVED))
    if per_sm < 1:
        raise ValueError(f"K = {k} centers of D = {d} do not fit in shared memory")
    tiles = -(-n // _TILE_ROWS)
    if tiles >= 2**31:
        raise ValueError(f"N = {n} gives the assign kernel too many tiles")
    return AssignPlan(min(sms * per_sm, tiles), tiles, smem)


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(y: torch.Tensor, centers: torch.Tensor) -> None:
    if y.ndim != 2 or centers.ndim != 2 or y.shape[1] != centers.shape[1]:
        raise ValueError(
            f"expected y (N, D) and centers (K, D), got {tuple(y.shape)} and "
            f"{tuple(centers.shape)}"
        )
    if centers.shape[0] < 1 or y.shape[1] < 1:
        raise ValueError(f"need at least one center and one dim, got {tuple(centers.shape)}")
    if not (y.is_floating_point() and centers.is_floating_point()):
        raise TypeError(f"expected floating-point inputs, got {y.dtype} and {centers.dtype}")
    if y.device != centers.device:
        raise ValueError(f"y on {y.device} but centers on {centers.device}")


def assign_bins_plain(y: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in eager PyTorch ops: (N,) int32."""
    _check(y, centers)
    y, c = y.to(torch.float32), centers.to(torch.float32)
    cross = y[:, 0:1] * c[:, 0]  # (N, K)
    c2 = c[:, 0] * c[:, 0]  # (K,)
    for d in range(1, y.shape[1]):
        cross = cross + y[:, d : d + 1] * c[:, d]
        c2 = c2 + c[:, d] * c[:, d]
    # torch.argmin: the first minimum, or the first NaN if there is one
    return torch.argmin(c2 - 2.0 * cross, dim=1).to(torch.int32)


def assign_bins(y: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Rows of y (N, D) -> nearest-center indices (N,) int32.

    Inputs are cast to float32, as the JAX function casts them, and made
    contiguous. On CUDA tensors: the kernel, for D <= 4 and K * (D + 1) <=
    12288 (anything else raises; there is no fallback). On CPU tensors: the
    plain version. N = 0 returns an empty tensor without a launch.
    """
    global launches
    _check(y, centers)
    if y.device.type == "cpu":
        return assign_bins_plain(y, centers)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    n, d = y.shape
    k = centers.shape[0]
    if d > MAX_D or k * (d + 1) > MAX_SHARED_FLOATS:
        raise ValueError(
            f"the assign kernel takes D <= {MAX_D} and K * (D + 1) <= "
            f"{MAX_SHARED_FLOATS}, got D = {d}, K = {k}"
        )
    y = y.detach().to(torch.float32).contiguous()
    c = centers.detach().to(torch.float32).contiguous()
    out = torch.empty((n,), dtype=torch.int32, device=y.device)
    if n == 0:
        return out
    plan = _assign_plan(n, d, k, _sms(y.device.index))
    err = _build.load().mmr_assign(
        y.data_ptr(), c.data_ptr(), out.data_ptr(), n, d, k, plan.blocks, plan.tiles,
        plan.smem, *_build.launch_args(y),
    )
    _build.check(err, "assign kernel")
    launches += 1
    return out
