"""Fused ResNet stem tail: BN affine + ReLU + 3x3/2 max-pool, with its backward.

Port of the JAX package's ops/stem_pool.py. The BN is folded into a
per-channel affine (a, b) (ops.fused_conv_bn.fold_bn; running statistics in
eval mode, batch statistics in training) and the kernels
(csrc/stem_pool.cu) compute

    forward:   p = maxpool3x3/2 pad 1(relu(y * a + b))     read y, write p
    backward:  dy = route(g) * relu_mask * a               read g and y, write dy
               da = sum gz * y, db = sum gz                 (float32)

each in one pass over shared-memory halo tiles of y: a block copies the y
rows and columns a tile of pooled positions touches (16-byte cp.async, the
next tile's copies in flight while it works on this one), forms z =
relu(y * a + b) from them and takes the windows' max (forward) or argmax
(backward, kept in shared memory, never in device memory); the backward
gathers g into a 2 x 2 quad of y under each pooled position; p and dy are
written in 16-byte chunks. The backward's da, db are per-block partials
summed in a fixed order by a second launch. `_stem_plan` picks the launch
shape. They sit in a torch.autograd.Function (the JAX custom VJP), so the
trunk trains through them. The plain version is `_composite` (affine, ReLU,
max_pool2d as three eager ops) and, for the backward, its autograd vjp
(`_plain_bwd`). The forward kernel is bit-identical to `_composite`; the
backward routes each pooled gradient exactly as max_pool2d's backward does
and differs from the plain vjp by float32 rounding only (it multiplies by a
and sums in float32 before the one rounding to y's dtype).

The forward kernel is the custom op `mmr::stem_pool_fwd` (torch.library),
so torch.export traces it into a serving program: its CUDA implementation
launches the kernel and counts the launch, its CPU implementation is
`_composite`, its fake implementation gives the channels_last output.
Training reaches it through `_StemPool`; a call that needs no gradient
(eval, serving, export) calls the op directly.

Layout: y is a (B, C, H, W) tensor in torch.channels_last memory format —
physically NHWC, as the trunk's conv1 writes it — with even H and W (the
JAX kernel's contract). p and dy are channels_last too; an incoming
gradient that is not is made so before the backward kernel.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from multi_modal_regression_tpu_torch.ops import _build

_IS_BF16 = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches in this process, counted where each kernel is launched
launches = 0  # forward
bwd_launches = 0  # backward

# the kernels' launch shape (csrc/stem_pool.cu holds the same constants):
# at most 256 threads a block; blocks an SM the forward and the backward are
# planned for (their __launch_bounds__); the H100's 132 SMs and 228 KB of
# shared memory an SM, 1 KB of it reserved per block; tiles of pooled
# positions (rows x columns) in order of preference; at most 32 chunks (16
# bytes, or one value) of a pixel a block
_STEM_THREADS, _STEM_FWD_PER_SM, _STEM_BWD_PER_SM = 256, 3, 2
_SMS, _SMEM_SM, _SMEM_RESERVED = 132, 228 * 1024, 1024
_STEM_TILES = ((8, 8), (4, 8), (4, 4), (2, 4), (2, 2), (1, 2), (1, 1))
_STEM_MAX_CHUNKS = 32


class StemTile(NamedTuple):
    """One direction's launch shape: tiles of th x tw pooled positions,
    walked by `blocks` blocks per channel tile (tiles blockIdx.x, +blocks,
    ...), `smem` bytes of dynamic shared memory a block."""

    th: int
    tw: int
    blocks: int
    smem: int


class StemPlan(NamedTuple):
    """Launch shape of the stem kernels: `vec` channels a thread moves at
    once (16 bytes' worth where C * itemsize is a multiple of 16, else 1),
    `cc` channels a block (grid y: ceil(C / cc) channel tiles), `threads` a
    block (cc / vec chunks a pixel x threads / chunks threads a chunk), and
    the forward's and backward's tiles."""

    vec: int
    cc: int
    threads: int
    fwd: StemTile
    bwd: StemTile


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def _stem_smem(th: int, tw: int, cc: int, itemsize: int, threads: int, vec: int,
               backward: bool) -> int:
    """A block's shared memory, as csrc/stem_pool.cu lays it out, each part
    16-byte aligned. Forward: two slots (the next tile's copies land in one
    while the block works in the other) of the z halo, (2 th + 1) x (2 tw +
    1) pixels x cc channels. Backward: two slots of the y halo, (2 th + 3) x
    (2 tw + 3) pixels, and of the g of the (th + 1) x (tw + 1) windows; the
    windows' argmax bytes; each chunk's affine (at most 8 bytes a channel)
    and the float32 a; at least the da, db sums of the block's threads
    (threads x vec x 2 floats)."""
    if not backward:
        return 2 * _align16((2 * th + 1) * (2 * tw + 1) * cc * itemsize)
    halo = _align16((2 * th + 3) * (2 * tw + 3) * cc * itemsize)
    win = (th + 1) * (tw + 1) * cc
    layout = 2 * halo + 2 * _align16(win * itemsize) + _align16(win)
    return max(layout + _align16(8 * cc) + _align16(4 * cc), 8 * vec * threads)


def _stem_tile(bsz: int, oh: int, ow: int, cc: int, itemsize: int, threads: int, vec: int,
               backward: bool) -> StemTile:
    """The first tile of `_STEM_TILES` (cut to the pooled image) whose shared
    memory lets the planned blocks share an SM; as few blocks as walk the
    tiles in as many steps as that many blocks on every SM would."""
    per_sm = _STEM_BWD_PER_SM if backward else _STEM_FWD_PER_SM
    for th, tw in _STEM_TILES:
        th, tw = min(th, oh), min(tw, ow)
        smem = _stem_smem(th, tw, cc, itemsize, threads, vec, backward)
        if per_sm * (smem + _SMEM_RESERVED) <= _SMEM_SM:
            break
    tiles = bsz * -(-oh // th) * -(-ow // tw)
    walk = -(-tiles // (_SMS * per_sm))  # tiles a block
    return StemTile(th, tw, -(-tiles // walk), smem)


@functools.lru_cache(maxsize=None)  # a wrapper call costs the host only a lookup
def _stem_plan(bsz: int, h: int, w: int, c: int, itemsize: int,
               aligned: bool = True) -> StemPlan:
    """Launch shape of both stem kernels for y (bsz, c, h, w) of `itemsize`
    bytes (4 float32, 2 bfloat16). 16-byte chunks where C * itemsize is a
    multiple of 16 and the tensors are `aligned` to 16 bytes, else one value
    a chunk; all C channels a block up to 32 chunks a pixel, else channel
    tiles of 32 chunks; threads whole groups of cc / vec; tiles from
    `_stem_tile`. The kernels' tile indices and their offsets inside a tile
    are 32-bit: raises where the tiles number 2**31 or more, or a tile's
    halo rows, (2 th + 3) rows of W x C elements, do not fit."""
    vec = 16 // itemsize if aligned and (c * itemsize) % 16 == 0 else 1
    cc = min(c, _STEM_MAX_CHUNKS * vec)
    nch = cc // vec
    threads = nch * max(1, _STEM_THREADS // nch)
    oh, ow = h // 2, w // 2
    plan = StemPlan(vec, cc, threads,
                    _stem_tile(bsz, oh, ow, cc, itemsize, threads, vec, False),
                    _stem_tile(bsz, oh, ow, cc, itemsize, threads, vec, True))
    for tile in (plan.fwd, plan.bwd):
        if bsz * -(-oh // tile.th) * -(-ow // tile.tw) >= 2**31:
            raise ValueError(f"B = {bsz} gives the stem kernels too many tiles")
        if (2 * tile.th + 3) * w * c >= 2**31:
            raise ValueError(f"W * C = {w * c} is too large for the stem kernels' 32-bit "
                             "offsets inside a tile")
    return plan


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _composite(y: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: affine in y's dtype, ReLU, max-pool 3x3/2 pad 1."""
    z = torch.relu(
        y * a.to(y.dtype)[:, None, None] + b.to(y.dtype)[:, None, None]
    )
    return F.max_pool2d(z, 3, stride=2, padding=1)


def _plain_bwd(g, y, a, b) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward: the autograd vjp of `_composite` at (y, a, b)."""
    _, vjp = torch.func.vjp(_composite, y, a, b)
    return vjp(g)


def _check_kernel_args(y, a, b) -> None:
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    if y.dtype not in _IS_BF16:
        raise TypeError(f"the stem kernels take float32 or bfloat16, not {y.dtype}")
    c = y.shape[1]
    for name, t in (("a", a), ("b", b)):
        if (t.dtype != torch.float32 or t.shape != (c,) or t.device != y.device
                or not t.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous float32 ({c},) tensor on {y.device}"
            )


def _forward(y, a, b) -> torch.Tensor:
    """The forward kernel on a CUDA tensor, `_composite` on a CPU tensor
    (the op `mmr::stem_pool_fwd`)."""
    if y.device.type == "cuda":
        _check_kernel_args(y, a, b)
    return torch.ops.mmr.stem_pool_fwd(y, a, b)


def _pooled_like(y: torch.Tensor) -> torch.Tensor:
    bsz, c, h, w = y.shape
    return torch.empty((bsz, c, h // 2, w // 2), dtype=y.dtype, device=y.device,
                       memory_format=torch.channels_last)


@torch.library.custom_op("mmr::stem_pool_fwd", mutates_args=(), device_types="cuda")
def _stem_pool_fwd(y: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The forward kernel launch (CUDA implementation of the op), on y made
    channels_last (a no-op for the trunk's conv1 output; an exported
    program's runtime layout is the card's)."""
    global launches
    y = y.contiguous(memory_format=torch.channels_last)
    bsz, c, h, w = y.shape
    out = _pooled_like(y)
    if out.numel() == 0:
        return out
    plan = _stem_plan(bsz, h, w, c, y.element_size(), _aligned(y, out))
    err = _build.load().mmr_stem_fwd(
        y.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(),
        bsz, h, w, c, _IS_BF16[y.dtype], plan.vec, plan.cc, plan.fwd.th, plan.fwd.tw,
        plan.threads, plan.fwd.blocks, *_build.launch_args(y),
    )
    _build.check(err, "stem kernel")
    launches += 1
    return out


@_stem_pool_fwd.register_kernel("cpu")
def _(y: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _composite(y, a, b)


@_stem_pool_fwd.register_fake
def _(y: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _pooled_like(y)


def stem_pool_bwd(
    g: torch.Tensor, y: torch.Tensor, a: torch.Tensor, b: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dy, da, db) of maxpool3x3/2(relu(y * a + b)) for the output gradient g.

    On a CUDA tensor: the backward kernel (y channels_last, float32 or
    bfloat16; g is made channels_last, a copy only if it is not). On a CPU
    tensor: `_plain_bwd`.
    """
    global bwd_launches
    if y.device.type == "cpu":
        return _plain_bwd(g, y, a, b)
    _check_kernel_args(y, a, b)
    bsz, c, h, w = y.shape
    if g.shape != (bsz, c, h // 2, w // 2) or g.dtype != y.dtype or g.device != y.device:
        raise ValueError(
            f"g must be {y.dtype} {(bsz, c, h // 2, w // 2)} on {y.device}, got "
            f"{g.dtype} {tuple(g.shape)} on {g.device}"
        )
    g = g.contiguous(memory_format=torch.channels_last)
    dy = torch.empty_like(y, memory_format=torch.channels_last)
    if y.numel() == 0:
        return dy, torch.zeros_like(a), torch.zeros_like(b)
    dab = torch.empty((2, c), dtype=torch.float32, device=y.device)
    plan = _stem_plan(bsz, h, w, c, y.element_size(), _aligned(g, y, dy))
    partial = torch.empty((plan.bwd.blocks, 2, c), dtype=torch.float32, device=y.device)
    err = _build.load().mmr_stem_bwd(
        g.data_ptr(), y.data_ptr(), a.data_ptr(), b.data_ptr(), dy.data_ptr(),
        partial.data_ptr(), dab.data_ptr(), bsz, h, w, c, _IS_BF16[y.dtype], plan.vec,
        plan.cc, plan.bwd.th, plan.bwd.tw, plan.threads, plan.bwd.blocks,
        *_build.launch_args(y),
    )
    _build.check(err, "stem backward kernel")
    bwd_launches += 1
    return dy, dab[0], dab[1]


class _StemPool(torch.autograd.Function):
    """Forward: `_forward`; backward: `stem_pool_bwd` (the JAX custom VJP)."""

    @staticmethod
    def forward(ctx, y, a, b):
        ctx.save_for_backward(y, a, b)
        return _forward(y, a, b)

    @staticmethod
    def backward(ctx, g):
        return stem_pool_bwd(g, *ctx.saved_tensors)


def stem_bn_relu_pool(
    y: torch.Tensor, a: torch.Tensor, b: torch.Tensor, impl: str = "kernel"
) -> torch.Tensor:
    """maxpool3x3/2(relu(y * a + b)); y (B, C, H, W), a, b (C,) float32.

    impl 'plain': `_composite` under plain autograd (the JAX 'xla'
    counterpart), any layout. impl 'kernel' (the JAX 'pallas' counterpart):
    y must be channels_last with even H and W, and the call goes through
    `_StemPool`: on a CUDA tensor both directions run the kernels (float32
    or bfloat16); on a CPU tensor, their plain versions. Anything else
    raises.
    """
    if impl == "plain":
        return _composite(y, a, b)
    if impl != "kernel":
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    if y.ndim != 4:
        raise ValueError(f"expected (B, C, H, W), got {tuple(y.shape)}")
    h, w = y.shape[2:]
    if h % 2 or w % 2:
        raise ValueError(f"the stem kernel needs even H and W, got {h}x{w}")
    # a traced layout (torch.export) need not be the one the card gives: the
    # op's CUDA implementation makes y channels_last, a no-op when it is
    if not y.is_contiguous(memory_format=torch.channels_last) and \
            not torch.compiler.is_compiling():
        raise ValueError("the stem kernel needs y in torch.channels_last")
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {y.device}")
    if torch.is_grad_enabled() and (y.requires_grad or a.requires_grad or b.requires_grad):
        return _StemPool.apply(y, a, b)
    return _forward(y, a, b)
