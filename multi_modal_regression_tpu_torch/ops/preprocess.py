"""Fused image preprocessing: uint8 (B, H, W, 3) -> normalized f32 or bf16.

Port of the JAX package's ops/preprocess.py. The kernel
(csrc/normalize.cu) computes the TPU kernel's form

    out = x * scale[c] + offset[c],  scale = 1/(255*std), offset = -mean/std

in one pass over the uint8 batch on the card, 48-byte groups a thread in
16-byte accesses, with the output written directly in the model's compute
dtype; `_normalize_plan` picks the launch shape. Its plain version, and the
reference it is tested against, is data.loader.normalize_images, (x/255 -
mean)/std: the two differ by float32 rounding only (<= 1 bf16 ulp after the
cast). `normalize_affine_plain` repeats the kernel's own arithmetic in
eager ops and gives its bits; the tests and chip_smoke.py hold the kernel
to it, and the main path never calls it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from multi_modal_regression_tpu_torch.data.loader import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    normalize_images,
)
from multi_modal_regression_tpu_torch.ops import _build

# float32, computed as the TPU kernel's _periodic_scale_offset does
SCALE = (1.0 / (255.0 * IMAGENET_STD)).astype(np.float32)
OFFSET = (-IMAGENET_MEAN / IMAGENET_STD).astype(np.float32)

_OUT_BF16 = {torch.float32: 0, torch.bfloat16: 1}

# the kernel's launch shape (csrc/normalize.cu holds the same constants):
# 256 threads a block, each taking one 48-byte group or one 3-byte pixel;
# the most blocks a launch takes (the grid's x limit)
_NORM_THREADS, _NORM_GROUP, _MAX_BLOCKS = 256, 48, 2**31 - 1

# kernel launches in this process, counted where the kernel is launched
launches = 0


class NormalizePlan(NamedTuple):
    """Launch shape of the normalize kernel: `groups` 48-byte groups from
    the first byte, each a thread's three 16-byte loads, then `pixels`
    pixels (3 values, one at a time) a thread each; `blocks` blocks of 256
    threads cover the groups + pixels items."""

    groups: int
    pixels: int
    blocks: int


@functools.lru_cache(maxsize=None)  # a wrapper call costs the host only a lookup
def _normalize_plan(n: int, misalign: int) -> NormalizePlan:
    """Launch shape for n uint8 values (a multiple of 3) at an address that
    is `misalign` bytes past a 16-byte boundary, written to a fresh output
    (16-byte aligned, so the plan is the same for float32 and bfloat16).
    48-byte groups where x is aligned, the n mod 48 values after them a
    pixel a thread; a pixel a thread throughout where it is not. Raises
    where the items need more blocks than a grid holds (2**31 - 1)."""
    if n < 0 or n % 3 or not 0 <= misalign < 16:
        raise ValueError(f"no normalize plan for n = {n}, misalign = {misalign}")
    groups = n // _NORM_GROUP if misalign == 0 else 0
    pixels = (n - _NORM_GROUP * groups) // 3
    blocks = -(-(groups + pixels) // _NORM_THREADS)
    if blocks > _MAX_BLOCKS:
        raise ValueError(f"{n} values are too many for one normalize launch")
    return NormalizePlan(groups, pixels, blocks)


def normalize_affine_plain(x_u8: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's arithmetic in eager ops: `x.float() * SCALE`, then
    `+ OFFSET` (each rounded to float32 on its own), then `.to(dtype)`."""
    scale = torch.from_numpy(SCALE).to(x_u8.device)
    offset = torch.from_numpy(OFFSET).to(x_u8.device)
    return (x_u8.float() * scale + offset).to(dtype)


def normalize_images_cuda(
    x_u8: torch.Tensor, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> normalized (B, H, W, 3) in `dtype`.

    On a CUDA tensor: the kernel, for dtype float32 or bfloat16; the input
    must be contiguous. On a CPU tensor: the plain version. Anything else
    raises.
    """
    global launches
    if x_u8.dtype != torch.uint8 or x_u8.ndim != 4 or x_u8.shape[-1] != 3:
        raise ValueError(
            f"expected uint8 (B, H, W, 3), got {x_u8.dtype} {tuple(x_u8.shape)}"
        )
    if x_u8.device.type == "cpu":
        return normalize_images(x_u8, dtype)
    if x_u8.device.type != "cuda":
        raise ValueError(f"unsupported device {x_u8.device}")
    if dtype not in _OUT_BF16:
        raise TypeError(f"the kernel writes float32 or bfloat16, not {dtype}")
    if not x_u8.is_contiguous():
        raise ValueError("the kernel needs a contiguous (B, H, W, 3) input")
    out = torch.empty(x_u8.shape, dtype=dtype, device=x_u8.device)
    if out.numel() == 0:
        return out
    plan = _normalize_plan(x_u8.numel(), x_u8.data_ptr() % 16)
    err = _build.load().mmr_normalize_u8(
        x_u8.data_ptr(), out.data_ptr(), plan.groups, plan.pixels, plan.blocks,
        _OUT_BF16[dtype], *SCALE.tolist(), *OFFSET.tolist(), *_build.launch_args(x_u8),
    )
    _build.check(err, "normalize kernel")
    launches += 1
    return out
