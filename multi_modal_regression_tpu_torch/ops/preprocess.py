"""Fused image preprocessing: uint8 (B, H, W, 3) -> normalized f32 or bf16.

Port of the JAX package's ops/preprocess.py. The kernel
(csrc/normalize.cu) computes the TPU kernel's form

    out = x * scale[c] + offset[c],  scale = 1/(255*std), offset = -mean/std

in one pass over the uint8 batch on the card, with the output written
directly in the model's compute dtype. Its plain version, and the reference
it is tested against, is data.loader.normalize_images, (x/255 - mean)/std:
the two differ by float32 rounding only (<= 1 bf16 ulp after the cast).
"""

from __future__ import annotations

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

# kernel launches in this process, counted where the kernel is launched
launches = 0


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
    lib = _build.load()
    err = lib.mmr_normalize_u8(
        x_u8.data_ptr(), out.data_ptr(), x_u8.numel(), _OUT_BF16[dtype],
        *SCALE.tolist(), *OFFSET.tolist(), *_build.launch_args(x_u8),
    )
    _build.check(err, "normalize kernel")
    launches += 1
    return out
