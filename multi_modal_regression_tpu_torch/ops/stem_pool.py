"""Fused ResNet stem tail, forward: BN affine + ReLU + 3x3/2 max-pool.

Port of the JAX package's ops/stem_pool.py. In eval mode the stem
BN is folded into a per-channel affine (a, b) (ops.fused_conv_bn.fold_bn)
and the kernel (csrc/stem_pool.cu) computes

    p = maxpool3x3/2 pad 1(relu(y * a + b))

in one pass: read y, write p. The plain version `_composite` is three eager
passes (affine, ReLU, max_pool2d) and is bit-identical to the kernel.

Layout: y is a (B, C, H, W) tensor in torch.channels_last memory format —
physically NHWC, as the trunk's conv1 writes it — with even H and W (the
JAX kernel's contract). The output is (B, C, H/2, W/2), channels_last.

Serving needs no gradient, so there is no backward kernel yet: impl
'kernel' raises when autograd would record it. The backward kernel
(JAX `_stem_bwd`) comes with the training step (ROADMAP.md).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from multi_modal_regression_tpu_torch.ops import _build

_IS_BF16 = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches in this process, counted where the kernel is launched
launches = 0


def _composite(y: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: affine in y's dtype, ReLU, max-pool 3x3/2 pad 1."""
    z = torch.relu(
        y * a.to(y.dtype)[:, None, None] + b.to(y.dtype)[:, None, None]
    )
    return F.max_pool2d(z, 3, stride=2, padding=1)


def stem_bn_relu_pool(
    y: torch.Tensor, a: torch.Tensor, b: torch.Tensor, impl: str = "kernel"
) -> torch.Tensor:
    """maxpool3x3/2(relu(y * a + b)); y (B, C, H, W), a, b (C,) float32.

    impl 'plain': `_composite` (the JAX 'xla' counterpart), any layout.
    impl 'kernel' (the JAX 'pallas' counterpart): y must be channels_last
    with even H and W. On a CUDA tensor the kernel runs (float32 or
    bfloat16); on a CPU tensor, `_composite`. Anything else raises.
    """
    global launches
    if impl == "plain":
        return _composite(y, a, b)
    if impl != "kernel":
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    if y.ndim != 4:
        raise ValueError(f"expected (B, C, H, W), got {tuple(y.shape)}")
    bsz, c, h, w = y.shape
    if h % 2 or w % 2:
        raise ValueError(f"the stem kernel needs even H and W, got {h}x{w}")
    if not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("the stem kernel needs y in torch.channels_last")
    if torch.is_grad_enabled() and (
        y.requires_grad or a.requires_grad or b.requires_grad
    ):
        raise RuntimeError(
            "the stem kernel has no backward yet; call it under torch.no_grad()"
        )
    if y.device.type == "cpu":
        return _composite(y, a, b)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    if y.dtype not in _IS_BF16:
        raise TypeError(f"the stem kernel takes float32 or bfloat16, not {y.dtype}")
    for name, t in (("a", a), ("b", b)):
        if (t.dtype != torch.float32 or t.shape != (c,) or t.device != y.device
                or not t.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous float32 ({c},) tensor on {y.device}"
            )
    out = torch.empty(
        (bsz, c, h // 2, w // 2), dtype=y.dtype, device=y.device,
        memory_format=torch.channels_last,
    )
    if out.numel() == 0:
        return out
    lib = _build.load()
    err = lib.mmr_stem_fwd(
        y.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(),
        bsz, h, w, c, _IS_BF16[y.dtype], *_build.launch_args(y),
    )
    _build.check(err, "stem kernel")
    launches += 1
    return out
