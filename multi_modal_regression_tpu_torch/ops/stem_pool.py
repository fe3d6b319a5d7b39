"""Fused ResNet stem tail: BN affine + ReLU + 3x3/2 max-pool, with its backward.

Port of the JAX package's ops/stem_pool.py. The BN is folded into a
per-channel affine (a, b) (ops.fused_conv_bn.fold_bn; running statistics in
eval mode, batch statistics in training) and the kernels
(csrc/stem_pool.cu) compute

    forward:   p = maxpool3x3/2 pad 1(relu(y * a + b))     read y, write p
    backward:  dy = route(g) * relu_mask * a               read g and y, write dy
               da = sum gz * y, db = sum gz                 (float32)

the forward in one pass, the backward in two (each window's argmax tap,
then a gather per input element). They sit in a torch.autograd.Function (the JAX custom
VJP), so the trunk trains through them. The plain version is `_composite`
(affine, ReLU, max_pool2d as three eager ops) and, for the backward, its
autograd vjp (`_plain_bwd`). The forward kernel is bit-identical to
`_composite`; the backward routes each pooled gradient exactly as
max_pool2d's backward does and differs from the plain vjp by float32
rounding only (it multiplies by a and sums in float32 before the one
rounding to y's dtype).

Layout: y is a (B, C, H, W) tensor in torch.channels_last memory format —
physically NHWC, as the trunk's conv1 writes it — with even H and W (the
JAX kernel's contract). p and dy are channels_last too; an incoming
gradient that is not is made so before the backward kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from multi_modal_regression_tpu_torch.ops import _build

_IS_BF16 = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches in this process, counted where each kernel is launched
launches = 0  # forward
bwd_launches = 0  # backward

# the backward's gather grid: blocks of 32 channels x 8 pixel rows, at most
# ~8 resident blocks on each of the H100's 132 SMs
_BWD_CHANNELS, _BWD_ROWS, _BWD_MAX_BLOCKS = 32, 8, 132 * 8


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
    """The forward kernel on a CUDA tensor, `_composite` on a CPU tensor."""
    global launches
    if y.device.type == "cpu":
        return _composite(y, a, b)
    _check_kernel_args(y, a, b)
    bsz, c, h, w = y.shape
    out = torch.empty(
        (bsz, c, h // 2, w // 2), dtype=y.dtype, device=y.device,
        memory_format=torch.channels_last,
    )
    if out.numel() == 0:
        return out
    err = _build.load().mmr_stem_fwd(
        y.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(),
        bsz, h, w, c, _IS_BF16[y.dtype], *_build.launch_args(y),
    )
    _build.check(err, "stem kernel")
    launches += 1
    return out


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
    nblk = max(1, min(
        -(-bsz * h * w // _BWD_ROWS),
        _BWD_MAX_BLOCKS // -(-c // _BWD_CHANNELS),
    ))
    arg = torch.empty(g.shape, dtype=torch.uint8, device=y.device,
                      memory_format=torch.channels_last)
    partial = torch.empty((nblk, 2, c), dtype=torch.float32, device=y.device)
    err = _build.load().mmr_stem_bwd(
        g.data_ptr(), y.data_ptr(), a.data_ptr(), b.data_ptr(), dy.data_ptr(),
        arg.data_ptr(), partial.data_ptr(), dab.data_ptr(), bsz, h, w, c, nblk,
        _IS_BF16[y.dtype], *_build.launch_args(y),
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
    if not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("the stem kernel needs y in torch.channels_last")
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {y.device}")
    return _StemPool.apply(y, a, b)
