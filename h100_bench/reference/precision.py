"""The arithmetic of the reference's products, and the control's.

`FLOAT32` computes everything in float32 (the caller turns TF32 off).
`FP8` is the comparison's control: the nearest precision below the
configurations' bfloat16. Every tensor the model computes (each
convolution's and product's operands and output, each BN's, ReLU's, pool's
and residual sum's output), and in training the gradient that flows back
through it, is rounded to float8 e4m3 under a scale of its own (its largest
magnitude onto e4m3's range), as a bfloat16 program rounds each of them to
bfloat16; products accumulate in float32, as an fp8 tensor-core path does. The loss and the optimizer stay in float32, as the
program keeps them. `BF16` rounds the same tensors to bfloat16 instead: the
configurations' own precision in the reference's hands, a second witness
beside the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def _e4m3(t: torch.Tensor) -> torch.Tensor:
    amax = t.abs().amax().clamp(min=1e-30)
    scale = E4M3_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale


class _Fp8Round(torch.autograd.Function):
    """The tensor rounded to e4m3 in the forward, and the gradient that
    flows back through it in the backward, as an fp8 training step keeps
    its activations' gradients in fp8."""

    @staticmethod
    def forward(ctx, t):
        return _e4m3(t)

    @staticmethod
    def backward(ctx, g):
        return _e4m3(g)


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under a per-tensor scale, back in t's dtype."""
    return _Fp8Round.apply(t)


class _Bf16Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.to(torch.bfloat16).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


class Precision:
    def __init__(self, name: str):
        if name not in ("float32", "bf16", "fp8"):
            raise ValueError(f"unknown reference precision {name!r}")
        self.name = name

    def act(self, t: torch.Tensor) -> torch.Tensor:
        """A computed tensor, rounded to the precision."""
        if self.name == "fp8":
            return fp8_round(t)
        return _Bf16Round.apply(t) if self.name == "bf16" else t

    def conv(self, x, w, stride: int, pad: int) -> torch.Tensor:
        return self.act(F.conv2d(self.act(x), self.act(w), stride=stride, padding=pad))

    def matmul(self, a, b) -> torch.Tensor:
        return self.act(torch.matmul(self.act(a), self.act(b)))


FLOAT32 = Precision("float32")
BF16 = Precision("bf16")  # the configurations' own precision: a witness, not a control
FP8 = Precision("fp8")


class no_tf32:
    """float32 products in float32: TF32 off inside, the caller's setting after."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
