"""Rematerialization for the train step (port of the JAX package's
train/remat.py).

The JAX step wraps its loss in `jax.checkpoint` with a policy that names
what the backward keeps; the rest is recomputed from it. torch's
checkpoint recomputes a checkpointed region whole when the backward first
needs it, so a region as wide as the loss would hold all its activations
again at once, more than no remat keeps. Here each mode is a
`models/checkpoint.Segments` that the trunks take when the model is built
(`use_remat`, from cfg.remat): the trunk runs its stem and each block, or
each stage, as a checkpointed segment (non-reentrant), keeping its input,
and a segment keeps inside only what the mode's policy names:

  none / None   no rematerialization
  block         a segment per block; nothing kept inside (the JAX tags:
                the stem output, each block's output, the pooled features)
  stage         a segment per stage; nothing kept inside
  conv          a segment per block; the outputs of convolutions and matrix
                products kept (a selective-checkpoint policy over aten ops),
                BN, ReLU and the residual adds recomputed
  dots          a segment per block; matrix products kept (none inside a
                ResNet block, so 'block' there; a VGG trunk's fc6 and fc7)
  nothing       a segment per stage; nothing kept inside ('stage': the
                narrowest that cuts the peak, where JAX keeps nothing at all)

The JAX package's tags sit on the ResNet trunk only; a VGG trunk runs each
stage between its max pools and its classifier as segments in every mode.
The heads run outside any segment. The values are those of the step
without remat: only what is kept for the backward, and so the memory and
the recompute, change. The kernels a recomputed forward runs (the stem,
the fused conv+BN ops) launch again in the backward.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

from multi_modal_regression_tpu_torch.models.checkpoint import Segments

REMAT_MODES = ("none", "block", "stage", "conv", "dots", "nothing")

_aten = torch.ops.aten
_DOTS = frozenset({_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm})
_CONVS = _DOTS | frozenset({
    _aten.convolution, _aten._convolution, _aten.cudnn_convolution,
    _aten.mkldnn_convolution, _aten.convolution_overrideable,
})


def check_mode(mode: str | None) -> str | None:
    """The mode, None for no rematerialization ('none' or None); raises for
    an unknown one."""
    if mode not in (None,) + REMAT_MODES:
        raise ValueError(f"remat must be one of {REMAT_MODES}, got {mode!r}")
    return None if mode == "none" else mode


def _saving(ops: frozenset):
    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op.overloadpacket in ops
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return functools.partial(create_selective_checkpoint_contexts, policy)


def remat_policy(mode: str | None) -> Segments | None:
    """The trunks' segments for a config `remat` mode (None: off)."""
    mode = check_mode(mode)
    if mode is None:
        return None
    return {
        "block": Segments("block"),
        "stage": Segments("stage"),
        "conv": Segments("block", _saving(_CONVS)),
        "dots": Segments("block", _saving(_DOTS)),
        "nothing": Segments("stage"),
    }[mode]


def use_remat(model: nn.Module, mode: str | None) -> nn.Module:
    """Give every trunk of `model` that segments its forward (a `remat`
    attribute: ResNetBackbone, VGGBackbone) the segments of `mode`; returns
    the model. A trunk applies them only when gradients are on."""
    policy = remat_policy(mode)
    for m in model.modules():
        if hasattr(m, "remat"):
            m.remat = policy
    return model
