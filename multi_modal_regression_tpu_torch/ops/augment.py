"""On-device image resize and flip (port of the JAX package's ops/augment.py).

A separable bilinear resize is a fixed matrix per axis, so resizing a
batch is two products:

    out[b, o, p, c] = Wr[o, h] * x[b, h, w, c] * Wc[p, w]

The matrices follow PIL's antialiased BILINEAR (half-pixel centers, a
triangle filter whose support widens by the ratio when downscaling, taps
outside the image excluded and the row renormalized), so the device path
reproduces the host loader's pixels up to float32 rounding. The JAX package
computes the products outside any Pallas kernel; here they are two float32
`torch.einsum` calls. A horizontal flip is a per-sample select on the
reversed width axis, with the pose's (az, el, ct) -> (-az, el, -ct)
(setupDataFlipped_pascal3d.m:117-121).

`device_preprocess` chains resize -> flip -> the plain normalize
(data.loader.normalize_images) on float 0..255 values, as the JAX package's
does: its normalize kernel never sees a resized batch, and neither does
the port's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from multi_modal_regression_tpu_torch.data.loader import normalize_images


@functools.lru_cache(maxsize=32)
def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) PIL-BILINEAR weights (antialiased when downscaling),
    built in float64 and returned in float32, as the JAX package builds
    them: a triangle filter of half-width max(1, n_in / n_out), its window
    clipped to the image and each row renormalized over the taps inside."""
    scale = n_in / n_out
    fs = max(1.0, scale)
    support = 1.0 * fs  # bilinear support x filter scale
    W = np.zeros((n_out, n_in), np.float64)
    for o in range(n_out):
        center = (o + 0.5) * scale
        lo = max(0, int(center - support + 0.5))
        hi = min(n_in, int(center + support + 0.5))
        for i in range(lo, hi):
            W[o, i] = max(0.0, 1.0 - abs((i + 0.5 - center) / fs))
    W /= W.sum(axis=1, keepdims=True)
    return W.astype(np.float32)


def resize_images(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(B, H, W, C) uint8 or float -> (B, out_h, out_w, C) float32, by two
    float32 products on the tensor's device."""
    _, h, w, _ = x.shape
    xf = x.to(torch.float32)
    Wr = torch.from_numpy(_resize_matrix(h, out_h)).to(x.device)
    Wc = torch.from_numpy(_resize_matrix(w, out_w)).to(x.device)
    y = torch.einsum("oh,bhwc->bowc", Wr, xf)
    return torch.einsum("pw,bowc->bopc", Wc, y)


def flip_images(x: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Flip horizontally the samples of (B, H, W, C) where flip (B,) bool
    is True."""
    return torch.where(flip[:, None, None, None], x.flip(2), x)


def flip_pose_euler(euler: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """The flip's pose: (az, el, ct) -> (-az, el, -ct) where flip is True
    (setupDataFlipped_pascal3d.m:121)."""
    sign = torch.where(flip, -1.0, 1.0).to(euler.dtype)[:, None]
    return euler * torch.cat([sign, torch.ones_like(sign), sign], dim=-1)


def device_preprocess(
    x_uint8: torch.Tensor, out_size: int | None = None,
    flip: torch.Tensor | None = None, dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """resize (when out_size differs from the batch's size) -> flip ->
    normalize, all on the batch's device; the normalize is the plain one,
    on the float 0..255 values the resize gives."""
    x = x_uint8
    if out_size is not None and tuple(x.shape[1:3]) != (out_size, out_size):
        x = resize_images(x, out_size, out_size)
    if flip is not None:
        x = flip_images(x, flip)
    return normalize_images(x, dtype=dtype)
