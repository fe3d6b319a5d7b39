"""Fused conv + BatchNorm ops (port of the JAX package's ops/fused_conv_bn.py).

For the 1x1 and the stride-1 3x3 convolutions of a ResNet bottleneck block
in training:

    forward:   xhat = relu(x * a + b)      the folded BN of the PREVIOUS conv,
                                           applied in bf16 while x is read
               y    = conv(xhat, w)        bf16 operands, float32 accumulation,
                                           rounded to bf16
               sums = [sum y, sum y^2]     per output channel, float32, of the
                                           ROUNDED y, in the pass that writes y

so the BN statistics of y cost no pass of their own and xhat is never
materialized. The moments are formed from `sums` outside
(`stats_to_moments`), so autograd routes d(mean), d(var) back into the conv
through the `sums` cotangent. The backward recomputes xhat from x and forms

    gy_eff = bf16(gy + gs[0] + 2 * y * gs[1])
    dxh = conv^T(gy_eff, w);  dz = dxh where z > 0 (z the recomputed bf16
    pre-activation);  dx = bf16(dz * a);  da = sum dz * x;  db = sum dz
    dw = xhat^T gy_eff in float32

The kernels are csrc/fused_mm.cu (1x1: forward `_mm_stats`, backward
`_mm_stats_bwd`) and csrc/fused_c3.cu (3x3: `_c3_fwd`, `_c3_bwd`); each has
its plain PyTorch version beside it here (`_mm_plain`, `_mm_bwd_plain`,
`_c3_plain`, `_c3_bwd_plain`), which computes the same function with the same
bf16 roundings (prologue, gy_eff, y) and float32 products, so kernel and
plain differ only in the order of float32 accumulation. The backwards are
written out, not autograd of the plain forwards: the JAX custom VJP rounds
gy_eff to bf16 and recomputes the bf16 prologue, and so does this.

impl 'kernel': on a CUDA tensor the kernels run (or the call raises), on a
CPU tensor their plain versions. impl 'plain': the plain versions on any
device, through the same autograd Functions (the JAX 'pallas' and 'xla').

Layout: activations are channels-last and contiguous, (M, K) or
(B, H, W, K) bfloat16, as the JAX package has them. Weights are the torch
parameters: (N, K) or (N, K, 1, 1) for the 1x1, (Cout, C, 3, 3) for the 3x3,
float32 master weights (cast to bf16 once per call); dw comes back in
float32 in the parameter's own layout. The kernels take channel counts that
are multiples of 8 and any number of rows.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from multi_modal_regression_tpu_torch.ops import _build

IMPLS = ("plain", "kernel")

# kernel launches in this process, counted where each wrapper launches
mm_launches = 0  # _mm_stats (1x1 forward)
mm_bwd_launches = 0  # _mm_stats_bwd
c3_launches = 0  # _c3_fwd (3x3 forward)
c3_bwd_launches = 0  # _c3_bwd

# tiles of the kernels: a backward dw block owns a tile of dw (the 3x3:
# 64 x 64, of one row of 3 taps) over a split of the rows, fed 64 rows a ring
# step; partials of da, db are summed in groups of 16 (csrc/sm90_tiles.cuh);
# 264 blocks, 2 per SM of the H100's 132, fill the card, and a block may take
# _SMEM_HALF bytes of shared memory for two to fit an SM (228 KB, 1 KB of it
# reserved per block)
_DW_TILE, _STEP, _GROUP, _FILL = 64, 64, 16, 2 * 132
_SMEM_HALF = 113 * 1024
# cp.async ring slots of the forward kernels, fixed in their sources
# (csrc/sm90_tiles.cuh kStages, csrc/fused_c3.cu kFwdStages)
_MM_FWD_SLOTS, _C3_FWD_SLOTS = 3, 2


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def fold_bn(
    mean: torch.Tensor, var: torch.Tensor, scale: torch.Tensor,
    bias: torch.Tensor, eps: float = 1e-5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, var, scale, bias) -> (a, b) with bn(x) = x * a + b, float32."""
    a = scale.float() * torch.rsqrt(var.float() + eps)
    b = bias.float() - mean.float() * a
    return a, b


def stats_to_moments(
    s: torch.Tensor, count: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(2, N) sums (sum y, sum y^2) -> (mean, biased variance clamped at 0)."""
    mean = s[0] / count
    var = s[1] / count - mean * mean
    return mean, torch.clamp(var, min=0.0)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _prologue(x, ab, relu):
    """(z, xhat): z = x * a + b with a, b, the product and the sum each
    rounded to bf16 (x's dtype), xhat = relu(z) or z. ab None: (None, x)."""
    if ab is None:
        return None, x
    abc = ab.to(x.dtype)
    z = x * abc[0] + abc[1]
    return z, (torch.relu(z) if relu else z)


def _stats(y):
    yf = y.float().reshape(-1, y.shape[-1])
    return torch.stack([yf.sum(dim=0), (yf * yf).sum(dim=0)])


def _gy_eff(gy, y, gs):
    return (gy.float() + gs[0] + 2.0 * y.float() * gs[1]).to(torch.bfloat16)


def _prologue_bwd(dxh, x, z, ab, relu):
    """(dx, dab) from dxh (float32) through the prologue; dab None without one."""
    if ab is None:
        return dxh.to(x.dtype), None
    dz = torch.where(z > 0, dxh, 0.0) if relu else dxh
    red = tuple(range(x.ndim - 1))
    dab = torch.stack([(dz * x.float()).sum(dim=red), dz.sum(dim=red)])
    return (dz * ab[0]).to(x.dtype), dab


def _mm_plain(x, wb, ab, relu):
    """Plain 1x1 forward: x (..., K) bf16, wb (N, K) bf16, ab (2, K) float32
    or None -> (y (..., N) bf16, sums (2, N) float32)."""
    _, xh = _prologue(x, ab, relu)
    y = (xh.float() @ wb.float().t()).to(torch.bfloat16)
    return y, _stats(y)


def _mm_bwd_plain(gy, gs, y, x, wb, ab, relu):
    """Plain 1x1 backward -> (dx bf16, dw (N, K) float32, dab (2, K) or None)."""
    k, n = x.shape[-1], wb.shape[0]
    ge = _gy_eff(gy, y, gs).float()
    z, xh = _prologue(x, ab, relu)
    dxh = ge @ wb.float()
    dw = ge.reshape(-1, n).t() @ xh.float().reshape(-1, k)
    dx, dab = _prologue_bwd(dxh, x, z, ab, relu)
    return dx, dw, dab


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _c3_plain(x, wb, ab, relu):
    """Plain 3x3 forward: x (B, H, W, C) bf16, wb (Cout, C, 3, 3) bf16 ->
    (y (B, H, W, Cout) bf16, sums (2, Cout)); the zero padding comes after
    the prologue."""
    _, xh = _prologue(x, ab, relu)
    y = F.conv2d(_nchw(xh).float(), wb.float(), padding=1)
    y = y.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous()
    return y, _stats(y)


def _c3_bwd_plain(gy, gs, y, x, wb, ab, relu):
    """Plain 3x3 backward -> (dx bf16, dw (Cout, C, 3, 3) float32, dab or None)."""
    ge = _nchw(_gy_eff(gy, y, gs).float())
    z, xh = _prologue(x, ab, relu)
    xs = _nchw(xh).float()
    dxh = torch.nn.grad.conv2d_input(xs.shape, wb.float(), ge, padding=1)
    dw = torch.nn.grad.conv2d_weight(xs, wb.shape, ge, padding=1)
    dx, dab = _prologue_bwd(dxh.permute(0, 2, 3, 1), x, z, ab, relu)
    return dx.contiguous(), dw, dab


# ---------------------------------------------------------------------------
# kernel wrappers: CUDA tensors only; they launch or raise
# ---------------------------------------------------------------------------


def _check_bf16(**tensors) -> torch.device:
    dev = next(iter(tensors.values())).device
    if dev.type != "cuda":
        raise ValueError(f"the fused conv+BN kernels run on CUDA tensors, not {dev}")
    for name, t in tensors.items():
        if t.dtype != torch.bfloat16 or t.device != dev or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous bfloat16 tensor on {dev}, got "
                f"{t.dtype} on {t.device}, contiguous={t.is_contiguous()}"
            )
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return dev


def _check_f32(shape: tuple, dev: torch.device, **tensors) -> None:
    for name, t in tensors.items():
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != shape
                              or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 {shape} tensor on {dev}")


def _check_channels(**counts) -> None:
    for name, c in counts.items():
        if c <= 0 or c % 8:
            raise ValueError(
                f"the fused conv+BN kernels take channel counts that are "
                f"multiples of 8, got {name}={c}"
            )


def _ptr(t):
    return None if t is None else t.data_ptr()


def _dw_splits(m: int, tiles: int, fill: int = _FILL) -> tuple[int, int]:
    """(splits, rows per split) of the backward dw kernels' M dimension:
    split only while the tiles alone fill under half of the `fill` blocks
    the card holds at once (a split costs a pass over float32 partials), no
    more splits than M has 512 rows (8 ring steps), whole 64-row steps."""
    want = max(1, min(_cdiv(m, 8 * _STEP), fill // tiles))
    rows = _cdiv(_cdiv(m, want), _STEP) * _STEP
    return _cdiv(m, rows), rows


class BwdPlan(NamedTuple):
    """Launch shape of a backward call: the dx tile (bm rows x bn channels),
    the dw splits, for the 1x1 the dw tile (tn x tk), for the 3x3 the halo
    (nseg segments of seg_rows)."""

    bm: int
    bn: int
    splits: int
    rows: int
    tn: int = 64
    tk: int = 64
    nseg: int = 0
    seg_rows: int = 0


def _mm_bwd_plan(m: int, k: int, n: int) -> BwdPlan:
    """Kernel #5: dx tiles of 128 x 128, made narrower (bn 64 for K <= 64)
    or shorter until they fill the card; dw tiles of 128 x 128, 64 on a side
    of 64 channels or fewer (so that gy_eff and xhat are formed K / tk and
    N / tn times, not K / 64 and N / 64), split by `_dw_splits`."""
    bn = 128 if k > 64 else 64
    bm = 128
    if _cdiv(m, bm) * _cdiv(k, bn) < _FILL:
        bm = 64
    if _cdiv(m, bm) * _cdiv(k, bn) < _FILL:
        bn = 64
    tn, tk = (128 if n > 64 else 64), (128 if k > 64 else 64)
    fill = _FILL if tn == 64 else _FILL // 2  # tn 128: one block an SM (shared memory)
    splits, rows = _dw_splits(m, _cdiv(n, tn) * _cdiv(k, tk), fill)
    return BwdPlan(bm, bn, splits, rows, tn, tk)


def _c3_bwd_plan(bsz: int, h: int, w: int, c: int, cout: int) -> BwdPlan:
    """Kernel #7: dx tiles of 128 (or, short of filling the card, 64) pixels
    x 64 channels. The halo of gy_eff a tile reads is one run of bm + 2 w + 2
    pixels, or three runs of bm + 2 (`_halo`)."""
    m = bsz * h * w
    bm = 128 if _cdiv(m, 128) * _cdiv(c, 64) >= _FILL else 64
    nseg, seg_rows = _halo(bm, w)
    splits, rows = _dw_splits(m, 3 * _cdiv(cout, _DW_TILE) * _cdiv(c, _DW_TILE))
    return BwdPlan(bm, 64, splits, rows, nseg=nseg, seg_rows=seg_rows)


class FwdPlan(NamedTuple):
    """Launch shape of a forward call: the y tile (bm rows x bn channels),
    the blocks per column tile (mgroups, each taking every mgroups-th row
    tile, one statistics partial each), the splits of the reduction
    (ksplit: of K for the 1x1, of C for the 3x3), for the 3x3 the halo
    (nseg segments of seg_rows)."""

    bm: int
    bn: int
    mgroups: int
    ksplit: int = 1
    nseg: int = 0
    seg_rows: int = 0


def _mgroups(mtiles: int, ntiles: int) -> int:
    """Blocks per column tile: one per row tile, or as many as fill the
    card (two an SM) when there are more tiles, each then walking several
    row tiles through one ring."""
    return min(mtiles, max(1, _FILL // ntiles))


def _ksplit(tiles: int, steps: int) -> int:
    """Splits of the reduction's `steps` ring steps: 1, or, where the tiles
    are fewer than the SMs (2 tiles <= 264 blocks), as many as fill the card
    with at least 2 steps a split. The splits' float32 products are then
    summed in a fixed order before the one rounding (a second pass over
    ksplit M N floats, in place of the statistics' partials)."""
    if 2 * tiles > _FILL:
        return 1
    return max(1, min(steps // 2, _FILL // tiles))


@functools.lru_cache(maxsize=None)  # a wrapper call costs the host only a lookup
def _mm_fwd_plan(m: int, k: int, n: int) -> FwdPlan:
    """Kernel #4: y tiles of 128 x 64 for N <= 64, else 128 x 128, and 64 x
    256 where K is one ring step and N >= 256 (x read and its prologue
    applied once per element, as at layer1); blocks to fill the card
    (`_mgroups`), or, where the tiles would leave SMs idle (as at layer4's
    2048 -> 512), by splitting K (`_ksplit`)."""
    if n <= 64:
        bm, bn = 128, 64
    elif k <= 64 and n >= 256:
        bm, bn = 64, 256
    else:
        bm, bn = 128, 128
    mtiles, ntiles = _cdiv(m, bm), _cdiv(n, bn)
    ksplit = _ksplit(mtiles * ntiles, _cdiv(k, _STEP))
    mgroups = mtiles if ksplit > 1 else _mgroups(mtiles, ntiles)
    return FwdPlan(bm, bn, mgroups, ksplit)


def _halo(bm: int, w: int) -> tuple[int, int]:
    """(nseg, seg_rows) of a 3x3 tile of bm pixels: one run of bm + 2 w + 2
    pixels, or, where that is longer, three runs of bm + 2 around the rows
    above, at and below the tile (so any W fits in shared memory)."""
    return (1, bm + 2 * w + 2) if 2 * w <= 2 * bm + 4 else (3, bm + 2)


@functools.lru_cache(maxsize=None)
def _c3_fwd_plan(bsz: int, h: int, w: int, c: int, cout: int) -> FwdPlan:
    """Kernel #6: tiles of 256 pixels x 64 output channels (each weight tile
    a ring step loads serves 256 pixels), or of 128 where a W so wide that
    the halo of 256 would keep two blocks off an SM; per 16-channel ring
    step one halo of x (`_halo`) and the 9 taps' 64 x 16 weight tiles in
    each of the ring's 2 slots; blocks to fill the card (`_mgroups`), or,
    where the tiles would leave SMs idle (as at layer4's 80 tiles), a split
    of C (`_ksplit`)."""
    for bm in (256, 128):
        nseg, seg_rows = _halo(bm, w)
        stage, other = (nseg * seg_rows + 9 * 64) * 24 * 2, 48 + (bm // 32) * 2 * 64 * 4
        if _C3_FWD_SLOTS * stage + other <= _SMEM_HALF:
            break
    mtiles, otiles = _cdiv(bsz * h * w, bm), _cdiv(cout, 64)
    ksplit = _ksplit(mtiles * otiles, _cdiv(c, 16))  # 16 channels a ring step
    mgroups = mtiles if ksplit > 1 else _mgroups(mtiles, otiles)
    return FwdPlan(bm, 64, mgroups, ksplit, nseg, seg_rows)


def _fwd_scratch(plan: FwdPlan, m: int, n: int, dev) -> torch.Tensor:
    """A forward call's float32 scratch: the statistics' partials (mgroups,
    2, N), or, with a split, the splits' products (ksplit, M, N)."""
    shape = (plan.mgroups, 2, n) if plan.ksplit == 1 else (plan.ksplit, m, n)
    return torch.empty(shape, dtype=torch.float32, device=dev)


def _bwd_scratch(plan: BwdPlan, m: int, k: int, n: int, dw_numel: int, dev, prologue: bool):
    """One buffer for a backward call's scratch, and the addresses in it of
    (ge, part_dw, part_ab, gsum_ab, cnt): gy_eff (M, N) bf16, written once
    by the dw kernel; the float32 dw partials of the splits (None for one
    split); with the prologue, the da, db partials per dx row tile and per
    group of 16 of them, and the groups' int32 arrival counters (zeroed by
    the first launch), else None. Each starts on a 256-byte boundary."""
    mtiles = _cdiv(m, plan.bm)
    groups = _cdiv(mtiles, _GROUP)
    sizes = [2 * m * n, 0 if plan.splits == 1 else 4 * plan.splits * dw_numel]
    sizes += [8 * mtiles * k, 8 * groups * k, 4 * _cdiv(k, plan.bn) * (groups + 1)] if prologue \
        else [0, 0, 0]
    offsets, total = [], 0
    for size in sizes:
        offsets.append(total if size else None)
        total += _cdiv(size, 256) * 256
    buf = torch.empty(total, dtype=torch.uint8, device=dev)
    base = buf.data_ptr()
    return buf, [None if off is None else base + off for off in offsets]


def _mm_stats(x, wb, ab, relu):
    """Kernel #4: x (..., K), wb (N, K) bf16 on the card -> (y, sums)."""
    global mm_launches
    dev = _check_bf16(x=x, w=wb)
    k, n = x.shape[-1], wb.shape[0]
    if wb.shape != (n, k):
        raise ValueError(f"w must be ({n}, {k}), got {tuple(wb.shape)}")
    _check_channels(K=k, N=n)
    _check_f32((2, k), dev, ab=ab)
    m = x.numel() // k
    y = torch.empty((*x.shape[:-1], n), dtype=torch.bfloat16, device=dev)
    if m == 0:
        return y, torch.zeros((2, n), dtype=torch.float32, device=dev)
    if m >= 2**31:
        raise ValueError(f"M = {m} does not fit the kernels' 32-bit row index")
    plan = _mm_fwd_plan(m, k, n)
    sums = torch.empty((2, n), dtype=torch.float32, device=dev)
    partial = _fwd_scratch(plan, m, n, dev)
    err = _build.load().mmr_mm_stats(
        x.data_ptr(), wb.data_ptr(), _ptr(ab), y.data_ptr(), partial.data_ptr(),
        sums.data_ptr(), m, k, n, int(relu), plan.bm, plan.bn, plan.mgroups, plan.ksplit,
        *_build.launch_args(x),
    )
    _build.check(err, "fused 1x1 forward kernel")
    mm_launches += 1
    return y, sums


def _mm_stats_bwd(gy, gs, y, x, wb, ab, relu):
    """Kernel #5 -> (dx, dw (N, K) float32, dab (2, K) or None)."""
    global mm_bwd_launches
    dev = _check_bf16(x=x, w=wb, y=y, gy=gy)
    k, n = x.shape[-1], wb.shape[0]
    if wb.shape != (n, k) or y.shape != (*x.shape[:-1], n) or gy.shape != y.shape:
        raise ValueError(
            f"shapes do not match: x {tuple(x.shape)}, w {tuple(wb.shape)}, "
            f"y {tuple(y.shape)}, gy {tuple(gy.shape)}"
        )
    _check_channels(K=k, N=n)
    _check_f32((2, k), dev, ab=ab)
    _check_f32((2, n), dev, gs=gs)
    m = x.numel() // k
    if m >= 2**31:
        raise ValueError(f"M = {m} does not fit the kernels' 32-bit row index")
    dx = torch.empty_like(x)
    fill = torch.zeros if m == 0 else torch.empty  # the kernels write every element
    dw = fill((n, k), dtype=torch.float32, device=dev)
    dab = None if ab is None else fill((2, k), dtype=torch.float32, device=dev)
    if m == 0:
        return dx, dw, dab
    plan = _mm_bwd_plan(m, k, n)
    scratch, ptrs = _bwd_scratch(plan, m, k, n, n * k, dev, ab is not None)  # held until return
    err = _build.load().mmr_mm_stats_bwd(
        gy.data_ptr(), y.data_ptr(), x.data_ptr(), wb.data_ptr(), gs.data_ptr(),
        _ptr(ab), dx.data_ptr(), dw.data_ptr(), _ptr(dab), *ptrs, m, k, n, int(relu),
        plan.splits, plan.rows, plan.bm, plan.bn, plan.tn, plan.tk, *_build.launch_args(x),
    )
    _build.check(err, "fused 1x1 backward kernel")
    mm_bwd_launches += 1
    return dx, dw, dab


def _taps_first(w):
    """(Cout, C, 3, 3) -> (3, 3, Cout, C) contiguous, the kernels' layout."""
    return w.permute(2, 3, 0, 1).contiguous()


def _c3_shapes(x, wb):
    if x.ndim != 4 or wb.ndim != 4 or wb.shape[1:] != (x.shape[-1], 3, 3):
        raise ValueError(
            f"expected x (B, H, W, C) and w (Cout, C, 3, 3), got {tuple(x.shape)} "
            f"and {tuple(wb.shape)}"
        )
    bsz, h, w, c = x.shape
    if bsz * h * w >= 2**31:
        raise ValueError(f"B*H*W = {bsz * h * w} does not fit the kernels' 32-bit pixel index")
    _check_channels(C=c, Cout=wb.shape[0])
    return bsz, h, w, c, wb.shape[0]


def _c3_fwd(x, wb, ab, relu):
    """Kernel #6: x (B, H, W, C), wb (Cout, C, 3, 3) bf16 on the card -> (y, sums)."""
    global c3_launches
    dev = _check_bf16(x=x, w=wb)
    bsz, h, w, c, cout = _c3_shapes(x, wb)
    _check_f32((2, c), dev, ab=ab)
    m = bsz * h * w
    y = torch.empty((bsz, h, w, cout), dtype=torch.bfloat16, device=dev)
    if m == 0:
        return y, torch.zeros((2, cout), dtype=torch.float32, device=dev)
    sums = torch.empty((2, cout), dtype=torch.float32, device=dev)
    w9 = _taps_first(wb)
    plan = _c3_fwd_plan(bsz, h, w, c, cout)
    partial = _fwd_scratch(plan, m, cout, dev)
    err = _build.load().mmr_c3_fwd(
        x.data_ptr(), w9.data_ptr(), _ptr(ab), y.data_ptr(), partial.data_ptr(),
        sums.data_ptr(), bsz, h, w, c, cout, int(relu), plan.bm, plan.nseg, plan.seg_rows,
        plan.mgroups, plan.ksplit, *_build.launch_args(x),
    )
    _build.check(err, "fused 3x3 forward kernel")
    c3_launches += 1
    return y, sums


def _c3_bwd(gy, gs, y, x, wb, ab, relu):
    """Kernel #7 -> (dx, dw (Cout, C, 3, 3) float32, dab (2, C) or None)."""
    global c3_bwd_launches
    dev = _check_bf16(x=x, w=wb, y=y, gy=gy)
    bsz, h, w, c, cout = _c3_shapes(x, wb)
    if y.shape != (bsz, h, w, cout) or gy.shape != y.shape:
        raise ValueError(f"y and gy must be {(bsz, h, w, cout)}, got "
                         f"{tuple(y.shape)} and {tuple(gy.shape)}")
    _check_f32((2, c), dev, ab=ab)
    _check_f32((2, cout), dev, gs=gs)
    m = bsz * h * w
    dx = torch.empty_like(x)
    fill = torch.zeros if m == 0 else torch.empty  # the kernels write every element
    dw9 = fill((3, 3, cout, c), dtype=torch.float32, device=dev)
    dab = None if ab is None else fill((2, c), dtype=torch.float32, device=dev)
    if m > 0:
        w9 = _taps_first(wb)
        plan = _c3_bwd_plan(bsz, h, w, c, cout)
        scratch, ptrs = _bwd_scratch(  # held until return
            plan, m, c, cout, 9 * cout * c, dev, ab is not None)
        err = _build.load().mmr_c3_bwd(
            gy.data_ptr(), y.data_ptr(), x.data_ptr(), w9.data_ptr(), gs.data_ptr(),
            _ptr(ab), dx.data_ptr(), dw9.data_ptr(), _ptr(dab), *ptrs, bsz, h, w, c, cout,
            int(relu), plan.splits, plan.rows, plan.bm, plan.nseg, plan.seg_rows,
            *_build.launch_args(x),
        )
        _build.check(err, "fused 3x3 backward kernel")
        c3_bwd_launches += 1
    # (kh, kw, Cout, C) -> the parameter's (Cout, C, kh, kw)
    return dx, dw9.permute(2, 3, 0, 1).contiguous(), dab


# ---------------------------------------------------------------------------
# autograd Functions (the JAX custom VJPs)
# ---------------------------------------------------------------------------


def _use_kernel(impl: str, x: torch.Tensor) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return impl == "kernel" and x.device.type == "cuda"


def _check_activation(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.bfloat16:
        raise TypeError(
            f"the fused conv+BN path computes in bfloat16 (y is always written "
            f"in bf16), got {x.dtype}"
        )
    return x.contiguous()


def _stack_ab(a, b, k: int):
    if (a is None) != (b is None):
        raise ValueError("pass both a and b, or neither")
    if a is None:
        return None
    if a.shape != (k,) or b.shape != (k,):
        raise ValueError(f"a and b must be ({k},), got {tuple(a.shape)}, {tuple(b.shape)}")
    return torch.stack([a.float(), b.float()])


class _FusedConvStats(torch.autograd.Function):
    """(y, sums) = conv(relu(x * a + b), w) for the 1x1 or the 3x3
    (`is_3x3`); the backward takes both cotangents (autograd hands zeros for
    one that the loss does not reach)."""

    @staticmethod
    def forward(ctx, x, a, b, w, relu, kernel, is_3x3):
        ab = _stack_ab(a, b, x.shape[-1])
        wb = w.detach().to(torch.bfloat16).reshape(w.shape if is_3x3 else w.shape[:2])
        wb = wb.contiguous()
        if is_3x3:
            y, s = (_c3_fwd if kernel else _c3_plain)(x, wb, ab, relu)
        else:
            y, s = (_mm_stats if kernel else _mm_plain)(x, wb, ab, relu)
        ctx.save_for_backward(x, ab, wb, y)
        ctx.relu, ctx.kernel, ctx.is_3x3, ctx.w_shape = relu, kernel, is_3x3, w.shape
        return y, s

    @staticmethod
    def backward(ctx, gy, gs):
        x, ab, wb, y = ctx.saved_tensors
        gy, gs = gy.contiguous(), gs.float().contiguous()
        if ctx.is_3x3:
            bwd = _c3_bwd if ctx.kernel else _c3_bwd_plain
        else:
            bwd = _mm_stats_bwd if ctx.kernel else _mm_bwd_plain
        dx, dw, dab = bwd(gy, gs, y, x, wb, ab, ctx.relu)
        da, db = (None, None) if dab is None else (dab[0], dab[1])
        return dx, da, db, dw.reshape(ctx.w_shape), None, None, None


def linear_bn_stats(x, a, b, w, relu: bool = True, impl: str = "kernel"):
    """relu(x * a + b) @ w^T with the per-channel (sum, sum of squares) of
    the output.

    x (M, K) or (B, H, W, K) bf16; a, b (K,) float32, the folded BN affine of
    x's producer; w (N, K) or (N, K, 1, 1), the float32 parameter. Returns
    (y (..., N) bf16, sums (2, N) float32), differentiable in x, a, b, w
    through both outputs.
    """
    x = _check_activation(x)
    if not (w.ndim in (2, 4) and w.shape[1] == x.shape[-1]
            and tuple(w.shape[2:]) in ((), (1, 1))):
        raise ValueError(f"w must be (N, {x.shape[-1]}[, 1, 1]), got {tuple(w.shape)}")
    return _FusedConvStats.apply(x, a, b, w, relu, _use_kernel(impl, x), False)


def linear_stats(x, w, impl: str = "kernel"):
    """x @ w^T with the per-channel sums of the output (no prologue)."""
    return linear_bn_stats(x, None, None, w, False, impl)


def conv1x1_bn_stats(x, w, ab=None, *, stride: int = 1, relu: bool = True,
                     impl: str = "kernel"):
    """1x1 conv over NHWC with fused input-BN prologue and stats epilogue.

    x (B, H, W, Cin) bf16; w (Cout, Cin, 1, 1) or (Cout, Cin); ab None or the
    fold_bn() affine (a, b) of x's producer. A stride takes every stride-th
    row and column first, as a contiguous copy (the copy the JAX slice
    makes; the kernels read dense rows). Returns (y (B, H', W', Cout), sums).
    """
    if stride != 1:
        x = x[:, ::stride, ::stride, :]
    if ab is None:
        return linear_stats(x, w, impl)
    return linear_bn_stats(x, ab[0], ab[1], w, relu, impl)


def conv3x3_bn_stats(x, w, ab=None, *, relu: bool = True, impl: str = "kernel"):
    """3x3 stride-1 pad-1 conv with fused input-BN prologue and stats epilogue.

    x (B, H, W, C) bf16; w (Cout, C, 3, 3), the float32 parameter; ab None or
    (a, b). The prologue comes before the zero padding: a border tap adds 0.
    Returns (y (B, H, W, Cout) bf16, sums (2, Cout)).
    """
    x = _check_activation(x)
    if not (x.ndim == 4 and w.ndim == 4 and tuple(w.shape[1:]) == (x.shape[-1], 3, 3)):
        raise ValueError(
            f"w must be (Cout, {x.shape[-1]}, 3, 3) for an NHWC x, got {tuple(w.shape)}")
    a, b = (None, None) if ab is None else ab
    return _FusedConvStats.apply(
        x, a, b, w, relu and ab is not None, _use_kernel(impl, x), True)
