#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: its kernels, serving, training.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card, nvcc and the port
package beside it, and never imports JAX or the JAX package. Phases, one
line each (or more), in order:

  0  device: torch's name for card 0 and nvidia-smi's name + power limit;
     exits non-zero, printing no result, when CUDA is unavailable
  1  build: compiles multi_modal_regression_tpu_torch/csrc/*.cu (ops/_build.py)
  2  normalize kernel at (64|96|17, 224, 224, 3), small shapes (48-byte
     groups and the pixels after them) and a misaligned view (x[1:] of a
     (3, 5, 7, 3) batch): bit-equal to its arithmetic in eager ops
     (normalize_affine_plain), and against the plain normalize_images f32
     within rtol 1e-6 / atol 1e-6, bf16 within 1 ulp; times of both; at 64
     (a request, bf16 and f32) and 96 (a training step's batch, bf16) its
     device time against its bound, and in bf16 the cast alone
     (x.to(torch.bfloat16), the same bytes without the affine) as a
     yardstick on both timers
  3  stem kernel vs its plain version at (64|48|17, 64, 112, 112): f32 and
     bf16, bit-exact; times of both; in bf16 at 64 (a request) and 48 (each
     of a training step's 2 calls) its device time against its bound, and
     the pooling alone (F.max_pool2d on z formed beforehand) as a yardstick
     on both timers; step sums (time x 2 calls at 48)
  3b stem backward kernel vs its plain version (the autograd vjp of the
     three eager ops) at (96|48, 64, 112, 112): f32 within rtol/atol 1e-6
     (dy) and 1e-5 of the largest |da|, |db|; bf16 within the tie tolerance
     (under 1% of dy rerouted, per-channel sums of dy and da, db within 2e-2
     of their largest magnitude); a NaN input; two runs bit-equal; times; in
     bf16 its device time against its bound and the pooling's backward alone
     (aten.max_pool2d_with_indices_backward with the forward's indices) as a
     yardstick on both timers; the record and step sums at 48
  4  serving: the full-width geodesic_bd slice (ResNet50 to layer4, N1 1000,
     N2 500, K 200, 12 classes, 224 px, bf16, stem_pool='kernel') with
     weights from seed 0, random BN running statistics and a 200-atom
     dictionary read back from a .npz; answers 4 requests of 64 images and
     one of 17, checks that each kernel launched once per request, and
     holds the poses, scores and residuals against the plain path; then one
     request in f32 with TF32 off against its plain path
  5  training: Trainer.fit of the full-width geodesic_bd preset (bf16,
     stem_pool='kernel', dual loaders of 4 items x 12 classes = 96 images a
     step, Adam) for 2 warm-up + 2 main steps; exactly 1 normalize, 2 stem
     forward and 2 stem backward launches per step; finite metrics, s moving,
     every BN's running statistics moved; the same 4 steps through the plain
     path (plain normalize, stem_pool='plain') from the same weights within
     TRAIN_TOL; host-clock step time in interleaved pairs, img/s and peak
     memory; then one f32 step with TF32 off and SGD(lr=1), stem kernels vs
     plain stem on the same normalized batch: loss within 1e-4 relative,
     every gradient leaf within 1e-3 of its largest magnitude
  3c fused 1x1 conv kernels (forward with BN prologue and statistics
     epilogue, backward) vs their plain versions, bf16, at all 16 shapes
     that a fused step gives them (tools/time_fused.MM_SHAPES: M 150528 ...
     2352 of a 48-image stream) and one ragged M: y and dx at most 1 bf16
     ulp apart on under 1% of the elements, sums, dw, da, db within
     FUSED_F32_TOL of their largest magnitude; two runs bit-equal; kernel
     times at every shape (plain versions at four of them), the bf16
     products alone through torch.matmul as yardsticks (forward xhat w^T;
     backward's two), and the step sums (time x calls over a step) against
     their bounds
  3d fused 3x3 conv kernels likewise at the 4 stride-1 shapes
     (48,56,56,64) ... (48,7,7,512) with the prologue (products alone:
     F.conv2d on channels-last xhat; torch.nn.grad.conv2d_input +
     conv2d_weight), (48,7,7,512) without it, and one small odd-sized shape
     with and without it
  6  fused training: Trainer.fit of the same preset with
     fused_conv_bn='kernel' for 2 + 2 steps; per step exactly 1 normalize,
     2 stem forward, 2 stem backward, 72 fused 1x1 forward, 72 backward, 26
     fused 3x3 forward, 26 backward launches; finite metrics, s moving,
     every running statistic moved; the same steps through
     fused_conv_bn='plain' from the same weights within FUSED_TRAIN_TOL; the
     first step's loss within 10% of the unfused path's; one request served
     from the trained fused model (eval branch, no fused kernel launched);
     host-clock step time in interleaved pairs against the unfused path of
     [5], img/s and peak memory
  3e assign kernel vs its plain version at (2,000,000, 3) x 200,
     (2,000,000, 4) x 200 and (1,000,003, 3) x 16: equal indices, two runs
     bit-equal; times of both (device time at the two 2,000,000-row shapes),
     and of torch.cdist + argmin on a line of its own; then rows of 2^60,
     inf and NaN (the careful loop for their warp tiles) and a center at
     2^61 (every row careful, timed), K (D + 1) at the limit ((100,000, 2)
     x 4096), a block of duplicate centers, a NaN row and a NaN center
  7  the dictionary path: 2,000,000 axis-angle poses from seeded Euler
     angles; fit_kmeans(K = 200) on the card, depth cut to n_init 1 and 10
     Lloyd steps, then predict and residuals over all poses: the assign
     kernel's launches counted; inertia below the start's, predict equal to
     the plain version's, a second fit from the same seed bit-equal, the
     .npz round trip; fit_gmm(K = 200) on the first 200,000 poses, depth cut
     to n_init 1 and 5 EM steps; `python -m ...cli dictionary` as a
     subprocess on a small generated tree
  8  the soft-bin presets at full width, as [5]: probabilistic_bd over the
     GMM of [7] and relaxed_bd over its kmeans dictionary, 2 main epochs of
     one 96-image step each under epoch_lr_decay 'step' (relaxed_bd after
     its warm-up epoch); 1 normalize, 2 stem forward, 2 stem backward
     launches per step and no assign launch; finite metrics, lc and lr
     nonzero, running statistics moved; the plain path within TRAIN_TOL
     (relaxed_bd's main-phase loss and Lr, which decode through an argmax
     over nearly flat scores, within SOFT_DECODE_TOL)
  10 the user's command: `python -m multi_modal_regression_tpu_torch.cli
     train --preset geodesic_bd` at full width (bf16, 4 items a class per
     stream, 1 warm-up + 2 main epochs of 2 steps) as a subprocess, from PNG
     trees that tools/synthetic writes (12 classes, 224 px, pattern 'pose':
     8-10 images a class per training tree, 24 test images) and [7]'s
     kmeans dictionary: exit 0, checkpoints last, best and final,
     plots.npz of 2 MedErrs, med_err records, a finite final MedErr; the
     restored `final` evaluated here with TF32 off within 1e-3 deg of it;
     one eval pass and one checkpoint write timed; `--resume` in this
     process from step 6 to 12 with exactly one normalize launch per train
     step and per eval batch and no other kernel; labels out of range
     refused on the host (`--num-classes` against `--dbinfo`, and a batch
     with label 12 through Trainer.fit) with the card still usable; the
     decode route, decode img/s at 1, 4 and 8 threads, the img/s of one
     BalancedLoader and of the two zipped, at the CLI's --num-workers,
     against [5]'s step img/s, each beside the card and the host CPU
  9  one JSON line of the kernels (times, plain times and the bound of each:
     the larger of bytes moved over 3.35 TB/s and operations over the peak
     rate of their type), then the result line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

With --profile, [6] also prints the device-time table (torch.profiler) of 3
fused and 3 unfused main steps.

Times are CUDA-event medians over 30 runs (plain versions of the fused and
assign kernels: 10) with the 50 MB L2 flushed before each
(tools/time_fused.cuda_ms), or host-clock medians of requests or steps that
end in a synchronize. A kernel's `ms` takes in the host's gaps between its
launches where the host enqueues them slower than the card runs them; its
`device_ms` holds the card asleep while the host enqueues the call, so the
launches run back to back (device time). Plain versions and the products'
yardsticks are timed both ways too (`plain_ms`, `plain_device_ms`; the
yardsticks' `..._ms` and `..._device_ms`): compare like with like.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import scipy.io as spio
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent))

from multi_modal_regression_tpu_torch import PASCAL3D_CLASSES, cli  # noqa: E402
from multi_modal_regression_tpu_torch.data import loader, native  # noqa: E402
from multi_modal_regression_tpu_torch.data.loader import normalize_images  # noqa: E402
from multi_modal_regression_tpu_torch.data.naming import make_name  # noqa: E402
from multi_modal_regression_tpu_torch.data.targets import euler_to_pose  # noqa: E402
from multi_modal_regression_tpu_torch.dictionary import kmeans  # noqa: E402
from multi_modal_regression_tpu_torch.dictionary.gmm import GMMDictionary, fit_gmm  # noqa: E402
from multi_modal_regression_tpu_torch.dictionary.kmeans import (  # noqa: E402
    KMeansDictionary,
    fit_kmeans,
)
from multi_modal_regression_tpu_torch.models.heads import HeadBatchNorm  # noqa: E402
from multi_modal_regression_tpu_torch.ops import (  # noqa: E402
    _build,
    assign,
    fused_conv_bn,
    preprocess,
    stem_pool,
)
from multi_modal_regression_tpu_torch.serving import make_inference_fn  # noqa: E402
from multi_modal_regression_tpu_torch.tools.synthetic import generate_pose_dataset  # noqa: E402
from multi_modal_regression_tpu_torch.tools.time_fused import (  # noqa: E402
    C3_SHAPES,
    MM_SHAPES,
    REPS,
    cuda_ms,
    fused_inputs,
)
from multi_modal_regression_tpu_torch.train import steps  # noqa: E402
from multi_modal_regression_tpu_torch.train.presets import (  # noqa: E402
    build_model,
    build_problem,
    get_config,
)
from multi_modal_regression_tpu_torch.train.state import TrainState  # noqa: E402
from multi_modal_regression_tpu_torch.train.trainer import Trainer, _interleave  # noqa: E402

PORT = "multi_modal_regression_tpu_torch"
JAX_PACKAGE = PORT.removesuffix("_torch")  # the port is named after the JAX package
# bf16 serving: the normalize kernel rounds differently from its plain
# version (<= 1 bf16 ulp on a few pixels) and bf16 carries that through 50
# layers; scores and residuals must agree within 2% of their largest
# magnitude. f32 with TF32 off: within 1e-4 of it.
SERVE_RTOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# bf16 training, kernel path vs plain path, per step. Each path repeats its
# own bits from run to run, and the forwards agree bit for bit; they differ
# in the stem backward's bf16 rounding (the kernel rounds dy once from
# float32 and sums da, db in float32, as the JAX kernel does; the plain vjp
# rounds gz, a, their product and the da, db sums to bf16). Adam's first
# steps move every weight by about +/-lr whatever its gradient's size, so
# rounding-level gradient differences become lr-sized weight differences,
# and the main phase's Lr decodes poses through an argmax bin, where one
# flipped bin moves Lr by up to pi/96. Measured on an H100: 2.4% on step 2
# (warm-up) and 9% on step 3's Lr. The metrics must agree within 15% (s, a
# log, within 0.15 absolute); the f32 gradient check below is the tight one.
TRAIN_TOL = 0.15
# relaxed_bd's main phase, kernel path vs plain path: Lr is the geodesic loss
# of centers[argmax(scores)] + residual, and its bin scores train against
# RBF soft bins under a KL that averages over all 96 x 200 elements (~0.03),
# so after the one warm-up step they are nearly flat and the argmax is a
# near tie on most rows: on the same batch Lr moves by 15% from one main step
# to the next at a learning rate of 1e-5, on either path. Rounding-level
# differences between the paths flip bins wholesale (measured on an H100: Lr
# 5.6% apart on the first main step, 16% on the second, the same in every
# run; lc, which has no argmax, 0.1%). Loss and Lr of those steps are held
# within 30%, lc and everything else within TRAIN_TOL; probabilistic_bd,
# whose Lr is an expectation under the softmax with no argmax, is held to
# TRAIN_TOL throughout (measured 0.24%).
SOFT_DECODE_TOL = 0.3
# Fused conv+BN kernels vs their plain versions. Both feed the same bf16
# operands to their products and differ in the order of the float32
# accumulation: y and dx at most 1 bf16 ulp apart on under 1% of the
# elements (elements under 1/64 of the largest magnitude, where sums cancel,
# are held to the ulp at that floor); float32 results (sums, dw, da, db)
# within 1e-3 of their largest magnitude.
FUSED_F32_TOL = 1e-3
# Fused training, kernel vs plain, per step. The first step (same weights,
# no update yet) shows the forward alone: the two trunks differ by those
# 1-ulp flips in each of 98 conv outputs and must agree within 3% (measured
# 1.6% on Lr, 0.1% on the loss, the same in every run). From step 2 on
# Adam's +/-lr steps turn rounding-level gradient differences into lr-sized
# weight differences and the argmax decode amplifies them, as in TRAIN_TOL;
# with cuDNN left free to pick float32 backward algorithms that sum with
# atomics, the plain path's own step-2 loss spread over 5.19-5.25 across
# four runs and the worst difference over 3.4-11.8%. So the plain path runs
# with deterministic cuDNN algorithms (then both paths repeat their bits:
# worst difference 2.9% in two runs) and steps 2-4 are held within 20%.
FUSED_TRAIN_TOL = 0.2
# H100 SXM peaks for the bounds: HBM bytes/s, dense bf16 tensor FLOP/s,
# float32 FLOP/s outside the tensor cores
PEAK_BYTES, PEAK_BF16, PEAK_F32 = 3.35e12, 989e12, 67e12


def bound(nbytes: float, ops: float, peak_ops: float) -> dict:
    """The least time the card could take: each input read and each output
    written once over the memory rate, or the operations over their peak."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / peak_ops * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(nbytes), "operations": int(ops),
            "library_ms": None}  # no single PyTorch call computes any of these kernels


def device_ms(fn, flush: torch.Tensor, key: str = "device_ms", reps: int = REPS) -> dict:
    """{key: t}: fn's time with the card asleep while the host enqueues it
    (cuda_ms held), beside the record's `ms` (or `plain_ms`), whose events
    also take in the host's gaps between launches."""
    return {key: cuda_ms(fn, flush, reps, held=True)}


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 ulps between two bf16 tensors."""

    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -32768 - i, i)

    return int((ordered(a) - ordered(b)).abs().max())


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this run needs a GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[0] device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    print(smi)
    return name, smi


def phase_build() -> None:
    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    print(f"[1] build: {path.name} in {time.perf_counter() - t0:.2f} s")


def phase_normalize(dev, flush) -> dict:
    """[2]: the normalize kernel bit-equal to its own arithmetic in eager ops
    (normalize_affine_plain) and within 1e-6 / 1 bf16 ulp of the plain
    normalize_images, at a request's (64, 17), a training step's (96) and
    small shapes, and at a misaligned view; device times against the bound
    and the bf16 cast alone (x.to(torch.bfloat16)) as a yardstick."""
    gen = torch.Generator(device=dev).manual_seed(0)
    rec = {}
    full = torch.randint(0, 256, (3, 5, 7, 3), dtype=torch.uint8, device=dev, generator=gen)
    cases = [(shape, torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen))
             for shape in ((64, 224, 224, 3), (96, 224, 224, 3), (17, 224, 224, 3),
                           (3, 5, 8, 3), (1, 7, 7, 3), (1, 1, 47, 3))]
    cases.append(("x[1:] of (3, 5, 7, 3), 105 bytes in", full[1:]))
    for shape, x in cases:
        for dtype in (torch.float32, torch.bfloat16):
            got = preprocess.normalize_images_cuda(x, dtype)
            same = preprocess.normalize_affine_plain(x, dtype)
            want = normalize_images(x, dtype)
            torch.cuda.synchronize()
            if not torch.equal(got, same):
                raise AssertionError(f"normalize {shape} {dtype}: not bit-equal to its arithmetic")
            err = float((got.float() - want.float()).abs().max())
            if dtype == torch.float32:
                torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
                tol = "rtol 1e-6 atol 1e-6"
            else:
                ulps = bf16_ulps(got, want)
                if ulps > 1:
                    raise AssertionError(f"normalize {shape} bf16: {ulps} ulps apart")
                tol = f"{ulps} ulp <= 1"
            line = (f"[2] normalize {shape} {str(dtype)[6:]}: bit-equal to x * scale + offset; "
                    f"max_abs_err {err:.3g} against normalize_images ({tol})")
            if x.shape[0] >= 17:
                ms = cuda_ms(lambda: preprocess.normalize_images_cuda(x, dtype), flush)
                plain_ms = cuda_ms(lambda: normalize_images(x, dtype), flush)
                line += f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
            if x.shape[0] in (64, 96):
                # 1 byte in, 2 or 4 out, a multiply and an add per value
                n = x.numel()
                timed = {"ms": ms, "plain_ms": plain_ms,
                         **device_ms(lambda: preprocess.normalize_images_cuda(x, dtype), flush),
                         **device_ms(lambda: normalize_images(x, dtype), flush,
                                     "plain_device_ms"),
                         **bound((1 + dtype.itemsize) * n, 2 * n, PEAK_F32)}
                line += (f"; device {timed['device_ms']:.4f} ms against its bound "
                         f"{timed['bound_ms']:.4f} ({timed['bound_by']}: {timed['bytes']} B)")
                if dtype == torch.bfloat16:
                    # the same bytes moved without the affine: a yardstick, not the function
                    timed["cast_only_ms"] = cuda_ms(lambda: x.to(torch.bfloat16), flush)
                    timed.update(device_ms(lambda: x.to(torch.bfloat16), flush,
                                           "cast_only_device_ms"))
                    line += (f"; x.to(bfloat16) alone {timed['cast_only_ms']:.4f} ms, device "
                             f"{timed['cast_only_device_ms']:.4f}")
                if (x.shape[0], dtype) == (64, torch.bfloat16):
                    rec.update(max_abs_err=err, **timed)
                elif x.shape[0] == 64:
                    rec.update({f"f32_{key}": timed[key]
                                for key in ("ms", "device_ms", "bound_ms", "bytes")})
                elif dtype == torch.bfloat16:
                    # one call a training step: the step's sum is this call
                    rec.update({f"step_{key}": timed[key] for key in
                                ("ms", "device_ms", "bound_ms", "bytes", "cast_only_ms",
                                 "cast_only_device_ms")})
            print(line)
    return rec


def _stem_z(y, a, b) -> torch.Tensor:
    """relu(y * a + b) as `_composite` forms it, channels-last: the input of
    the pooling yardsticks."""
    dt = y.dtype
    z = torch.relu(y * a.to(dt)[:, None, None] + b.to(dt)[:, None, None])
    return z.contiguous(memory_format=torch.channels_last)


def step_sums(rec: dict, calls: int, keys) -> dict:
    """{"step_<key>": calls x rec[key]}: a kernel's sums over the step's calls."""
    return {f"step_{key}": calls * rec[key] for key in keys}


def phase_stem(dev, flush) -> dict:
    """[3]: the stem forward kernel at a request's (64 and 17 images) and a
    training stream's (48) shapes, f32 and bf16, bit-exact; times of both.
    In bf16 at 64 and 48 also its device time, its bound and a yardstick on
    both timers: F.max_pool2d on z formed beforehand, one library call for
    the pooling alone (not the same function: no affine, no ReLU; used
    nowhere in the port). Returns the record at 64 with the step sums (2
    calls at 48)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    rec, step = {}, {}
    for shape in ((64, 64, 112, 112), (48, 64, 112, 112), (17, 64, 112, 112)):
        c = shape[1]
        y32 = torch.randn(shape, device=dev, generator=gen).to(
            memory_format=torch.channels_last
        )
        a = torch.rand(c, device=dev, generator=gen) * 1.5 + 0.5
        b = torch.randn(c, device=dev, generator=gen) * 0.1
        for dtype in (torch.float32, torch.bfloat16):
            y = y32.to(dtype)
            got = stem_pool.stem_bn_relu_pool(y, a, b, "kernel")
            want = stem_pool._composite(y, a, b)
            torch.cuda.synchronize()
            if got.shape != want.shape:
                raise AssertionError(f"stem {shape}: shape {tuple(got.shape)}")
            err = float((got.float() - want.float()).abs().max())
            if not torch.equal(got, want):
                raise AssertionError(f"stem {shape} {dtype}: not bit-exact, max err {err}")
            ms = cuda_ms(lambda: stem_pool.stem_bn_relu_pool(y, a, b, "kernel"), flush)
            plain_ms = cuda_ms(lambda: stem_pool._composite(y, a, b), flush)
            print(
                f"[3] stem {shape} {str(dtype)[6:]}: bit-exact, "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
            )
            if dtype != torch.bfloat16 or shape[0] == 17:
                continue
            z = _stem_z(y, a, b)
            pool = lambda: F.max_pool2d(z, 3, stride=2, padding=1)  # noqa: E731
            # y read, p written; 9 taps x (multiply, add, ReLU, max) per output
            timed = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     **device_ms(lambda: stem_pool.stem_bn_relu_pool(y, a, b, "kernel"), flush),
                     **device_ms(lambda: stem_pool._composite(y, a, b), flush,
                                 "plain_device_ms"),
                     "pool_only_ms": cuda_ms(pool, flush),
                     **device_ms(pool, flush, "pool_only_device_ms"),
                     **bound(2 * (y.numel() + got.numel()), 36 * got.numel(), PEAK_F32)}
            del z
            print(
                f"[3] stem {shape} bf16: kernel device {timed['device_ms']:.4f} ms against its "
                f"bound {timed['bound_ms']:.4f} ms ({timed['bound_by']}); plain device "
                f"{timed['plain_device_ms']:.4f} ms; pooling alone (F.max_pool2d on z, a "
                f"yardstick) {timed['pool_only_ms']:.4f} ms (device "
                f"{timed['pool_only_device_ms']:.4f})"
            )
            if shape[0] == 64:
                rec = timed
            else:  # a training step's 2 calls, one a stream
                step = step_sums(timed, 2, ("ms", "device_ms", "bound_ms", "pool_only_ms",
                                            "pool_only_device_ms"))
    print(
        f"[3] stem step sums over 2 calls at 48 images (ms x calls): kernel "
        f"{step['step_ms']:.4f} ms (device {step['step_device_ms']:.4f}) against its bound "
        f"{step['step_bound_ms']:.4f} ms; pooling alone {step['step_pool_only_ms']:.4f} ms "
        f"(device {step['step_pool_only_device_ms']:.4f})"
    )
    return {**rec, **step}


def _stem_bwd_inputs(shape, dev, gen):
    b, c, h, w = shape
    y = torch.randn(shape, device=dev, generator=gen).contiguous(memory_format=torch.channels_last)
    g = torch.randn((b, c, h // 2, w // 2), device=dev, generator=gen).contiguous(
        memory_format=torch.channels_last
    )
    a = torch.rand(c, device=dev, generator=gen) * 1.5 + 0.5
    bb = torch.randn(c, device=dev, generator=gen) * 0.1
    return y, g, a, bb


def check_stem_bwd(tag, got, want, dtype) -> float:
    """Kernel (dy, da, db) against the plain vjp; returns the max |dy| error."""
    (dy, da, db), (pdy, pda, pdb) = got, want
    if dy.shape != pdy.shape or not dy.is_contiguous(memory_format=torch.channels_last):
        raise AssertionError(f"{tag}: dy {tuple(dy.shape)} not channels_last")
    dyf, pdyf = dy.float(), pdy.float()
    err = float((dyf - pdyf).abs().max())
    if dtype == torch.float32:
        torch.testing.assert_close(dy, pdy, rtol=1e-6, atol=1e-6)
        for name, k, p in (("da", da, pda), ("db", db, pdb)):
            e = float((k - p).abs().max())
            if not e <= 1e-5 * float(p.abs().max()):
                raise AssertionError(f"{tag} {name}: max err {e:.3g}")
        print(f"[3b] {tag}: dy max err {err:.3g} (rtol/atol 1e-6), da/db within 1e-5 of max")
        return err
    scale = float(pdyf.abs().max())
    rerouted = float(((dyf - pdyf).abs() > 2e-2 * scale).float().mean())
    sums, psums = dyf.sum(dim=(0, 2, 3)), pdyf.sum(dim=(0, 2, 3))
    sum_err = float((sums - psums).abs().max()) / float(psums.abs().max())
    ab_err = max(float((k.float() - p.float()).abs().max()) / float(p.float().abs().max())
                 for k, p in ((da, pda), (db, pdb)))
    if not (rerouted < 0.01 and sum_err <= 2e-2 and ab_err <= 2e-2):
        raise AssertionError(
            f"{tag}: rerouted {rerouted:.3g}, channel sums {sum_err:.3g}, da/db {ab_err:.3g}"
        )
    print(
        f"[3b] {tag}: {rerouted * 100:.4f}% of dy rerouted (< 1%), channel sums "
        f"{sum_err:.3g}, da/db {ab_err:.3g} of max (<= 2e-2); dy max err {err:.3g}"
    )
    return err


def phase_stem_bwd(dev, flush) -> dict:
    """[3b]: the stem backward kernel at (96|48, 64, 112, 112) against the
    plain vjp; in bf16 also its device time, its bound and a yardstick on
    both timers: aten.max_pool2d_with_indices_backward with the forward's
    indices, one library call for the pooling's backward alone (not the
    same function: no mask, no a, no da, db; used nowhere in the port).
    Returns the record at 48, the shape of each of a training step's 2
    calls, with the step sums."""
    gen = torch.Generator(device=dev).manual_seed(3)
    rec = {}
    for shape in ((96, 64, 112, 112), (48, 64, 112, 112)):
        y32, g32, a, b = _stem_bwd_inputs(shape, dev, gen)
        for dtype in (torch.float32, torch.bfloat16):
            y, g = y32.to(dtype), g32.to(dtype)
            got = stem_pool.stem_pool_bwd(g, y, a, b)
            want = stem_pool._plain_bwd(g, y, a, b)
            again = stem_pool.stem_pool_bwd(g, y, a, b)
            torch.cuda.synchronize()
            tag = f"stem bwd {shape} {str(dtype)[6:]}"
            err = check_stem_bwd(tag, got, want, dtype)
            if not all(torch.equal(u, v) for u, v in zip(got, again)):
                raise AssertionError(f"{tag}: two runs differ")
            del got, want, again
            ms = cuda_ms(lambda: stem_pool.stem_pool_bwd(g, y, a, b), flush)
            plain_ms = cuda_ms(lambda: stem_pool._plain_bwd(g, y, a, b), flush)
            print(f"[3b] {tag}: two runs bit-equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            if dtype != torch.bfloat16:
                continue
            z = _stem_z(y, a, b)
            _, idx = F.max_pool2d(z, 3, stride=2, padding=1, return_indices=True)
            pool = lambda: torch.ops.aten.max_pool2d_with_indices_backward(  # noqa: E731
                g, z, [3, 3], [2, 2], [1, 1], [1, 1], False, idx)
            # g and y read, dy written; per input element the affine, the
            # mask, up to 4 window compares and 3 multiply-adds
            timed = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     **device_ms(lambda: stem_pool.stem_pool_bwd(g, y, a, b), flush),
                     **device_ms(lambda: stem_pool._plain_bwd(g, y, a, b), flush,
                                 "plain_device_ms"),
                     "pool_only_ms": cuda_ms(pool, flush),
                     **device_ms(pool, flush, "pool_only_device_ms"),
                     **bound(2 * (g.numel() + 2 * y.numel()), 14 * y.numel(), PEAK_F32)}
            del z, idx
            print(
                f"[3b] {tag}: kernel device {timed['device_ms']:.4f} ms against its bound "
                f"{timed['bound_ms']:.4f} ms ({timed['bound_by']}); plain device "
                f"{timed['plain_device_ms']:.4f} ms; pooling's backward alone "
                f"(max_pool2d_with_indices_backward, a yardstick) {timed['pool_only_ms']:.4f} ms "
                f"(device {timed['pool_only_device_ms']:.4f})"
            )
            if shape[0] == 48:  # each of a training step's 2 calls
                rec = {**timed, **step_sums(timed, 2, (
                    "ms", "device_ms", "bound_ms", "pool_only_ms", "pool_only_device_ms"))}
    print(
        f"[3b] stem bwd step sums over 2 calls at 48 images (ms x calls): kernel "
        f"{rec['step_ms']:.4f} ms (device {rec['step_device_ms']:.4f}) against its bound "
        f"{rec['step_bound_ms']:.4f} ms; pooling's backward alone {rec['step_pool_only_ms']:.4f} "
        f"ms (device {rec['step_pool_only_device_ms']:.4f})"
    )
    # NaN inputs: NaN wins its windows in both, and propagates into da
    y, g, a, b = _stem_bwd_inputs((4, 8, 16, 12), dev, gen)
    y[0, 0, 5, 5] = y[1, 3, 0, 0] = y[2, 7, 15, 11] = float("nan")
    got = stem_pool.stem_pool_bwd(g, y, a, b)
    want = stem_pool._plain_bwd(g, y, a, b)
    torch.cuda.synchronize()
    for name, k, p in zip(("dy", "da", "db"), got, want):
        if not torch.equal(k.isnan(), p.isnan()):
            raise AssertionError(f"stem bwd NaN case: {name} NaN positions differ")
        torch.testing.assert_close(k.nan_to_num(), p.nan_to_num(), rtol=1e-6, atol=1e-5)
    print(f"[3b] stem bwd NaN inputs: NaN positions equal ({int(got[1].isnan().sum())} channels of da NaN)")
    return rec


def bf16_close(tag: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """The bf16 tolerance of the fused kernels (see FUSED_F32_TOL's note);
    returns the largest absolute error."""
    if got.shape != want.shape or got.dtype != torch.bfloat16:
        raise AssertionError(f"{tag}: shape {tuple(got.shape)} dtype {got.dtype}")
    gf, wf = got.float(), want.float()
    floor = 2.0**-6 * float(wf.abs().max())
    above = wf.abs() >= floor

    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -32768 - i, i)

    ulps = int(torch.where(above, (ordered(got) - ordered(want)).abs(), 0).max())
    low = float(torch.where(above, 0.0, (gf - wf).abs()).max())
    share = float((got != want).float().mean())
    if not (ulps <= 1 and low <= 2.0**-7 * floor and share < 0.01):
        raise AssertionError(
            f"{tag}: {ulps} ulps, {low:.3g} under the floor {floor:.3g}, {share:.3%} differ")
    return float((gf - wf).abs().max())


def f32_close(tag: str, got: torch.Tensor, want: torch.Tensor, tol: float = FUSED_F32_TOL) -> float:
    """Largest error as a share of the largest magnitude; raises above tol."""
    if got.shape != want.shape or got.dtype != torch.float32:
        raise AssertionError(f"{tag}: shape {tuple(got.shape)} dtype {got.dtype}")
    err = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
    if not err <= tol:
        raise AssertionError(f"{tag}: {err:.3g} of the largest magnitude > {tol:g}")
    return err


def check_fused(tag, fns, x, wb, ab, gy, gs, flush,
                time_plain=True) -> tuple[dict, dict, torch.Tensor]:
    """One fused conv's forward and backward kernels against their plain
    versions on the same inputs; returns their (forward, backward) records
    without the bounds, and y. time_plain False: no plain timings."""
    fwd, fwd_plain, bwd, bwd_plain = fns
    relu = ab is not None
    y, s = fwd(x, wb, ab, relu)
    py, ps = fwd_plain(x, wb, ab, relu)
    y_err = bf16_close(f"{tag} y", y, py)
    f32_close(f"{tag} sums vs its own y", s, fused_conv_bn._stats(y), 1e-5)
    s_err = f32_close(f"{tag} sums", s, ps)
    del py, ps
    got = bwd(gy, gs, y, x, wb, ab, relu)
    want = bwd_plain(gy, gs, y, x, wb, ab, relu)
    dx_err = bf16_close(f"{tag} dx", got[0], want[0])
    dw_err = f32_close(f"{tag} dw", got[1], want[1])
    dab_err = f32_close(f"{tag} da, db", got[2], want[2]) if relu else 0.0
    del want
    again = (fwd(x, wb, ab, relu), bwd(gy, gs, y, x, wb, ab, relu))
    torch.cuda.synchronize()
    for u, v in zip((y, s, *got), (*again[0], *again[1])):
        if u is not None and not torch.equal(u, v):
            raise AssertionError(f"{tag}: two runs differ")
    del got, again
    ms = cuda_ms(lambda: fwd(x, wb, ab, relu), flush)
    bwd_ms = cuda_ms(lambda: bwd(gy, gs, y, x, wb, ab, relu), flush)
    dev_ms = device_ms(lambda: fwd(x, wb, ab, relu), flush)
    bwd_dev_ms = device_ms(lambda: bwd(gy, gs, y, x, wb, ab, relu), flush)
    plain = ({"plain_ms": None, "plain_device_ms": None},
             {"plain_ms": None, "plain_device_ms": None})
    if time_plain:
        for rec, fn in zip(plain, (lambda: fwd_plain(x, wb, ab, relu),
                                   lambda: bwd_plain(gy, gs, y, x, wb, ab, relu))):
            rec.update(plain_ms=cuda_ms(fn, flush, 10),
                       **device_ms(fn, flush, "plain_device_ms", 10))
    said = [f"plain {r['plain_ms']:.4f} ms (device {r['plain_device_ms']:.4f})" if time_plain
            else "plain not timed here" for r in plain]
    print(
        f"{tag}: y max err {y_err:.3g} (<= 1 ulp, < 1% differ), sums {s_err:.2g}, dx max err "
        f"{dx_err:.3g}, dw {dw_err:.2g}, da/db {dab_err:.2g} of max (<= {FUSED_F32_TOL:g}); "
        f"two runs bit-equal; forward kernel {ms:.4f} ms (device {dev_ms['device_ms']:.4f}), "
        f"{said[0]}; backward kernel {bwd_ms:.4f} ms (device {bwd_dev_ms['device_ms']:.4f}), "
        f"{said[1]}"
    )
    return ({"max_abs_err": y_err, "ms": ms, **plain[0], **dev_ms},
            {"max_abs_err": dx_err, "ms": bwd_ms, **plain[1], **bwd_dev_ms}, y)


def products_ms(is_3x3: bool, x, wb, ab, gy, gs, y, flush) -> dict:
    """Yardsticks, used nowhere in the port: the bf16 products alone, one
    library call each, on xhat and gy_eff formed beforehand. "fwd": the
    forward's product (torch.matmul(xhat, w^T) for the 1x1, F.conv2d on a
    channels-last xhat for the 3x3); "bwd": the backward's two
    (torch.matmul for the 1x1, torch.nn.grad.conv2d_input and conv2d_weight
    for the 3x3). Not the same functions: no prologue, statistics, gy_eff,
    mask, da or db. Each on both timers: "fwd", "bwd" as the kernels' `ms`,
    "fwd_device", "bwd_device" as their `device_ms`."""
    ge = fused_conv_bn._gy_eff(gy, y, gs)
    _, xh = fused_conv_bn._prologue(x, ab, ab is not None)
    if is_3x3:
        gn, xn = ge.permute(0, 3, 1, 2), xh.permute(0, 3, 1, 2)  # channels-last NCHW views
        wl = wb.contiguous(memory_format=torch.channels_last)
        fns = {"fwd": lambda: torch.nn.functional.conv2d(xn, wl, padding=1),
               "bwd": lambda: (torch.nn.grad.conv2d_input(xn.shape, wb, gn, padding=1),
                               torch.nn.grad.conv2d_weight(xn, wb.shape, gn, padding=1))}
    else:
        g2, x2 = ge.reshape(-1, ge.shape[-1]), xh.reshape(-1, xh.shape[-1])
        wt = wb.t()
        fns = {"fwd": lambda: torch.matmul(x2, wt),
               "bwd": lambda: (torch.matmul(g2, wb), torch.matmul(g2.t(), x2))}
    out = {}
    for key, fn in fns.items():
        out[key] = cuda_ms(fn, flush)
        out.update(device_ms(fn, flush, f"{key}_device"))
    return out


def fused_bounds(m: int, k_taps: int, k: int, n: int, prologue: bool) -> tuple[dict, dict]:
    """(forward, backward) bounds of a fused conv with m output rows, k
    input channels over k_taps taps and n output channels. Forward: x and w
    read, y and the sums written, 2 m k n taps operations. Backward: gy, y,
    x, w, gs read, dx and dw written, twice the operations."""
    w_elems, ab_bytes = k_taps * k * n, (8 * k if prologue else 0)
    fwd = bound(2 * (m * k + w_elems + m * n) + ab_bytes + 8 * n,
                2 * m * k_taps * k * n, PEAK_BF16)
    bwd = bound(2 * (2 * m * n + 2 * m * k + w_elems) + 4 * w_elems + 2 * ab_bytes + 8 * n,
                4 * m * k_taps * k * n, PEAK_BF16)
    return fwd, bwd


def step_line(tag: str, calls: int, step: dict) -> None:
    print(f"{tag} step sums over {calls} calls a fused step (ms x calls): forward kernel "
          f"{step['fwd']:.4f} ms (device {step['fwd_device']:.4f}) against its bound "
          f"{step['fwd_bound']:.4f} ms; backward kernel {step['bwd']:.4f} ms (device "
          f"{step['bwd_device']:.4f}) against {step['bwd_bound']:.4f} ms; products only "
          f"(library yardsticks) forward {step['fwd_products']:.4f} ms (device "
          f"{step['fwd_products_device']:.4f}), backward {step['products']:.4f} ms (device "
          f"{step['products_device']:.4f})")


def phase_fused(dev, flush, is_3x3: bool) -> tuple[dict, dict]:
    """[3c] (1x1) or [3d] (3x3): every main-path shape, then the ragged or
    odd shapes; returns the (forward, backward) records of the table shape
    with the step sums."""
    if is_3x3:
        gen = torch.Generator(device=dev).manual_seed(6)
        fns = (fused_conv_bn._c3_fwd, fused_conv_bn._c3_plain,
               fused_conv_bn._c3_bwd, fused_conv_bn._c3_bwd_plain)
        # (x shape, cout, prologue, calls, time plain): the 4 stride-1 shapes,
        # layer4's without the prologue, and a small one with odd H, W and
        # image seams inside a 128-pixel tile
        jobs = [(shape, shape[-1], True, calls, True) for shape, calls in C3_SHAPES]
        jobs.append(((48, 7, 7, 512), 512, False, 0, False))
        jobs += [((3, 13, 11, 24), 40, pro, 0, True) for pro in (True, False)]
        table = ((48, 56, 56, 64), True)
    else:
        gen = torch.Generator(device=dev).manual_seed(5)
        fns = (fused_conv_bn._mm_stats, fused_conv_bn._mm_plain,
               fused_conv_bn._mm_stats_bwd, fused_conv_bn._mm_bwd_plain)
        timed = {(150528, 256, 64, False), (150528, 64, 256, True), (2352, 512, 2048, True),
                 (2352, 2048, 512, False)}  # plain versions timed at these only
        jobs = [((m, k), n, pro, calls, (m, k, n, pro) in timed)
                for m, k, n, pro, calls in MM_SHAPES]
        jobs.append(((9413, 264), 1000, True, 0, True))  # ragged M, K and N no multiples of 64
        table = ((150528, 64), True)
    label = "[3d] fused 3x3" if is_3x3 else "[3c] fused 1x1"
    step = dict.fromkeys(("fwd", "bwd", "fwd_device", "bwd_device", "fwd_bound", "bwd_bound",
                          "products", "products_device", "fwd_products",
                          "fwd_products_device"), 0.0)
    recs = None
    for x_shape, n, pro, calls, time_plain in jobs:
        w_shape = (n, x_shape[-1], 3, 3) if is_3x3 else (n, x_shape[-1])
        args = fused_inputs(x_shape, w_shape, pro, dev, gen)
        tag = f"{label} ({', '.join(map(str, x_shape))} -> {n}){' prologue' if pro else ''}"
        fwd, bwd, y = check_fused(tag, fns, *args, flush, time_plain)
        m = 1
        for d in x_shape[:-1]:
            m *= d
        bf, bb = fused_bounds(m, 9 if is_3x3 else 1, x_shape[-1], n, pro)
        prod = products_ms(is_3x3, *args, y, flush)
        print(f"{tag}: bound forward {bf['bound_ms']:.4f} ms ({bf['bound_by']}), backward "
              f"{bb['bound_ms']:.4f} ms ({bb['bound_by']}); products only: forward "
              f"{prod['fwd']:.4f} ms (device {prod['fwd_device']:.4f}), backward "
              f"{prod['bwd']:.4f} ms (device {prod['bwd_device']:.4f}); {calls} calls a step")
        for key, v in (("fwd", fwd["ms"]), ("bwd", bwd["ms"]), ("fwd_device", fwd["device_ms"]),
                       ("bwd_device", bwd["device_ms"]), ("fwd_bound", bf["bound_ms"]),
                       ("bwd_bound", bb["bound_ms"]), ("products", prod["bwd"]),
                       ("products_device", prod["bwd_device"]),
                       ("fwd_products", prod["fwd"]),
                       ("fwd_products_device", prod["fwd_device"])):
            step[key] += calls * v
        if (x_shape, pro) == table:
            recs = ({**fwd, **bf, "fwd_products_only_ms": prod["fwd"],
                     "fwd_products_only_device_ms": prod["fwd_device"]},
                    {**bwd, **bb, "products_only_ms": prod["bwd"],
                     "products_only_device_ms": prod["bwd_device"]})
        del args, y
    step_line(label, sum(job[3] for job in jobs), step)
    fwd_rec, bwd_rec = recs
    fwd_rec.update(step_ms=step["fwd"], step_device_ms=step["fwd_device"],
                   step_bound_ms=step["fwd_bound"],
                   step_fwd_products_only_ms=step["fwd_products"],
                   step_fwd_products_only_device_ms=step["fwd_products_device"])
    bwd_rec.update(step_ms=step["bwd"], step_device_ms=step["bwd_device"],
                   step_bound_ms=step["bwd_bound"], step_products_only_ms=step["products"],
                   step_products_only_device_ms=step["products_device"])
    return fwd_rec, bwd_rec


def _assign_equal(tag: str, y, c) -> torch.Tensor:
    """The kernel's indices, held EQUAL to the plain version's and to a rerun."""
    got = assign.assign_bins(y, c)
    want = assign.assign_bins_plain(y, c)
    again = assign.assign_bins(y, c)
    torch.cuda.synchronize()
    if got.shape != (y.shape[0],) or got.dtype != torch.int32:
        raise AssertionError(f"assign {tag}: {tuple(got.shape)} {got.dtype}")
    differ = int((got != want).sum())
    if differ:
        raise AssertionError(f"assign {tag}: {differ} rows differ from plain")
    if not torch.equal(got, again):
        raise AssertionError(f"assign {tag}: two runs differ")
    return got


def phase_assign(dev, flush) -> dict:
    """[3e]: the assign kernel against its plain version: indices must be
    EQUAL (both round each product and sum on its own, in the same order),
    through the fast loop and through the careful one."""
    gen = torch.Generator(device=dev).manual_seed(8)
    rec = {}
    for n, d, k in ((2_000_000, 3, 200), (2_000_000, 4, 200), (1_000_003, 3, 16)):
        y = torch.randn((n, d), device=dev, generator=gen)
        c = torch.randn((k, d), device=dev, generator=gen)
        got = _assign_equal(f"({n}, {d}) x {k}", y, c)
        ms = cuda_ms(lambda: assign.assign_bins(y, c), flush)
        plain_ms = cuda_ms(lambda: assign.assign_bins_plain(y, c), flush, 10)
        # y and the centers read, int32 indices written; per (row, center) D
        # multiplies and D - 1 adds of the cross term, the doubling, the
        # subtraction and the compare: 2 D + 2
        b = bound(4 * (n * d + k * d + n), n * k * (2 * d + 2), PEAK_F32)
        timed = {"ms": ms, "plain_ms": plain_ms,
                 **device_ms(lambda: assign.assign_bins(y, c), flush), **b}
        print(
            f"[3e] assign ({n}, {d}) x {k}: equal indices, two runs bit-equal; kernel "
            f"{ms:.4f} ms, device {timed['device_ms']:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}: {b['bytes']} B, {b['operations']} op)"
        )
        if (n, d, k) == (2_000_000, 3, 200):
            rec = {"max_abs_err": float((got - assign.assign_bins_plain(y, c)).abs().max()),
                   **timed, **device_ms(lambda: assign.assign_bins_plain(y, c), flush,
                                        "plain_device_ms", 10)}
            # not one call and not the same arithmetic, so no library_ms: two
            # calls through an (N, K) float32 matrix, timed as a yardstick
            cdist_ms = cuda_ms(lambda: torch.cdist(y, c).argmin(dim=1), flush, 10)
            print(f"[3e] note: torch.cdist(y, c).argmin(1) at ({n}, {d}) x {k}, two calls "
                  f"through a {4 * n * k / 1e9:.1f} GB matrix: {cdist_ms:.4f} ms")
            # rows outside the fast loop's guard, in warp tiles spread over
            # the rows, then one center at 2^61: every row in the careful loop
            y[::100_003] = torch.tensor([2.0**60, -1.0, 0.5], device=dev)
            y[5::200_011] = torch.tensor([float("inf"), 0.0, 1.0], device=dev)
            y[9::300_007] = torch.tensor([0.5, float("nan"), 1.0], device=dev)
            _assign_equal("with rows of 2^60, inf and NaN", y, c)
            c[123] = torch.tensor([2.0**61, 0.0, 0.0], device=dev)
            _assign_equal("with a center at 2^61 (every row careful)", y, c)
            rec["careful_device_ms"] = cuda_ms(lambda: assign.assign_bins(y, c), flush,
                                               held=True)
            print(f"[3e] careful loop: rows of 2^60, inf and NaN, then a center at 2^61: equal "
                  f"indices, two runs bit-equal; every row careful {rec['careful_device_ms']:.4f} "
                  f"device ms")
        elif d == 4:
            rec.update({f"d4_{key}": timed[key] for key in ("ms", "device_ms", "bound_ms")})
        del got, y, c
    # K (D + 1) at the 12,288-float limit: 64 KB of padded centers a block
    y = torch.randn((100_000, 2), device=dev, generator=gen)
    c = torch.randn((4096, 2), device=dev, generator=gen)
    _assign_equal("(100000, 2) x 4096", y, c)
    print("[3e] assign (100000, 2) x 4096, K (D + 1) at the limit: equal indices, two runs "
          "bit-equal")
    # ties, NaN: rows that sit on duplicated centers take the lower index; a
    # NaN row takes index 0 (its first NaN distance); a NaN center takes every row
    y = torch.randn((4096, 3), device=dev, generator=gen)
    c = torch.randn((200, 3), device=dev, generator=gen)
    c[100:110] = c[0:10]
    y[:10] = c[:10]
    y[77, 1] = float("nan")
    got, want = assign.assign_bins(y, c), assign.assign_bins_plain(y, c)
    if not torch.equal(got, want) or got[:10].tolist() != list(range(10)) or int(got[77]) != 0:
        raise AssertionError("assign: duplicate centers or a NaN row handled unlike plain")
    c[150, 2] = float("nan")
    got, want = assign.assign_bins(y, c), assign.assign_bins_plain(y, c)
    if not torch.equal(got, want) or got[0] != 150 or got[77] != 0 or int((got == 150).sum()) != 4095:
        raise AssertionError("assign: a NaN center handled unlike plain")
    empty = assign.assign_bins(y[:0], c)
    torch.cuda.synchronize()
    if empty.shape != (0,):
        raise AssertionError("assign: N = 0")
    print("[3e] assign: duplicate centers -> the lower index, a NaN row -> index 0, a NaN center "
          "-> every row; equal to plain")
    return rec


def randomize_bn_stats(model: torch.nn.Module, rng: np.random.Generator) -> None:
    """Running means ~ N(0, 0.1), variances ~ U(0.5, 2): eval BN is not the identity."""
    for m in model.modules():
        if isinstance(m, (torch.nn.BatchNorm2d, HeadBatchNorm)):
            shape = tuple(m.running_mean.shape)
            m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.1, shape).astype(np.float32)))
            m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, shape).astype(np.float32)))


def make_requests(rng: np.random.Generator, sizes, image_size: int, num_classes: int):
    reqs = []
    for b in sizes:
        images = rng.integers(0, 256, (b, image_size, image_size, 3), np.uint8)
        labels = rng.permutation(np.arange(b) % num_classes).astype(np.int64)
        reqs.append((images, labels))
    return reqs


def outputs(model, problem, images, labels, dev, dtype, kernel: bool):
    """(scores, residual, poses) of one request through the kernel path
    (normalize kernel, the model as built) or the plain path."""
    norm = preprocess.normalize_images_cuda if kernel else normalize_images
    with torch.inference_mode():
        x = norm(torch.from_numpy(images).to(dev), dtype)
        scores, residual = model(x, torch.from_numpy(labels).to(dev))
        return scores, residual, problem.decode((scores, residual))


def compare(tag, kern, plain, rtol) -> float:
    """Scores and residuals everywhere; poses where the top-2 bin-score
    margin exceeds the score tolerance. Returns the largest error."""
    (s_k, r_k, p_k), (s_p, r_p, p_p) = kern, plain
    worst = 0.0
    for name, k, p in (("scores", s_k, s_p), ("residual", r_k, r_p)):
        err = float((k - p).abs().max())
        tol = rtol * float(p.abs().max())
        if not err <= tol:
            raise AssertionError(f"{tag} {name}: max err {err:.3g} > {tol:.3g}")
        worst = max(worst, err)
    top2 = torch.topk(s_p, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > rtol * float(s_p.abs().max())
    perr = float((p_k[clear] - p_p[clear]).abs().max()) if clear.any() else 0.0
    ptol = rtol * float(r_p.abs().max())
    if not perr <= ptol:
        raise AssertionError(f"{tag} poses: max err {perr:.3g} > {ptol:.3g}")
    print(
        f"[4] {tag}: scores/residual max err {worst:.3g}, poses max err "
        f"{perr:.3g} on {int(clear.sum())}/{len(clear)} clear rows (rtol {rtol:g} of max)"
    )
    return worst


def timed_requests(fn, reqs, n: int) -> list[float]:
    """Host-clock seconds of n requests (cycling reqs), each synchronized."""
    times = []
    for i in range(n):
        images, labels = reqs[i % len(reqs)]
        t0 = time.perf_counter()
        fn(images, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def make_dictionary(k: int) -> KMeansDictionary:
    """A k-atom axis-angle dictionary, written to a .npz and read back."""
    rng = np.random.default_rng(1)
    v = rng.standard_normal((k, 3))
    centers = (v / np.linalg.norm(v, axis=1, keepdims=True)
               * rng.uniform(0, np.pi, (k, 1))).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        KMeansDictionary(cluster_centers=centers).save(Path(tmp) / "kmeans.npz")
        return KMeansDictionary.load(Path(tmp) / "kmeans.npz")


def phase_serve(dev, dictionary) -> dict:
    cfg = get_config("geodesic_bd", compute_dtype="bfloat16", stem_pool="kernel")
    dtype = torch.bfloat16
    t0 = time.perf_counter()
    model = build_model(cfg, dev)
    with torch.no_grad():
        randomize_bn_stats(model, np.random.default_rng(0))
    problem = build_problem(cfg, dictionary, dev)
    infer = make_inference_fn(model, problem)
    plain = build_model(cfg.replace(stem_pool="plain"), dev)
    plain.load_state_dict(model.state_dict())
    n_params = sum(p.numel() for p in model.parameters())
    print(
        f"[4] model: {cfg.feature_network}/{cfg.feature_layer} N0 {cfg.N0} N1 {cfg.N1} "
        f"N2 {cfg.N2} K {cfg.dict_size} classes {cfg.num_classes} {cfg.image_size}px "
        f"bf16, {n_params / 1e6:.1f} M params, built in {time.perf_counter() - t0:.1f} s"
    )
    reqs = make_requests(np.random.default_rng(2), (64, 64, 64, 64, 17),
                         cfg.image_size, cfg.num_classes)

    def plain_infer(images, labels):
        return outputs(plain, problem, images, labels, dev, dtype, kernel=False)[2]

    # warm-up and timing, not counted
    timed_requests(infer, reqs[:4], 3)
    timed_requests(plain_infer, reqs[:4], 3)
    torch.cuda.reset_peak_memory_stats()
    t_kernel = timed_requests(infer, reqs[:4], 20)
    t_plain = timed_requests(plain_infer, reqs[:4], 20)
    t_kernel += timed_requests(infer, reqs[:4], 20)
    t_plain += timed_requests(plain_infer, reqs[:4], 20)
    med_k, med_p = statistics.median(t_kernel), statistics.median(t_plain)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(
        f"[4] bf16 batch 64, 40 requests each (host uint8 in, poses on device): "
        f"kernel path median {med_k * 1e3:.3f} ms = {64 / med_k:.1f} img/s; "
        f"plain path median {med_p * 1e3:.3f} ms = {64 / med_p:.1f} img/s; "
        f"peak device memory {peak:.2f} GiB"
    )

    # the counted run: each kernel launches exactly once per request
    preprocess.launches = 0
    stem_pool.launches = 0
    served = [infer(images, labels) for images, labels in reqs]
    torch.cuda.synchronize()
    launches = {"normalize": preprocess.launches, "stem_pool": stem_pool.launches}
    print(f"[4] served {len(reqs)} requests ({sum(len(l) for _, l in reqs)} images); launches {launches}")
    for name, n in launches.items():
        if n != len(reqs):
            raise AssertionError(f"{name} kernel launched {n} times for {len(reqs)} requests")
    for (images, labels), poses in zip(reqs, served):
        if poses.shape != (len(labels), 3) or not bool(torch.isfinite(poses).all()):
            raise AssertionError(f"bad poses: shape {tuple(poses.shape)}")

    for i, ((images, labels), poses) in enumerate(zip(reqs, served)):
        kern = outputs(model, problem, images, labels, dev, dtype, kernel=True)
        if not torch.equal(kern[2], poses):
            raise AssertionError("served poses differ from the kernel path's decode")
        ref = outputs(plain, problem, images, labels, dev, dtype, kernel=False)
        compare(f"request {i} (batch {len(labels)}) bf16 kernel vs plain", kern, ref,
                SERVE_RTOL[dtype])

    # one request in f32, TF32 off for convs and matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    state = model.state_dict()
    del model, plain, infer
    torch.cuda.empty_cache()
    cfg32 = cfg.replace(compute_dtype="float32")
    m32 = build_model(cfg32, dev)
    m32.load_state_dict(state)
    p32 = build_model(cfg32.replace(stem_pool="plain"), dev)
    p32.load_state_dict(state)
    images, labels = reqs[0]
    preprocess.launches = stem_pool.launches = 0
    served32 = make_inference_fn(m32, problem)(images, labels)
    torch.cuda.synchronize()
    if (preprocess.launches, stem_pool.launches) != (1, 1):
        raise AssertionError("f32 request did not go through both kernels")
    kern = outputs(m32, problem, images, labels, dev, torch.float32, kernel=True)
    if not torch.equal(kern[2], served32):
        raise AssertionError("f32 served poses differ from the kernel path's decode")
    ref = outputs(p32, problem, images, labels, dev, torch.float32, kernel=False)
    compare("request 0 (batch 64) f32 kernel vs plain, TF32 off", kern, ref,
            SERVE_RTOL[torch.float32])
    return {"launches": launches, "img_s": 64 / med_k, "plain_img_s": 64 / med_p}


def make_loader(rng: np.random.Generator, n_batches: int, items: int, size: int,
                classes: int) -> list[dict]:
    """BalancedLoader-style batches: `items` images of each class, uint8
    images, Euler angles in degrees, int32 labels. Each image is noise
    around its own brightness and contrast, so that features vary across
    the batch as they do for real crops (pure noise images give a ResNet
    nearly the same pooled features, which leaves the head BNs nothing to
    normalize but rounding)."""
    n = items * classes

    def images():
        level = rng.uniform(40, 215, (n, 1, 1, 3))
        spread = rng.uniform(5, 60, (n, 1, 1, 1))
        noise = rng.standard_normal((n, size, size, 3))
        return np.clip(level + spread * noise, 0, 255).astype(np.uint8)

    return [
        {
            "xdata": images(),
            "euler": np.stack([rng.uniform(-180, 180, n), rng.uniform(-30, 60, n),
                               rng.uniform(-20, 20, n)], axis=1).astype(np.float32),
            "label": np.tile(np.arange(classes), items).astype(np.int32),
        }
        for _ in range(n_batches)
    ]


class plain_normalize:
    """Run train steps with the plain normalize in place of the kernel."""

    def __enter__(self):
        self.saved = steps.normalize_images_cuda
        steps.normalize_images_cuda = normalize_images

    def __exit__(self, *exc):
        steps.normalize_images_cuda = self.saved


def bn_stats(model) -> dict:
    return {k: v.clone() for k, v in model.state_dict().items() if "running" in k}


def timed_steps(step_fn, state, batch, n: int):
    """Host-clock seconds of n train steps, each ending in a synchronize."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return state, times


def phase_train(dev, dictionary) -> dict:
    cfg = get_config(
        "geodesic_bd", compute_dtype="bfloat16", stem_pool="kernel",
        items_per_batch=4, max_iterations=2, num_warmup_epochs=1, num_epochs=1,
    )
    t0 = time.perf_counter()
    kern = Trainer(cfg, dictionary=dictionary, device=dev)
    init_sd = {k: v.clone() for k, v in kern.model.state_dict().items()}
    rng = np.random.default_rng(4)
    real, render = (make_loader(rng, 2, cfg.items_per_batch, cfg.image_size, cfg.num_classes)
                    for _ in range(2))
    n_img = 2 * len(real[0]["label"])
    print(
        f"[5] train: {cfg.feature_network}/{cfg.feature_layer} N0 {cfg.N0} N1 {cfg.N1} "
        f"N2 {cfg.N2} K {cfg.dict_size} classes {cfg.num_classes} {cfg.image_size}px bf16, "
        f"{n_img} images a step (2 streams x {cfg.items_per_batch} items x "
        f"{cfg.num_classes} classes), Adam mu {cfg.optimizer_dtype}; built in "
        f"{time.perf_counter() - t0:.1f} s"
    )
    before = bn_stats(kern.model)

    # the counted run: Trainer.fit, 2 warm-up + 2 main steps
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    state = kern.fit(kern.init_state(), real, render, log_every=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {k: v for k, v in read_counts().items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = state.step
    print(f"[5] fit: {n} steps in {fit_s:.2f} s (first steps included); launches {launches}; "
          f"peak device memory {peak:.2f} GiB")
    if n != 4 or launches != {"normalize": n, "stem_pool": 2 * n, "stem_pool_bwd": 2 * n}:
        raise AssertionError("expected 4 steps of 1 normalize, 2 stem, 2 stem bwd launches")
    keys = ("loss", "lc", "lr", "s", "alpha")
    hist = kern.history
    for rec in hist:
        if not all(np.isfinite(rec[k]) for k in keys):
            raise AssertionError(f"non-finite metrics at step {rec['step']}: {rec}")
    if len({rec["s"] for rec in hist}) != len(hist):
        raise AssertionError("s did not change from step to step")
    after = bn_stats(kern.model)
    stuck = [k for k in before if torch.equal(before[k], after[k])]
    if stuck:
        raise AssertionError(f"running statistics that did not move: {stuck[:5]}")
    print(f"[5] metrics finite at every step, s moving, all {len(before)} running statistics moved")

    # the same 4 steps through the plain path, from the same weights
    plain = Trainer(cfg.replace(stem_pool="plain"), dictionary=dictionary, device=dev)
    plain.model.load_state_dict(init_sd)
    with plain_normalize():
        pstate = plain.fit(plain.init_state(), real, render, log_every=1)
    torch.cuda.synchronize()
    worst = 0.0
    for rk, rp in zip(hist, plain.history, strict=True):
        for k in keys:
            err = abs(rk[k] - rp[k]) / (1.0 if k == "s" else abs(rp[k]))
            if not err <= TRAIN_TOL:
                raise AssertionError(f"step {rk['step']} {k}: kernel {rk[k]} plain {rp[k]}")
            worst = max(worst, err)
        print(
            f"[5] step {rk['step']} {rk['phase']}: kernel loss {rk['loss']:.5f} lc {rk['lc']:.5f} "
            f"lr {rk['lr']:.5f} s {rk['s']:.5f} | plain loss {rp['loss']:.5f} "
            f"lc {rp['lc']:.5f} lr {rp['lr']:.5f} s {rp['s']:.5f}"
        )
    print(f"[5] kernel vs plain metrics: worst difference {worst:.3g} (<= {TRAIN_TOL})")

    # step time: 10 interleaved pairs of main steps, the 96-image batch on the card
    batch = kern._to_device(next(_interleave(real, render)))
    step_k = kern.train_step_fn("main", dual_stream=True)
    step_p = plain.train_step_fn("main", dual_stream=True)
    state, _ = timed_steps(step_k, state, batch, 2)
    with plain_normalize():
        pstate, _ = timed_steps(step_p, pstate, batch, 2)
    t_k, t_p = [], []
    for i in range(10):
        for path in (("k", "p") if i % 2 == 0 else ("p", "k")):
            if path == "k":
                state, t = timed_steps(step_k, state, batch, 1)
                t_k += t
            else:
                with plain_normalize():
                    pstate, t = timed_steps(step_p, pstate, batch, 1)
                t_p += t
    med_k, med_p = statistics.median(t_k), statistics.median(t_p)
    print(
        f"[5] bf16 main train step, {n_img} images on the card, 10 interleaved pairs: "
        f"kernel path median {med_k * 1e3:.3f} ms = {n_img / med_k:.1f} img/s "
        f"(q1 {np.percentile(t_k, 25) * 1e3:.3f}, q3 {np.percentile(t_k, 75) * 1e3:.3f}); "
        f"plain path median {med_p * 1e3:.3f} ms = {n_img / med_p:.1f} img/s "
        f"(q1 {np.percentile(t_p, 25) * 1e3:.3f}, q3 {np.percentile(t_p, 75) * 1e3:.3f}); "
        f"kernel faster in {sum(a < b for a, b in zip(t_k, t_p))} of 10 pairs"
    )
    del kern, plain, state, pstate, step_k, step_p
    torch.cuda.empty_cache()

    # one f32 step, TF32 off, SGD(lr=1): the gradients of both stems. Both
    # take the normalize kernel's output (checked in [2]): its float32 values
    # differ from the plain normalize's by up to 7.2e-7, and any such input
    # perturbation flips a ReLU mask somewhere among the heads' ~1.1 M
    # pre-activations, which moves a whole column of that head's weight
    # gradient (float32 against float64 on the card: 21-43% of a leaf's
    # largest magnitude, on both paths alike)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = cfg.replace(compute_dtype="float32")
    problem = build_problem(cfg32, dictionary, dev)
    loss, grads = {}, {}
    for path in ("kernel", "plain"):
        model = build_model(cfg32.replace(stem_pool=path), dev, param_dtype=torch.float32)
        model.load_state_dict(init_sd)
        sgd = torch.optim.SGD(model.parameters(), lr=1.0)
        step = steps.make_train_step(model, problem, sgd, phase="main", dual_stream_bn=True,
                                     compute_dtype=torch.float32)
        preprocess.launches = stem_pool.launches = stem_pool.bwd_launches = 0
        _, m = step(TrainState(0, model, sgd, torch.zeros((), device=dev)), batch)
        torch.cuda.synchronize()
        counts = (preprocess.launches, stem_pool.launches, stem_pool.bwd_launches)
        if counts != ((1, 2, 2) if path == "kernel" else (1, 0, 0)):
            raise AssertionError(f"f32 {path} step launches {counts}")
        loss[path] = float(m["loss"])
        grads[path] = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
        del model, sgd, step
        torch.cuda.empty_cache()
    loss_err = abs(loss["kernel"] - loss["plain"]) / abs(loss["plain"])
    worst_leaf, worst_err = "", 0.0
    for k, gp in grads["plain"].items():
        err = float((grads["kernel"][k] - gp).abs().max()) / max(float(gp.abs().max()), 1e-30)
        if err > worst_err:
            worst_leaf, worst_err = k, err
    print(
        f"[5] f32 main step, TF32 off, SGD(lr=1), stem kernels vs plain stem: loss kernel {loss['kernel']:.7f} plain "
        f"{loss['plain']:.7f} (relative {loss_err:.3g} <= 1e-4); worst gradient leaf "
        f"{worst_leaf}: {worst_err:.3g} of its largest magnitude (<= 1e-3), "
        f"{len(grads['plain'])} leaves"
    )
    if not (loss_err <= 1e-4 and worst_err <= 1e-3):
        raise AssertionError("f32 kernel-path gradients differ from the plain path")
    return {"launches": launches, "img_s": n_img / med_k, "plain_img_s": n_img / med_p,
            "img_s_iqr": (n_img / np.percentile(t_k, 75), n_img / np.percentile(t_k, 25))}


FUSED_COUNTERS = ("mm_launches", "mm_bwd_launches", "c3_launches", "c3_bwd_launches")


def reset_counts() -> None:
    preprocess.launches = stem_pool.launches = stem_pool.bwd_launches = 0
    for name in FUSED_COUNTERS:
        setattr(fused_conv_bn, name, 0)


def read_counts() -> dict:
    return {"normalize": preprocess.launches, "stem_pool": stem_pool.launches,
            "stem_pool_bwd": stem_pool.bwd_launches,
            **{name.removesuffix("_launches"): getattr(fused_conv_bn, name)
               for name in FUSED_COUNTERS}}


def profile_steps(tag: str, step_fn, state, batch, n: int = 3):
    """Device time by kernel of n steps (torch.profiler), largest first."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
    # kernels and device copies only: an annotation's device time is a span
    rows = [(e.key, e.device_time_total / n / 1e3, e.count / n)
            for e in prof.key_averages() if e.device_time_total > 0
            and e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith(("Optimizer.", "ProfilerStep"))]
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    print(f"[6] profile {tag}: {total:.3f} ms of kernels per step, {sum(r[2] for r in rows):.0f} launches")
    for key, ms, count in rows[:40]:
        print(f"[6]   {ms:8.3f} ms {100 * ms / total:5.1f}% x{count:6.1f}  {key[:110]}")
    return state


def phase_train_fused(dev, dictionary, profile: bool) -> dict:
    base = get_config(
        "geodesic_bd", compute_dtype="bfloat16", stem_pool="kernel",
        items_per_batch=4, max_iterations=2, num_warmup_epochs=1, num_epochs=1,
    )
    cfg = base.replace(fused_conv_bn="kernel")
    kern = Trainer(cfg, dictionary=dictionary, device=dev)
    init_sd = {k: v.clone() for k, v in kern.model.state_dict().items()}
    rng = np.random.default_rng(4)  # the loaders of [5]
    real, render = (make_loader(rng, 2, cfg.items_per_batch, cfg.image_size, cfg.num_classes)
                    for _ in range(2))
    n_img = 2 * len(real[0]["label"])
    before = bn_stats(kern.model)

    # the counted run: Trainer.fit, 2 warm-up + 2 main steps
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    state = kern.fit(kern.init_state(), real, render, log_every=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = state.step
    print(f"[6] fused fit (fused_conv_bn='kernel'): {n} steps in {fit_s:.2f} s (first steps "
          f"included); launches {launches}; peak device memory {peak:.2f} GiB")
    per_step = {"normalize": 1, "stem_pool": 2, "stem_pool_bwd": 2, "mm": 72, "mm_bwd": 72,
                "c3": 26, "c3_bwd": 26}
    if n != 4 or launches != {k: v * n for k, v in per_step.items()}:
        raise AssertionError(f"expected 4 steps of {per_step} launches")
    keys = ("loss", "lc", "lr", "s", "alpha")
    hist = kern.history
    for rec in hist:
        if not all(np.isfinite(rec[k]) for k in keys):
            raise AssertionError(f"non-finite metrics at step {rec['step']}: {rec}")
    if len({rec["s"] for rec in hist}) != len(hist):
        raise AssertionError("s did not change from step to step")
    after = bn_stats(kern.model)
    stuck = [k for k in before if torch.equal(before[k], after[k])]
    if stuck:
        raise AssertionError(f"running statistics that did not move: {stuck[:5]}")
    print(f"[6] metrics finite at every step, s moving, all {len(before)} running statistics moved")

    # the same steps through the plain fused ops, and through the unfused
    # trunk of [5], from the same weights
    others = {}
    for name, c in (("plain", base.replace(fused_conv_bn="plain")), ("unfused", base)):
        t = Trainer(c, dictionary=dictionary, device=dev)
        t.model.load_state_dict(init_sd)
        reset_counts()
        # the plain ops' float32 library backward repeats its bits only
        # with deterministic algorithms
        torch.backends.cudnn.deterministic = name == "plain"
        try:
            st = t.fit(t.init_state(), real, render, log_every=1)
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.deterministic = False
        if any(getattr(fused_conv_bn, name_) for name_ in FUSED_COUNTERS):
            raise AssertionError(f"the {name} path launched a fused kernel")
        others[name] = (t, st)
    worst = 0.0
    for rk, rp, ru in zip(hist, others["plain"][0].history, others["unfused"][0].history,
                          strict=True):
        for k in keys:
            err = abs(rk[k] - rp[k]) / (1.0 if k == "s" else abs(rp[k]))
            if not err <= (0.03 if rk["step"] == 1 else FUSED_TRAIN_TOL):
                raise AssertionError(f"step {rk['step']} {k}: kernel {rk[k]} plain {rp[k]}")
            worst = max(worst, err)
        print(
            f"[6] step {rk['step']} {rk['phase']}: fused kernel loss {rk['loss']:.5f} lc "
            f"{rk['lc']:.5f} lr {rk['lr']:.5f} s {rk['s']:.5f} | fused plain loss "
            f"{rp['loss']:.5f} lc {rp['lc']:.5f} lr {rp['lr']:.5f} s {rp['s']:.5f} | unfused "
            f"loss {ru['loss']:.5f} lc {ru['lc']:.5f} lr {ru['lr']:.5f} s {ru['s']:.5f}"
        )
    print(f"[6] fused kernel vs fused plain metrics: worst difference {worst:.3g} "
          f"(<= {FUSED_TRAIN_TOL}, first step <= 0.03)")
    first, first_u = hist[0]["loss"], others["unfused"][0].history[0]["loss"]
    if not abs(first - first_u) <= 0.10 * abs(first_u):
        raise AssertionError(f"first-step loss fused {first} vs unfused {first_u}")
    print(f"[6] first-step loss: fused {first:.5f}, unfused {first_u:.5f} "
          f"({abs(first - first_u) / abs(first_u):.3%} apart, <= 10%)")
    del others["plain"]

    # one request served from the trained fused model: the eval branch
    # (library convs, folded running-stat affine), no fused kernel
    images, labels = make_requests(np.random.default_rng(7), (64,), cfg.image_size,
                                   cfg.num_classes)[0]
    reset_counts()
    poses = make_inference_fn(kern.model, kern.problem)(images, labels)
    torch.cuda.synchronize()
    counts = read_counts()
    if poses.shape != (64, 3) or not bool(torch.isfinite(poses).all()):
        raise AssertionError(f"bad poses from the fused model: {tuple(poses.shape)}")
    if counts != {**dict.fromkeys(counts, 0), "normalize": 1, "stem_pool": 1}:
        raise AssertionError(f"serving from the fused model launched {counts}")
    twin = build_model(base, dev, param_dtype=torch.float32)
    twin.load_state_dict(kern.model.state_dict())
    got = outputs(kern.model, kern.problem, images, labels, dev, torch.bfloat16, kernel=True)
    ref = outputs(twin, kern.problem, images, labels, dev, torch.bfloat16, kernel=True)
    errs = [float((g - r).abs().max()) / float(r.abs().max()) for g, r in zip(got[:2], ref[:2])]
    # bf16 folded affine against float32 eval BN in each of 53 BNs: 10% of max
    if not max(errs) <= 0.1:
        raise AssertionError(f"fused eval vs unfused eval: {errs}")
    print(f"[6] served 64 images from the trained fused model (launches {counts}); scores and "
          f"residual within {max(errs):.3g} of the unfused model's largest (<= 0.1)")
    del twin

    # step time: 10 interleaved pairs of main steps against the unfused path
    unf, ustate = others["unfused"]
    batch = kern._to_device(next(_interleave(real, render)))
    step_k = kern.train_step_fn("main", dual_stream=True)
    step_u = unf.train_step_fn("main", dual_stream=True)
    state, _ = timed_steps(step_k, state, batch, 2)
    ustate, _ = timed_steps(step_u, ustate, batch, 2)
    peaks = {}
    for name, fn, st in (("fused", step_k, state), ("unfused", step_u, ustate)):
        torch.cuda.reset_peak_memory_stats()
        timed_steps(fn, st, batch, 1)
        peaks[name] = torch.cuda.max_memory_allocated() / 2**30
    t_k, t_u = [], []
    for i in range(10):
        for path in (("k", "u") if i % 2 == 0 else ("u", "k")):
            if path == "k":
                state, t = timed_steps(step_k, state, batch, 1)
                t_k += t
            else:
                ustate, t = timed_steps(step_u, ustate, batch, 1)
                t_u += t
    med_k, med_u = statistics.median(t_k), statistics.median(t_u)
    print(
        f"[6] bf16 main train step, {n_img} images on the card, 10 interleaved pairs: "
        f"fused kernel path median {med_k * 1e3:.3f} ms = {n_img / med_k:.1f} img/s "
        f"(q1 {np.percentile(t_k, 25) * 1e3:.3f}, q3 {np.percentile(t_k, 75) * 1e3:.3f}), "
        f"peak {peaks['fused']:.2f} GiB; unfused path median {med_u * 1e3:.3f} ms = "
        f"{n_img / med_u:.1f} img/s (q1 {np.percentile(t_u, 25) * 1e3:.3f}, q3 "
        f"{np.percentile(t_u, 75) * 1e3:.3f}), peak {peaks['unfused']:.2f} GiB; fused faster in "
        f"{sum(a < b for a, b in zip(t_k, t_u))} of 10 pairs"
    )
    if profile:
        state = profile_steps("fused kernel path", step_k, state, batch)
        ustate = profile_steps("unfused path", step_u, ustate, batch)
    return {"launches": launches, "img_s": n_img / med_k, "unfused_img_s": n_img / med_u}


KMEANS_CUT = dict(n_init=1, num_iters=10)  # the defaults are 4 restarts of 100 steps
GMM_CUT = dict(n_init=1, num_iters=5)


def make_poses(n: int, dev) -> torch.Tensor:
    """n axis-angle poses on the card from seeded Euler angles in degrees:
    azimuth uniform over the circle, elevation N(10, 15) clipped to
    [-45, 80], tilt N(0, 8) clipped to [-45, 45] (views of objects standing
    on the ground, as render trees hold them), turned by euler_to_pose."""
    rng = np.random.default_rng(9)
    euler = np.stack([
        rng.uniform(-180, 180, n),
        np.clip(rng.normal(10, 15, n), -45, 80),
        np.clip(rng.normal(0, 8, n), -45, 45),
    ], axis=1).astype(np.float32)
    return euler_to_pose(torch.from_numpy(euler).to(dev))


def make_tree(root: Path, classes, per_class: int) -> None:
    """A render-style tree of empty .png files whose names encode the pose."""
    rng = np.random.default_rng(10)
    for cls in classes:
        (root / cls).mkdir(parents=True)
        for j in range(per_class):
            name = make_name(f"{cls}_{j:06d}object0", rng.uniform(0, 360), rng.uniform(-30, 60),
                             rng.uniform(-25, 25), 4.0)
            (root / cls / f"{name}.png").touch()


def phase_dictionary(
    dev, smi: str, n: int = 2_000_000, k: int = 200, n_gmm: int = 200_000
) -> tuple[KMeansDictionary, GMMDictionary, int]:
    y = make_poses(n, dev)
    torch.cuda.synchronize()
    print(f"[7] {n} axis-angle poses on the card (seeded Euler angles: az uniform, el N(10, 15), "
          f"ct N(0, 8) degrees); K {k}; depth cut to {KMEANS_CUT} (kmeans) and {GMM_CUT} on the "
          f"first {n_gmm} poses (GMM); card: {smi}")

    # the counted run: fit, predict, residuals
    assign.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    kd = fit_kmeans(y, k, seed=0, device=dev, **KMEANS_CUT)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    bins = kd.predict(y, device=dev)
    res = kd.residuals(y, device=dev)
    launches = assign.launches
    expect = KMEANS_CUT["n_init"] * (KMEANS_CUT["num_iters"] + 1) + 2
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[7] fit_kmeans: {fit_s:.3f} s on {smi}, inertia {kd.inertia:.2f}, peak device memory "
          f"{peak:.2f} GiB; assign launches {launches} = n_init * (num_iters + 1) + 1 predict + 1 "
          f"residuals = {expect}")
    if launches != expect:
        raise AssertionError(f"assign kernel launched {launches} times, expected {expect}")

    c = kd.cluster_centers
    if c.shape != (k, 3) or c.dtype != np.float32 or not np.isfinite(c).all():
        raise AssertionError(f"bad centers: {c.shape} {c.dtype}")
    start = fit_kmeans(y, k, seed=0, device=dev, n_init=1, num_iters=0)
    if not (np.isfinite(kd.inertia) and kd.inertia < start.inertia):
        raise AssertionError(f"inertia {kd.inertia} not below the start's {start.inertia}")
    want = assign.assign_bins_plain(y, torch.from_numpy(c).to(dev)).cpu().numpy()
    if bins.dtype != np.int32 or not np.array_equal(bins, want):
        raise AssertionError(f"predict differs from plain on {int((bins != want).sum())} rows")
    y_host = y.cpu().numpy()
    if not np.array_equal(res, y_host - c[bins]):
        raise AssertionError("residuals differ from y - centers[predict(y)]")
    used = len(np.unique(bins))
    again = fit_kmeans(y, k, seed=0, device=dev, **KMEANS_CUT)
    if not (np.array_equal(again.cluster_centers, c) and again.inertia == kd.inertia):
        raise AssertionError("two fits from one seed differ")
    with tempfile.TemporaryDirectory() as tmp:
        kd.save(Path(tmp) / "kmeans.npz")
        back = KMeansDictionary.load(Path(tmp) / "kmeans.npz")
    if not (np.array_equal(back.cluster_centers, c) and back.inertia == kd.inertia):
        raise AssertionError("kmeans .npz round trip")
    print(f"[7] kmeans: inertia {kd.inertia:.2f} below the kmeans++ start's {start.inertia:.2f}; "
          f"predict over {n} poses equal to plain ({used} of {k} bins used); residuals consistent; "
          f"a second fit from seed 0 bit-equal; .npz round trip")
    del want, y_host, res

    # where the fit's time goes: the seeding and the Lloyd steps on their own
    t0 = time.perf_counter()
    centers0 = kmeans._kmeans_pp_init(y, k, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    seed_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    kmeans._lloyd(y, centers0, KMEANS_CUT["num_iters"])
    torch.cuda.synchronize()
    lloyd_s = time.perf_counter() - t0
    bins_dev = assign.assign_bins(y, centers0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(KMEANS_CUT["num_iters"]):
        kmeans._cluster_sums(y, bins_dev, k)
    torch.cuda.synchronize()
    sums_s = time.perf_counter() - t0
    print(f"[7] fit_kmeans by part (host clock, {smi}): greedy kmeans++ seeding {seed_s:.3f} s, "
          f"{KMEANS_CUT['num_iters']} Lloyd steps + inertia {lloyd_s:.3f} s, of which the one-hot "
          f"cluster sums {sums_s:.3f} s")
    del bins_dev

    # the GMM the probabilistic preset trains on
    y_g = y[:n_gmm]
    t0 = time.perf_counter()
    gd = fit_gmm(y_g, k, seed=0, device=dev, **GMM_CUT)
    torch.cuda.synchronize()
    gmm_s = time.perf_counter() - t0
    one = fit_gmm(y_g, k, seed=0, device=dev, n_init=1, num_iters=1)
    eig = np.linalg.eigvalsh(gd.covariances.astype(np.float64))
    ok = (np.isfinite(gd.log_likelihood) and gd.log_likelihood >= one.log_likelihood
          and abs(float(gd.weights.sum()) - 1.0) <= 1e-4 and (gd.weights >= 0).all()
          and np.isfinite(gd.means).all() and eig.min() > 0
          and gd.means.shape == (k, 3) and gd.covariances.shape == (k, 3, 3))
    print(f"[7] fit_gmm: {gmm_s:.3f} s on {smi}, log-likelihood {gd.log_likelihood:.1f} after "
          f"{GMM_CUT['num_iters']} steps (after 1: {one.log_likelihood:.1f}), weights sum "
          f"{float(gd.weights.sum()):.6f}, least covariance eigenvalue {eig.min():.3g}")
    if not ok:
        raise AssertionError("fit_gmm: bad mixture")
    proba = gd.predict_proba(y_g[:4096], device=dev)
    if proba.shape != (4096, k) or not np.allclose(proba.sum(1), 1.0, atol=1e-4):
        raise AssertionError("predict_proba: rows do not sum to 1")
    with tempfile.TemporaryDirectory() as tmp:
        gd.save(Path(tmp) / "gmm.npz")
        back = GMMDictionary.load(Path(tmp) / "gmm.npz")
    if not all(np.array_equal(getattr(back, a), getattr(gd, a))
               for a in ("means", "covariances", "weights")):
        raise AssertionError("gmm .npz round trip")

    # the command a user runs, on a small tree, in its own process
    with tempfile.TemporaryDirectory() as tmp:
        make_tree(Path(tmp) / "render", PASCAL3D_CLASSES, 50)
        out = Path(tmp) / "kmeans_dictionary_axis_angle_16.npz"
        cmd = [sys.executable, "-m", f"{PORT}.cli", "dictionary", "--data-root",
               str(Path(tmp) / "render"), "--size", "16", "--out", str(out)]
        run = subprocess.run(cmd, cwd=Path(__file__).resolve().parent, capture_output=True,
                             text=True, timeout=300)
        if run.returncode != 0:
            raise AssertionError(f"cli dictionary exited {run.returncode}:\n{run.stdout}{run.stderr}")
        small = KMeansDictionary.load(out)
    if small.cluster_centers.shape != (16, 3) or not np.isfinite(small.cluster_centers).all():
        raise AssertionError("cli dictionary: bad file")
    print(f"[7] cli dictionary (subprocess, {50 * len(PASCAL3D_CLASSES)} named files, K 16): "
          f"exit 0; {run.stdout.strip().splitlines()[-1]}")
    return kd, gd, launches


def phase_train_soft(dev, preset: str, dictionary) -> None:
    """[8]: 2 main epochs of one full-width step each (after relaxed_bd's
    warm-up epoch) under the step decay, kernel path against plain path."""
    cfg = get_config(
        preset, compute_dtype="bfloat16", stem_pool="kernel", items_per_batch=4,
        max_iterations=1, num_epochs=2,
    )
    kern = Trainer(cfg, dictionary=dictionary, device=dev)
    init_sd = {k: v.clone() for k, v in kern.model.state_dict().items()}
    rng = np.random.default_rng(11)
    real, render = (make_loader(rng, 1, cfg.items_per_batch, cfg.image_size, cfg.num_classes)
                    for _ in range(2))
    before = bn_stats(kern.model)
    reset_counts()
    assign.launches = 0
    state = kern.fit(kern.init_state(), real, render, log_every=1)
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_counts().items() if v}
    n = state.step
    if n != cfg.num_warmup_epochs + 2 or assign.launches != 0 or launches != {
            "normalize": n, "stem_pool": 2 * n, "stem_pool_bwd": 2 * n}:
        raise AssertionError(f"{preset}: {n} steps, launches {launches}, assign {assign.launches}")
    keys = ("loss", "lc", "lr", "s", "alpha")
    hist = kern.history
    for rec in hist:
        if not (all(np.isfinite(rec[k]) for k in keys) and rec["lc"] > 0 and rec["lr"] > 0):
            raise AssertionError(f"{preset}: bad metrics at step {rec['step']}: {rec}")
    rates = [rec["learning_rate"] for rec in hist if rec["phase"] == "main"]
    if not np.allclose(rates, [cfg.init_lr * 0.1, cfg.init_lr * 0.01], rtol=1e-12):
        raise AssertionError(f"{preset}: main-epoch learning rates {rates}")
    after = bn_stats(kern.model)
    stuck = [k for k in before if torch.equal(before[k], after[k])]
    if stuck:
        raise AssertionError(f"{preset}: running statistics that did not move: {stuck[:5]}")
    plain = Trainer(cfg.replace(stem_pool="plain"), dictionary=dictionary, device=dev)
    plain.model.load_state_dict(init_sd)
    with plain_normalize():
        plain.fit(plain.init_state(), real, render, log_every=1)
    torch.cuda.synchronize()
    worst = worst_decode = 0.0
    for rk, rp in zip(hist, plain.history, strict=True):
        for k in keys:
            err = abs(rk[k] - rp[k]) / (1.0 if k == "s" else abs(rp[k]))
            if cfg.problem == "relaxed_kmeans" and rk["phase"] == "main" and k in ("loss", "lr"):
                limit, worst_decode = SOFT_DECODE_TOL, max(worst_decode, err)
            else:
                limit, worst = TRAIN_TOL, max(worst, err)
            if not err <= limit:
                raise AssertionError(f"{preset} step {rk['step']} {k}: kernel {rk[k]} plain {rp[k]}")
        print(
            f"[8] {preset} step {rk['step']} {rk['phase']} at learning rate "
            f"{rk['learning_rate']:.3g}: kernel loss {rk['loss']:.5f} lc {rk['lc']:.5f} lr "
            f"{rk['lr']:.5f} s {rk['s']:.5f} | plain loss {rp['loss']:.5f} lc {rp['lc']:.5f} "
            f"lr {rp['lr']:.5f} s {rp['s']:.5f}"
        )
    print(f"[8] {preset}: {n} steps of {2 * len(real[0]['label'])} images, launches {launches} "
          f"and no assign launch; metrics finite, lc and lr nonzero; all {len(before)} running "
          f"statistics moved; kernel vs plain worst difference {worst:.3g} (<= {TRAIN_TOL})"
          + (f", main-phase loss and Lr through the argmax decode {worst_decode:.3g} "
             f"(<= {SOFT_DECODE_TOL})" if worst_decode else ""))
    del kern, plain, state
    torch.cuda.empty_cache()


USER_TREE = (("augmented2", 8, 1), ("renderforcnn", 8, 2), ("test", 1, 3))
TIMING_PER_CLASS = 120  # 120-122 items a class: 30 batches an epoch at 4 items
TIMING_REPEATS = 3


def host_cpu() -> str:
    """The host CPU as lscpu or /proc/cpuinfo names it, and its core count."""
    name = ""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
        name = next((ln.split(":", 1)[1].strip() for ln in out.splitlines()
                     if ln.startswith("Model name:")), "")
    except (OSError, subprocess.TimeoutExpired):
        pass
    if not name or name == "unknown":
        info = {}
        for ln in Path("/proc/cpuinfo").read_text().splitlines():
            key, _, val = ln.partition(":")
            info.setdefault(key.strip(), val.strip())
        name = (f"{info.get('model name', 'unknown')} (vendor {info.get('vendor_id', '?')}, "
                f"family {info.get('cpu family', '?')}, model {info.get('model', '?')})")
    return f"{name}, {os.cpu_count()} cores"


def rate_line(rates) -> str:
    """Median img/s with the least and the most of the repeats."""
    return f"{statistics.median(rates):.1f} img/s (min {min(rates):.1f}, max {max(rates):.1f})"


def loader_epoch(start) -> tuple[float, float]:
    """One epoch of `start()`'s batches: seconds to the first batch (the
    prefetch thread and decode pool started, the first batch decoded), and
    img/s over the rest of the epoch."""
    t0 = time.perf_counter()
    it = start()
    next(it)
    t1 = time.perf_counter()
    n = sum(len(b["label"]) for b in it)
    return t1 - t0, n / (time.perf_counter() - t1)


def _stamped(batches, stamps: list):
    """Yield `batches`, stamping the host clock each time the next is asked for."""
    for b in batches:
        yield b
        stamps.append(time.perf_counter())


def read_records(path: Path) -> list[dict]:
    return [json.loads(line) for line in path.read_text().splitlines()]


def phase_user_command(dev, smi: str, dictionary: KMeansDictionary, step: dict) -> int:
    """[10]: `cli train` of the full-width geodesic_bd preset from PNG trees,
    in a subprocess, then its resume in this process. Returns the normalize
    launches of the resumed run."""
    cpu = host_cpu()
    where = f"card {smi}; host {cpu}"
    # what the first decode of every new process pays: without a library in
    # build/native/ it tries the build (two g++ runs when that fails)
    built = native.library_path().exists()
    probe = (f"import time\nfrom {PORT}.data import native\nt = time.perf_counter()\n"
             f"ok = native.available()\nprint(ok, time.perf_counter() - t)")
    ok, took = subprocess.run([sys.executable, "-c", probe], cwd=Path(__file__).resolve().parent,
                              capture_output=True, text=True, timeout=900,
                              check=True).stdout.split()[-2:]
    before = ("a library was in build/native/ already" if built else
              "no library in build/native/, so a build was tried")
    print(f"[10] native.available() in a fresh process: {ok} after {float(took):.3f} s "
          f"({before}); {where}")
    route = ("native libpng decode (data/native.py)" if native.available() else
             "PIL, per file (the native decode library does not build here: no libpng headers "
             "or no g++)")
    print(f"[10] decode route on this host: {route}; {where}")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        data = tmp / "data"
        t0 = time.perf_counter()
        for sub, per_class, seed in USER_TREE:
            generate_pose_dataset(data / sub, PASCAL3D_CLASSES, per_class, 224, seed=seed,
                                  pattern="pose")
        pngs = {sub: sorted((data / sub).rglob("*.png")) for sub, _, _ in USER_TREE}
        print(f"[10] wrote {', '.join(f'{len(v)} {k}' for k, v in pngs.items())} 224 px PNGs "
              f"(tools/synthetic, pattern 'pose') in {time.perf_counter() - t0:.2f} s")
        npz = tmp / "kmeans_dictionary_axis_angle_200.npz"
        dictionary.save(npz)
        wd = tmp / "run"
        args = ["train", "--preset", "geodesic_bd", "--data-root", str(data), "--dictionary",
                str(npz), "--compute-dtype", "bfloat16", "--items-per-batch", "4",
                "--num-warmup-epochs", "1", "--num-epochs", "2", "--max-iterations", "2",
                "--workdir", str(wd)]
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", f"{PORT}.cli", *args],
                             cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                             timeout=900)
        run_s = time.perf_counter() - t0
        if run.returncode != 0:
            raise AssertionError(f"cli train exited {run.returncode}:\n{run.stdout}{run.stderr}")
        ck = wd / "checkpoints"
        names = sorted(p.name for p in ck.iterdir())
        with np.load(wd / "plots.npz") as f:
            curve = f["val_loss"]
        recs = read_records(wd / "metrics.jsonl")
        sub_med = float(run.stdout.split("final MedErr ")[1].split()[0])
        saved = torch.load(ck / "final", map_location="cpu", weights_only=True)
        if not (names == ["best", "final", "last"] and curve.shape == (2,)
                and sum("med_err" in r for r in recs) == 2 and np.isfinite(sub_med)
                and saved["step"] == 6):
            raise AssertionError(f"cli train: checkpoints {names}, plots {curve}, step "
                                 f"{saved['step']}, final MedErr {sub_med}:\n{run.stdout}")
        logged = [(r["step"], round(r["images_per_sec"], 1)) for r in recs if "images_per_sec" in r]
        print(f"[10] cli train (subprocess): exit 0 in {run_s:.1f} s; 6 steps of 96 images (2 "
              f"warm-up + 2 x 2 main), checkpoints {names}, plots.npz {curve.round(3).tolist()}, "
              f"{run.stdout.strip().splitlines()[-1]}")
        print(f"[10] cli train logged train img/s (step, img/s; each the first step of an epoch, "
              f"loader wait and first-call costs included): {logged}; {where}")

        # the restored `final` evaluated here, TF32 off
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        parsed = cli.build_parser().parse_args(args)
        cfg = cli._config_from_args(parsed)
        trainer = Trainer(cfg, dictionary=dictionary, workdir=wd, device=dev)
        real, render, test = cli._make_loaders(parsed, cfg)
        state = trainer.restore_checkpoint("final")
        med = trainer.evaluate(state, test)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = trainer.evaluate(state, test)
        eval_s = time.perf_counter() - t0
        if not (abs(med - sub_med) <= 1e-3 and again == med):
            raise AssertionError(f"restored final: MedErr {med}, {again} against the run's {sub_med}")
        print(f"[10] restored `final` (step {state.step}): MedErr {med:.6f} deg against the "
              f"subprocess's {sub_med:.3f} (<= 1e-3 deg, TF32 off); one eval pass "
              f"({len(pngs['test'])} images, {len(test)} padded batch of {cfg.eval_batch}) "
              f"{eval_s * 1e3:.1f} ms wall; {where}")
        t0 = time.perf_counter()
        trainer.save_checkpoint(state, "timing")
        copy_s = time.perf_counter() - t0
        trainer.wait_for_checkpoints()
        write_s = time.perf_counter() - t0
        size = (ck / "timing").stat().st_size
        print(f"[10] one checkpoint write: {write_s:.3f} s wall ({size / 2**20:.1f} MiB; "
              f"{copy_s:.3f} s of it on the caller's thread, the copy to the host); {where}")
        (ck / "timing").unlink()
        del trainer, state

        # --resume in this process
        reset_counts()
        if cli.main(args + ["--resume"]) != 0:
            raise AssertionError("cli train --resume failed")
        torch.cuda.synchronize()
        counts = read_counts()
        final = torch.load(ck / "final", map_location="cpu", weights_only=True)
        resumed = read_records(wd / "metrics.jsonl")[len(recs):]
        n_steps = final["step"] - saved["step"]
        n_evals = len(test) * (cfg.num_epochs + 1)
        if not (final["step"] == 12 and resumed[0]["step"] == 7
                and counts == {**{k: 0 for k in counts}, "normalize": n_steps + n_evals}):
            raise AssertionError(f"resume: step {final['step']}, first logged {resumed[0]}, "
                                 f"launches {counts}")
        print(f"[10] --resume (this process): from step {saved['step']} to {final['step']}, "
              f"normalize launches {counts['normalize']} = {n_steps} train steps + {n_evals} "
              f"eval batches, no other kernel (stem_pool and fused_conv_bn stay off, as the "
              f"JAX package's 'auto' resolves them)")

        # labels out of range never reach the card
        dbinfo = tmp / "dbinfo.mat"
        spio.savemat(str(dbinfo), {"classes": np.array(PASCAL3D_CLASSES, dtype=object)})
        try:
            cli.main(args + ["--dbinfo", str(dbinfo), "--num-classes", "3"])
            raise AssertionError("--num-classes 3 against 12 classes was not refused")
        except SystemExit as e:
            refused_cli = str(e)
        trainer = Trainer(cfg, dictionary=dictionary, device=dev)
        batch = next(iter(real))
        batch["label"] = batch["label"] + 1  # 1..12 with 12 classes
        try:
            trainer.fit(trainer.init_state(), [batch], [batch])
            raise AssertionError("a label of 12 with 12 classes was not refused")
        except ValueError as e:
            refused_fit = str(e)
        after = trainer.evaluate(trainer.init_state(), test)  # the context still works
        torch.cuda.synchronize()
        if trainer.history or not np.isfinite(after):
            raise AssertionError(f"after the refusal: history {trainer.history}, MedErr {after}")
        print(f"[10] labels out of range refused on the host, no step run: cli "
              f"({refused_cli}); fit ({refused_fit}); an eval pass on the card afterwards: "
              f"MedErr {after:.3f} deg")
        del trainer

        # the host pipeline's rates, on a tree of 30 batches an epoch a loader
        timing = tmp / "timing"
        t0 = time.perf_counter()
        for sub, per_class, seed in (("augmented2", TIMING_PER_CLASS, 11),
                                     ("renderforcnn", TIMING_PER_CLASS, 12), ("test", 1, 13)):
            generate_pose_dataset(timing / sub, PASCAL3D_CLASSES, per_class, 224, seed=seed,
                                  pattern="pose")
        parsed_t = cli.build_parser().parse_args(
            [str(timing) if a == str(data) else a for a in args])
        real_t, render_t, _ = cli._make_loaders(parsed_t, cfg)
        paths = [str(p) for sub in ("augmented2", "renderforcnn")
                 for p in sorted((timing / sub).rglob("*.png"))]
        print(f"[10] timing tree: {len(paths)} training PNGs of 224 px (tools/synthetic), "
              f"{len(real_t)} batches of {real_t.batch_images} an epoch a loader, written in "
              f"{time.perf_counter() - t0:.2f} s")
        pools = {t: concurrent.futures.ThreadPoolExecutor(t) for t in (1, 4, 8)}
        decode = {t: [] for t in pools}
        try:
            for t, pool in pools.items():  # threads started before the clock
                loader._decode_many(paths[:64], 224, pool, t)
            for _ in range(TIMING_REPEATS):
                for t, pool in pools.items():
                    t0 = time.perf_counter()
                    loader._decode_many(paths, 224, pool, t)
                    decode[t].append(len(paths) / (time.perf_counter() - t0))
        finally:
            for pool in pools.values():
                pool.shutdown()
        print(f"[10] decode_image ({route.split(' (')[0]}), {TIMING_REPEATS} passes of "
              f"{len(paths)} files at each thread count, interleaved: "
              + "; ".join(f"{t} thread{'s' * (t > 1)} {rate_line(r)}" for t, r in decode.items())
              + f"; {where}")

        trainer = Trainer(cfg.replace(max_iterations=None), dictionary=dictionary, device=dev)
        state = trainer.init_state()
        step_fn = trainer.train_step_fn("main", dual_stream=True)
        batch = trainer._to_device(next(_interleave(real_t, render_t)))
        n_img = len(batch["label"])
        state, _ = timed_steps(step_fn, state, batch, 2)
        state, t_alone = timed_steps(step_fn, state, batch, 10)
        starts, one, zipped, fit = [], [], [], []
        for _ in range(TIMING_REPEATS):
            first, rate = loader_epoch(lambda: iter(real_t))
            starts.append(first)
            one.append(rate)
            first, rate = loader_epoch(lambda: _interleave(real_t, render_t))
            starts.append(first)
            zipped.append(rate)
            stamps, step0 = [], state.step
            state = trainer.run_epoch(state, _stamped(real_t, stamps), render_t, "main",
                                      log_every=10**9)
            torch.cuda.synchronize()
            # steps 2..N: stamps[0] is taken after step 1, whose log waited for the card
            fit.append((state.step - step0 - 1) * n_img / (time.perf_counter() - stamps[0]))
        lo, hi = step["img_s_iqr"]
        print(f"[10] host loaders at --num-workers {parsed.num_workers}, {TIMING_REPEATS} epochs "
              f"each, interleaved with the runs below, the rest of an epoch after its first "
              f"batch: one BalancedLoader {rate_line(one)}; the real and render loaders zipped, "
              f"as a step takes them, {rate_line(zipped)}; an epoch's start (threads, pool, "
              f"first batch), not in the rates: median {statistics.median(starts):.3f} s; "
              f"{where}")
        print(f"[10] main train step of this config alone ({n_img} images on the card, 10 steps "
              f"each synchronized): {rate_line([n_img / t for t in t_alone])}; [5]'s step "
              f"(stem kernels on) {step['img_s']:.1f} img/s (quartiles {lo:.1f}-{hi:.1f}); "
              f"Trainer.run_epoch fed by the two loaders, steps 2-{len(real_t)} of "
              f"{TIMING_REPEATS} epochs: {rate_line(fit)}; {where}")
        del trainer, state, batch
        torch.cuda.empty_cache()
    return counts["normalize"]


def main() -> None:
    name, smi = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    norm = phase_normalize(dev, flush)
    stem = phase_stem(dev, flush)
    stem_bwd = phase_stem_bwd(dev, flush)
    mm, mm_bwd = phase_fused(dev, flush, is_3x3=False)
    c3, c3_bwd = phase_fused(dev, flush, is_3x3=True)
    assign_rec = phase_assign(dev, flush)
    del flush
    torch.cuda.empty_cache()
    dictionary = make_dictionary(get_config("geodesic_bd").dict_size)
    serve = phase_serve(dev, dictionary)
    train = phase_train(dev, dictionary)
    fused = phase_train_fused(dev, dictionary, profile="--profile" in sys.argv[1:])
    kmeans_dict, gmm_dict, assign_launches = phase_dictionary(dev, smi)
    phase_train_soft(dev, "probabilistic_bd", gmm_dict)
    phase_train_soft(dev, "relaxed_bd", kmeans_dict)
    cli_launches = phase_user_command(dev, smi, kmeans_dict, train)
    # launches: each kernel's count over the 4 steps of its training path
    # ([5] unfused, [6] fused) or over the dictionary path's fit, predict and
    # residuals ([7]); serving's counts are in [4]
    fused_src = f"{PORT}/csrc/fused_%s.cu"
    fused_at = f"{JAX_PACKAGE}/ops/fused_conv_bn.py:%d"
    kernels = [
        {"name": "normalize", "route": "cuda",
         "source": f"{PORT}/csrc/normalize.cu",
         "replaces": f"{JAX_PACKAGE}/ops/preprocess.py:60",
         "launches": train["launches"]["normalize"],
         "serving_launches": serve["launches"]["normalize"],
         "cli_train_resume_launches": cli_launches, **norm},
        {"name": "stem_pool", "route": "cuda",
         "source": f"{PORT}/csrc/stem_pool.cu",
         "replaces": f"{JAX_PACKAGE}/ops/stem_pool.py:162",
         "launches": train["launches"]["stem_pool"],
         "serving_launches": serve["launches"]["stem_pool"], **stem},
        {"name": "stem_pool_bwd", "route": "cuda",
         "source": f"{PORT}/csrc/stem_pool.cu",
         "replaces": f"{JAX_PACKAGE}/ops/stem_pool.py:186",
         "launches": train["launches"]["stem_pool_bwd"], **stem_bwd},
        {"name": "mm_stats", "route": "cuda", "source": fused_src % "mm",
         "replaces": fused_at % 215, "launches": fused["launches"]["mm"], **mm},
        {"name": "mm_stats_bwd", "route": "cuda", "source": fused_src % "mm",
         "replaces": fused_at % 447, "launches": fused["launches"]["mm_bwd"], **mm_bwd},
        {"name": "c3_fwd", "route": "cuda", "source": fused_src % "c3",
         "replaces": fused_at % 805, "launches": fused["launches"]["c3"], **c3},
        {"name": "c3_bwd", "route": "cuda", "source": fused_src % "c3",
         "replaces": fused_at % 878, "launches": fused["launches"]["c3_bwd"], **c3_bwd},
        {"name": "assign", "route": "cuda", "source": f"{PORT}/csrc/assign.cu",
         "replaces": f"{JAX_PACKAGE}/ops/assign.py:45", "launches": assign_launches,
         **assign_rec},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
