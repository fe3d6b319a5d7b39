#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: its kernels, serving, training,
evaluation, the quality-parity gate, the single-model pose zoo, the
two-stage and joint category + pose pipelines, and the ObjectNet, VGG,
resize, flip and remat slice.

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
  11 the packed caches and the evaluation commands over [10]'s trees and
     `final` checkpoint: `cli pack --packed-cache auto` as a subprocess
     (exit 0, its wall time, the decode route); a PackedBalancedLoader and
     a PackedTestLoader byte-equal to the PNG loaders over one epoch; `cli
     evaluate --packed-cache auto --checkpoint final --eval-num-epochs 3`
     in this process (the snapshot ensemble: c = 4 from 2 steps an epoch,
     snapshots num0.npz and num1.npz after fine-tune steps 2 and 6, finite
     MedErrs, the ensembled MedErr recomputed from the two files within
     1e-6 deg of the run's, exactly one normalize launch per fine-tune step
     and per test batch of each snapshot and no other kernel); `cli predict
     --packed-cache auto --checkpoint final` as a subprocess, its
     results_run.npz MedErr within 1e-3 deg of the MedErr [10]'s resume
     printed for the same `final`; then on [10]'s timing tree: 3 cold
     packs, one PackedBalancedLoader and the two zipped, the step alone and
     `run_epoch` fed by the packed loaders (3 repeats, median (min, max)),
     beside [10]'s PNG-fed rate, the card and the host CPU
  12 the data-prep, detection and quality-parity chain at full width (bf16,
     4 items a class a stream, ResNet50 to layer4, N1 1000, N2 500, K 200,
     12 classes, 224 px): a synthesized release (tools/synthetic, 2 images
     a split) and `cli prepare-data --dataset pascal3d` as a subprocess; a
     render tree (`prepare-data --dataset synthetic --images-per-class 20`,
     252 named poses); the VOC val images' GT boxes as maskrcnn results
     cropped by `prepare-detections --image-size 224`; `cli verify-parity
     --render-root --det-path --annotations` in this process, depth cut to
     2 steps an epoch, 1 warm-up + 1 main epoch, 1 fine-tune epoch: exit 0,
     five stages with finite numbers, each stage's wall time, exactly 6
     steps + test batches x (2 + snapshots) + detection batches normalize
     launches and 4 x 101 assign launches (the K 200 fit); again, reusing
     every artifact with the same stages and one test pass; `cli predict
     --det-path --checkpoint ensemble_final` (one launch a detection batch)
     and `cli evaluate-detections`, whose table equals the gate's;
     run_detection_inference's kernel path against its plain path (the
     plain normalize on the card) from that checkpoint, bf16 within
     SERVE_RTOL and f32 with TF32 off within 1e-4
  13 the single-model pose zoo at full width (ResNet50 to layer4, N0 2048,
     N1 1000, N2 500, N3 100, each preset's K of 200, 100 or 16, 12
     classes, 224 px, bf16, 2 x 4 items x 12 classes = 96 images a step):
     K 16 and K 100 kmeans dictionaries fitted on the card from [7]'s
     2,000,000 poses at [7]'s depth cut (exactly 11 assign launches each),
     beside [7]'s K 200 kmeans and GMM; Trainer.fit of each of the 19
     presets the zoo adds, 1 warm-up + 1 main step (2 main epochs of 1
     step for a single-phase preset, so its 'step' decay moves the rate),
     stem_pool 'kernel' for the bin-delta kinds and None for the
     models/pose kinds: per step exactly 1 normalize, 2 stem and 2 stem
     backward launches (0 and 0 for the models/pose kinds), no assign
     launch, finite metrics, Lc nonzero but for the regression problems, Lr
     nonzero but for classification, each step's rate, every running
     statistic moved, riemannian_bd's warm-up s carried into its main step;
     8 of them (ZOO_COMPARE: each new model kind and problem family) again
     through the plain path from the same weights within TRAIN_TOL, then
     one 64-image request served from the trained model through
     make_inference_fn against the plain path within SERVE_RTOL;
     geodesic_bd_multires' peak memory, its head bank's per-forward bf16
     cast and product (CUDA events), and its main step against [5]'s
     geodesic_bd step in 5 interleaved pairs (host clock); `cli train
     --preset geodesic_bd_quaternion` and `--preset geodesic_regression`
     (no --dictionary) as two subprocesses at once over [10]'s trees (1 +
     1 epochs of 2 steps): exit 0, finite MedErrs; `cli evaluate
     --checkpoint final --eval-num-epochs 1` of the quaternion run in this
     process: its ensembled MedErr within 1e-6 deg of the one recomputed
     from the snapshot file
  14 the two-stage and joint category + pose pipelines at full width
     (ResNet50 to layer4, N0 2048, N1 1000, N2 500, N3 100, K 200 or the
     preset's own 16, 12 classes, 224 px, bf16, 96 images a step):
     Trainer.fit of each of the 14 presets, 1 warm-up + 1 main step (2 main
     epochs of 1 step for a single-phase preset), stem_pool 'kernel' for the
     _rene presets' one_bin_delta trunk: per step exactly 1 normalize, 2
     stem (0 for the other kinds) and no stem backward launch (the _rene
     trunk is frozen: no gradient runs into it), no assign launch; finite
     metrics, Lc zero exactly for the _rene problems and Lr for the category
     problem, each step's rate, every train_only-frozen leaf bit-equal,
     running statistics moved exactly where BN trains (none under
     frozen_bn, res_models' alone under bn_train_only); 4 of them
     (JOINT_COMPARE) through the plain path from the same weights within
     TRAIN_TOL; one 64-image request of each of the 6 new kinds through
     make_inference_fn (1 normalize launch) against the plain path on the
     rows whose argmax choices (category, bin, joint posterior) the two
     paths cannot make differently (a top-2 margin over twice the paths'
     largest difference); then
     `cli dictionary` in this process (K 200 over [10]'s timing render
     tree, exactly 4 x 101 assign launches), chain 1 as one subprocess
     (`cli train classification` -> `cli train simple_bd_rene
     --warm-start-kind classifier`: the rene run's trunk and bin heads the
     classifier's bits after its frozen fine-tune) beside chain 2 in this
     process ([10]'s geodesic_bd `final` -> `cli train joint_cat_pose_top1
     --warm-start-kind oracle` -> `cli train cat_given_pose --warm-start-kind
     oracle` -> `cli predict --analysis --checkpoint final,last`: grafted
     tensors bit-equal to their sources, launches exact, the .mat's
     ypred_pose (N, 3, 12), the analysis kernel vs plain on clear rows)
  15 the ObjectNet slice at full width (ResNet50 to layer4, N1 1000, N2
     500, N3 100, 100 classes, 224 px, bf16, one flat batch of 96 images a
     step): Trainer.fit of each of the five objectnet_* presets, 1 warm-up
     + 1 main step (2 main epochs of 1 step for objectnet_classification),
     stem_pool 'kernel': per step exactly 1 normalize, 1 stem and 1 stem
     backward launch, no assign launch, finite metrics, Lc nonzero but for
     regression, Lr nonzero but for classification, each step's rate,
     every running statistic moved; objectnet_bd and objectnet_bd_multires
     again through the plain path within TRAIN_TOL; objectnet_bd on
     vgg16/fc7 and vgg13/fc6 (1 normalize and no stem launch a step); one
     64-image request of each label-concat kind and of the VGG16 model
     through make_inference_fn against the plain path on the rows clear of
     a tie (`_clear`); geodesic_bd (dual loaders, 96 images) one main step
     with device_resize_from 256 + train_flip (no normalize launch: the
     resize path normalizes with the plain version, as the JAX package
     does) and one with train_flip alone (1), then a step under each remat
     mode against remat None from the same weights: its metrics and every
     parameter's gradient (difference over remat None's norm) within
     TRAIN_TOL, 4 stem launches (the recomputed stem), every BN counter
     advanced once a stream, a peak below remat None's; each mode's
     host-clock step time and peak memory; and remat 'block' on the fused
     trunk against its own remat None, metrics and gradients within
     FUSED_TRAIN_TOL (the forward kernels launched twice); then one
     subprocess: `cli prepare-data --dataset objectnet3d` on a synthesized
     release, `cli dictionary` (K 16, exactly 4 x 101 assign launches),
     `cli train --preset objectnet_bd_multires --train-flip` and `cli
     predict` on its `final`: exit 0, finite MedErrs
  9  one JSON line of the kernels (times, plain times and the bound of each:
     the larger of bytes moved over 3.35 TB/s and operations over the peak
     rate of their type; `zoo_launches` their launches in [13],
     `joint_launches` in [14], `objectnet_launches` in [15]), then the
     result line
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
import contextlib
import io
import json
import os
import shutil
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

from multi_modal_regression_tpu_torch import PASCAL3D_CLASSES, cli, detection  # noqa: E402
from multi_modal_regression_tpu_torch.data import FlatTestIndex, loader, native, packed  # noqa: E402
from multi_modal_regression_tpu_torch.data.loader import normalize_images  # noqa: E402
from multi_modal_regression_tpu_torch.data.naming import make_name  # noqa: E402
from multi_modal_regression_tpu_torch.data.targets import euler_to_pose  # noqa: E402
from multi_modal_regression_tpu_torch.dictionary import kmeans  # noqa: E402
from multi_modal_regression_tpu_torch.dictionary.gmm import GMMDictionary, fit_gmm  # noqa: E402
from multi_modal_regression_tpu_torch.dictionary.kmeans import (  # noqa: E402
    KMeansDictionary,
    fit_kmeans,
)
from multi_modal_regression_tpu_torch.metrics import mean_class_median_error  # noqa: E402
from multi_modal_regression_tpu_torch.models import surgery  # noqa: E402
from multi_modal_regression_tpu_torch.models.heads import HeadBatchNorm  # noqa: E402
from multi_modal_regression_tpu_torch.ops import (  # noqa: E402
    _build,
    assign,
    fused_conv_bn,
    preprocess,
    stem_pool,
)
from multi_modal_regression_tpu_torch.serving import make_inference_fn  # noqa: E402
from multi_modal_regression_tpu_torch.tools import parity  # noqa: E402
from multi_modal_regression_tpu_torch.tools.ingest import (  # noqa: E402
    load_annotations_for_images,
    read_image_set,
)
from multi_modal_regression_tpu_torch.tools.synthetic import (  # noqa: E402
    generate_pascal3d_release,
    generate_pose_dataset,
)
from multi_modal_regression_tpu_torch.tools.time_fused import (  # noqa: E402
    C3_SHAPES,
    MM_SHAPES,
    REPS,
    cuda_ms,
    fused_inputs,
)
from multi_modal_regression_tpu_torch.train import steps  # noqa: E402
from multi_modal_regression_tpu_torch.train.analysis import run_joint_analysis  # noqa: E402
from multi_modal_regression_tpu_torch.train.evaluator import (  # noqa: E402
    SnapshotEnsembleEvaluator,
    ensemble_poses,
)
from multi_modal_regression_tpu_torch.train.presets import (  # noqa: E402
    build_model,
    build_problem,
    get_config,
    trained_parameters,
)
from multi_modal_regression_tpu_torch.train.problems import DICTIONARY_FREE  # noqa: E402
from multi_modal_regression_tpu_torch.train.schedules import epoch_lr_factor  # noqa: E402
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
# [13]'s problems whose main-phase Lr is taken at the argmax bin of nearly
# flat scores after one step, held like relaxed_bd's at SOFT_DECODE_TOL:
# log_euclidean regresses the residual target of the PREDICTED bin, so a
# flipped bin swaps the target itself (measured on an H100: Lr 19.8% apart on
# its second step, the first step's metrics equal)
ARGMAX_TARGET_PROBLEMS = ("log_euclidean",)
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


def compare(tag, kern, plain, rtol, phase: str = "4") -> float:
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
        f"[{phase}] {tag}: scores/residual max err {worst:.3g}, poses max err "
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


class _Tee(io.StringIO):
    """A copy of what is written, passed on to `out` as it comes."""

    def __init__(self, out):
        super().__init__()
        self.out = out

    def write(self, text: str) -> int:
        self.out.write(text)
        return super().write(text)


@contextlib.contextmanager
def tee_stdout():
    """Standard output as it is printed, kept for the caller to read."""
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        yield tee


def phase_user_command(dev, smi: str, dictionary: KMeansDictionary, step: dict,
                       tmp: Path) -> dict:
    """[10]: `cli train` of the full-width geodesic_bd preset from PNG trees
    written under `tmp`, in a subprocess, then its resume in this process.
    Returns the normalize launches of the resumed run and what [11] reuses:
    the train arguments, the trees, the resumed `final`'s printed MedErr,
    the decode route and the PNG-fed rates."""
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
    with tee_stdout() as resumed_out:
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
    return {"launches": counts["normalize"], "args": args, "data": data, "timing": timing,
            "final_med": float(resumed_out.getvalue().split("final MedErr ")[1].split()[0]),
            "route": route, "png_fed": fit, "step_alone": [n_img / t for t in t_alone]}


def same_batches(tag: str, got, want) -> int:
    """Fail unless two loaders' epochs are equal key by key, byte for byte;
    returns the number of batches."""
    n = 0
    for g, w in zip(got, want, strict=True):
        if sorted(g) != sorted(w) or any(
                g[k].dtype != w[k].dtype or not np.array_equal(g[k], w[k]) for k in w):
            raise AssertionError(f"{tag}: batch {n} differs from the PNG loader's")
        n += 1
    return n


def phase_packed_eval(dev, smi: str, dictionary: KMeansDictionary, user: dict) -> int:
    """[11]: `cli pack`, `cli evaluate` (the snapshot ensemble) and `cli
    predict` over [10]'s trees and `final` checkpoint, then the packed
    loaders' rates on [10]'s timing tree. Returns the normalize launches of
    the evaluate run."""
    where = f"card {smi}; host {host_cpu()}"
    args, data = user["args"], user["data"]
    root = Path(__file__).resolve().parent
    wd = Path(args[args.index("--workdir") + 1])
    model_args = args[args.index("--dictionary"):]  # dictionary, config, workdir
    pack_args = ["pack", "--preset", "geodesic_bd", "--data-root", str(data),
                 "--items-per-batch", "4", "--packed-cache", "auto"]
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", f"{PORT}.cli", *pack_args], cwd=root,
                         capture_output=True, text=True, timeout=600)
    pack_s = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"cli pack exited {run.returncode}:\n{run.stdout}{run.stderr}")
    print(f"[11] cli pack --packed-cache auto (subprocess): exit 0 in {pack_s:.2f} s wall, "
          f"process start included; decode route {user['route'].split(' (')[0]}; "
          + "; ".join(ln.split(": ", 1)[1] for ln in run.stdout.strip().splitlines())
          + f"; {where}")

    # the packed loaders against the PNG loaders of the same flags and seed
    packed_parsed = cli.build_parser().parse_args(args + ["--packed-cache", "auto"])
    cfg = cli._config_from_args(packed_parsed)
    preal, _, ptest = cli._make_loaders(packed_parsed, cfg)
    real, _, test = cli._make_loaders(cli.build_parser().parse_args(args), cfg)
    n_real = same_batches("PackedBalancedLoader", iter(preal), iter(real))
    n_test = same_batches("PackedTestLoader", iter(ptest), iter(test))
    print(f"[11] {type(preal).__name__} and {type(ptest).__name__} byte-equal to the PNG "
          f"loaders over one epoch ({n_real} and {n_test} batches, images, Euler angles, "
          f"labels, valid)")

    # cli evaluate in this process: c = 2 x 2 batches, 3 epochs of 2 steps
    eval_args = ["evaluate", "--preset", "geodesic_bd", "--data-root", str(data), *model_args,
                 "--packed-cache", "auto", "--checkpoint", "final", "--eval-num-epochs", "3"]
    seen = []
    ensemble = SnapshotEnsembleEvaluator.ensemble

    def spy(self):
        seen.append(ensemble(self))
        return seen[-1]

    reset_counts()
    assign_before = assign.launches
    SnapshotEnsembleEvaluator.ensemble = spy
    try:
        t0 = time.perf_counter()
        with tee_stdout() as out:
            if cli.main(eval_args) != 0:
                raise AssertionError("cli evaluate failed")
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
    finally:
        SnapshotEnsembleEvaluator.ensemble = ensemble
    counts = read_counts()
    text = out.getvalue()
    res = wd / "results_run"
    files = sorted(p.name for p in res.iterdir())
    snaps = []
    for k in range(2):
        with np.load(res / f"num{k}.npz") as z:
            snaps.append({key: z[key] for key in z.files})
    meds = [mean_class_median_error(z["ytest"], z["yhat_test"], z["test_labels"],
                                    cfg.num_classes) for z in snaps]
    ens = mean_class_median_error(
        snaps[0]["ytest"], ensemble_poses([z["yhat_test"] for z in snaps], "axis_angle"),
        snaps[0]["test_labels"], cfg.num_classes)
    printed = float(text.split("ensembled MedErr: ")[1].split()[0])
    n_test = len(test)
    want = {**{k: 0 for k in counts}, "normalize": 6 + 2 * n_test}
    if not (files == ["num0.npz", "num1.npz"] and [int(z["step"]) for z in snaps] == [2, 6]
            and np.all(np.isfinite(meds)) and np.isfinite(ens) and len(seen) == 1
            and abs(seen[0][0] - ens) <= 1e-6 and f"{seen[0][0]:.4f}" == f"{printed:.4f}"
            and counts == want and assign.launches == assign_before):
        raise AssertionError(f"cli evaluate: files {files}, steps "
                             f"{[int(z['step']) for z in snaps]}, MedErrs {meds}, ensembled "
                             f"{ens} (run {seen}, printed {printed}), launches {counts}:\n{text}")
    print(f"[11] cli evaluate --packed-cache auto --checkpoint final --eval-num-epochs 3 (this "
          f"process): exit 0 in {eval_s:.2f} s wall; snapshots num0.npz, num1.npz after "
          f"fine-tune steps 2 and 6 (c = 4), MedErr {meds[0]:.4f}, {meds[1]:.4f} deg; "
          f"ensembled {printed:.4f} deg (from the two files: {ens:.6f}, the run's "
          f"{seen[0][0]:.6f}); normalize launches {counts['normalize']} = 6 fine-tune steps + "
          f"2 snapshots x {n_test} test batch, no other kernel; {where}")

    # cli predict as a subprocess, against [10]'s printed MedErr of `final`
    pred_args = ["predict", "--preset", "geodesic_bd", "--data-root", str(data), *model_args,
                 "--packed-cache", "auto", "--checkpoint", "final"]
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", f"{PORT}.cli", *pred_args], cwd=root,
                         capture_output=True, text=True, timeout=600)
    pred_s = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"cli predict exited {run.returncode}:\n{run.stdout}{run.stderr}")
    with np.load(wd / "results_run.npz") as z:
        pred = {key: z[key] for key in z.files}
    med = mean_class_median_error(pred["ytest"], pred["yhat_test"], pred["test_labels"],
                                  cfg.num_classes)
    said = float(run.stdout.split("MedErr ")[-1])
    if not (sorted(pred) == ["test_labels", "yhat_test", "ytest"]
            and pred["yhat_test"].shape == (len(ptest.index), 3) and abs(med - said) <= 1e-4
            and abs(med - user["final_med"]) <= 1e-3):
        raise AssertionError(f"cli predict: MedErr {med} (printed {said}) against [10]'s "
                             f"{user['final_med']}:\n{run.stdout}")
    print(f"[11] cli predict --packed-cache auto --checkpoint final (subprocess): exit 0 in "
          f"{pred_s:.2f} s wall; results_run.npz of {len(pred['test_labels'])} poses, MedErr "
          f"{med:.6f} deg against [10]'s {user['final_med']:.3f} for the same `final` "
          f"(<= 1e-3 deg); {run.stdout.strip().splitlines()[-2].strip()}")

    # the packed pipeline's rates on [10]'s timing tree
    timing = user["timing"]
    parsed_t = cli.build_parser().parse_args(
        [str(timing) if a == str(data) else a for a in args] + ["--packed-cache", "auto"])
    pack_times = []
    for _ in range(TIMING_REPEATS):
        shutil.rmtree(timing / ".packed", ignore_errors=True)
        t0 = time.perf_counter()
        real_t, render_t, test_t = cli._make_loaders(parsed_t, cfg)
        pack_times.append(time.perf_counter() - t0)
    n_png = sum(len(ld.pack.meta["classes"][c]) for ld in (real_t, render_t)
                for c in ld.pack.meta["classes"])
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
    times = (f"{statistics.median(pack_times):.3f} s (min {min(pack_times):.3f}, max "
             f"{max(pack_times):.3f})")
    print(f"[11] pack of the timing tree ({n_png} training PNGs + {len(test_t.index)} test, "
          f"224 px, cli._make_loaders with --packed-cache auto, {TIMING_REPEATS} cold packs): "
          f"{times}, {(n_png + len(test_t.index)) / statistics.median(pack_times):.1f} img/s; "
          f"decode route "
          f"{user['route'].split(' (')[0]}; {where}")
    print(f"[11] packed loaders, {TIMING_REPEATS} epochs each, interleaved with the runs below, "
          f"the rest of an epoch after its first batch: one PackedBalancedLoader "
          f"{rate_line(one)}; the two zipped {rate_line(zipped)}; an epoch's start median "
          f"{statistics.median(starts):.3f} s; {where}")
    print(f"[11] main train step of this config alone ({n_img} images, 10 steps each "
          f"synchronized): {rate_line([n_img / t for t in t_alone])}; Trainer.run_epoch fed by "
          f"the two packed loaders, steps 2-{len(real_t)} of {TIMING_REPEATS} epochs: "
          f"{rate_line(fit)}; [10] in this run: fed by the PNG loaders "
          f"{rate_line(user['png_fed'])}, the step alone {rate_line(user['step_alone'])}; "
          f"{where}")
    del trainer, state, batch
    torch.cuda.empty_cache()
    return counts["normalize"]


# [12]: the gate's cut in depth (verify-parity's flags; full widths), and
# the synthesized release's size (12 classes, 96 px images)
GATE_CUT = ["--max-iterations", "2", "--num-epochs", "1", "--num-warmup-epochs", "1",
            "--eval-num-epochs", "1"]
GATE_IMAGES_PER_SPLIT = 2


class stage_clock:
    """Wall seconds of the calls to some functions, summed per stage, the
    card synchronized at the end of each call; the functions restored on
    exit."""

    def __init__(self, targets):
        self.targets = targets  # (owner, attribute, stage)
        self.times: dict[str, float] = {}

    def _wrap(self, fn, stage: str):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                self.times[stage] = self.times.get(stage, 0.0) + time.perf_counter() - t0
        return timed

    def __enter__(self):
        self.saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in self.targets]
        for (owner, attr, stage), (_, _, fn) in zip(self.targets, self.saved):
            setattr(owner, attr, self._wrap(fn, stage))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in self.saved:
            setattr(owner, attr, fn)


def phase_gate(dev, smi: str, tmp: Path) -> dict:
    """[12]: the data-prep, detection and quality-parity chain at full width
    from a synthesized release: `cli prepare-data --dataset pascal3d` (a
    subprocess), a render tree and a detection set, `cli verify-parity`
    twice, `cli predict --det-path` and `cli evaluate-detections`, then
    run_detection_inference's kernel path against its plain path. Returns
    the gate's launches of #1 and #3."""
    where = f"card {smi}; host {host_cpu()}"
    root = Path(__file__).resolve().parent
    classes = PASCAL3D_CLASSES
    t0 = time.perf_counter()
    db, voc = generate_pascal3d_release(tmp / "release", classes=classes,
                                        images_per_split=GATE_IMAGES_PER_SPLIT)
    release_s = time.perf_counter() - t0
    data = tmp / "prepared"
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", f"{PORT}.cli", "prepare-data", "--dataset",
                          "pascal3d", "--db-path", str(db), "--voc-dir", str(voc), "--out",
                          str(data)], cwd=root, capture_output=True, text=True, timeout=900)
    prep_s = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"cli prepare-data exited {run.returncode}:\n{run.stdout}{run.stderr}")
    trees = {sub: len(list((data / sub).rglob("*.png" if sub != "original" else "*/*.mat")))
             for sub in ("train", "test", "augmented2", "original")}
    print(f"[12] release of {len(classes)} classes ({GATE_IMAGES_PER_SPLIT} images a split, "
          f"96 px; tools/synthetic) written in {release_s:.2f} s; cli prepare-data --dataset "
          f"pascal3d (subprocess): exit 0 in {prep_s:.2f} s wall, process start included: "
          f"{trees['train']} train, {trees['test']} test and {trees['augmented2']} augmented2 "
          f"crops, {trees['original']} original .mat files; {where}")

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        if cli.main(["prepare-data", "--dataset", "synthetic", "--images-per-class", "20",
                     "--out", str(tmp / "synthetic")]) != 0:
            raise AssertionError("cli prepare-data --dataset synthetic failed")
    render = tmp / "synthetic" / "renderforcnn"
    n_render = len(list(render.rglob("*.png")))
    # the maskrcnn protocol over the VOC val images, each class's GT boxes
    # as its detections
    dets = tmp / "dets"
    dets.mkdir()
    names = read_image_set(voc / "ImageSets" / "Main" / "val.txt")
    for cls in classes:
        rows = [f"{n} {a.bbox[0]} {a.bbox[1]} {a.bbox[2]} {a.bbox[3]} 0.9" for n in names
                for a in load_annotations_for_images(db / "Annotations" / f"{cls}_pascal",
                                                     [n])[0] or ()]
        (dets / f"results_{cls}.txt").write_text("\n".join(rows) + "\n")
    det_set = dets / "det_set"
    with contextlib.redirect_stdout(io.StringIO()):
        if cli.main(["prepare-detections", "--detector", "maskrcnn", "--det-source", str(dets),
                     "--images-dir", str(voc / "JPEGImages"), "--image-set",
                     str(voc / "ImageSets" / "Main" / "val.txt"), "--out", str(det_set),
                     "--image-size", "224"]) != 0:
            raise AssertionError("cli prepare-detections failed")
    index = detection.DetectionSetIndex(str(det_set))
    samples = [index.load_image(i) for i in range(len(index))]
    xdata = np.ascontiguousarray(np.concatenate([x["xdata"] for x in samples if x is not None]))
    labels = np.concatenate([x["labels"] for x in samples if x is not None])
    inputs_s = time.perf_counter() - t0
    print(f"[12] render tree (cli prepare-data --dataset synthetic --images-per-class 20): "
          f"{n_render} named poses; detection set (cli prepare-detections --detector maskrcnn "
          f"--image-size 224, the VOC val images' GT boxes as detections): {len(xdata)} crops "
          f"over {len(index)} images; both in {inputs_s:.2f} s")

    # the gate, in this process: its launches counted, its stages timed
    wd = tmp / "gate"
    gate_args = ["verify-parity", "--data-root", str(data), "--render-root", str(render),
                 "--det-path", str(det_set), "--annotations", str(db / "Annotations"),
                 "--workdir", str(wd), "--compute-dtype", "bfloat16", "--items-per-batch", "4",
                 *GATE_CUT]
    cfg = get_config("geodesic_bd", compute_dtype="bfloat16", items_per_batch=4)
    targets = [(parity, "fit_pose_dictionary", "dictionary"),
               (packed, "pack_index", "pack"), (Trainer, "fit", "train"),
               (SnapshotEnsembleEvaluator, "run", "evaluate"),
               (detection, "run_detection_inference", "detections")]
    runs = []
    for attempt in ("first", "again"):
        reset_counts()
        assign.launches = 0
        with stage_clock(targets) as clock, tee_stdout() as out:
            t0 = time.perf_counter()
            rc = cli.main(gate_args)
            torch.cuda.synchronize()
            gate_s = time.perf_counter() - t0
        counts = {**read_counts(), "assign": assign.launches}
        table = json.loads((wd / "parity.json").read_text())
        runs.append((counts, table, clock.times, gate_s, out.getvalue()))
        if rc != 0:
            raise AssertionError(f"cli verify-parity ({attempt}) exited {rc}")
    (counts, table, times, gate_s, text), (counts2, table2, times2, gate2_s, text2) = runs
    stages = table["stages"]
    numbers = [stages["train"]["med_err_deg"], stages["evaluate"]["ensembled_med_err_deg"],
               stages["evaluate"]["acc_pi_6_pct"], *stages["evaluate"]["snapshot_med_errs"],
               *(v for row in stages["evaluate"]["per_class"].values() for v in row.values()),
               *(v for row in stages["detections"].values() for v in row.values())]
    n_test = -(-len(FlatTestIndex(str(data / "test"), classes=classes)) // cfg.eval_batch)
    n_det = -(-len(xdata) // cfg.eval_batch)
    n_snap = len(stages["evaluate"]["snapshot_med_errs"])
    # 2 warm-up + 2 main steps, an eval after the main epoch and one after
    # fit, 2 fine-tune steps, a test pass per snapshot, the detection batches
    want = {**{k: 0 for k in counts}, "normalize": 4 + 2 + n_test * (2 + n_snap) + n_det,
            "assign": 4 * 101}
    if not (set(stages) == {"prepare_data", "dictionary", "train", "evaluate", "detections"}
            and np.all(np.isfinite(numbers)) and counts == want
            and set(stages["detections"]) == {*classes, "mean"}):
        raise AssertionError(f"cli verify-parity: stages {sorted(stages)}, launches {counts} "
                             f"against {want}:\n{text}")
    stage_line = ", ".join(f"{k} {v:.2f} s" for k, v in times.items())
    mean = stages["detections"]["mean"]
    print(f"[12] cli verify-parity (this process; geodesic_bd {cfg.feature_network}/"
          f"{cfg.feature_layer} N1 {cfg.N1} N2 {cfg.N2} K {cfg.dict_size}, {cfg.num_classes} "
          f"classes, {cfg.image_size} px, bf16, "
          f"4 items a class a stream, {' '.join(GATE_CUT)}): exit 0 in {gate_s:.2f} s wall; "
          f"stages {stage_line} (prepare_data above: {prep_s:.2f} s); launches {counts} = "
          f"6 steps + {n_test} test batch x (2 + {n_snap} snapshot) + {n_det} detection "
          f"batch, and 4 x 101 assign for the K {cfg.dict_size} kmeans fit; {where}")
    print(f"[12] parity table: train MedErr {stages['train']['med_err_deg']} deg, snapshots "
          f"{stages['evaluate']['snapshot_med_errs']}, ensembled "
          f"{stages['evaluate']['ensembled_med_err_deg']} deg, Acc@pi/6 "
          f"{stages['evaluate']['acc_pi_6_pct']}%; detections mean AP {mean['ap']} AVP "
          f"{mean['avp']} ARP {mean['arp']} (random weights trained 6 steps: a check of the "
          f"path, not a quality); deviations {len(table['deviations'])}")
    want2 = {**{k: 0 for k in counts2}, "normalize": n_test}
    if not (all(table2["stages"][k] == stages[k] for k in stages) and counts2 == want2
            and "skipping training" in text2 and "skipping fine-tune" in text2
            and "cached results exist" in text2 and "dictionary" not in times2):
        raise AssertionError(f"cli verify-parity again: stages differ or artifacts not "
                             f"reused, launches {counts2}:\n{text2}")
    print(f"[12] cli verify-parity again: exit 0 in {gate2_s:.2f} s wall; every artifact "
          f"reused (no fit, no fine-tune, detections.json), the same five stages; launches "
          f"{counts2} (the train stage's test pass of `final`); {where}")

    # cli predict --det-path on the gate's ensembled checkpoint, then
    # evaluate-detections on its results: the gate's detection table
    dict_path = wd / f"kmeans_{cfg.dict_size}.npz"
    model_args = ["--preset", "geodesic_bd", "--dictionary", str(dict_path),
                  "--workdir", str(wd), "--compute-dtype", "bfloat16"]
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["predict", *model_args, "--checkpoint", "ensemble_final", "--det-path",
                       str(det_set)])
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    pred_counts = read_counts()
    results = wd / f"results_run_{det_set.name}.mat"
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc2 = cli.main(["evaluate-detections", "--results", str(results), "--det-path",
                        str(det_set), "--annotations", str(db / "Annotations"), "--out",
                        str(wd / "det_table.json")])
    edet_s = time.perf_counter() - t0
    got = json.loads((wd / "det_table.json").read_text())
    rounded = {c: {k: round(float(v), 4) for k, v in row.items()} for c, row in got.items()}
    if not (rc == rc2 == 0 and rounded == stages["detections"]
            and pred_counts == {**{k: 0 for k in pred_counts}, "normalize": n_det}):
        raise AssertionError(f"predict --det-path + evaluate-detections: {rounded} against "
                             f"{stages['detections']}, launches {pred_counts}")
    print(f"[12] cli predict --det-path --checkpoint ensemble_final (this process): exit 0 in "
          f"{pred_s:.2f} s wall, {len(xdata)} poses, normalize launches {n_det}; cli "
          f"evaluate-detections: {edet_s:.2f} s; its AP/AVP/ARP table equals the gate's "
          f"detections stage; {where}")

    # run_detection_inference: kernel path vs plain path on the card, from
    # the ensembled checkpoint, bf16 and then f32 with TF32 off
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dictionary = KMeansDictionary.load(dict_path)
    worst = {}
    for dtype in ("bfloat16", "float32"):
        trainer = Trainer(cfg.replace(compute_dtype=dtype), dictionary=dictionary,
                          workdir=wd, device=dev)
        state = trainer.restore_checkpoint("ensemble_final")
        reset_counts()
        poses = detection.run_detection_inference(state.model, trainer.problem, index,
                                                  batch_size=cfg.eval_batch)[1]
        torch.cuda.synchronize()
        n = read_counts()["normalize"]
        with plain_normalize():
            plain = detection.run_detection_inference(state.model, trainer.problem, index,
                                                      batch_size=cfg.eval_batch)[1]
        if n != n_det or read_counts()["normalize"] != n:
            raise AssertionError(f"{dtype}: normalize launched {n} times for {n_det} batches")
        # (scores, residual, poses) as run_detection_inference computes them:
        # the normalize writes float32, the model casts to its own dtype
        kern, ref = ([torch.cat(t) for t in zip(*(
            outputs(state.model, trainer.problem, xdata[i:i + cfg.eval_batch],
                    labels[i:i + cfg.eval_batch], dev, torch.float32, kernel)
            for i in range(0, len(xdata), cfg.eval_batch)))] for kernel in (True, False))
        ours = np.concatenate([p for p in poses if p.size])
        theirs = np.concatenate([p for p in plain if p.size])
        if not (np.array_equal(ours, kern[2].float().cpu().numpy())
                and np.array_equal(theirs, ref[2].float().cpu().numpy())):
            raise AssertionError(f"{dtype}: run_detection_inference's poses differ from its "
                                 f"path's decode")
        worst[dtype] = compare(f"run_detection_inference {dtype} kernel vs plain path "
                               f"({len(xdata)} crops, {n} normalize launch)", kern, ref,
                               SERVE_RTOL[getattr(torch, dtype)], phase="12")
        del trainer, state
    torch.cuda.empty_cache()
    return {"normalize": counts["normalize"], "assign": counts["assign"],
            "predict_normalize": pred_counts["normalize"], "worst": worst}


# --- [13] the single-model pose zoo ----------------------------------------------------

# the 19 presets this slice ports, in ROADMAP order (4.1-4.5)
ZOO_PRESETS = (
    "simple_bd", "euclidean_bd", "laplacian_bd", "riemannian_bd", "log_euclidean_bd",
    "geodesic_bd_quaternion", "probabilistic_bd_quaternion", "geodesic_bd_multires",
    "probabilistic_bd_multires", "probabilistic_bd_quaternion_multires", "classification",
    "geodesic_regression", "geodesic_regression_quaternion", "independent_regression",
    "independent_bd", "rendered_bd", "ablation_geodesic_bd", "ablation_gbd_augmentation",
    "ablation_c0",
)
# one preset of each new model kind and each new problem family: the same steps
# through the plain path, then one request served both ways
ZOO_COMPARE = (
    "geodesic_bd_multires", "probabilistic_bd_multires", "geodesic_regression_quaternion",
    "classification", "independent_regression", "independent_bd", "riemannian_bd",
    "log_euclidean_bd",
)
# the model kinds whose trunk takes the stem kernels (the models/pose kinds
# have no stem option, in the JAX package either)
BD_KINDS = ("one_bin_delta", "one_delta_per_bin", "probabilistic")


def zoo_config(preset: str):
    """Full width, bf16, 4 items a class a stream, 2 steps: 1 warm-up + 1 main
    step, or 2 main epochs of 1 step for a single-phase preset (so the 'step'
    decay moves the rate)."""
    base = get_config(preset)
    warm = base.num_warmup_epochs > 0
    return get_config(
        preset, compute_dtype="bfloat16", items_per_batch=4, max_iterations=1,
        stem_pool="kernel" if base.model_kind in BD_KINDS else None,
        num_warmup_epochs=1 if warm else 0, num_epochs=1 if warm else 2,
    )


def zoo_outputs(model, problem, images, labels, dev, kernel: bool):
    """(raw outputs as a tuple, poses) of one bf16 request through the kernel
    path (normalize kernel, the model as built) or the plain path."""
    norm = preprocess.normalize_images_cuda if kernel else normalize_images
    with torch.inference_mode():
        x = norm(torch.from_numpy(images).to(dev), torch.bfloat16)
        out = model(x, torch.from_numpy(labels).to(dev))
        return (out if isinstance(out, tuple) else (out,)), problem.decode(out)


def zoo_compare(tag: str, kern, plain, poses_served, cfg, rtol: float) -> float:
    """Raw outputs everywhere within rtol of their largest magnitude; the
    served poses against the plain path's on every row for the regression
    kinds, else on the rows whose top-2 bin-score margin exceeds rtol of the
    largest score (a near tie may pick another bin)."""
    (outs_k, _), (outs_p, poses_p) = kern, plain
    worst = 0.0
    for k, p in zip(outs_k, outs_p, strict=True):
        err = float((k - p).abs().max())
        if not err <= rtol * float(p.abs().max()):
            raise AssertionError(f"[13] {tag} outputs: max err {err:.3g}")
        worst = max(worst, err)
    if cfg.problem.startswith("regression"):
        clear = torch.ones(len(poses_p), dtype=torch.bool, device=poses_p.device)
    else:
        s = outs_p[0]
        top2 = torch.topk(s, 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > rtol * float(s.abs().max())
    perr = float((poses_served[clear] - poses_p[clear]).abs().max()) if clear.any() else 0.0
    if not perr <= rtol * max(float(poses_p.abs().max()), 1.0):
        raise AssertionError(f"[13] {tag} served poses: max err {perr:.3g}")
    print(f"[13] {tag}: one 64-image request through make_inference_fn against the plain path: "
          f"outputs max err {worst:.3g}, poses {tuple(poses_p.shape)} max err {perr:.3g} on "
          f"{int(clear.sum())}/{len(clear)} rows (rtol {rtol:g} of max)")
    return worst


def zoo_dictionaries(dev, smi: str, kmeans_200, gmm) -> tuple[dict, int]:
    """K 16 and K 100 kmeans dictionaries fitted on the card from [7]'s
    poses at [7]'s depth cut; [7]'s K 200 kmeans and GMM beside them.
    Returns them and the assign launches of the two fits."""
    y = make_poses(2_000_000, dev)
    fits, launches = {}, 0
    expect = KMEANS_CUT["n_init"] * (KMEANS_CUT["num_iters"] + 1)
    for k in (16, 100):
        assign.launches = 0
        t0 = time.perf_counter()
        fits[k] = fit_kmeans(y, k, seed=0, device=dev, **KMEANS_CUT)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        c = fits[k].cluster_centers
        if assign.launches != expect or c.shape != (k, 3) or not np.isfinite(c).all():
            raise AssertionError(f"[13] K {k} fit: {assign.launches} assign launches, "
                                 f"centers {c.shape}")
        launches += assign.launches
        print(f"[13] fit_kmeans K {k} over {len(y)} poses ({KMEANS_CUT}): {fit_s:.3f} s on "
              f"{smi}, inertia {fits[k].inertia:.2f}, assign launches {assign.launches} = "
              f"n_init * (num_iters + 1)")
    del y
    torch.cuda.empty_cache()
    return {16: fits[16], 100: fits[100], 200: kmeans_200, "gmm": gmm}, launches


def zoo_dictionary(cfg, dicts):
    if cfg.problem in DICTIONARY_FREE:
        return None
    if cfg.problem in ("probabilistic", "probabilistic_multires"):
        return dicts["gmm"]
    return dicts[cfg.dict_size]


def zoo_checks(preset: str, cfg, hist, launches: dict, before: dict, after: dict) -> None:
    """Exact launches, finite metrics, the terms that must be nonzero, the
    rate of each step, every running statistic moved, riemannian's carried s."""
    n = len(hist)
    bd = cfg.model_kind in BD_KINDS
    want = {**{k: 0 for k in launches}, "normalize": n,
            "stem_pool": 2 * n if bd else 0, "stem_pool_bwd": 2 * n if bd else 0}
    if n != 2 or launches != want:
        raise AssertionError(f"[13] {preset}: {n} steps, launches {launches}, expected {want}")
    for rec in hist:
        if not all(np.isfinite(rec[k]) for k in ("loss", "lc", "lr", "s", "alpha")):
            raise AssertionError(f"[13] {preset}: non-finite metrics {rec}")
        if (rec["lc"] != 0) != (not cfg.problem.startswith("regression")):
            raise AssertionError(f"[13] {preset}: lc {rec['lc']} (problem {cfg.problem})")
        if (rec["lr"] != 0) != (cfg.problem != "classification"):
            raise AssertionError(f"[13] {preset}: lr {rec['lr']} (problem {cfg.problem})")
    epochs = [0] * cfg.num_warmup_epochs + [e + 1 for e in range(cfg.num_epochs)]
    rates = [cfg.init_lr * (epoch_lr_factor(cfg.epoch_lr_decay, e) if cfg.epoch_lr_decay
                            else 1.0) for e in epochs]
    if not np.allclose([r["learning_rate"] for r in hist], rates, rtol=1e-12):
        raise AssertionError(f"[13] {preset}: rates {[r['learning_rate'] for r in hist]}")
    stuck = [k for k in before if torch.equal(before[k], after[k])]
    if stuck:
        raise AssertionError(f"[13] {preset}: running statistics that did not move: {stuck[:5]}")
    if preset == "riemannian_bd":
        # the main step's loss takes the warm-up's s: Lc + exp(-s) Lr + s
        w, m = hist
        carried = m["lc"] + np.exp(-w["s"]) * m["lr"] + w["s"]
        if not (w["s"] != 0 and abs(m["loss"] - carried) <= 1e-3 * abs(m["loss"])
                and abs(m["loss"] - (m["lc"] + m["lr"])) > 1e-3 * abs(m["loss"])):
            raise AssertionError(f"[13] riemannian_bd: s not carried: {hist}")
        print(f"[13] riemannian_bd carries s = {w['s']:.5f} into its main step: loss "
              f"{m['loss']:.5f} = Lc + exp(-s) Lr + s = {carried:.5f} (Lc + Lr = "
              f"{m['lc'] + m['lr']:.5f})")


def zoo_plain(preset, cfg, dictionary, init_sd, real, render, hist, dev,
              phase: str = "13") -> Trainer:
    """The same steps through the plain path from the same weights, held
    within TRAIN_TOL of the kernel path's metrics."""
    plain = Trainer(cfg.replace(stem_pool="plain" if cfg.stem_pool else None),
                    dictionary=dictionary, device=dev)
    plain.model.load_state_dict(init_sd)
    with plain_normalize():
        plain.fit(plain.init_state(), real, render, log_every=1)
    torch.cuda.synchronize()
    worst = worst_argmax = 0.0
    for i, (rk, rp) in enumerate(zip(hist, plain.history, strict=True)):
        for k in ("loss", "lc", "lr", "s", "alpha"):
            if rk[k] == rp[k]:
                continue
            err = abs(rk[k] - rp[k]) / (1.0 if k == "s" else abs(rp[k]))
            if cfg.problem in ARGMAX_TARGET_PROBLEMS and i > 0 and k in ("loss", "lr", "alpha"):
                limit, worst_argmax = SOFT_DECODE_TOL, max(worst_argmax, err)
            else:
                limit, worst = TRAIN_TOL, max(worst, err)
            if not err <= limit:
                raise AssertionError(f"[{phase}] {preset} step {rk['step']} {k}: kernel "
                                     f"{rk[k]} plain {rp[k]}")
    print(f"[{phase}] {preset} kernel vs plain path, {len(hist)} steps from the same weights: "
          f"worst metric difference {worst:.3g} (<= {TRAIN_TOL})"
          + (f", the second step's loss, Lr and alpha through the argmax bin's target "
             f"{worst_argmax:.3g} (<= {SOFT_DECODE_TOL})" if worst_argmax else "") + "; "
          + "; ".join(f"step {rk['step']} {rk['phase']} loss {rk['loss']:.5f} / "
                      f"{rp['loss']:.5f}" for rk, rp in zip(hist, plain.history)))
    return plain


def zoo_multires_cost(dev, smi: str, multires: Trainer, dictionary, real, render) -> dict:
    """The largest head bank (geodesic_bd_multires: 12 x 200 delta heads of
    2048 -> 100 -> 3): its main step against [5]'s geodesic_bd step on the
    same 96-image batch in interleaved pairs (host clock, synchronized), and
    the head bank's per-forward bf16 copy and product."""
    cfg = get_config("geodesic_bd", compute_dtype="bfloat16", stem_pool="kernel",
                     items_per_batch=4, max_iterations=1)
    base = Trainer(cfg, dictionary=dictionary, device=dev)
    batch = multires._to_device(next(_interleave(real, render)))
    n_img = len(batch["label"])
    step_m = multires.train_step_fn("main", dual_stream=True)
    step_b = base.train_step_fn("main", dual_stream=True)
    state_m, state_b = multires.init_state(), base.init_state()
    state_m, _ = timed_steps(step_m, state_m, batch, 2)
    state_b, _ = timed_steps(step_b, state_b, batch, 2)
    t_m, t_b = [], []
    for i in range(5):
        for which in (("m", "b") if i % 2 == 0 else ("b", "m")):
            if which == "m":
                state_m, t = timed_steps(step_m, state_m, batch, 1)
                t_m += t
            else:
                state_b, t = timed_steps(step_b, state_b, batch, 1)
                t_b += t
    bank = multires.model.res_models
    w = bank.fc1_kernel
    feat = torch.randn(n_img // 2, w.shape[1], device=dev, dtype=torch.bfloat16)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    cast_ms = cuda_ms(lambda: w.to(torch.bfloat16), flush, reps=10, held=True)
    wb = w.to(torch.bfloat16)
    mm_ms = cuda_ms(lambda: torch.matmul(feat, wb), flush, reps=10, held=True)
    n_params = sum(p.numel() for p in bank.parameters())
    med_m, med_b = statistics.median(t_m), statistics.median(t_b)
    print(f"[13] geodesic_bd_multires head bank: {w.shape[0]} heads, res_models "
          f"{n_params / 1e6:.1f} M parameters ({4 * n_params / 2**30:.2f} GiB float32 master "
          f"weights); per forward its fc1 kernel {tuple(w.shape)} is cast to bf16 "
          f"({2 * w.numel() / 2**30:.2f} GiB) in {cast_ms:.3f} ms and multiplied by a "
          f"({n_img // 2}, {w.shape[1]}) stream as a broadcast batched product in {mm_ms:.3f} ms "
          f"(device time: CUDA events, L2 flushed, medians of 10); 2 forwards a dual-stream "
          f"step; {smi}")
    print(f"[13] bf16 main train step, {n_img} images, 5 interleaved pairs (host clock): "
          f"geodesic_bd_multires median {med_m * 1e3:.3f} ms = {n_img / med_m:.1f} img/s "
          f"(min {min(t_m) * 1e3:.3f}, max {max(t_m) * 1e3:.3f}); [5]'s geodesic_bd median "
          f"{med_b * 1e3:.3f} ms = {n_img / med_b:.1f} img/s (min {min(t_b) * 1e3:.3f}, max "
          f"{max(t_b) * 1e3:.3f}); {smi}")
    del base, state_b, step_b, wb, feat, flush
    torch.cuda.empty_cache()
    return {"step_ms": med_m * 1e3, "base_step_ms": med_b * 1e3, "cast_ms": cast_ms,
            "mm_ms": mm_ms}


def zoo_cli(dev, smi: str, user: dict, tmp: Path) -> None:
    """`cli train` of geodesic_bd_quaternion and of geodesic_regression (no
    --dictionary) over [10]'s trees, both subprocesses at once; then `cli
    evaluate` of the quaternion run's `final` in this process."""
    root = Path(__file__).resolve().parent
    args, data = user["args"], user["data"]
    npz = args[args.index("--dictionary") + 1]
    common = ["--data-root", str(data), "--compute-dtype", "bfloat16", "--items-per-batch",
              "4"]
    cut = ["--num-warmup-epochs", "1", "--num-epochs", "1", "--max-iterations", "2"]
    runs = {
        "geodesic_bd_quaternion": ["--dictionary", npz, *common, *cut],
        "geodesic_regression": [*common, *cut],
    }
    t0 = time.perf_counter()
    procs = {
        p: subprocess.Popen([sys.executable, "-m", f"{PORT}.cli", "train", "--preset", p, *a,
                             "--workdir", str(tmp / f"zoo_{p}")], cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for p, a in runs.items()
    }
    outs = {}
    for p, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            raise
        if proc.returncode != 0:
            raise AssertionError(f"[13] cli train {p} exited {proc.returncode}:\n{out}{err}")
        outs[p] = out
    wall = time.perf_counter() - t0
    meds = {p: float(o.split("final MedErr ")[1].split()[0]) for p, o in outs.items()}
    saved = torch.load(tmp / "zoo_geodesic_bd_quaternion" / "checkpoints" / "final",
                       map_location="cpu", weights_only=True)
    if not (all(np.isfinite(m) for m in meds.values()) and saved["step"] == 4
            and saved["config"]["problem"] == "geodesic_quat"):
        raise AssertionError(f"[13] cli train: MedErrs {meds}, step {saved['step']}")
    print(f"[13] cli train --preset geodesic_bd_quaternion and --preset geodesic_regression "
          f"(no --dictionary), two subprocesses at once over [10]'s trees (1 warm-up + 1 "
          f"main epoch of 2 steps): both exit 0 in {wall:.1f} s wall; final MedErr (the "
          f"quaternion error) {meds['geodesic_bd_quaternion']:.3f} deg, regression "
          f"{meds['geodesic_regression']:.3f} deg; {smi}")
    eval_args = ["evaluate", "--preset", "geodesic_bd_quaternion", "--dictionary", npz,
                 *common, "--workdir", str(tmp / "zoo_geodesic_bd_quaternion"),
                 "--checkpoint", "final", "--eval-num-epochs", "1"]
    seen = []
    ensemble = SnapshotEnsembleEvaluator.ensemble

    def spy(self):
        seen.append(ensemble(self))
        return seen[-1]

    SnapshotEnsembleEvaluator.ensemble = spy
    try:
        with tee_stdout():
            if cli.main(eval_args) != 0:
                raise AssertionError("[13] cli evaluate failed")
    finally:
        SnapshotEnsembleEvaluator.ensemble = ensemble
    res = tmp / "zoo_geodesic_bd_quaternion" / "results_run"
    snaps = []
    for f in sorted(res.glob("num*.npz")):
        with np.load(f) as z:
            snaps.append({k: z[k] for k in z.files})
    ens = mean_class_median_error(
        snaps[0]["ytest"], ensemble_poses([z["yhat_test"] for z in snaps], "quaternion"),
        snaps[0]["test_labels"], 12, representation="quaternion")
    if not (snaps and snaps[0]["yhat_test"].shape[1] == 4 and len(seen) == 1
            and abs(seen[0][0] - ens) <= 1e-6):
        raise AssertionError(f"[13] cli evaluate: {len(snaps)} snapshots, run {seen}, "
                             f"recomputed {ens}")
    print(f"[13] cli evaluate --preset geodesic_bd_quaternion --checkpoint final "
          f"--eval-num-epochs 1 (this process): {len(snaps)} snapshot of quaternions "
          f"{snaps[0]['yhat_test'].shape}; ensembled MedErr {seen[0][0]:.6f} deg, from the "
          f"files {ens:.6f} (<= 1e-6 deg)")


def phase_zoo(dev, smi: str, kmeans_200, gmm, user: dict, tmp: Path) -> dict:
    """[13]: the 19 presets of the single-model pose zoo at full width."""
    dicts, assign_launches = zoo_dictionaries(dev, smi, kmeans_200, gmm)
    rng = np.random.default_rng(13)
    real, render = (make_loader(rng, 1, 4, 224, 12) for _ in range(2))
    totals = {k: 0 for k in read_counts()}
    serve_launches = {}
    multires = None
    t_all = time.perf_counter()
    for preset in ZOO_PRESETS:
        cfg = zoo_config(preset)
        dictionary = zoo_dictionary(cfg, dicts)
        t0 = time.perf_counter()
        kern = Trainer(cfg, dictionary=dictionary, device=dev)
        build_s = time.perf_counter() - t0
        init_sd = ({k: v.clone() for k, v in kern.model.state_dict().items()}
                   if preset in ZOO_COMPARE else None)
        before = bn_stats(kern.model)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        assign.launches = 0
        t0 = time.perf_counter()
        kern.fit(kern.init_state(), real, render, log_every=1)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = read_counts()
        if assign.launches:
            raise AssertionError(f"[13] {preset}: {assign.launches} assign launches in its steps")
        hist = kern.history
        zoo_checks(preset, cfg, hist, launches, before, bn_stats(kern.model))
        for k, v in launches.items():
            totals[k] += v
        n_params = sum(p.numel() for p in kern.model.parameters())
        print(f"[13] {preset} ({cfg.model_kind}, {cfg.problem}, K {cfg.dict_size}, ndim "
              f"{cfg.ndim}, stem_pool {cfg.stem_pool}): {n_params / 1e6:.1f} M parameters, built "
              f"in {build_s:.1f} s; {len(hist)} steps in {fit_s:.2f} s, launches "
              f"{ {k: v for k, v in launches.items() if v} }, peak {peak:.2f} GiB; "
              + "; ".join(f"{r['phase']} lr {r['learning_rate']:.3g}: loss {r['loss']:.4f} "
                          f"lc {r['lc']:.4f} lr {r['lr']:.4f}" for r in hist))
        if preset == "geodesic_bd_multires":
            multires = {"peak_gib": peak, "params_m": n_params / 1e6}
            multires.update(zoo_multires_cost(dev, smi, kern, dicts[200], real, render))
            print(f"[13] geodesic_bd_multires peak device memory during its fit: {peak:.2f} GiB "
                  f"({n_params / 1e6:.1f} M parameters, Adam mu {cfg.optimizer_dtype}); {smi}")
        if preset in ZOO_COMPARE:
            plain = zoo_plain(preset, cfg, dictionary, init_sd, real, render, hist, dev)
            plain.model.load_state_dict(kern.model.state_dict())
            images, labels = make_requests(np.random.default_rng(14), (64,), 224, 12)[0]
            infer = make_inference_fn(kern.model, kern.problem)
            reset_counts()
            served = infer(images, labels)
            torch.cuda.synchronize()
            serve_launches[preset] = {k: v for k, v in read_counts().items() if v}
            bd = cfg.model_kind in BD_KINDS
            want = {"normalize": 1, **({"stem_pool": 1} if bd else {})}
            if serve_launches[preset] != want:
                raise AssertionError(f"[13] {preset} serve launches {serve_launches[preset]}")
            kern_out = zoo_outputs(kern.model, kern.problem, images, labels, dev, True)
            plain_out = zoo_outputs(plain.model, plain.problem, images, labels, dev, False)
            zoo_compare(preset, kern_out, plain_out, served, cfg, SERVE_RTOL[torch.bfloat16])
            del plain, init_sd
        del kern
        torch.cuda.empty_cache()
    print(f"[13] 19 presets trained, {len(ZOO_COMPARE)} of them against the plain path and "
          f"served, in {time.perf_counter() - t_all:.1f} s; launches over the 38 steps "
          f"{ {k: v for k, v in totals.items() if v} } and assign {assign_launches} for the "
          f"two dictionary fits; {smi}")
    zoo_cli(dev, smi, user, tmp)
    return {**totals, "assign": assign_launches, "multires": multires, "dicts": dicts}


# --- [14] the two-stage and joint category + pose pipelines ------------------------------

# the 14 presets this slice ports, in ROADMAP order (4.6, 4.7, 5, 4.8's two)
JOINT_PRESETS = (
    "simple_bd_rene", "euclidean_bd_rene", "joint_cat_pose_top1", "joint_cat_pose_top1_new",
    "joint_cat_pose_weighted", "joint_cat_pose2_top1", "joint_cat_pose2_weighted",
    "joint_cat_pose3_top1", "joint_cat_pose3_weighted", "elhoseiny_bd", "elhoseiny_regression",
    "categorization", "cat_given_pose", "cat_given_pose3",
)
# the same steps through the plain path: a variant-1 joint_top1, a variant-2
# weighted, the one-stage BD and a _rene fine-tune (the stem kernels under eval BN)
JOINT_COMPARE = ("joint_cat_pose_top1_new", "joint_cat_pose2_weighted", "elhoseiny_bd",
                 "simple_bd_rene")
# one preset of each new model kind: a request served from its trained model
JOINT_SERVE = {
    "joint_cat_pose_top1_new": "joint_bd_v1", "joint_cat_pose2_weighted": "joint_bd_v2",
    "joint_cat_pose3_top1": "joint_reg_v3", "elhoseiny_bd": "elhoseiny_bd",
    "elhoseiny_regression": "elhoseiny_reg", "categorization": "categorization",
}


def joint_config(preset: str):
    """Full width, bf16, 4 items a class a stream, 2 steps: 1 warm-up + 1 main
    step, or 2 main epochs of 1 step for a single-phase preset; the stem
    kernels for the one_bin_delta trunk of the _rene presets (the joint kinds
    have no stem option, in the JAX package either)."""
    base = get_config(preset)
    warm = base.num_warmup_epochs > 0
    return get_config(
        preset, compute_dtype="bfloat16", items_per_batch=4, max_iterations=1,
        stem_pool="kernel" if base.model_kind in BD_KINDS else None,
        num_warmup_epochs=1 if warm else 0, num_epochs=1 if warm else 2,
    )


def joint_dictionary(cfg, dicts):
    if cfg.problem in ("joint_reg", "elhoseiny_reg", "category"):
        return None
    return dicts[cfg.dict_size]


def joint_checks(preset: str, cfg, trainer: Trainer, launches: dict, before: dict) -> dict:
    """Exact launches (the frozen trunk of a _rene step runs no stem backward),
    finite metrics, the terms that must be nonzero, each step's rate, the
    train_only leaves bit-equal, running statistics moved exactly where BN
    trains (none under frozen_bn, res_models' alone under bn_train_only).
    Returns the counts of trained and frozen leaves and of moved statistics."""
    hist, n = trainer.history, len(trainer.history)
    stem = cfg.stem_pool is not None
    want = {**{k: 0 for k in launches}, "normalize": n, "stem_pool": 2 * n if stem else 0}
    if n != 2 or launches != want:
        raise AssertionError(f"[14] {preset}: {n} steps, launches {launches}, expected {want}")
    for rec in hist:
        if not all(np.isfinite(rec[k]) for k in ("loss", "lc", "lr", "s", "alpha")):
            raise AssertionError(f"[14] {preset}: non-finite metrics {rec}")
        if (rec["lc"] != 0) != (not cfg.problem.endswith("rene")):
            raise AssertionError(f"[14] {preset}: lc {rec['lc']} (problem {cfg.problem})")
        if (rec["lr"] != 0) != (cfg.problem != "category"):
            raise AssertionError(f"[14] {preset}: lr {rec['lr']} (problem {cfg.problem})")
    epochs = [0] * cfg.num_warmup_epochs + [e + 1 for e in range(cfg.num_epochs)]
    rates = [cfg.init_lr * (epoch_lr_factor(cfg.epoch_lr_decay, e) if cfg.epoch_lr_decay
                            else 1.0) for e in epochs]
    if not np.allclose([r["learning_rate"] for r in hist], rates, rtol=1e-12):
        raise AssertionError(f"[14] {preset}: rates {[r['learning_rate'] for r in hist]}")
    trained = {id(p) for p in trained_parameters(cfg, trainer.model)}
    names = {k for k, p in trainer.model.named_parameters() if id(p) in trained}
    after = trainer.model.state_dict()
    counts = {"trained": 0, "frozen": 0, "stats_moved": 0, "stats_kept": 0}
    for k, v in after.items():
        if k.endswith("num_batches_tracked"):
            continue
        same = torch.equal(v, before[k])
        if "running" in k:
            scope = cfg.bn_train_only
            trains = not cfg.frozen_bn and (scope is None or k.split(".")[0] in scope)
            if same == trains:
                raise AssertionError(f"[14] {preset}: running statistic {k} "
                                     f"{'did not move' if trains else 'moved'}")
            counts["stats_moved" if trains else "stats_kept"] += 1
        elif k in names:
            counts["trained"] += 1
        elif not same:
            raise AssertionError(f"[14] {preset}: frozen leaf {k} changed")
        else:
            counts["frozen"] += 1
    if not any(not torch.equal(after[k], before[k]) for k in names):
        raise AssertionError(f"[14] {preset}: no trained leaf moved")
    return counts


def _clear(q_kern: torch.Tensor, q_plain: torch.Tensor, rows=None) -> torch.Tensor:
    """The rows whose argmax over the last axis cannot differ between the two
    paths: the plain path's top-2 margin exceeds twice the largest
    difference E between the paths' q (over `rows`, default all), which no
    perturbation of at most E per element can overturn. With E = 0 (the same
    bits) every row is clear but an exact tie."""
    diff = (q_kern - q_plain).abs()
    if rows is not None:
        diff = diff[rows]
    e = float(diff.max()) if diff.numel() else 0.0
    top2 = torch.topk(q_plain, 2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]) > 2 * e


def _log_joint(cat: torch.Tensor, per_head: torch.Tensor) -> torch.Tensor:
    """log(softmax(per-class bin scores) x softmax(category logits)),
    flattened (class, bin): joint_top1's argmax, as a continuous quantity."""
    q = torch.log_softmax(per_head, -1) + torch.log_softmax(cat, -1)[:, :, None]
    return q.reshape(q.shape[0], -1)


def joint_clear_rows(kind: str, mixing: str, kern, plain) -> torch.Tensor:
    """The rows whose argmax choices (category, bin, joint posterior) the two
    paths cannot make differently (`_clear`), from each path's forward
    outputs and, for the variants 1 and 2, its `analysis` outputs (the
    per-class scores): a category argmax only where the mixing takes one
    (top1, top1_st; joint_top1's over (class, bin)), a bin argmax for the
    decoded BD kinds, the class argmax for the classifier."""
    (outs_k, ana_k), (outs_p, ana_p) = kern, plain
    n = outs_p[0].shape[0]
    clear = torch.ones(n, dtype=torch.bool, device=outs_p[0].device)
    if kind in ("joint_bd_v1", "joint_bd_v2"):
        if mixing == "joint_top1":
            return _clear(_log_joint(ana_k[0], ana_k[1]), _log_joint(ana_p[0], ana_p[1]))
        if mixing != "weighted":
            clear &= _clear(outs_k[0], outs_p[0])
        # the mixed bin scores are continuous once the class choice is
        return clear & _clear(outs_k[1], outs_p[1], clear)
    if kind == "joint_reg_v3" and mixing != "weighted" or kind == "categorization":
        return _clear(outs_k[0], outs_p[0])
    if kind == "elhoseiny_bd":
        return _clear(outs_k[1], outs_p[1])
    return clear


def joint_serve(preset: str, kind: str, trainer: Trainer, dev) -> dict:
    """One 64-image request through make_inference_fn (1 normalize launch,
    no other) against the plain path (the plain normalize, the same model):
    raw outputs and served poses, or class ids, on the clear rows within
    SERVE_RTOL (ids equal)."""
    rtol = SERVE_RTOL[torch.bfloat16]
    images, labels = make_requests(np.random.default_rng(15), (64,), 224, 12)[0]
    model = trainer.model
    infer = make_inference_fn(model, trainer.problem)
    reset_counts()
    served = infer(images, labels)
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_counts().items() if v}
    if launches != {"normalize": 1}:
        raise AssertionError(f"[14] {preset} serve launches {launches}")
    paths = []
    for kernel in (True, False):
        outs, dec = zoo_outputs(model, trainer.problem, images, labels, dev, kernel)
        ana = None
        if hasattr(model, "analysis"):
            norm = preprocess.normalize_images_cuda if kernel else normalize_images
            with torch.inference_mode():
                ana = model.analysis(norm(torch.from_numpy(images).to(dev), torch.bfloat16))
        paths.append(((outs, ana), dec))
    ((outs_k, ana_k), _), ((outs_p, ana_p), dec_p) = paths
    clear = joint_clear_rows(kind, getattr(model, "mixing", None), (outs_k, ana_k),
                             (outs_p, ana_p))
    if not clear.any():
        raise AssertionError(f"[14] {preset}: no row clear of a tie between the two paths")
    every = max(float((k - p).abs().max()) for k, p in zip(outs_k, outs_p))  # all rows
    worst = 0.0
    for k, p in zip(outs_k, outs_p, strict=True):
        err = float((k[clear] - p[clear]).abs().max())
        if not err <= rtol * float(p.abs().max()):
            raise AssertionError(f"[14] {preset} outputs on clear rows: max err {err:.3g}")
        worst = max(worst, err)
    if dec_p.dtype == torch.int32:
        if not torch.equal(served[clear], dec_p[clear]):
            raise AssertionError(f"[14] {preset} served class ids differ on clear rows")
        perr = 0.0
    else:
        perr = float((served[clear] - dec_p[clear]).abs().max())
        if not perr <= rtol * max(float(dec_p.abs().max()), 1.0):
            raise AssertionError(f"[14] {preset} served poses: max err {perr:.3g}")
    print(f"[14] {preset} ({kind}): one 64-image request through make_inference_fn (launches "
          f"{launches}) against the plain path: outputs max err {worst:.3g}, served "
          f"{'class ids equal' if dec_p.dtype == torch.int32 else f'poses max err {perr:.3g}'} "
          f"on {int(clear.sum())}/{len(clear)} rows clear of a tie (rtol {rtol:g} of max); "
          f"outputs max err {every:.3g} over all 64 rows")
    return {"outputs_err": worst, "served_err": perr, "clear": int(clear.sum())}


def chain_dictionary(smi: str, user: dict, tmp: Path) -> tuple[Path, int]:
    """`cli dictionary` in this process: a K 200 kmeans over the poses of
    [10]'s timing render tree (the default n_init 4 x 100 Lloyd steps:
    exactly 4 x 101 assign launches). Chain 1 trains on it."""
    npz = tmp / "chain_kmeans_200.npz"
    assign.launches = 0
    t0 = time.perf_counter()
    with tee_stdout() as out:
        if cli.main(["dictionary", "--data-root", str(user["timing"] / "renderforcnn"),
                     "--out", str(npz), "--size", "200"]) != 0:
            raise AssertionError("[14] cli dictionary failed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_poses = int(out.getvalue().split(" poses parsed")[0].split()[-1])
    if assign.launches != 4 * 101 or KMeansDictionary.load(npz).cluster_centers.shape != (200, 3):
        raise AssertionError(f"[14] cli dictionary: {assign.launches} assign launches")
    print(f"[14] cli dictionary (this process) over {n_poses} poses of [10]'s timing render "
          f"tree, K 200, n_init 4 x 100 steps: {wall:.2f} s wall, assign launches "
          f"{assign.launches} = 4 x 101; {smi}")
    return npz, assign.launches


def chain_common(user: dict, npz) -> list[str]:
    return ["--data-root", str(user["data"]), "--dictionary", str(npz), "--compute-dtype",
            "bfloat16", "--items-per-batch", "4", "--max-iterations", "2", "--num-epochs", "1"]


def _sub(sd: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in sd.items() if k.startswith(prefix + ".")}


def _bit_equal(tag: str, got: dict, want: dict) -> int:
    if not got or sorted(got) != sorted(want) or not all(
            torch.equal(got[k].cpu(), want[k].cpu()) for k in got):
        raise AssertionError(f"[14] {tag}: not bit-equal")
    return len(got)


def chain_one_start(user: dict, npz: Path, tmp: Path) -> subprocess.Popen:
    """Chain 1, one subprocess: `cli train classification` then `cli train
    simple_bd_rene --warm-start-kind classifier` from it."""
    common = chain_common(user, npz)
    cls = ["train", "--preset", "classification", *common, "--workdir", str(tmp / "chain_cls")]
    rene = ["train", "--preset", "simple_bd_rene", *common, "--workdir",
            str(tmp / "chain_rene"), "--warm-start-workdir", str(tmp / "chain_cls"),
            "--warm-start-preset", "classification", "--warm-start-kind", "classifier"]
    script = (f"from {PORT} import cli\n"
              f"for args in ({cls!r}, {rene!r}):\n"
              f"    assert cli.main(list(args)) == 0\n")
    return subprocess.Popen([sys.executable, "-c", script], cwd=Path(__file__).resolve().parent,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def chain_one_finish(proc: subprocess.Popen, tmp: Path, t0: float) -> dict:
    """Exit 0; the rene run's trunk and bin heads are the classifier's bits
    after its fine-tune (grafted, then frozen with BN on running statistics)."""
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[14] chain 1 exited {proc.returncode}:\n{out}{err}")
    cls = torch.load(tmp / "chain_cls" / "checkpoints" / "final", map_location="cpu",
                     weights_only=True)
    rene = torch.load(tmp / "chain_rene" / "checkpoints" / "final", map_location="cpu",
                      weights_only=True)
    n = _bit_equal("chain 1 trunk", _sub(rene["model"], "feature_model"),
                   _sub(cls["model"], "feature_model"))
    n += _bit_equal("chain 1 bin heads", _sub(rene["model"], "bin_models"),
                    _sub(cls["model"], "pose_models"))
    meds = [float(x.split()[0]) for x in out.split("final MedErr ")[1:]]
    if "warm-started (classifier)" not in out or len(meds) != 2 or not all(
            np.isfinite(m) for m in meds) or len(rene["optimizer"]) != 8:
        raise AssertionError(f"[14] chain 1 output:\n{out}")
    print(f"[14] chain 1 (one subprocess): cli train classification -> cli train simple_bd_rene "
          f"--warm-start-kind classifier, exit 0 in {wall:.1f} s wall (beside chain 2); the "
          f"rene `final`'s trunk and bin heads bit-equal to the classifier's `final` ({n} "
          f"tensors: grafted, then frozen); Adam state for res_models' 8 leaves only; final "
          f"MedErrs {meds[0]:.3f}, {meds[1]:.3f} deg")
    return {"wall_s": wall, "bit_equal": n}


def chain_two(dev, smi: str, user: dict, tmp: Path) -> dict:
    """Chain 2, in this process: [10]'s geodesic_bd run as the oracle ->
    `cli train joint_cat_pose_top1 --warm-start-kind oracle` -> `cli train
    cat_given_pose --warm-start-kind oracle` from it -> `cli predict
    --analysis` over the joint run's final and last; the analysis kernel vs
    plain path. Returns the normalize launches."""
    args10 = user["args"]
    oracle_wd = Path(args10[args10.index("--workdir") + 1])
    npz = args10[args10.index("--dictionary") + 1]
    common = chain_common(user, npz)
    grafts = []
    graft = surgery.graft_oracle_into_joint

    def spy(dst, src, kind):
        out = graft(dst, src, kind)
        grafts.append({k: v.detach().cpu().clone() for k, v in out.items()})
        return out

    n_test = len(list((user["data"] / "test").rglob("*.png")))
    test_batches = -(-n_test // get_config("geodesic_bd").eval_batch)
    launches = 0
    surgery.graft_oracle_into_joint = spy
    try:
        reset_counts()
        t0 = time.perf_counter()
        with tee_stdout() as out_joint:
            if cli.main(["train", "--preset", "joint_cat_pose_top1", *common, "--workdir",
                         str(tmp / "chain_joint"), "--warm-start-workdir", str(oracle_wd),
                         "--warm-start-preset", "geodesic_bd"]) != 0:
                raise AssertionError("[14] chain 2 joint train failed")
        torch.cuda.synchronize()
        joint_s = time.perf_counter() - t0
        counts = read_counts()
        want = {**{k: 0 for k in counts}, "normalize": 2 + 2 * test_batches}
        if counts != want:
            raise AssertionError(f"[14] chain 2 joint launches {counts}, expected {want}")
        launches += counts["normalize"]
        reset_counts()
        t0 = time.perf_counter()
        with tee_stdout() as out_cat:
            if cli.main(["train", "--preset", "cat_given_pose", *common, "--workdir",
                         str(tmp / "chain_cat"), "--warm-start-workdir", str(tmp / "chain_joint"),
                         "--warm-start-preset", "joint_cat_pose_top1"]) != 0:
                raise AssertionError("[14] chain 2 cat_given_pose train failed")
        torch.cuda.synchronize()
        cat_s = time.perf_counter() - t0
        counts = read_counts()
        # 1 warm-up + 1 main epoch of 2 steps; an eval after the main epoch and the final one
        want = {**{k: 0 for k in counts}, "normalize": 4 + 2 * test_batches}
        if counts != want:
            raise AssertionError(f"[14] chain 2 cat_given_pose launches {counts}, expected {want}")
        launches += counts["normalize"]
    finally:
        surgery.graft_oracle_into_joint = graft
    oracle = torch.load(oracle_wd / "checkpoints" / "final", map_location="cpu",
                        weights_only=True)
    joint = torch.load(tmp / "chain_joint" / "checkpoints" / "final", map_location="cpu",
                       weights_only=True)
    cat = torch.load(tmp / "chain_cat" / "checkpoints" / "final", map_location="cpu",
                     weights_only=True)
    if len(grafts) != 2:
        raise AssertionError(f"[14] chain 2: {len(grafts)} grafts")
    n_graft = n_frozen = 0
    for m in ("feature_model", "bin_models", "res_models"):
        n_graft += _bit_equal(f"chain 2 oracle graft {m}", _sub(grafts[0], m),
                              _sub(oracle["model"], m))
        n_graft += _bit_equal(f"chain 2 joint graft {m}", _sub(grafts[1], m),
                              _sub(joint["model"], m))
        n_frozen += _bit_equal(f"chain 2 cat_given_pose {m}", _sub(cat["model"], m),
                               _sub(joint["model"], m))
    acc = float(out_cat.getvalue().split("final Acc ")[1].split()[0])
    med = float(out_joint.getvalue().split("final MedErr ")[1].split()[0])
    if not (np.isfinite(med) and 0 <= acc <= 1 and len(cat["optimizer"]) == 2):
        raise AssertionError(f"[14] chain 2: MedErr {med}, Acc {acc}")
    print(f"[14] chain 2 (this process): [10]'s geodesic_bd `final` (step {oracle['step']}) -> "
          f"cli train joint_cat_pose_top1 --warm-start-kind oracle ({joint_s:.1f} s wall, final "
          f"MedErr {med:.3f} deg) -> cli train cat_given_pose --warm-start-kind oracle "
          f"({cat_s:.1f} s, final Acc {acc:.4f}); the grafted tensors bit-equal to their "
          f"sources' `final` ({n_graft} tensors over the two grafts), cat_given_pose's trunk and "
          f"banks still the joint run's bits after its frozen fine-tune ({n_frozen} tensors); "
          f"Adam state for the fc's 2 leaves only; {smi}")

    # predict --analysis over two checkpoints
    reset_counts()
    t0 = time.perf_counter()
    pred = ["predict", "--preset", "joint_cat_pose_top1", *common, "--workdir",
            str(tmp / "chain_joint"), "--analysis", "--checkpoint", "final,last"]
    with tee_stdout() as out_pred:
        if cli.main(pred) != 0:
            raise AssertionError("[14] cli predict --analysis failed")
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    counts = read_counts()
    if counts != {**{k: 0 for k in counts}, "normalize": 2 * test_batches}:
        raise AssertionError(f"[14] predict --analysis launches {counts}")
    launches += counts["normalize"]
    mat = spio.loadmat(tmp / "chain_joint" / "results_run_analysis.mat")
    runs = sorted(k for k in mat if k.endswith("_results"))
    r = mat["pose_results"][0, 0]
    shape = r["ypred_pose"].shape
    if runs != ["cat_results", "pose_results"] or shape != (n_test, 3, 12) or not np.isfinite(
            r["ypred_pose"]).all():
        raise AssertionError(f"[14] analysis .mat: runs {runs}, ypred_pose {shape}")
    reports = [ln for ln in out_pred.getvalue().splitlines() if "cat acc" in ln]
    print(f"[14] cli predict --analysis --checkpoint final,last ({pred_s:.1f} s wall, "
          f"{counts['normalize']} normalize launches = 2 checkpoints x {test_batches} test "
          f"batch): results_run_analysis.mat with {runs}, ypred_pose {shape}; "
          + " / ".join(reports))

    # the analysis, kernel path against the plain path (the plain normalize)
    parsed = cli.build_parser().parse_args(pred)
    cfg = cli._config_from_args(parsed)
    trainer = Trainer(cfg, dictionary=cli._load_dictionary_cached(str(npz)),
                      workdir=tmp / "chain_joint", device=dev)
    state = trainer.restore_checkpoint("final")
    test = cli._make_test_loader(parsed, cfg, PASCAL3D_CLASSES, cfg.image_size)
    centers = cli._load_dictionary_cached(str(npz)).cluster_centers
    got = run_joint_analysis(trainer, state, test, centers)
    batches = [trainer._to_device(b) for b in test]
    with torch.inference_mode():
        raw_k = [trainer.model.analysis(preprocess.normalize_images_cuda(b["xdata"],
                                                                         torch.bfloat16))
                 for b in batches]
    with plain_normalize():
        want = run_joint_analysis(trainer, state, test, centers)
        with torch.inference_mode():
            raw_p = [trainer.model.analysis(normalize_images(b["xdata"], torch.bfloat16))
                     for b in batches]
    valid = np.concatenate([np.asarray(b["valid"], bool) for b in test])

    def cat_rows(i):  # output i of every batch, joined, valid rows
        return (torch.cat([r[i] for r in raw_k]), torch.cat([r[i] for r in raw_p]))

    cat_clear = _clear(*cat_rows(0)).cpu().numpy()[valid]
    bin_clear = _clear(*cat_rows(1)).cpu().numpy()[valid]  # (N, C): each class's bin
    rtol = SERVE_RTOL[torch.bfloat16]
    if not (cat_clear.any() and bin_clear.any()
            and np.array_equal(got["ytrue_cat"], want["ytrue_cat"])
            and np.array_equal(got["ypred_cat"][cat_clear], want["ypred_cat"][cat_clear])):
        raise AssertionError("[14] analysis class ids differ on clear rows")
    gp = np.transpose(got["ypred_pose"], (0, 2, 1))[bin_clear]  # (entries, D)
    wp = np.transpose(want["ypred_pose"], (0, 2, 1))[bin_clear]
    perr = float(np.abs(gp - wp).max())
    if not perr <= rtol * max(float(np.abs(wp).max()), 1.0):
        raise AssertionError(f"[14] analysis poses: max err {perr:.3g}")
    print(f"[14] run_joint_analysis of the joint `final`, kernel path against the plain "
          f"normalize: class ids equal on {int(cat_clear.sum())}/{len(cat_clear)} rows clear "
          f"of a tie, per-class poses max err {perr:.3g} on {int(bin_clear.sum())}/"
          f"{bin_clear.size} (row, class) entries with a clear bin (rtol {rtol:g} of max)")
    del trainer, state
    torch.cuda.empty_cache()
    return {"normalize": launches, "joint_s": joint_s, "cat_s": cat_s, "predict_s": pred_s,
            "analysis_err": perr}


def phase_joint(dev, smi: str, dicts: dict, user: dict, tmp: Path) -> dict:
    """[14]: the 14 two-stage and joint presets at full width, then the two
    chains through the command line."""
    t_all = time.perf_counter()
    rng = np.random.default_rng(14)
    real, render = (make_loader(rng, 1, 4, 224, 12) for _ in range(2))
    totals = {k: 0 for k in read_counts()}
    peaks, served = {}, {}
    for preset in JOINT_PRESETS:
        cfg = joint_config(preset)
        dictionary = joint_dictionary(cfg, dicts)
        t0 = time.perf_counter()
        kern = Trainer(cfg, dictionary=dictionary, device=dev)
        build_s = time.perf_counter() - t0
        before = {k: v.clone() for k, v in kern.model.state_dict().items()}
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        assign.launches = 0
        t0 = time.perf_counter()
        kern.fit(kern.init_state(), real, render, log_every=1)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        peaks[preset] = torch.cuda.max_memory_allocated() / 2**30
        launches = read_counts()
        if assign.launches:
            raise AssertionError(f"[14] {preset}: {assign.launches} assign launches in its steps")
        counts = joint_checks(preset, cfg, kern, launches, before)
        for k, v in launches.items():
            totals[k] += v
        hist = kern.history
        n_params = sum(p.numel() for p in kern.model.parameters())
        n_trained = sum(p.numel() for p in trained_parameters(cfg, kern.model))
        print(f"[14] {preset} ({cfg.model_kind}, {cfg.problem}, mixing {cfg.mixing}, K "
              f"{cfg.dict_size}, stem_pool {cfg.stem_pool}, frozen_bn {cfg.frozen_bn}, "
              f"train_only {cfg.train_only}, bn_train_only {cfg.bn_train_only}): "
              f"{n_params / 1e6:.1f} M parameters ({n_trained / 1e6:.2f} M trained), built in "
              f"{build_s:.1f} s; {len(hist)} steps in {fit_s:.2f} s, launches "
              f"{ {k: v for k, v in launches.items() if v} }, peak {peaks[preset]:.2f} GiB; "
              f"leaves trained {counts['trained']}, frozen and bit-equal {counts['frozen']}; "
              f"running statistics moved {counts['stats_moved']}, kept {counts['stats_kept']}; "
              + "; ".join(f"{r['phase']} lr {r['learning_rate']:.3g}: loss {r['loss']:.4f} "
                          f"lc {r['lc']:.4f} lr {r['lr']:.4f}" for r in hist))
        if preset in JOINT_COMPARE:
            # the same steps from the same weights (`before`), stem_pool 'plain' for
            # the _rene trunk and the plain normalize
            zoo_plain(preset, cfg, dictionary, before, real, render, hist, dev, phase="14")
        if preset in JOINT_SERVE:
            served[preset] = joint_serve(preset, JOINT_SERVE[preset], kern, dev)
        del kern, before
        torch.cuda.empty_cache()
    print(f"[14] 14 presets trained, {len(JOINT_COMPARE)} of them against the plain path, "
          f"{len(served)} kinds served, in {time.perf_counter() - t_all:.1f} s; launches over "
          f"the 28 steps { {k: v for k, v in totals.items() if v} }; peak device memory "
          f"v1 {peaks['joint_cat_pose_top1']:.2f} GiB, v2 (a second layer4) "
          f"{peaks['joint_cat_pose2_top1']:.2f}, v3 {peaks['joint_cat_pose3_top1']:.2f}, "
          f"_rene {peaks['simple_bd_rene']:.2f}, categorization {peaks['categorization']:.2f}; "
          f"{smi}")
    npz, assign_launches = chain_dictionary(smi, user, tmp)
    t0 = time.perf_counter()
    proc = chain_one_start(user, npz, tmp)
    try:
        two = chain_two(dev, smi, user, tmp)
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    one = chain_one_finish(proc, tmp, t0)
    wall = time.perf_counter() - t_all
    print(f"[14] done in {wall:.1f} s (chains {time.perf_counter() - t0:.1f} s); {smi}")
    return {"normalize": totals["normalize"] + two["normalize"],
            "stem_pool": totals["stem_pool"], "stem_pool_bwd": totals["stem_pool_bwd"],
            "assign": assign_launches, "wall_s": wall, "peaks": peaks, "chain1": one,
            "chain2": two}



OBJECTNET_PRESETS = ("objectnet_quat", "objectnet_bd", "objectnet_bd_multires",
                     "objectnet_regression", "objectnet_classification")
# the same steps through the plain path: the BD and the delta-per-bin kinds
OBJECTNET_COMPARE = ("objectnet_bd", "objectnet_bd_multires")
# one request of each label-concat kind from its trained model, and one from a VGG model
OBJECTNET_SERVE = {
    "objectnet_bd": "labelconcat_bd", "objectnet_bd_multires": "labelconcat_delta_per_bin",
    "objectnet_regression": "labelconcat_regression",
    "objectnet_classification": "labelconcat_classification",
}
OBJECTNET_VGG = (("vgg16", "fc7"), ("vgg13", "fc6"))
OBJECTNET_IMAGES = 96  # a step's flat batch (learnObjectnetBDModel.py:74)
REMAT_ORDER = ("block", "stage", "conv", "dots", "nothing")


def objectnet_config(preset: str, **over):
    """Full width (ResNet50 to layer4, N1 1000, N2 500, N3 100, the preset's
    100 classes and K), bf16, stem_pool 'kernel' (None on a VGG trunk), 2
    steps: 1 warm-up + 1 main step, or 2 main epochs of 1 step for the
    single-phase classification preset."""
    base = get_config(preset)
    warm = base.num_warmup_epochs > 0
    vgg = over.get("feature_network", "resnet50").startswith("vgg")
    return get_config(
        preset, compute_dtype="bfloat16", max_iterations=1,
        stem_pool=None if vgg else "kernel", num_warmup_epochs=1 if warm else 0,
        num_epochs=1 if warm else 2, **({"N0": 4096} if vgg else {}), **over,
    )


def make_flat_loader(rng: np.random.Generator, n_batches: int, n: int, size: int,
                     classes: int) -> list[dict]:
    """FlatLoader-style batches of n images: make_loader's images and poses,
    labels drawn over all the classes."""
    batches = make_loader(rng, n_batches, n, size, 1)
    for b in batches:
        b["label"] = rng.integers(0, classes, n).astype(np.int32)
    return batches


def objectnet_checks(tag: str, cfg, trainer: Trainer, launches: dict, before: dict) -> None:
    """Exact launches (1 normalize a step; 1 stem and 1 stem backward a step on
    a ResNet trunk with the stem kernel, single loader; none on VGG), finite
    metrics, Lc nonzero but for regression, Lr nonzero but for
    classification, each step's rate, every running statistic moved."""
    hist, n = trainer.history, len(trainer.history)
    stem = n if cfg.stem_pool == "kernel" else 0
    want = {**{k: 0 for k in launches}, "normalize": n, "stem_pool": stem, "stem_pool_bwd": stem}
    if n != 2 or launches != want:
        raise AssertionError(f"[15] {tag}: {n} steps, launches {launches}, expected {want}")
    for rec in hist:
        if not all(np.isfinite(rec[k]) for k in ("loss", "lc", "lr", "s", "alpha")):
            raise AssertionError(f"[15] {tag}: non-finite metrics {rec}")
        if (rec["lc"] != 0) != (cfg.problem != "regression"):
            raise AssertionError(f"[15] {tag}: lc {rec['lc']} (problem {cfg.problem})")
        if (rec["lr"] != 0) != (cfg.problem != "classification"):
            raise AssertionError(f"[15] {tag}: lr {rec['lr']} (problem {cfg.problem})")
    epochs = [0] * cfg.num_warmup_epochs + [e + 1 for e in range(cfg.num_epochs)]
    rates = [cfg.init_lr * (epoch_lr_factor(cfg.epoch_lr_decay, e) if cfg.epoch_lr_decay
                            else 1.0) for e in epochs]
    if not np.allclose([r["learning_rate"] for r in hist], rates, rtol=1e-12):
        raise AssertionError(f"[15] {tag}: rates {[r['learning_rate'] for r in hist]}")
    after = trainer.model.state_dict()
    stuck = [k for k in before if "running" in k and torch.equal(before[k], after[k])]
    if stuck:
        raise AssertionError(f"[15] {tag}: running statistics that did not move: {stuck[:5]}")


def objectnet_serve(tag: str, kind: str, trainer: Trainer, dev) -> dict:
    """One 64-image request of 100 classes through make_inference_fn (1
    normalize launch, 1 stem launch on a ResNet trunk with the stem kernel)
    against the plain path (the plain normalize, the same model), on the
    rows whose bin argmax the two paths cannot make differently (`_clear`;
    every row for the regression kind)."""
    rtol = SERVE_RTOL[torch.bfloat16]
    images, labels = make_requests(np.random.default_rng(16), (64,), 224, 100)[0]
    model = trainer.model
    infer = make_inference_fn(model, trainer.problem)
    reset_counts()
    served = infer(images, labels)
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_counts().items() if v}
    want = {"normalize": 1, **({"stem_pool": 1} if trainer.config.stem_pool else {})}
    if launches != want:
        raise AssertionError(f"[15] {tag} serve launches {launches}, expected {want}")
    (outs_k, _), (outs_p, dec_p) = (zoo_outputs(model, trainer.problem, images, labels, dev, k)
                                    for k in (True, False))
    clear = (torch.ones(len(dec_p), dtype=torch.bool, device=dec_p.device)
             if kind == "labelconcat_regression" else _clear(outs_k[0], outs_p[0]))
    if not clear.any():
        raise AssertionError(f"[15] {tag}: no row clear of a tie between the two paths")
    worst = 0.0
    for k, p in zip(outs_k, outs_p, strict=True):
        err = float((k[clear] - p[clear]).abs().max())
        if not err <= rtol * float(p.abs().max()):
            raise AssertionError(f"[15] {tag} outputs on clear rows: max err {err:.3g}")
        worst = max(worst, err)
    perr = float((served[clear] - dec_p[clear]).abs().max())
    if not perr <= rtol * max(float(dec_p.abs().max()), 1.0):
        raise AssertionError(f"[15] {tag} served poses: max err {perr:.3g}")
    print(f"[15] {tag} ({kind}): one 64-image request through make_inference_fn (launches "
          f"{launches}) against the plain path: outputs max err {worst:.3g}, served poses "
          f"{tuple(served.shape)} max err {perr:.3g} on {int(clear.sum())}/{len(clear)} rows "
          f"clear of a tie (rtol {rtol:g} of max)")
    return {"outputs_err": worst, "served_err": perr, "clear": int(clear.sum())}


def objectnet_fit(tag: str, cfg, dictionary, batches, dev, totals: dict):
    """Trainer.fit of cfg over the flat batches (single loader): checks,
    launches added to `totals`; returns (trainer, the initial state_dict,
    wall s, peak GiB)."""
    kern = Trainer(cfg, dictionary=dictionary, device=dev)
    before = {k: v.clone() for k, v in kern.model.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    assign.launches = 0
    t0 = time.perf_counter()
    kern.fit(kern.init_state(), batches, None, log_every=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = read_counts()
    if assign.launches:
        raise AssertionError(f"[15] {tag}: {assign.launches} assign launches in its steps")
    objectnet_checks(tag, cfg, kern, launches, before)
    for k, v in launches.items():
        totals[k] += v
    n_params = sum(p.numel() for p in kern.model.parameters())
    print(f"[15] {tag} ({cfg.model_kind}, {cfg.problem}, {cfg.feature_network}/"
          f"{cfg.feature_layer}, K {cfg.dict_size}, {cfg.num_classes} classes, stem_pool "
          f"{cfg.stem_pool}): {n_params / 1e6:.1f} M parameters; {len(kern.history)} steps of "
          f"{OBJECTNET_IMAGES} images in {fit_s:.2f} s, launches "
          f"{ {k: v for k, v in launches.items() if v} }, peak {peak:.2f} GiB; "
          + "; ".join(f"{r['phase']} lr {r['learning_rate']:.3g}: loss {r['loss']:.4f} lc "
                      f"{r['lc']:.4f} lr {r['lr']:.4f}" for r in kern.history))
    return kern, before, fit_s, peak


def remat_run(cfg, dictionary, real, render, dev, init_sd=None) -> dict:
    """One main step of cfg from `init_sd` (or its seed's weights) with
    launches counted and BN counters checked (exactly one update a stream),
    the gradients that step's backward left on the parameters kept, then 3
    timed steps on the same batch (host clock, each ending in a
    synchronize) and the peak memory over them."""
    t = Trainer(cfg, dictionary=dictionary, device=dev)
    if init_sd is not None:
        t.model.load_state_dict(init_sd)
    # kept on the host, so that no run's peak holds another run's tensors
    before = {k: v.cpu() for k, v in t.model.state_dict().items()}
    reset_counts()
    t.fit(t.init_state(), real, render, log_every=1)
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_counts().items() if v}
    grads = {n: p.grad.float().cpu() for n, p in t.model.named_parameters()
             if p.grad is not None}
    after = t.model.state_dict()
    for k, v in after.items():
        if k.endswith("num_batches_tracked") and int(v) - int(before[k]) != 2:
            raise AssertionError(f"[15] remat {cfg.remat}: {k} advanced by "
                                 f"{int(v) - int(before[k])}, not once a stream")
    step = t.train_step_fn("main", dual_stream=True)
    batch = t._to_device(next(_interleave(real, render)))
    state = t.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, times = timed_steps(step, state, batch, 3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    rec = {"hist": t.history, "grads": grads, "launches": launches,
           "ms": statistics.median(times) * 1e3, "peak": peak, "init": before}
    del t, step, state, batch
    torch.cuda.empty_cache()
    return rec


def remat_close(tag: str, got: dict, want: dict, tol: float) -> tuple[float, float]:
    """The step's metrics, and what its backward produced: each parameter's
    gradient, as the norm of its difference over the norm of `want`'s (a
    gradient 0 in `want` must be 0), within `tol`. Adam's first step moves
    every weight by about +/-lr whatever its gradient, so the weights after
    the step would hide a wrong gradient; the gradients show it. Returns the
    worst metric and the worst gradient difference."""
    worst = 0.0
    for rk, rp in zip(got["hist"], want["hist"], strict=True):
        for k in ("loss", "lc", "lr", "s", "alpha"):
            err = abs(rk[k] - rp[k]) / (1.0 if k == "s" else max(abs(rp[k]), 1e-12))
            if not err <= tol:
                raise AssertionError(f"[15] {tag} {k}: {rk[k]} against {rp[k]}")
            worst = max(worst, err)
    if got["grads"].keys() != want["grads"].keys() or not want["grads"]:
        raise AssertionError(f"[15] {tag}: gradients of other parameters than remat None's")
    worst_grad = 0.0
    for k, g0 in want["grads"].items():
        diff, ref = float((got["grads"][k] - g0).norm()), float(g0.norm())
        err = diff / ref if ref > 0 else (0.0 if diff == 0 else float("inf"))
        if not err <= tol:
            raise AssertionError(f"[15] {tag} gradient of {k}: {err:.3g} of its norm apart")
        worst_grad = max(worst_grad, err)
    return worst, worst_grad


def objectnet_fields(dev, smi: str, dictionary) -> dict:
    """geodesic_bd (dual loaders, 96 images a step) with the new fields: one
    main step with device_resize_from 256 + train_flip (no normalize launch:
    the resize path takes the plain normalize, as in the JAX package), one
    with train_flip alone (1 normalize launch), then a step under each remat
    mode against remat None (metrics and gradients within TRAIN_TOL, a lower
    peak), and remat 'block' on the fused trunk against its own remat None
    (metrics and gradients within FUSED_TRAIN_TOL)."""
    rng = np.random.default_rng(151)
    base = dict(compute_dtype="bfloat16", items_per_batch=4, max_iterations=1,
                stem_pool="kernel", num_warmup_epochs=0, num_epochs=1)
    counts = {k: 0 for k in read_counts()}
    big = [make_loader(rng, 1, 4, 256, 12) for _ in range(2)]
    for tag, over, real, render, normalize in (
            ("device_resize_from 256 + train_flip", dict(device_resize_from=256, train_flip=True),
             *big, 0),
            ("train_flip", dict(train_flip=True), *(make_loader(rng, 1, 4, 224, 12)
                                                    for _ in range(2)), 1)):
        cfg = get_config("geodesic_bd", **base, **over)
        t = Trainer(cfg, dictionary=dictionary, device=dev)
        reset_counts()
        t.fit(t.init_state(), real, render, log_every=1)
        torch.cuda.synchronize()
        launches = read_counts()
        want = {**{k: 0 for k in launches}, "normalize": normalize, "stem_pool": 2,
                "stem_pool_bwd": 2}
        rec = t.history[0]
        if launches != want or not all(np.isfinite(rec[k]) for k in ("loss", "lc", "lr")):
            raise AssertionError(f"[15] geodesic_bd {tag}: launches {launches}, expected "
                                 f"{want}; {rec}")
        for k, v in launches.items():
            counts[k] += v
        print(f"[15] geodesic_bd {tag}: one main step of 96 images, launches "
              f"{ {k: v for k, v in launches.items() if v} } (expected {want['normalize']} "
              f"normalize), loss {rec['loss']:.4f} lc {rec['lc']:.4f} lr {rec['lr']:.4f}")
        del t
        torch.cuda.empty_cache()
    real, render = (make_loader(rng, 1, 4, 224, 12) for _ in range(2))
    runs = {None: remat_run(get_config("geodesic_bd", **base), dictionary, real, render, dev)}
    init = runs[None]["init"]
    for mode in REMAT_ORDER:
        runs[mode] = remat_run(get_config("geodesic_bd", **base, remat=mode), dictionary, real,
                               render, dev, init)
    rows = []
    for mode, r in runs.items():
        # a recomputed forward launches the stem kernel again in the backward
        want = {"normalize": 1, "stem_pool": 2 if mode is None else 4, "stem_pool_bwd": 2}
        if r["launches"] != want:
            raise AssertionError(f"[15] remat {mode}: launches {r['launches']}, expected {want}")
        err, gerr = ((0.0, 0.0) if mode is None else
                     remat_close(f"remat {mode}", r, runs[None], TRAIN_TOL))
        # every mode keeps less for the backward than no remat does
        if mode is not None and not r["peak"] < runs[None]["peak"]:
            raise AssertionError(f"[15] remat {mode}: peak {r['peak']:.2f} GiB, not below "
                                 f"remat None's {runs[None]['peak']:.2f}")
        rows.append(f"{mode}: step {r['ms']:.2f} ms, peak {r['peak']:.2f} GiB, launches "
                    f"{r['launches']}, worst metric difference {err:.3g}, worst gradient "
                    f"difference {gerr:.3g}")
        for k, v in r["launches"].items():
            counts[k] += v
    print(f"[15] geodesic_bd remat modes, bf16 main step of 96 images from the same weights "
          f"(host-clock median of 3 steps, peak device memory over them); every BN's "
          f"num_batches_tracked advanced once a stream: " + "; ".join(rows)
          + f" (<= {TRAIN_TOL}, the gradients per parameter as a share of remat None's "
          f"norm); {smi}")
    fused = {}
    for mode in (None, "block"):
        cfg = get_config("geodesic_bd", **base, fused_conv_bn="kernel", remat=mode)
        fused[mode] = remat_run(cfg, dictionary, real, render, dev,
                                init if mode is None else fused[None]["init"])
        for k, v in fused[mode]["launches"].items():
            counts[k] += v
    err, gerr = remat_close("fused remat block", fused["block"], fused[None], FUSED_TRAIN_TOL)
    fl = {m: fused[m]["launches"] for m in fused}
    # 'block' runs each block's forward kernels again in the backward
    want = {**fl[None], "mm": 2 * fl[None].get("mm", 0), "c3": 2 * fl[None].get("c3", 0),
            "stem_pool": 2 * fl[None].get("stem_pool", 0)}
    if fl["block"] != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"[15] fused remat block launches {fl}")
    print(f"[15] fused trunk (fused_conv_bn 'kernel') remat 'block' against remat None: worst "
          f"metric difference {err:.3g}, worst gradient difference {gerr:.3g} (<= "
          f"{FUSED_TRAIN_TOL}); launches {fl['block']} against "
          f"{fl[None]} (the forward kernels recomputed in the backward); step "
          f"{fused['block']['ms']:.2f} ms against {fused[None]['ms']:.2f}, peak "
          f"{fused['block']['peak']:.2f} GiB against {fused[None]['peak']:.2f}; {smi}")
    return {"counts": counts, "remat": {str(m): {k: r[k] for k in ("ms", "peak", "launches")}
                                        for m, r in runs.items()},
            "fused_remat": {str(m): {k: r[k] for k in ("ms", "peak", "launches")}
                            for m, r in fused.items()}}


def objectnet_cli(tmp: Path) -> dict:
    """One subprocess: `cli prepare-data --dataset objectnet3d` on a
    synthesized release (72 train crops, 4 test crops), `cli dictionary`
    (K 16 over the prepared train tree, the default 4 x 100 Lloyd steps:
    exactly 4 x 101 assign launches), `cli train --preset
    objectnet_bd_multires --train-flip` (1 + 1 epochs of 2 steps of 24
    images, full width, the tree's 3 classes) and `cli predict` on its
    `final`."""
    root = tmp / "objectnet"
    data, npz, work = root / "data", root / "kmeans16.npz", root / "run"
    common = ["--preset", "objectnet_bd_multires", "--data-root", str(data), "--dbinfo",
              str(data / "dbinfo.mat"), "--dictionary", str(npz), "--compute-dtype",
              "bfloat16", "--items-per-batch", "2", "--workdir", str(work)]
    steps_ = [["prepare-data", "--dataset", "objectnet3d", "--db-path", str(root / "release"),
               "--out", str(data), "--workers", "4"],
              ["dictionary", "--data-root", str(data / "train"), "--dbinfo",
               str(data / "dbinfo.mat"), "--db-type", "real", "--out", str(npz),
               "--size", "16"],
              ["train", *common, "--train-flip", "--num-warmup-epochs", "1", "--num-epochs",
               "1", "--max-iterations", "2"],
              ["predict", *common, "--checkpoint", "final"]]
    script = (f"import time\n"
              f"from {PORT} import cli\n"
              f"from {PORT}.ops import assign\n"
              f"from {PORT}.tools.synthetic import generate_objectnet3d_release\n"
              f"generate_objectnet3d_release({str(root / 'release')!r}, num_train=6, "
              f"num_test=3, image_size=256)\n"
              f"for args in {steps_!r}:\n"
              f"    t0 = time.perf_counter()\n"
              f"    assign.launches = 0\n"
              f"    assert cli.main(list(args)) == 0\n"
              f"    print(f'STAGE {{args[0]}} {{time.perf_counter() - t0:.2f}} s, assign "
              f"launches {{assign.launches}}', flush=True)\n")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", script], cwd=Path(__file__).resolve().parent,
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[15] objectnet CLI chain exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    out = proc.stdout
    stages = {ln.split()[1]: ln for ln in out.splitlines() if ln.startswith("STAGE ")}
    assign_launches = int(stages["dictionary"].split("assign launches ")[1])
    meds = [float(x.split()[0]) for x in out.split("final MedErr ")[1:]]
    with np.load(work / "results_run.npz") as z:
        ypred, ytrue, labels = z["yhat_test"], z["ytest"], z["test_labels"]
    pred_med = mean_class_median_error(ytrue, ypred, labels, 3)
    if assign_launches != 4 * 101 or len(meds) != 1 or not np.isfinite(meds[0]) \
            or not np.isfinite(pred_med):
        raise AssertionError(f"[15] objectnet CLI chain output:\n{out[-3000:]}")
    print(f"[15] objectnet CLI chain (one subprocess, {wall:.1f} s wall): "
          + "; ".join(s.removeprefix("STAGE ") for s in stages.values())
          + f"; assign launches {assign_launches} = 4 x 101; train final MedErr {meds[0]:.3f} "
          f"deg, predict's results_run.npz MedErr {pred_med:.3f} deg over {len(labels)} "
          f"test crops")
    return {"assign": assign_launches, "wall_s": wall}


def phase_objectnet(dev, smi: str, dicts: dict, tmp: Path) -> dict:
    """[15]: the five ObjectNet presets at full width on the ResNet50 trunk,
    objectnet_bd on two VGG trunks, the label-concat kinds and a VGG model
    served, geodesic_bd with device_resize_from, train_flip and remat, then
    the ObjectNet command-line chain."""
    t_all = time.perf_counter()
    rng = np.random.default_rng(15)
    batches = make_flat_loader(rng, 1, OBJECTNET_IMAGES, 224, 100)
    totals = {k: 0 for k in read_counts()}
    served, peaks = {}, {}
    for preset in OBJECTNET_PRESETS:
        cfg = objectnet_config(preset)
        dictionary = None if cfg.problem in DICTIONARY_FREE else dicts[cfg.dict_size]
        kern, before, _, peaks[preset] = objectnet_fit(preset, cfg, dictionary, batches, dev,
                                                       totals)
        if preset in OBJECTNET_COMPARE:
            zoo_plain(preset, cfg, dictionary, before, batches, None, kern.history, dev,
                      phase="15")
        if preset in OBJECTNET_SERVE:
            served[preset] = objectnet_serve(preset, OBJECTNET_SERVE[preset], kern, dev)
        del kern, before
        torch.cuda.empty_cache()
    for arch, layer in OBJECTNET_VGG:
        tag = f"objectnet_bd on {arch}/{layer}"
        cfg = objectnet_config("objectnet_bd", feature_network=arch, feature_layer=layer)
        kern, _, _, peaks[tag] = objectnet_fit(tag, cfg, dicts[200], batches, dev, totals)
        if arch == "vgg16":
            served[tag] = objectnet_serve(tag, "labelconcat_bd", kern, dev)
        del kern
        torch.cuda.empty_cache()
    print(f"[15] 5 ObjectNet presets and 2 VGG trunks trained, "
          f"{len(OBJECTNET_COMPARE)} of them against the plain path, {len(served)} served, in "
          f"{time.perf_counter() - t_all:.1f} s; launches over their 14 steps "
          f"{ {k: v for k, v in totals.items() if v} }; peak device memory "
          + ", ".join(f"{k} {v:.2f} GiB" for k, v in peaks.items()) + f"; {smi}")
    fields = objectnet_fields(dev, smi, dicts[200])
    for k, v in fields["counts"].items():
        totals[k] += v
    chain = objectnet_cli(tmp)
    wall = time.perf_counter() - t_all
    print(f"[15] done in {wall:.1f} s; launches in this process "
          f"{ {k: v for k, v in totals.items() if v} }, assign {chain['assign']} in the chain; "
          f"{smi}")
    return {**totals, "assign": chain["assign"], "wall_s": wall, "peaks": peaks,
            "remat": fields["remat"], "fused_remat": fields["fused_remat"], "served": served}



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
    with tempfile.TemporaryDirectory() as tmp:
        user = phase_user_command(dev, smi, kmeans_dict, train, Path(tmp))
        eval_launches = phase_packed_eval(dev, smi, kmeans_dict, user)
        with tempfile.TemporaryDirectory() as tmp_gate:
            gate = phase_gate(dev, smi, Path(tmp_gate))
        zoo = phase_zoo(dev, smi, kmeans_dict, gmm_dict, user, Path(tmp))
        joint = phase_joint(dev, smi, zoo["dicts"], user, Path(tmp))
        objectnet = phase_objectnet(dev, smi, zoo["dicts"], Path(tmp))
    # launches: each kernel's count over the 4 steps of its training path
    # ([5] unfused, [6] fused) or over the dictionary path's fit, predict and
    # residuals ([7]); serving's counts are in [4], the gate's in [12]; the
    # zoo's ([13]: the 38 steps of its 19 fits, and its two dictionary fits)
    # in zoo_launches; [14]'s (the 28 steps of its 14 fits, chain 2 in this
    # process and the chain's dictionary fit) in joint_launches
    fused_src = f"{PORT}/csrc/fused_%s.cu"
    fused_at = f"{JAX_PACKAGE}/ops/fused_conv_bn.py:%d"
    kernels = [
        {"name": "normalize", "route": "cuda",
         "source": f"{PORT}/csrc/normalize.cu",
         "replaces": f"{JAX_PACKAGE}/ops/preprocess.py:60",
         "launches": train["launches"]["normalize"],
         "serving_launches": serve["launches"]["normalize"],
         "cli_train_resume_launches": user["launches"],
         "cli_evaluate_launches": eval_launches,
         "verify_parity_launches": gate["normalize"],
         "predict_det_path_launches": gate["predict_normalize"],
         "zoo_launches": zoo["normalize"], "joint_launches": joint["normalize"],
         "objectnet_launches": objectnet["normalize"], **norm},
        {"name": "stem_pool", "route": "cuda",
         "source": f"{PORT}/csrc/stem_pool.cu",
         "replaces": f"{JAX_PACKAGE}/ops/stem_pool.py:162",
         "launches": train["launches"]["stem_pool"],
         "serving_launches": serve["launches"]["stem_pool"],
         "zoo_launches": zoo["stem_pool"], "joint_launches": joint["stem_pool"],
         "objectnet_launches": objectnet["stem_pool"], **stem},
        {"name": "stem_pool_bwd", "route": "cuda",
         "source": f"{PORT}/csrc/stem_pool.cu",
         "replaces": f"{JAX_PACKAGE}/ops/stem_pool.py:186",
         "launches": train["launches"]["stem_pool_bwd"],
         "zoo_launches": zoo["stem_pool_bwd"], "joint_launches": joint["stem_pool_bwd"],
         "objectnet_launches": objectnet["stem_pool_bwd"], **stem_bwd},
        {"name": "mm_stats", "route": "cuda", "source": fused_src % "mm",
         "replaces": fused_at % 215, "launches": fused["launches"]["mm"],
         "zoo_launches": zoo["mm"], "objectnet_launches": objectnet["mm"], **mm},
        {"name": "mm_stats_bwd", "route": "cuda", "source": fused_src % "mm",
         "replaces": fused_at % 447, "launches": fused["launches"]["mm_bwd"],
         "zoo_launches": zoo["mm_bwd"], "objectnet_launches": objectnet["mm_bwd"], **mm_bwd},
        {"name": "c3_fwd", "route": "cuda", "source": fused_src % "c3",
         "replaces": fused_at % 805, "launches": fused["launches"]["c3"],
         "zoo_launches": zoo["c3"], "objectnet_launches": objectnet["c3"], **c3},
        {"name": "c3_bwd", "route": "cuda", "source": fused_src % "c3",
         "replaces": fused_at % 878, "launches": fused["launches"]["c3_bwd"],
         "zoo_launches": zoo["c3_bwd"], "objectnet_launches": objectnet["c3_bwd"], **c3_bwd},
        {"name": "assign", "route": "cuda", "source": f"{PORT}/csrc/assign.cu",
         "replaces": f"{JAX_PACKAGE}/ops/assign.py:45", "launches": assign_launches,
         "verify_parity_launches": gate["assign"], "zoo_launches": zoo["assign"],
         "joint_launches": joint["assign"], "objectnet_launches": objectnet["assign"],
         **assign_rec},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
