#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: its kernels, then serving.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card, nvcc and the port
package beside it, and never imports JAX or the JAX package. Phases, one
line each (or more), in order:

  0  device: torch's name for card 0 and nvidia-smi's name + power limit;
     exits non-zero, printing no result, when CUDA is unavailable
  1  build: compiles multi_modal_regression_tpu_torch/csrc/*.cu (ops/_build.py)
  2  normalize kernel vs its plain version on the card: f32 within
     rtol 1e-6 / atol 1e-6, bf16 within 1 ulp; times of both
  3  stem kernel vs its plain version: f32 and bf16, bit-exact; times of both
  4  serving: the full-width geodesic_bd slice (ResNet50 to layer4, N1 1000,
     N2 500, K 200, 12 classes, 224 px, bf16, stem_pool='kernel') with
     weights from seed 0, random BN running statistics and a 200-atom
     dictionary read back from a .npz; answers 4 requests of 64 images and
     one of 17, checks that each kernel launched once per request, and
     holds the poses, scores and residuals against the plain path; then one
     request in f32 with TF32 off against its plain path
  5  one JSON line of the kernels, then the result line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Times are CUDA-event medians over 30 runs with the 50 MB L2 flushed before
each, or host-clock medians of requests that end in a synchronize.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from multi_modal_regression_tpu_torch.data.loader import normalize_images  # noqa: E402
from multi_modal_regression_tpu_torch.dictionary.kmeans import KMeansDictionary  # noqa: E402
from multi_modal_regression_tpu_torch.models.heads import HeadBatchNorm  # noqa: E402
from multi_modal_regression_tpu_torch.ops import _build, preprocess, stem_pool  # noqa: E402
from multi_modal_regression_tpu_torch.serving import make_inference_fn  # noqa: E402
from multi_modal_regression_tpu_torch.train.presets import (  # noqa: E402
    build_model,
    build_problem,
    get_config,
)

REPS = 30
PORT = "multi_modal_regression_tpu_torch"
JAX_PACKAGE = PORT.removesuffix("_torch")  # the port is named after the JAX package
# bf16 serving: the normalize kernel rounds differently from its plain
# version (<= 1 bf16 ulp on a few pixels) and bf16 carries that through 50
# layers; scores and residuals must agree within 2% of their largest
# magnitude. f32 with TF32 off: within 1e-4 of it.
SERVE_RTOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def cuda_ms(fn, flush: torch.Tensor) -> float:
    """Median device time of fn() in ms, L2 flushed before each run."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPS):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 ulps between two bf16 tensors."""

    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -32768 - i, i)

    return int((ordered(a) - ordered(b)).abs().max())


def phase_device() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this run needs a GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[0] device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    print(smi)
    return name


def phase_build() -> None:
    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    print(f"[1] build: {path.name} in {time.perf_counter() - t0:.2f} s")


def phase_normalize(dev, flush) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    rec = {}
    for shape in ((64, 224, 224, 3), (17, 224, 224, 3), (3, 5, 8, 3)):
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            got = preprocess.normalize_images_cuda(x, dtype)
            want = normalize_images(x, dtype)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            if dtype == torch.float32:
                torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
                tol = "rtol 1e-6 atol 1e-6"
            else:
                ulps = bf16_ulps(got, want)
                if ulps > 1:
                    raise AssertionError(f"normalize {shape} bf16: {ulps} ulps apart")
                tol = f"{ulps} ulp <= 1"
            line = f"[2] normalize {shape} {str(dtype)[6:]}: max_abs_err {err:.3g} ({tol})"
            if shape[0] >= 17:
                ms = cuda_ms(lambda: preprocess.normalize_images_cuda(x, dtype), flush)
                plain_ms = cuda_ms(lambda: normalize_images(x, dtype), flush)
                line += f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
                if shape[0] == 64 and dtype == torch.bfloat16:
                    rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
            print(line)
    return rec


def phase_stem(dev, flush) -> dict:
    gen = torch.Generator(device=dev).manual_seed(1)
    rec = {}
    for shape in ((64, 64, 112, 112), (17, 64, 112, 112)):
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
            if shape[0] == 64 and dtype == torch.bfloat16:
                rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
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


def phase_serve(dev) -> dict:
    cfg = get_config("geodesic_bd", compute_dtype="bfloat16", stem_pool="kernel")
    dtype = torch.bfloat16
    t0 = time.perf_counter()
    model = build_model(cfg, dev)
    with torch.no_grad():
        randomize_bn_stats(model, np.random.default_rng(0))
    rng = np.random.default_rng(1)
    v = rng.standard_normal((cfg.dict_size, 3))
    centers = (v / np.linalg.norm(v, axis=1, keepdims=True)
               * rng.uniform(0, np.pi, (cfg.dict_size, 1))).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        KMeansDictionary(cluster_centers=centers).save(Path(tmp) / "kmeans.npz")
        dictionary = KMeansDictionary.load(Path(tmp) / "kmeans.npz")
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


def main() -> None:
    name = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    norm = phase_normalize(dev, flush)
    stem = phase_stem(dev, flush)
    del flush
    serve = phase_serve(dev)
    kernels = [
        {"name": "normalize", "route": "cuda",
         "source": f"{PORT}/csrc/normalize.cu",
         "replaces": f"{JAX_PACKAGE}/ops/preprocess.py:60",
         "launches": serve["launches"]["normalize"], **norm},
        {"name": "stem_pool", "route": "cuda",
         "source": f"{PORT}/csrc/stem_pool.cu",
         "replaces": f"{JAX_PACKAGE}/ops/stem_pool.py:162",
         "launches": serve["launches"]["stem_pool"], **stem},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
