"""The port's CUDA kernels vs their plain versions, on the card.

Marked `cuda`: each test skips where torch.cuda.is_available() is False
(decided in the fixture, never at import). Run on a machine with the card,
which need not have JAX (tests/conftest.py imports it, hence --noconftest):

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

The first test builds the kernels (ops/_build.py).
"""

import numpy as np
import pytest
import torch

from multi_modal_regression_tpu_torch.data.loader import normalize_images
from multi_modal_regression_tpu_torch.ops import preprocess, stem_pool
from multi_modal_regression_tpu_torch.serving import make_inference_fn
from multi_modal_regression_tpu_torch.train.presets import (
    build_model,
    build_problem,
    get_config,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 16, 8, 3), (4, 5, 8, 3), (1, 1, 1, 3)])
def test_normalize_kernel(dev, shape, dtype):
    """f32 within rtol/atol 1e-6; bf16 within one ulp (at most 2**-7
    relative); one launch counted per call."""
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, shape, np.uint8)).to(dev)
    before = preprocess.launches
    got = preprocess.normalize_images_cuda(x, dtype)
    assert preprocess.launches == before + 1
    want = normalize_images(x, dtype)
    tol = 1e-6 if dtype == torch.float32 else 2**-7
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 8, 16, 12), (3, 4, 8, 8), (1, 3, 2, 2)])
def test_stem_kernel_bit_exact(dev, shape, dtype):
    """(B, C, H, W) channels_last; bit-exact vs the plain version, including
    NaN inputs (propagated by both)."""
    rng = np.random.default_rng(sum(shape))
    y = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    y[0, 0, 0, 0] = float("nan")
    y = y.to(dtype).contiguous(memory_format=torch.channels_last)
    a = torch.from_numpy(rng.uniform(0.5, 2.0, shape[1]).astype(np.float32)).to(dev)
    b = torch.from_numpy((0.1 * rng.standard_normal(shape[1])).astype(np.float32)).to(dev)
    before = stem_pool.launches
    got = stem_pool.stem_bn_relu_pool(y, a, b, "kernel")
    assert stem_pool.launches == before + 1
    want = stem_pool._composite(y, a, b)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


def test_kernels_reject_what_they_do_not_take(dev):
    x = torch.zeros((2, 4, 4, 3), dtype=torch.uint8, device=dev)
    with pytest.raises(TypeError):
        preprocess.normalize_images_cuda(x, torch.float16)
    with pytest.raises(ValueError, match="contiguous"):
        preprocess.normalize_images_cuda(x.transpose(1, 2), torch.float32)
    y = torch.zeros((2, 4, 6, 6), device=dev).contiguous(memory_format=torch.channels_last)
    a = torch.ones(4, device=dev)
    with pytest.raises(ValueError, match="float32"):
        stem_pool.stem_bn_relu_pool(y, a.double(), a)
    with pytest.raises(ValueError, match="float32"):
        stem_pool.stem_bn_relu_pool(y, a.cpu(), a)


def test_small_slice_kernel_path_matches_plain(dev):
    """A small geodesic_bd model in f32 on the card (TF32 off): served poses
    through both kernels vs the plain path, within 1e-4; one launch of each
    kernel per request."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    small = dict(N1=16, N2=8, dict_size=8, num_classes=3, image_size=32)
    cfg = get_config("geodesic_bd", stem_pool="kernel", **small)
    centers = np.random.default_rng(1).standard_normal((8, 3)).astype(np.float32)
    model = build_model(cfg, dev)
    plain = build_model(cfg.replace(stem_pool="plain"), dev)
    plain.load_state_dict(model.state_dict())
    problem = build_problem(cfg, centers, dev)
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, (6, 32, 32, 3), np.uint8)
    labels = np.arange(6) % 3
    n0, s0 = preprocess.launches, stem_pool.launches
    got = make_inference_fn(model, problem)(images, labels)
    assert (preprocess.launches - n0, stem_pool.launches - s0) == (1, 1)
    with torch.inference_mode():
        x = normalize_images(torch.from_numpy(images).to(dev))
        want = problem.decode(plain(x, torch.from_numpy(labels).to(dev)))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
