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
from multi_modal_regression_tpu_torch.dictionary.gmm import fit_gmm
from multi_modal_regression_tpu_torch.dictionary.kmeans import fit_kmeans
from multi_modal_regression_tpu_torch.ops import assign
from multi_modal_regression_tpu_torch.ops import fused_conv_bn as fcb
from multi_modal_regression_tpu_torch.ops import preprocess, stem_pool
from multi_modal_regression_tpu_torch.serving import make_inference_fn
from multi_modal_regression_tpu_torch.train.presets import (
    build_model,
    build_problem,
    get_config,
)
from multi_modal_regression_tpu_torch.train.state import TrainState
from multi_modal_regression_tpu_torch.train.steps import make_train_step
from multi_modal_regression_tpu_torch.train.trainer import Trainer

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 16, 8, 3), (1, 1, 1, 3), (1, 3, 5, 3), (1, 7, 7, 3),
                                   (1, 1, 47, 3), (1, 5, 19, 3), (96, 224, 224, 3)],
                         ids=["groups", "one_pixel", "under_48", "tail_3", "tail_45",
                              "tail_45_of_95", "step"])
def test_normalize_kernel_equals_its_arithmetic(dev, shape, dtype):
    """Bit-equal to normalize_affine_plain (the kernel's arithmetic in eager
    ops): 48-byte groups, the pixels after them (n mod 48 = 3 and 45: 49 and
    47 pixels), fewer than 48 values, one pixel, and a training step's batch;
    within 1e-6 / 1 bf16 ulp of normalize_images."""
    x = torch.from_numpy(np.random.default_rng(3).integers(0, 256, shape, np.uint8)).to(dev)
    plan = preprocess._normalize_plan(x.numel(), x.data_ptr() % 16)
    assert plan.groups == x.numel() // 48 and 3 * plan.pixels == x.numel() % 48
    got = preprocess.normalize_images_cuda(x, dtype)
    assert torch.equal(got, preprocess.normalize_affine_plain(x, dtype))
    assert torch.equal(got, preprocess.normalize_images_cuda(x, dtype))
    tol = 1e-6 if dtype == torch.float32 else 2**-7
    torch.testing.assert_close(got.float(), normalize_images(x, dtype).float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_normalize_kernel_misaligned_view(dev, dtype):
    """x[1:] of a (3, 5, 7, 3) batch starts 105 bytes in: no 16-byte groups,
    a pixel a thread, bit-equal to normalize_affine_plain."""
    full = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (3, 5, 7, 3), np.uint8))
    full = full.to(dev)
    x = full[1:]
    assert x.is_contiguous() and (x.data_ptr() - full.data_ptr()) == 105
    plan = preprocess._normalize_plan(x.numel(), x.data_ptr() % 16)
    assert plan.groups == 0 and plan.pixels == 70
    got = preprocess.normalize_images_cuda(x, dtype)
    assert torch.equal(got, preprocess.normalize_affine_plain(x, dtype))
    assert torch.equal(got, preprocess.normalize_images_cuda(full, dtype)[1:])


def test_normalize_kernel_past_32_bit_items(dev):
    """A misaligned view of 2**32 + 64 pixels (12.9 GB of uint8, a pixel a
    thread): the item index passes 2**32 in one launch; the first and last
    4096 pixels and 4096 across pixel 2**32 are bit-equal to
    normalize_affine_plain."""
    torch.cuda.empty_cache()
    p = 2**32 + 64
    gen = torch.Generator(device=dev).manual_seed(6)
    full = torch.randint(0, 256, (3 * (p + 1),), dtype=torch.uint8, device=dev, generator=gen)
    x = full[3:].view(1, 1, p, 3)
    plan = preprocess._normalize_plan(x.numel(), x.data_ptr() % 16)
    assert x.data_ptr() % 16 != 0 and plan.groups == 0 and plan.pixels == p
    got = preprocess.normalize_images_cuda(x, torch.bfloat16).view(p, 3)
    for a in (0, 2**32 - 2048, p - 4096):
        want = preprocess.normalize_affine_plain(x.view(p, 3)[a : a + 4096], torch.bfloat16)
        assert torch.equal(got[a : a + 4096], want)
    del got, x, full
    torch.cuda.empty_cache()


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


def _stem_bwd_inputs(shape, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    b, c, h, w = shape
    y = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((b, c, h // 2, w // 2)).astype(np.float32)).to(dev)
    a = torch.from_numpy(rng.uniform(0.5, 2.0, c).astype(np.float32)).to(dev)
    bb = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32)).to(dev)
    cl = torch.channels_last
    return y.to(dtype).contiguous(memory_format=cl), g.to(dtype).contiguous(memory_format=cl), a, bb


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 8, 16, 12), (3, 40, 8, 8), (1, 3, 2, 2)])
def test_stem_backward_kernel(dev, shape, dtype):
    """(dy, da, db) vs the plain vjp, one launch counted, two runs bit-equal.
    f32: dy within rtol/atol 1e-6, da and db within 1e-5 of their largest
    magnitude. bf16: the tie tolerance (under 1% of dy rerouted by more than
    2e-2 of its largest magnitude; da, db within 2e-2 of theirs)."""
    y, g, a, b = _stem_bwd_inputs(shape, dtype, dev, sum(shape))
    before = stem_pool.bwd_launches
    got = stem_pool.stem_pool_bwd(g, y, a, b)
    assert stem_pool.bwd_launches == before + 1
    again = stem_pool.stem_pool_bwd(g, y, a, b)
    want = stem_pool._plain_bwd(g, y, a, b)
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    _assert_stem_bwd_close(got, want, dtype)


def _assert_stem_bwd_close(got, want, dtype):
    """test_stem_backward_kernel's tolerances for the kernel's (dy, da, db)
    against the plain vjp's."""
    dy, da, db = got
    assert dy.dtype == dtype and dy.is_contiguous(memory_format=torch.channels_last)
    assert da.dtype == db.dtype == torch.float32
    if dtype == torch.float32:
        torch.testing.assert_close(dy, want[0], rtol=1e-6, atol=1e-6)
        for k, w in zip((da, db), want[1:]):
            assert float((k - w).abs().max()) <= 1e-5 * float(w.abs().max())
        return
    scale = float(want[0].float().abs().max())
    assert float(((dy.float() - want[0].float()).abs() > 2e-2 * scale).float().mean()) < 0.01
    for k, w in zip((da, db), want[1:]):
        assert float((k - w.float()).abs().max()) <= 2e-2 * float(w.float().abs().max())


def test_stem_autograd_runs_both_kernels(dev):
    """Through autograd the forward and the backward kernels run once each,
    and y, a, b get the plain path's gradients (f32, within 1e-6)."""
    y, g, a, b = _stem_bwd_inputs((2, 16, 12, 10), torch.float32, dev, 7)
    leaves = [t.clone().requires_grad_() for t in (y, a, b)]
    plain = [t.clone().requires_grad_() for t in (y, a, b)]
    f0, b0 = stem_pool.launches, stem_pool.bwd_launches
    out = stem_pool.stem_bn_relu_pool(*leaves, "kernel")
    (out * g).sum().backward()
    assert (stem_pool.launches - f0, stem_pool.bwd_launches - b0) == (1, 1)
    (stem_pool.stem_bn_relu_pool(*plain, "plain") * g).sum().backward()
    for k, p in zip(leaves, plain):
        torch.testing.assert_close(k.grad, p.grad, rtol=1e-6, atol=1e-5)


def test_stem_backward_takes_any_gradient_layout(dev):
    """A gradient that is not channels_last is made so (same result); a
    gradient of the wrong shape or dtype raises."""
    y, g, a, b = _stem_bwd_inputs((2, 8, 8, 6), torch.float32, dev, 8)
    want = stem_pool.stem_pool_bwd(g, y, a, b)
    got = stem_pool.stem_pool_bwd(g.contiguous(), y, a, b)
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    with pytest.raises(ValueError, match="g must be"):
        stem_pool.stem_pool_bwd(g[:, :, :2], y, a, b)
    with pytest.raises(ValueError, match="g must be"):
        stem_pool.stem_pool_bwd(g.to(torch.bfloat16), y, a, b)


def _stem_forward_equal(y, a, b):
    """The forward kernel against `_composite`, bit for bit (NaN where it
    has NaN), one launch counted."""
    before = stem_pool.launches
    got = stem_pool.stem_bn_relu_pool(y, a, b, "kernel")
    assert stem_pool.launches == before + 1
    want = stem_pool._composite(y, a, b)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


def _stem_backward_twice(g, y, a, b):
    """Two runs of the backward kernel, bit-equal, one launch counted each."""
    before = stem_pool.bwd_launches
    got = stem_pool.stem_pool_bwd(g, y, a, b)
    again = stem_pool.stem_pool_bwd(g, y, a, b)
    assert stem_pool.bwd_launches == before + 2
    for u, v in zip(got, again):
        assert torch.equal(u.isnan(), v.isnan())
        assert torch.equal(u.nan_to_num(), v.nan_to_num())
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 64, 34, 50), (3, 40, 18, 130), (1, 64, 112, 112)],
                         ids=str)
def test_stem_kernels_across_tiles(dev, shape, dtype):
    """Tiles ragged in both axes (17 x 25 and 9 x 65 pooled positions) and one
    whole stem map: the forward bit-exact, the backward within
    test_stem_backward_kernel's tolerances, one launch counted a call, two
    runs bit-equal."""
    y, g, a, b = _stem_bwd_inputs(shape, dtype, dev, sum(shape))
    _stem_forward_equal(y, a, b)
    got = _stem_backward_twice(g, y, a, b)
    _assert_stem_bwd_close(got, stem_pool._plain_bwd(g, y, a, b), dtype)


def test_stem_backward_ties_across_tile_seams(dev):
    """f32 y constant over 5 x 5 blocks of four values (negative ones too),
    so most windows hold ties, many of them across the seams of the tiles
    (every 8 input rows and columns): dy within the f32 tolerance of the
    plain vjp, so each tie is routed to the same tap as max_pool2d's
    backward routes it (a misrouted g would be off by its own size)."""
    rng = np.random.default_rng(12)
    levels = np.array([-1.0, 0.5, 1.0, 2.0], np.float32)
    blocks = levels[rng.integers(0, 4, (2, 64, 8, 15))].repeat(5, axis=2).repeat(5, axis=3)
    y = torch.from_numpy(np.ascontiguousarray(blocks[..., :74])).to(dev)  # (2, 64, 40, 74)
    y = y.contiguous(memory_format=torch.channels_last)
    _, g, a, b = _stem_bwd_inputs(tuple(y.shape), torch.float32, dev, 13)
    _stem_forward_equal(y, a, b)
    got = _stem_backward_twice(g, y, a, b)
    _assert_stem_bwd_close(got, stem_pool._plain_bwd(g, y, a, b), torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stem_nan_on_tile_seams(dev, dtype):
    """NaN at pixels on and beside the tiles' seams (input rows and columns
    7, 8, 15, 16, 31, 33): the forward bit-exact with NaN in the same
    places; the backward's dy, da, db NaN exactly where the plain vjp's are
    and, with NaN zeroed, within test_stem_backward_kernel's tolerances."""
    y, g, a, b = _stem_bwd_inputs((2, 64, 34, 50), dtype, dev, 14)
    for n, ch, hh, ww in ((0, 0, 7, 15), (0, 5, 8, 16), (1, 9, 15, 31), (1, 63, 16, 33),
                          (0, 17, 16, 7), (1, 33, 31, 8)):
        y[n, ch, hh, ww] = float("nan")
    _stem_forward_equal(y, a, b)
    got = _stem_backward_twice(g, y, a, b)
    want = stem_pool._plain_bwd(g, y, a, b)
    for k, w in zip(got, want):
        assert torch.equal(k.isnan(), w.isnan())
    assert int(got[1].isnan().sum()) > 0
    _assert_stem_bwd_close(*(tuple(t.nan_to_num() for t in ts) for ts in (got, want)), dtype)


def test_small_train_step_stem_kernel_matches_plain(dev):
    """One dual-stream f32 train step (TF32 off, SGD(lr=1) so the parameter
    delta is the gradient) of a small geodesic_bd model with the stem kernels
    against the plain stem, both after the normalize kernel: 1 normalize, 2
    stem and 2 stem backward launches; loss within 1e-5 relative, every
    gradient leaf within 1e-4 of its largest magnitude."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    small = dict(N1=32, N2=16, dict_size=8, num_classes=3, image_size=64)
    cfg = get_config("geodesic_bd", stem_pool="kernel", compute_dtype="float32", **small)
    centers = np.random.default_rng(1).standard_normal((8, 3)).astype(np.float32)
    problem = build_problem(cfg, centers, dev)
    rng = np.random.default_rng(2)
    batch = {
        "xdata": torch.from_numpy(rng.integers(0, 256, (24, 64, 64, 3), np.uint8)).to(dev),
        "euler": torch.from_numpy(rng.uniform(-90, 90, (24, 3)).astype(np.float32)).to(dev),
        "label": torch.from_numpy(np.tile(np.arange(3), 8).astype(np.int32)).to(dev),
    }
    results = {}
    weights = None
    for stem in ("kernel", "plain"):
        model = build_model(cfg.replace(stem_pool=stem), dev)
        if weights is None:
            weights = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(weights)
        sgd = torch.optim.SGD(model.parameters(), lr=1.0)
        step = make_train_step(model, problem, sgd, phase="main", dual_stream_bn=True)
        counts = (preprocess.launches, stem_pool.launches, stem_pool.bwd_launches)
        _, m = step(TrainState(0, model, sgd, torch.zeros((), device=dev)), batch)
        counts = tuple(n - n0 for n, n0 in zip(
            (preprocess.launches, stem_pool.launches, stem_pool.bwd_launches), counts))
        assert counts == ((1, 2, 2) if stem == "kernel" else (1, 0, 0))
        results[stem] = (float(m["loss"]), {k: p.grad for k, p in model.named_parameters()})
    (lk, gk), (lp, gp) = results["kernel"], results["plain"]
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    for k, w in gp.items():
        assert float((gk[k] - w).abs().max()) <= 1e-4 * float(w.abs().max()), k


# --- the fused conv+BN kernels -------------------------------------------------


def _ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -32768 - i, i)

    return (ordered(a) - ordered(b)).abs()


def _assert_bf16_close(got, want, what):
    """Kernel and plain version feed the same bf16 operands to their products
    and differ in the order of the float32 accumulation only: at most 1 bf16
    ulp apart, on under 1% of the elements. Elements below 1/64 of the
    largest magnitude (sums that cancel) are held to the ulp at that floor."""
    assert got.shape == want.shape and got.dtype == want.dtype == torch.bfloat16
    wf = want.float()
    floor = 2.0**-6 * float(wf.abs().max())
    u = torch.where(wf.abs() >= floor, _ulps(got, want), 0)
    assert int(u.max()) <= 1, f"{what}: {int(u.max())} ulps"
    d = torch.where(wf.abs() < floor, (got.float() - wf).abs(), 0.0)
    assert float(d.max()) <= 2.0**-7 * floor, f"{what}: {float(d.max())} below the floor"
    assert float((got != want).float().mean()) < 0.01, what


def _assert_f32_close(got, want, what, tol=1e-3):
    """float32 sums in another order: within 1e-3 of the largest magnitude."""
    assert got.shape == want.shape and got.dtype == torch.float32
    scale = max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) <= tol * scale, what


def _fused_inputs(x_shape, w_shape, dev, seed, prologue):
    rng = np.random.default_rng(seed)
    k = x_shape[-1]
    x = torch.from_numpy(rng.standard_normal(x_shape).astype(np.float32)).to(dev).bfloat16()
    fan = float(np.prod(w_shape[1:]))
    wb = torch.from_numpy((rng.standard_normal(w_shape) / np.sqrt(fan)).astype(np.float32))
    wb = wb.to(dev).bfloat16()
    ab = None
    if prologue:
        ab = torch.from_numpy(np.stack([
            rng.uniform(0.5, 2.0, k), rng.standard_normal(k) * 0.3]).astype(np.float32)).to(dev)
    y_shape = (*x_shape[:-1], w_shape[0])
    gy = torch.from_numpy((rng.standard_normal(y_shape) * 0.1).astype(np.float32))
    gs = torch.from_numpy((rng.standard_normal((2, w_shape[0])) * 0.01).astype(np.float32))
    return x, wb, ab, gy.to(dev).bfloat16(), gs.to(dev)


def _check_fused_pair(fwd, fwd_plain, bwd, bwd_plain, counters, x, wb, ab, gy, gs):
    n0 = tuple(getattr(fcb, c) for c in counters)
    y, s = fwd(x, wb, ab, ab is not None)
    py, ps = fwd_plain(x, wb, ab, ab is not None)
    _assert_bf16_close(y, py, "y")
    # the sums are those of the kernel's own rounded y
    _assert_f32_close(s, fcb._stats(y), "sums", tol=1e-5)
    got = bwd(gy, gs, y, x, wb, ab, ab is not None)
    again = bwd(gy, gs, y, x, wb, ab, ab is not None)
    want = bwd_plain(gy, gs, y, x, wb, ab, ab is not None)
    assert tuple(getattr(fcb, c) for c in counters) == (n0[0] + 1, n0[1] + 2)
    _assert_bf16_close(got[0], want[0], "dx")
    _assert_f32_close(got[1], want[1], "dw")
    assert got[1].shape == wb.shape
    if ab is None:
        assert got[2] is None
    else:
        _assert_f32_close(got[2], want[2], "dab")
    for g, a in zip(got, again):  # no atomics: two runs give the same bits
        assert g is None or torch.equal(g, a)
    y2, s2 = fwd(x, wb, ab, ab is not None)
    assert torch.equal(y, y2) and torch.equal(s, s2)


@pytest.mark.parametrize("prologue", [True, False], ids=["prologue", "no_prologue"])
@pytest.mark.parametrize("mkn", [(700, 64, 96), (129, 8, 24), (4096, 256, 64), (33, 136, 200)])
def test_fused_mm_kernels(dev, mkn, prologue):
    """Kernels #4 and #5 against their plain versions at small and ragged
    shapes (M no multiple of 128 or 32; K and N multiples of 8 only)."""
    m, k, n = mkn
    args = _fused_inputs((m, k), (n, k), dev, sum(mkn), prologue)
    _check_fused_pair(fcb._mm_stats, fcb._mm_plain, fcb._mm_stats_bwd, fcb._mm_bwd_plain,
                      ("mm_launches", "mm_bwd_launches"), *args)


@pytest.mark.parametrize("prologue", [True, False], ids=["prologue", "no_prologue"])
@pytest.mark.parametrize("shape", [(2, 7, 9, 16, 32), (3, 14, 14, 64, 64), (1, 5, 5, 8, 8),
                                   (5, 3, 11, 72, 24)])
def test_fused_c3_kernels(dev, shape, prologue):
    """Kernels #6 and #7 against their plain versions: odd H and W, images
    whose seams fall inside a 128-pixel tile, a ragged last tile. With the
    prologue, b > 0 on some channels, so padding before it would show."""
    b, h, w, c, cout = shape
    args = _fused_inputs((b, h, w, c), (cout, c, 3, 3), dev, sum(shape), prologue)
    _check_fused_pair(fcb._c3_fwd, fcb._c3_plain, fcb._c3_bwd, fcb._c3_bwd_plain,
                      ("c3_launches", "c3_bwd_launches"), *args)


@pytest.mark.parametrize("mkn", [(40, 64, 64), (20000, 64, 64), (300, 512, 2048),
                                 (500, 8, 64), (200, 64, 2048)], ids=str)
def test_fused_mm_backward_tiling(dev, mkn):
    """Kernel #5 where its tiling is stressed: M under one tile, M over many
    dw row splits (a fixed-order sum of their partials), N K larger than a
    block's dw tile by far, K = 8, N = 2048; against the plain version, two
    runs bit-equal, one count per call."""
    m, k, n = mkn
    args = _fused_inputs((m, k), (n, k), dev, sum(mkn), True)
    _check_fused_pair(fcb._mm_stats, fcb._mm_plain, fcb._mm_stats_bwd, fcb._mm_bwd_plain,
                      ("mm_launches", "mm_bwd_launches"), *args)


@pytest.mark.parametrize("shape", [(2, 5, 3, 16, 16), (3, 9, 13, 32, 32), (1, 14, 14, 64, 64),
                                   (2, 7, 7, 512, 512), (1, 3, 150, 16, 16)], ids=str)
def test_fused_c3_backward_tiling(dev, shape):
    """Kernel #7 where its halo tiles are stressed: W far under a tile's
    pixels, H W no multiple of the tile, batch 1, C = 512 at 7 x 7, and a W
    so wide that the halo is cut into three runs."""
    b, h, w, c, cout = shape
    args = _fused_inputs((b, h, w, c), (cout, c, 3, 3), dev, sum(shape), True)
    _check_fused_pair(fcb._c3_fwd, fcb._c3_plain, fcb._c3_bwd, fcb._c3_bwd_plain,
                      ("c3_launches", "c3_bwd_launches"), *args)


def _check_forward_nan(fwd, x, wb, ab):
    """One NaN in x: the kernel's y is NaN exactly at the outputs that read
    that pixel (the prologue keeps NaN; a 3x3 spreads it to the neighbours
    inside the image only, not across a border or seam), every other element
    has the bits of the run without the NaN, and every column's sums are
    NaN. The NaN positions come from the shapes alone, not from a library
    convolution, which may spread NaN further."""
    relu = ab is not None
    clean, _ = fwd(x, wb, ab, relu)
    x = x.clone()
    flat = x.view(-1, x.shape[-1])
    flat[flat.shape[0] // 2, 0] = float("nan")
    y, s = fwd(x, wb, ab, relu)
    hit = x.isnan().any(dim=-1)
    if x.ndim == 4:  # the 3x3 neighbourhood of the pixel, inside its image
        hit = torch.nn.functional.max_pool2d(hit[:, None].float(), 3, 1, 1)[:, 0] > 0
    want = hit[..., None].expand_as(y)
    assert torch.equal(y.isnan(), want)
    assert torch.equal(y[~want], clean[~want])
    assert bool(s.isnan().all())


@pytest.mark.parametrize("prologue", [True, False], ids=["prologue", "no_prologue"])
@pytest.mark.parametrize("mkn", [(40, 64, 64), (2352, 2048, 512), (500, 8, 64),
                                 (700, 264, 1000), (300, 512, 2048), (1000, 64, 256),
                                 (40000, 128, 64)], ids=str)
def test_fused_mm_forward_tiling(dev, mkn, prologue):
    """Kernel #4 where its tiling is stressed: M under one tile; layer4's
    2048-deep reduction, split in 3 and summed by the fixed-order second
    launch; K = 8 (one ring step, most of it zeros, w loaded once); K 264
    and N 1000 (ragged ring steps and tiles, split in 2); N 2048 (split in
    4); the 64 x 256 tile over a ragged M; 313 row tiles, more than the
    264 blocks, so blocks walk two tiles through one ring. Against the plain
    version, two runs bit-equal, one count per call, and a NaN in x kept."""
    m, k, n = mkn
    args = _fused_inputs((m, k), (n, k), dev, sum(mkn), prologue)
    _check_fused_pair(fcb._mm_stats, fcb._mm_plain, fcb._mm_stats_bwd, fcb._mm_bwd_plain,
                      ("mm_launches", "mm_bwd_launches"), *args)
    _check_forward_nan(fcb._mm_stats, *args[:3])


@pytest.mark.parametrize("prologue", [True, False], ids=["prologue", "no_prologue"])
@pytest.mark.parametrize("shape", [(1, 3, 150, 16, 16), (1, 3, 300, 16, 16), (2, 7, 7, 512, 512),
                                   (3, 9, 13, 32, 32), (2, 5, 7, 8, 24), (8, 96, 97, 16, 24)],
                         ids=str)
def test_fused_c3_forward_tiling(dev, shape, prologue):
    """Kernel #6 where its halo tiles are stressed: W 150 (a halo of one run
    of 558 pixels) and W 300 (three runs), C = Cout = 512 at 7 x 7 (C split
    in 16, 8 output-channel tiles), image seams inside a tile with odd H and
    W, C = 8 (half of a 16-channel step zeros), 291 tiles of one ring step
    each, more than the 264 blocks, so blocks walk two tiles through one
    ring. b > 0 on some channels, so padding before the prologue would show;
    against the plain version, two runs bit-equal, one count per call, and a
    NaN in x spread to its neighbours inside the image only."""
    b, h, w, c, cout = shape
    args = _fused_inputs((b, h, w, c), (cout, c, 3, 3), dev, sum(shape), prologue)
    if prologue:
        assert bool((args[2][1] > 0).any())
    _check_fused_pair(fcb._c3_fwd, fcb._c3_plain, fcb._c3_bwd, fcb._c3_bwd_plain,
                      ("c3_launches", "c3_bwd_launches"), *args)
    _check_forward_nan(fcb._c3_fwd, *args[:3])


def test_fused_kernels_reject_what_they_do_not_take(dev):
    x = torch.zeros((16, 12), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="multiples of 8"):
        fcb.linear_stats(x, torch.zeros((8, 12), device=dev))
    with pytest.raises(ValueError, match="multiples of 8"):
        fcb.conv3x3_bn_stats(torch.zeros((1, 4, 4, 8), dtype=torch.bfloat16, device=dev),
                             torch.zeros((12, 8, 3, 3), device=dev))
    x = torch.zeros((16, 16), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="float32"):
        fcb._mm_stats(x, torch.zeros((8, 16), dtype=torch.bfloat16, device=dev),
                      torch.zeros((2, 16), dtype=torch.float64, device=dev), True)
    with pytest.raises(ValueError, match="bfloat16"):
        fcb._mm_stats(x, torch.zeros((8, 16), device=dev), None, False)


def test_fused_ops_autograd_runs_the_kernels(dev):
    """Through autograd, the 1x1 (strided, by its contiguous copy) and the
    3x3 ops launch their forward and backward kernels once each and give the
    plain path's gradients: dx within the ulp tolerance, the rest within
    1e-3 of their largest magnitude."""
    x, wb, ab, _, _ = _fused_inputs((2, 9, 8, 16), (32, 16, 3, 3), dev, 11, True)
    w3 = wb.float()
    w1 = w3[:, :, 1, 1].contiguous()

    def run(impl):
        leaves = [t.clone().requires_grad_() for t in (x, ab[0], ab[1], w3, w1)]
        xx, a, b, w3_, w1_ = leaves
        y1, s1 = fcb.conv1x1_bn_stats(xx, w1_, (a, b), stride=2, impl=impl)
        y3, s3 = fcb.conv3x3_bn_stats(xx, w3_, (a, b), impl=impl)
        (y1.float().pow(2).sum() + s1.pow(2).sum() * 1e-3 + y3.float().pow(2).sum()
         + s3.sum()).backward()
        return [t.grad for t in leaves]

    n0 = (fcb.mm_launches, fcb.mm_bwd_launches, fcb.c3_launches, fcb.c3_bwd_launches)
    got = run("kernel")
    n1 = (fcb.mm_launches, fcb.mm_bwd_launches, fcb.c3_launches, fcb.c3_bwd_launches)
    assert tuple(b - a for a, b in zip(n0, n1)) == (1, 1, 1, 1)
    want = run("plain")
    assert (fcb.mm_launches, fcb.mm_bwd_launches, fcb.c3_launches, fcb.c3_bwd_launches) == n1
    scale = float(want[0].float().abs().max())
    assert float((got[0].float() - want[0].float()).abs().max()) <= 2.0**-7 * scale
    for g, w in zip(got[1:], want[1:]):
        _assert_f32_close(g, w, "grad")


def test_small_fused_train_step_kernel_matches_plain(dev):
    """One bf16 warm-up step of a small geodesic_bd model (ResNet50 to layer4
    at 64 px, 24 images, one stream) with fused_conv_bn='kernel' against
    'plain' from the same weights: 36 1x1 and 13 3x3 launches each way; loss,
    lc, lr within 5% (measured 0.4%, 0.5%, 0.1%). The two differ by 1-ulp
    flips of each conv's output, carried through 49 convs and BNs over as
    few as 96 elements per channel; the warm-up losses (CE, MSE) are smooth
    in the outputs, while the main phase's Lr goes through the argmax
    decode, where one flipped bin of 24 rows moved it by 6.7%."""
    small = dict(N1=32, N2=16, dict_size=8, num_classes=3, image_size=64,
                 compute_dtype="bfloat16", items_per_batch=8)
    centers = np.random.default_rng(1).standard_normal((8, 3)).astype(np.float32)
    rng = np.random.default_rng(2)
    batch = {
        "xdata": rng.integers(0, 256, (24, 64, 64, 3), np.uint8),
        "euler": rng.uniform(-90, 90, (24, 3)).astype(np.float32),
        "label": np.tile(np.arange(3), 8).astype(np.int32),
    }
    metrics, weights = {}, None
    for impl in ("kernel", "plain"):
        trainer = Trainer(get_config("geodesic_bd", fused_conv_bn=impl, **small),
                          dictionary=centers, device=dev)
        if weights is None:
            weights = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        trainer.model.load_state_dict(weights)
        n0 = (fcb.mm_launches, fcb.mm_bwd_launches, fcb.c3_launches, fcb.c3_bwd_launches)
        _, m = trainer.train_step_fn("warmup")(trainer.init_state(), trainer._to_device(batch))
        n1 = (fcb.mm_launches, fcb.mm_bwd_launches, fcb.c3_launches, fcb.c3_bwd_launches)
        assert tuple(b - a for a, b in zip(n0, n1)) == (
            (36, 36, 13, 13) if impl == "kernel" else (0, 0, 0, 0))
        metrics[impl] = {k: float(v) for k, v in m.items()}
    for k in ("loss", "lc", "lr"):
        assert abs(metrics["kernel"][k] - metrics["plain"][k]) <= 0.05 * abs(metrics["plain"][k]), (
            k, metrics)


# --- the assign kernel and the dictionary path -----------------------------------


@pytest.mark.parametrize("n,d,k", [(257, 3, 16), (100_003, 4, 200), (5000, 1, 7),
                                   (4096, 2, 3000), (70_000, 3, 200)])
def test_assign_kernel_equals_plain(dev, n, d, k):
    """Equal indices (both sides round each product and sum on its own, in
    the same order), int32, one launch counted per call, two runs equal."""
    rng = np.random.default_rng(n + d + k)
    y = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev)
    c = torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32)).to(dev)
    before = assign.launches
    got = assign.assign_bins(y, c)
    assert assign.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (n,) and not got.requires_grad
    assert torch.equal(got, assign.assign_bins_plain(y, c))
    assert torch.equal(got, assign.assign_bins(y, c))


def _assign_equal(y, c):
    got = assign.assign_bins(y, c)
    assert got.dtype == torch.int32 and got.shape == (y.shape[0],)
    assert torch.equal(got, assign.assign_bins_plain(y, c))
    assert torch.equal(got, assign.assign_bins(y, c))
    return got


@pytest.mark.parametrize("where", ["tiles_eq_grid-1", "tiles_eq_grid+1",
                                   "tile_a_warp-1", "tile_a_warp", "tile_a_warp+1"])
def test_assign_kernel_at_plan_boundaries(dev, where):
    """N one row either side of where the plan's shape changes: as many
    tiles of 256 rows as blocks of the full grid (one row short of it, one
    tile more, which one block walks after its first), and a tile for each
    of the grid's warps (one row short, exact, one row more); equal to
    plain, reruns bit-equal."""
    sms = assign._sms(dev.index)
    grid = sms * 3  # blocks an SM at K = 200
    n = {"tiles_eq_grid-1": 256 * grid - 1, "tiles_eq_grid+1": 256 * grid + 1,
         "tile_a_warp-1": 256 * 8 * grid - 1, "tile_a_warp": 256 * 8 * grid,
         "tile_a_warp+1": 256 * 8 * grid + 1}[where]
    plan = assign._assign_plan(n, 3, 200, sms)
    assert plan.tiles == -(-n // 256) and plan.blocks == min(grid, plan.tiles)
    rng = np.random.default_rng(n)
    y = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32)).to(dev)
    c = torch.from_numpy(rng.standard_normal((200, 3)).astype(np.float32)).to(dev)
    _assign_equal(y, c)


@pytest.mark.parametrize("d,k", [(1, 1), (2, 1), (3, 1), (4, 1), (1, 6144), (2, 4096),
                                 (3, 3072), (4, 2457), (4, 5), (2, 7)])
def test_assign_kernel_dims_and_center_limits(dev, d, k):
    """K = 1 at every D; K * (D + 1) at the 12,288-float limit for every D
    (the padded slots take 64-96 KB of dynamic shared memory); K not a
    multiple of the 4-center groups; equal to plain, reruns bit-equal."""
    assert k * (d + 1) <= assign.MAX_SHARED_FLOATS
    rng = np.random.default_rng(10 * d + k)
    y = torch.from_numpy(rng.standard_normal((9000, d)).astype(np.float32)).to(dev)
    c = torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32)).to(dev)
    got = _assign_equal(y, c)
    if k == 1:
        assert int(got.abs().sum()) == 0


def test_assign_kernel_careful_rows(dev):
    """Rows outside the fast loop's guard go through the careful loop of
    the same kernel: |v| = 2^60 (just past the guard), 2^60 less an ulp
    (just inside), +inf, -inf, NaN, huge rows whose distances overflow;
    one such row in a warp tile sends the whole tile, and every row of it
    must still equal plain. Then one center at 2^61 sends every row of
    every block through the careful loop."""
    rng = np.random.default_rng(5)
    n = 100_000
    y = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32)).to(dev)
    c = torch.from_numpy(rng.standard_normal((200, 3)).astype(np.float32)).to(dev)
    edge = float(2**60)
    below = float(np.nextafter(np.float32(edge), np.float32(0)))
    specials = {7: (edge, 0.5, -0.5), 300: (-edge, 1.0, 2.0), 301: (below, below, -below),
                5000: (float("inf"), 0.0, 1.0), 5001: (1.0, -float("inf"), 0.0),
                77_777: (float("nan"), 1.0, 1.0), 99_999: (3e38, -3e38, 3e38)}
    for i, row in specials.items():
        y[i] = torch.tensor(row, device=dev)
    got = _assign_equal(y, c)
    assert int(got[77_777]) == 0
    c[123] = torch.tensor([float(2**61), 0.0, 0.0], device=dev)
    _assign_equal(y, c)
    plain_rows = y.clone()
    plain_rows[list(specials)] = 0.0
    _assign_equal(plain_rows, c)


def test_assign_kernel_ties_nan_casts_and_refusals(dev):
    """Duplicate centers -> the lower index; a NaN row -> index 0; a NaN
    center -> every row; float64 and strided inputs are cast and copied;
    N = 0 launches nothing; D > 4 and centers beyond shared memory raise."""
    rng = np.random.default_rng(1)
    y = torch.from_numpy(rng.standard_normal((512, 3)).astype(np.float32)).to(dev)
    c = torch.from_numpy(rng.standard_normal((40, 3)).astype(np.float32)).to(dev)
    c[30:35] = c[0:5]
    y[:5] = c[:5]
    y[9, 2] = float("nan")
    got = assign.assign_bins(y, c)
    assert torch.equal(got, assign.assign_bins_plain(y, c))
    assert got[:5].tolist() == [0, 1, 2, 3, 4] and int(got[9]) == 0
    assert torch.equal(assign.assign_bins(y.double(), c.double()), got)
    wide = torch.cat([y, y], dim=1)[:, ::2]
    assert not wide.is_contiguous()
    assert torch.equal(assign.assign_bins(wide, c), assign.assign_bins(wide.contiguous(), c))
    c[20, 0] = float("nan")
    got = assign.assign_bins(y, c)
    assert torch.equal(got, assign.assign_bins_plain(y, c))
    assert int((got == 20).sum()) == 511 and int(got[9]) == 0
    before = assign.launches
    assert assign.assign_bins(y[:0], c).shape == (0,)
    assert assign.launches == before
    with pytest.raises(ValueError, match="D <= 4"):
        assign.assign_bins(torch.zeros((4, 5), device=dev), torch.zeros((3, 5), device=dev))
    with pytest.raises(ValueError, match="D <= 4"):
        assign.assign_bins(torch.zeros((4, 3), device=dev), torch.zeros((4000, 3), device=dev))
    with pytest.raises(ValueError, match="centers on"):
        assign.assign_bins(y, c.cpu())


def test_dictionary_fits_on_the_card(dev):
    """fit_kmeans on planted blobs on the card: the blobs recovered, the
    kernel launched n_init * (num_iters + 1) times, predict (default device)
    equal to the nearest center, two fits from one seed bit-equal; fit_gmm
    recovers the same blobs."""
    rng = np.random.default_rng(2)
    centers = rng.uniform(-2, 2, (4, 3))
    pts = (centers[np.repeat(np.arange(4), 500)]
           + 0.05 * rng.standard_normal((2000, 3))).astype(np.float32)
    before = assign.launches
    d = fit_kmeans(pts, 4, seed=0, n_init=2, num_iters=8)
    assert assign.launches == before + 2 * 9
    dist = np.linalg.norm(centers[:, None] - d.cluster_centers[None], axis=-1)
    assert np.all(dist.min(axis=1) < 0.1)
    bins = d.predict(pts)
    full = np.linalg.norm(pts[:, None] - d.cluster_centers[None], axis=-1)
    np.testing.assert_array_equal(bins, full.argmin(axis=1))
    again = fit_kmeans(pts, 4, seed=0, n_init=2, num_iters=8)
    np.testing.assert_array_equal(again.cluster_centers, d.cluster_centers)
    g = fit_gmm(pts, 4, seed=0, n_init=1, num_iters=20)
    dist = np.linalg.norm(centers[:, None] - g.means[None], axis=-1)
    assert np.all(dist.min(axis=1) < 0.1)
    np.testing.assert_allclose(g.predict_proba(pts).sum(axis=1), 1.0, atol=1e-5)


# --- evaluation and checkpoints on the card ---------------------------------------

_EVAL_SMALL = dict(feature_network="resnet18", feature_layer="layer2", N0=128, N1=16, N2=8,
                   dict_size=8, num_classes=3, image_size=32, items_per_batch=2,
                   max_iterations=1, num_warmup_epochs=1, num_epochs=1)


def _eval_batches(rng, sizes=(6, 6, 6, 2), pad_to=6) -> list[dict]:
    """TestLoader-style batches: the last one padded, `valid` False there."""
    out = []
    for n in sizes:
        b = {"xdata": rng.integers(0, 256, (pad_to, 32, 32, 3), np.uint8),
             "euler": rng.uniform(-90, 90, (pad_to, 3)).astype(np.float32),
             "label": (np.arange(pad_to) % 3).astype(np.int32),
             "valid": np.arange(pad_to) < n}
        out.append(b)
    return out


def test_trainer_evaluate_on_the_card(dev):
    """Trainer.predict and evaluate on the card (f32, TF32 off) against the
    same trainer's weights on the CPU: the padded rows dropped, poses within
    1e-3, MedErr within 1e-3 deg, one normalize launch per eval batch."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    centers = np.random.default_rng(1).standard_normal((8, 3)).astype(np.float32)
    cfg = get_config("geodesic_bd", compute_dtype="float32", **_EVAL_SMALL)
    card = Trainer(cfg, dictionary=centers, device=dev)
    cpu = Trainer(cfg, dictionary=centers, device="cpu")
    cpu.model.load_state_dict(card.model.state_dict())
    batches = _eval_batches(np.random.default_rng(2))
    n0 = preprocess.launches
    got = card.predict(card.init_state(), batches)
    assert preprocess.launches - n0 == len(batches)
    want = cpu.predict(cpu.init_state(), batches)
    assert got[0].shape == (20, 3)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-3)
    med = card.evaluate(card.init_state(), batches)
    assert abs(med - cpu.evaluate(cpu.init_state(), batches)) <= 1e-3


@pytest.mark.parametrize("checkpoint_async", [True, False])
def test_checkpoint_round_trip_on_the_card(dev, tmp_path, checkpoint_async):
    """A bf16 trainer on the card after a warm-up and a main step, saved and
    restored into a new trainer (other initial weights): weights, BN
    statistics, Adam's count, bf16 first moment and f32 second moment, s,
    step and learning rate bit-equal, all on the card."""
    centers = np.random.default_rng(1).standard_normal((8, 3)).astype(np.float32)
    cfg = get_config("geodesic_bd", compute_dtype="bfloat16", stem_pool="kernel",
                     checkpoint_async=checkpoint_async, **_EVAL_SMALL)
    rng = np.random.default_rng(3)
    real, render = ([{k: v for k, v in b.items() if k != "valid"}
                     for b in _eval_batches(rng, (6,))] for _ in range(2))
    a = Trainer(cfg, dictionary=centers, workdir=tmp_path, device=dev)
    sa = a.fit(a.init_state(), real, render)
    b = Trainer(cfg.replace(seed=1), dictionary=centers, workdir=tmp_path, device=dev)
    sb = b.restore_checkpoint("last")
    assert sb.step == sa.step == 2 and sb.s.device == dev and torch.equal(sb.s, sa.s)
    for k, v in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[k], v), k
    pa = [p for g in a.optimizer.param_groups for p in g["params"]]
    pb = [p for g in b.optimizer.param_groups for p in g["params"]]
    for p, q in zip(pa, pb, strict=True):
        st, su = a.optimizer.state[p], b.optimizer.state[q]
        assert st["count"] == su["count"] == 2
        assert su["mu"].dtype == torch.bfloat16 and su["mu"].device == dev
        assert su["nu"].dtype == torch.float32
        assert torch.equal(st["mu"], su["mu"]) and torch.equal(st["nu"], su["nu"])
    assert b.optimizer.param_groups[0]["lr"] == a.optimizer.param_groups[0]["lr"]


# --- snapshot-ensemble evaluation and the packed loaders on the card ---------------


def test_snapshot_evaluator_on_the_card(dev):
    """SnapshotEnsembleEvaluator.run on the card (f32, TF32 off) from dual
    loaders of 2 batches (c = 4) for 3 epochs: snapshots after steps 2 and
    6, one normalize launch per fine-tune step and per eval batch of each
    snapshot, and the same run on the CPU from the same weights within
    1e-3 of its poses and MedErr."""
    from multi_modal_regression_tpu_torch.train.evaluator import SnapshotEnsembleEvaluator

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    centers = np.random.default_rng(1).standard_normal((8, 3)).astype(np.float32)
    cfg = get_config("geodesic_bd", compute_dtype="float32",
                     **{**_EVAL_SMALL, "max_iterations": None})
    rng = np.random.default_rng(4)
    real, render = ([{k: v for k, v in b.items() if k != "valid"}
                     for b in _eval_batches(rng, (6, 6))] for _ in range(2))
    test = _eval_batches(rng)
    trainers = {where: Trainer(cfg, dictionary=centers, device=where) for where in (dev, "cpu")}
    trainers["cpu"].model.load_state_dict(trainers[dev].model.state_dict())
    runs = {}
    for where, t in trainers.items():
        n0 = preprocess.launches
        ev = SnapshotEnsembleEvaluator(t)
        state = ev.run(t.init_state(), real, render, test, num_epochs=3)
        runs[where] = (t, ev, preprocess.launches - n0, state)
    _, ev, launches, state = runs[dev]
    assert state.step == 6 and [s.step for s in ev.snapshots] == [2, 6]
    assert launches == 6 + 2 * len(test) and runs["cpu"][2] == 0
    cpu = runs["cpu"][1]
    for s, c in zip(ev.snapshots, cpu.snapshots, strict=True):
        np.testing.assert_array_equal(s.labels, c.labels)
        np.testing.assert_allclose(s.ypred, c.ypred, rtol=0, atol=1e-3)
        assert abs(s.med_err - c.med_err) <= 1e-3
    assert abs(ev.ensemble()[0] - cpu.ensemble()[0]) <= 1e-3


def test_packed_loaders_feed_run_epoch_on_the_card(dev, tmp_path):
    """Two PackedBalancedLoaders over a packed 32 px tree (3 classes, 4-6
    images each: 3 steps an epoch at 2 items) feed Trainer.run_epoch on the
    card: one normalize launch a step, finite losses; a PackedTestLoader
    feeds evaluate with one launch per batch."""
    from multi_modal_regression_tpu_torch.data import (
        ClassBalancedIndex,
        FlatTestIndex,
        PackedBalancedLoader,
        PackedTestLoader,
        pack_index,
    )
    from multi_modal_regression_tpu_torch.tools.synthetic import generate_pose_dataset

    classes = ("aeroplane", "bicycle", "boat")
    for sub, n, seed in (("real", 4, 1), ("render", 4, 2), ("test", 2, 3)):
        generate_pose_dataset(tmp_path / sub, classes, n, 32, seed=seed, pattern="pose")
    loaders = []
    for sub in ("real", "render"):
        index = ClassBalancedIndex(str(tmp_path / sub), sub, classes=classes)
        pack = pack_index(index, tmp_path / ".packed" / sub, image_size=32, num_workers=2)
        loaders.append(PackedBalancedLoader(index, pack, items_per_batch=2, seed=0))
    test_index = FlatTestIndex(str(tmp_path / "test"), classes=classes)
    test = PackedTestLoader(test_index, pack_index(test_index, tmp_path / ".packed" / "test",
                                                   image_size=32), batch_size=6)
    centers = np.random.default_rng(1).standard_normal((8, 3)).astype(np.float32)
    cfg = get_config("geodesic_bd", compute_dtype="bfloat16",
                     **{**_EVAL_SMALL, "max_iterations": None})
    t = Trainer(cfg, dictionary=centers, device=dev)
    n0 = preprocess.launches
    state = t.run_epoch(t.init_state(), *loaders, "main", log_every=1)
    assert state.step == len(loaders[0]) == 3 and preprocess.launches - n0 == 3
    assert all(np.isfinite(r["loss"]) for r in t.history) and len(t.history) == 3
    n0 = preprocess.launches
    assert np.isfinite(t.evaluate(state, test)) and preprocess.launches - n0 == len(test)


# --- the detection protocol and the parity gate on the card ------------------------


def _det_set(root, n_images=6):
    """A 32 px detector crop set of 3 classes (tools/synthetic)."""
    from multi_modal_regression_tpu_torch.detection import DetectionSetIndex
    from multi_modal_regression_tpu_torch.tools.synthetic import generate_detection_set

    generate_detection_set(root, num_images=n_images, max_boxes=3, image_size=32,
                           num_classes=3, seed=3)
    return DetectionSetIndex(str(root))


def test_detection_inference_on_the_card(dev, tmp_path, monkeypatch):
    """run_detection_inference on the card at batch 4: one normalize launch
    a batch; in f32 with TF32 off, poses within 1e-4 of the plain path (the
    plain normalize on the card, same weights) and within 1e-3 of the CPU;
    a bf16 model gives finite poses of the same layout."""
    from multi_modal_regression_tpu_torch.detection import run_detection_inference
    from multi_modal_regression_tpu_torch.train import steps

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    index = _det_set(tmp_path / "set")
    n = sum(len(index.load_image(i)["labels"]) for i in range(len(index))
            if index.load_image(i) is not None)
    centers = np.random.default_rng(1).standard_normal((8, 3)).astype(np.float32)
    cfg = get_config("geodesic_bd", compute_dtype="float32", **_EVAL_SMALL)
    card = Trainer(cfg, dictionary=centers, device=dev)
    cpu = Trainer(cfg, dictionary=centers, device="cpu")
    cpu.model.load_state_dict(card.model.state_dict())
    n0 = preprocess.launches
    got = run_detection_inference(card.model, card.problem, index, batch_size=4)
    assert preprocess.launches - n0 == -(-n // 4) and n > 4
    want = run_detection_inference(cpu.model, cpu.problem, index, batch_size=4)
    with monkeypatch.context() as m:
        m.setattr(steps, "normalize_images_cuda", normalize_images)
        n0 = preprocess.launches
        plain = run_detection_inference(card.model, card.problem, index, batch_size=4)
        assert preprocess.launches == n0
    for g, p, w in zip(got[1], plain[1], want[1], strict=True):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, p, rtol=0, atol=1e-4)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3)
    for k in (0, 2, 3):
        for g, w in zip(got[k], want[k], strict=True):
            np.testing.assert_array_equal(g, w)
    bf16 = Trainer(cfg.replace(compute_dtype="bfloat16"), dictionary=centers, device=dev)
    out = run_detection_inference(bf16.model, bf16.problem, index, batch_size=4)
    for g, w in zip(out[1], want[1], strict=True):
        assert g.shape == w.shape and np.isfinite(g).all()


def test_verify_parity_on_the_card(dev, tmp_path):
    """`cli verify-parity` on the card at the CPU test's tiny settings
    (ResNet18, K 4, 32 px, 2 steps an epoch) over a synthesized release and
    a maskrcnn-protocol detection set: exit 0, five stages with finite
    numbers; the normalize kernel launched in every step and eval batch and
    the assign kernel n_init x (num_iters + 1) = 404 times by the
    dictionary fit; a second run reuses every artifact, fits nothing and
    writes the same stages."""
    import json

    from multi_modal_regression_tpu_torch import cli
    from multi_modal_regression_tpu_torch.tools.ingest import (
        load_annotations_for_images,
        read_image_set,
    )
    from multi_modal_regression_tpu_torch.tools.synthetic import generate_pascal3d_release

    classes = ("aeroplane", "bicycle", "boat")
    db, voc = generate_pascal3d_release(tmp_path / "release", classes=classes)
    names = read_image_set(voc / "ImageSets" / "Main" / "val.txt")
    for cls in classes:
        rows = [f"{n} {a.bbox[0]} {a.bbox[1]} {a.bbox[2]} {a.bbox[3]} 0.9" for n in names
                for a in load_annotations_for_images(db / "Annotations" / f"{cls}_pascal",
                                                     [n])[0] or ()]
        (tmp_path / f"results_{cls}.txt").write_text("\n".join(rows) + "\n")
    assert cli.main(["prepare-detections", "--detector", "maskrcnn", "--det-source",
                     str(tmp_path), "--images-dir", str(voc / "JPEGImages"), "--image-set",
                     str(voc / "ImageSets" / "Main" / "val.txt"), "--out",
                     str(tmp_path / "det_set"), "--image-size", "32"]) == 0
    args = ["verify-parity", "--data-root", str(tmp_path / "prepared"), "--det-path",
            str(tmp_path / "det_set"), "--annotations", str(db / "Annotations"),
            "--workdir", str(tmp_path / "gate"), "--classes", ",".join(classes),
            "--feature-network", "resnet18", "--N0", "512", "--N1", "16", "--N2", "8",
            "--dict-size", "4", "--image-size", "32", "--items-per-batch", "1",
            "--max-iterations", "2", "--num-epochs", "1", "--num-warmup-epochs", "1",
            "--eval-num-epochs", "1", "--num-workers", "2"]
    n0, a0 = preprocess.launches, assign.launches
    assert cli.main([*args, "--db-path", str(db), "--voc-dir", str(voc)]) == 0
    table = json.loads((tmp_path / "gate" / "parity.json").read_text())
    assert set(table["stages"]) == {"prepare_data", "dictionary", "train", "evaluate",
                                    "detections"}
    assert np.isfinite(table["stages"]["evaluate"]["ensembled_med_err_deg"])
    assert all(np.isfinite(v) for row in table["stages"]["detections"].values()
               for v in row.values() if not isinstance(v, str))
    assert preprocess.launches - n0 >= 4 + 2 + 3 and assign.launches - a0 == 404
    n0, a0 = preprocess.launches, assign.launches
    assert cli.main(args) == 0
    again = json.loads((tmp_path / "gate" / "parity.json").read_text())
    for k in ("dictionary", "train", "evaluate", "detections"):
        assert again["stages"][k] == table["stages"][k], k
    assert assign.launches == a0 and preprocess.launches - n0 >= 1


# --- the single-model pose zoo ---------------------------------------------------

ZOO_KINDS = {
    "one_delta_per_bin": "geodesic_bd_multires",
    "probabilistic": "probabilistic_bd_multires",
    "per_class_regression": "geodesic_regression",
    "per_class_classification": "classification",
    "independent_regression": "independent_regression",
    "independent_bd": "independent_bd",
}


@pytest.mark.parametrize("kind", sorted(ZOO_KINDS))
def test_zoo_train_step_kernel_matches_plain(dev, kind, monkeypatch):
    """One dual-stream f32 main step (TF32 off, SGD(lr=1), ResNet50 to
    layer4 at 64 px, 24 images, N1 32, N2 16, N3 8, K 8, 3 classes) of each
    new model kind, kernel path against plain path from the same weights.
    The bin-delta kinds run the stem kernels against the plain stem, both
    after the normalize kernel: 1 normalize, 2 stem and 2 stem backward
    launches against 1, 0, 0; loss within 1e-5 relative, every gradient
    leaf within 1e-4 of its largest magnitude. The models/pose kinds have
    no stem option: the normalize kernel against the plain normalize, 1
    launch against 0, loss within 1e-4 relative and each gradient leaf
    within 5e-2 of its norm: the two normalizes differ by up to 7.2e-7,
    which flips a few ReLU and max-pool masks, and conv1's gradient, which
    every flip reaches, moved by 1.8-2.3% of its norm on an H100."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    preset = ZOO_KINDS[kind]
    small = dict(N1=32, N2=16, N3=8, dict_size=8, num_classes=3, image_size=64,
                 compute_dtype="float32")
    bin_delta = kind in ("one_delta_per_bin", "probabilistic")
    rng = np.random.default_rng(1)
    centers = rng.standard_normal((8, 3)).astype(np.float32)
    if kind == "probabilistic":
        from multi_modal_regression_tpu_torch.dictionary.gmm import GMMDictionary

        covs = np.tile(0.2 * np.eye(3, dtype=np.float32), (8, 1, 1))
        dictionary = GMMDictionary(centers, covs, np.full(8, 1 / 8, np.float32))
    else:
        dictionary = centers
    batch = {
        "xdata": torch.from_numpy(rng.integers(0, 256, (24, 64, 64, 3), np.uint8)).to(dev),
        "euler": torch.from_numpy(rng.uniform(-90, 90, (24, 3)).astype(np.float32)).to(dev),
        "label": torch.from_numpy(np.tile(np.arange(3), 8).astype(np.int32)).to(dev),
    }
    results = {}
    weights = None
    for path in ("kernel", "plain"):
        stem = path if bin_delta else None
        cfg = get_config(preset, stem_pool=stem, **small)
        model = build_model(cfg, dev)
        if weights is None:
            weights = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(weights)
        if path == "plain" and not bin_delta:
            monkeypatch.setattr("multi_modal_regression_tpu_torch.train.steps."
                                "normalize_images_cuda", normalize_images)
        sgd = torch.optim.SGD(model.parameters(), lr=1.0)
        step = make_train_step(model, build_problem(cfg, dictionary, dev), sgd, phase="main",
                               alpha=cfg.alpha, dual_stream_bn=True,
                               dual_loss_sum=cfg.loss_stream_sum)
        counts = (preprocess.launches, stem_pool.launches, stem_pool.bwd_launches)
        _, m = step(TrainState(0, model, sgd, torch.zeros((), device=dev)), batch)
        counts = tuple(n - n0 for n, n0 in zip(
            (preprocess.launches, stem_pool.launches, stem_pool.bwd_launches), counts))
        want = ((1, 2, 2) if path == "kernel" else (1, 0, 0)) if bin_delta else (
            (1, 0, 0) if path == "kernel" else (0, 0, 0))
        assert counts == want, (path, counts)
        assert torch.isfinite(m["loss"])
        results[path] = (float(m["loss"]), {k: p.grad for k, p in model.named_parameters()})
    (lk, gk), (lp, gp) = results["kernel"], results["plain"]
    assert abs(lk - lp) <= (1e-5 if bin_delta else 1e-4) * abs(lp)
    if bin_delta:
        for k, w in gp.items():
            assert float((gk[k] - w).abs().max()) <= 1e-4 * float(w.abs().max()), k
    else:
        errs = sorted(((float((gk[k] - w).norm()) / max(float(w.norm()), 1e-30), k)
                       for k, w in gp.items()), reverse=True)
        assert errs[0][0] <= 5e-2, errs[:3]


# --- the two-stage and joint pipelines --------------------------------------------------


@pytest.mark.parametrize("preset", ["joint_cat_pose_top1", "simple_bd_rene"])
def test_joint_and_rene_steps_kernel_matches_plain(dev, preset, monkeypatch):
    """One dual-stream f32 main step (TF32 off, SGD(lr=1) over the preset's
    trained leaves, ResNet50 to layer4 at 64 px, 24 images with the is_real
    mask, N1 32, N2 16, K 8, 3 classes), kernel path against plain path
    from the same weights. simple_bd_rene runs the stem kernels with the
    trunk's BN on its running statistics (bn_train_only res_models) against
    the plain stem, both after the normalize kernel: 1 normalize, 2 stem and
    0 stem backward launches (the frozen trunk takes no gradient) against
    1, 0, 0; the two forwards are the same bits, so the loss within 1e-6
    relative and res_models' gradients within 1e-5 of each leaf's largest
    magnitude; every frozen leaf bit-equal after the step on both paths.
    joint_cat_pose_top1 has no stem option: the normalize kernel against the
    plain normalize, 1 launch against 0, loss within 1e-4 relative and each
    gradient leaf within 5e-2 of its norm, as the zoo's pose kinds."""
    from multi_modal_regression_tpu_torch.train.presets import trained_parameters

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    small = dict(N1=32, N2=16, dict_size=8, num_classes=3, image_size=64,
                 compute_dtype="float32")
    rene = preset == "simple_bd_rene"
    rng = np.random.default_rng(2)
    centers = rng.standard_normal((8, 3)).astype(np.float32)
    batch = {
        "xdata": torch.from_numpy(rng.integers(0, 256, (24, 64, 64, 3), np.uint8)).to(dev),
        "euler": torch.from_numpy(rng.uniform(-90, 90, (24, 3)).astype(np.float32)).to(dev),
        "label": torch.from_numpy(np.tile(np.arange(3), 8).astype(np.int32)).to(dev),
        "is_real": (torch.arange(24) < 12).to(dev),
    }
    results = {}
    weights = None
    for path in ("kernel", "plain"):
        cfg = get_config(preset, stem_pool=path if rene else None, **small)
        model = build_model(cfg, dev)
        if weights is None:
            weights = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(weights)
        if path == "plain" and not rene:
            monkeypatch.setattr("multi_modal_regression_tpu_torch.train.steps."
                                "normalize_images_cuda", normalize_images)
        trained = trained_parameters(cfg, model)
        sgd = torch.optim.SGD(trained, lr=1.0)
        step = make_train_step(model, build_problem(cfg, centers, dev), sgd, phase="main",
                               alpha=cfg.alpha, dual_stream_bn=True)
        counts = (preprocess.launches, stem_pool.launches, stem_pool.bwd_launches)
        _, m = step(TrainState(0, model, sgd, torch.zeros((), device=dev)), batch)
        counts = tuple(n - n0 for n, n0 in zip(
            (preprocess.launches, stem_pool.launches, stem_pool.bwd_launches), counts))
        want = ((1, 2, 0) if path == "kernel" else (1, 0, 0)) if rene else (
            (1, 0, 0) if path == "kernel" else (0, 0, 0))
        assert counts == want, (path, counts)
        assert torch.isfinite(m["loss"])
        ids = {id(p) for p in trained}
        for k, p in model.named_parameters():
            if id(p) not in ids:
                assert p.grad is None and torch.equal(p, weights[k]), k
        results[path] = (float(m["loss"]), {k: p.grad for k, p in model.named_parameters()
                                            if id(p) in ids})
    (lk, gk), (lp, gp) = results["kernel"], results["plain"]
    assert abs(lk - lp) <= (1e-6 if rene else 1e-4) * abs(lp)
    if rene:
        for k, w in gp.items():
            assert float((gk[k] - w).abs().max()) <= 1e-5 * float(w.abs().max()), k
    else:
        errs = sorted(((float((gk[k] - w).norm()) / max(float(w.norm()), 1e-30), k)
                       for k, w in gp.items()), reverse=True)
        assert errs[0][0] <= 5e-2, errs[:3]


# --- the ObjectNet slice: VGG, remat, flips -------------------------------------------

_SMALL_CARD = dict(N1=16, N2=8, N3=4, image_size=32, items_per_batch=2, max_iterations=1,
                   num_warmup_epochs=0, num_epochs=1)


def _card_batches(seed: int, n: int, classes: int = 12):
    rng = np.random.default_rng(seed)
    return [{"xdata": rng.integers(0, 256, (n, 32, 32, 3), np.uint8),
             "euler": rng.uniform(-60, 60, (n, 3)).astype(np.float32),
             "label": (np.arange(n) % classes).astype(np.int32)}]


def _tf32_off():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def test_vgg_step_on_the_card(dev):
    """objectnet_bd on a VGG13/fc6 trunk (32 px, 5 classes, f32, TF32 off),
    one main step of a flat batch: exactly 1 normalize and no stem launch, a
    finite loss within 1e-5 of the plain normalize's step from the same
    weights, and a request served from the VGG model."""
    _tf32_off()
    cfg = get_config("objectnet_bd", **_SMALL_CARD, feature_network="vgg13",
                     feature_layer="fc6", N0=4096, num_classes=5, dict_size=8)
    centers = np.random.default_rng(0).standard_normal((8, 3)).astype(np.float32)
    batches = _card_batches(1, 12, 5)
    losses = {}
    for path in ("kernel", "plain"):
        t = Trainer(cfg, dictionary=centers, device=dev)
        counts = (preprocess.launches, stem_pool.launches)
        if path == "plain":
            import multi_modal_regression_tpu_torch.train.steps as steps_mod

            saved, steps_mod.normalize_images_cuda = steps_mod.normalize_images_cuda, \
                normalize_images
        try:
            t.fit(t.init_state(), batches, None, log_every=1)
        finally:
            if path == "plain":
                steps_mod.normalize_images_cuda = saved
        torch.cuda.synchronize()
        d = (preprocess.launches - counts[0], stem_pool.launches - counts[1])
        assert d == ((1, 0) if path == "kernel" else (0, 0)), (path, d)
        losses[path] = t.history[0]["loss"]
        assert np.isfinite(losses[path])
    assert abs(losses["kernel"] - losses["plain"]) <= 1e-5 * abs(losses["plain"])
    infer = make_inference_fn(t.model, t.problem)
    poses = infer(batches[0]["xdata"], batches[0]["label"])
    assert poses.shape == (12, 3) and bool(torch.isfinite(poses).all())


@pytest.mark.parametrize("mode", ["block", "stage", "conv", "dots", "nothing"])
def test_remat_step_on_the_card(dev, mode):
    """geodesic_bd (ResNet50 to layer2, stem kernels, f32, TF32 off, dual
    loaders) one main step under each remat mode against remat None from the
    same weights: the loss within 1e-6 relative, every running statistic
    within 1e-6 (the forward is the same), every parameter's gradient (what
    the backward through the recomputed segments and the stem kernel's
    recomputed output produced) within 1e-4 of remat None's norm, every
    BN's num_batches_tracked advanced by exactly one a stream; the stem
    kernel launched again for the recomputed stem (4 launches against 2),
    its backward twice. Adam's first step moves each weight by about +/-lr
    whatever its gradient, so the gradients are compared, not the weights."""
    _tf32_off()
    cfg = get_config("geodesic_bd", **_SMALL_CARD, feature_layer="layer2", N0=512,
                     num_classes=3, dict_size=8, stem_pool="kernel")
    centers = np.random.default_rng(0).standard_normal((8, 3)).astype(np.float32)
    real, render = _card_batches(2, 6, 3), _card_batches(3, 6, 3)
    runs = {}
    for remat in (None, mode):
        t = Trainer(cfg.replace(remat=remat), dictionary=centers, device=dev)
        before = {k: v.clone() for k, v in t.model.state_dict().items()}
        c0 = (stem_pool.launches, stem_pool.bwd_launches)
        t.fit(t.init_state(), real, render, log_every=1)
        torch.cuda.synchronize()
        grads = {n: p.grad for n, p in t.model.named_parameters() if p.grad is not None}
        runs[remat] = (t.history[0]["loss"], t.model.state_dict(), before,
                       (stem_pool.launches - c0[0], stem_pool.bwd_launches - c0[1]), grads)
    (l0, sd0, _, c_none, g0), (l1, sd1, init, c_mode, g1) = runs[None], runs[mode]
    assert c_none == (2, 2) and c_mode == (4, 2), (c_none, c_mode)
    assert abs(l1 - l0) <= 1e-6 * abs(l0)
    assert g0.keys() == g1.keys() and len(g0) > 0
    for k, g in g1.items():
        assert float((g - g0[k]).norm()) <= 1e-4 * float(g0[k].norm()), k
    for k, v in sd1.items():
        if k.endswith("num_batches_tracked"):
            assert int(v) - int(init[k]) == 2, k
        elif "running" in k:
            torch.testing.assert_close(v, sd0[k], rtol=1e-6, atol=1e-7, msg=k)


def test_flip_step_repeats_on_the_card(dev, monkeypatch):
    """train_flip draws its masks from the state's generator on the card:
    two runs from one seed draw the same masks (torch.rand on a seeded CUDA
    generator repeats) and end with bit-equal weights; the masks are not all
    one value; the step still launches the normalize kernel once."""
    import multi_modal_regression_tpu_torch.train.steps as steps_mod

    cfg = get_config("geodesic_bd", **{**_SMALL_CARD, "num_epochs": 2},
                     feature_network="resnet18", feature_layer="layer2", N0=128,
                     num_classes=3, dict_size=8, train_flip=True, compute_dtype="bfloat16")
    centers = np.random.default_rng(0).standard_normal((8, 3)).astype(np.float32)
    real, render = _card_batches(4, 6, 3), _card_batches(5, 6, 3)
    orig = steps_mod.flip_mask
    runs = []
    for _ in range(2):
        masks = []
        monkeypatch.setattr(steps_mod, "flip_mask",
                            lambda rng, n, device: masks.append(orig(rng, n, device))
                            or masks[-1])
        t = Trainer(cfg, dictionary=centers, device=dev)
        state = t.init_state()
        assert state.rng.device.type == "cuda"
        c0 = preprocess.launches
        t.fit(state, real, render, log_every=1)
        torch.cuda.synchronize()
        assert preprocess.launches - c0 == 2
        runs.append((masks, {k: v.clone() for k, v in t.model.state_dict().items()}))
    (m0, sd0), (m1, sd1) = runs
    assert len(m0) == 2 and all(torch.equal(a, b) for a, b in zip(m0, m1))
    assert 0 < int(torch.cat(m0).sum()) < 24
    for k, v in sd0.items():
        assert torch.equal(v, sd1[k]), k
