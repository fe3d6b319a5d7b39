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
