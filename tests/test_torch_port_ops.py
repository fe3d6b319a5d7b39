"""The PyTorch port's kernel modules and small pieces vs the JAX package, on CPU.

The same numpy-seeded inputs go through the JAX function and its port
counterpart. On the CPU every port wrapper takes its kernel's plain version
(the CUDA kernels themselves are checked on the card by chip_smoke.py and
tests/test_torch_port_cuda.py). Each test states its tolerance.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_regression_tpu.data.loader import normalize_images as jax_normalize
from multi_modal_regression_tpu.data.targets import euler_to_pose as jax_euler_to_pose
from multi_modal_regression_tpu.dictionary.kmeans import (
    KMeansDictionary as JaxKMeansDictionary,
)
from multi_modal_regression_tpu.geometry import so3 as jax_so3
from multi_modal_regression_tpu.losses.bin_delta import (
    decode_bin_delta as jax_decode_bin_delta,
)
from multi_modal_regression_tpu.models.heads import MultiHeadMLP as JaxMultiHeadMLP
from multi_modal_regression_tpu.models.heads import select_class as jax_select_class
from multi_modal_regression_tpu.ops import stem_pool as jax_stem
from multi_modal_regression_tpu.ops.fused_conv_bn import fold_bn as jax_fold_bn
from multi_modal_regression_tpu.ops.preprocess import _pallas_normalize
from multi_modal_regression_tpu_torch.data.loader import normalize_images
from multi_modal_regression_tpu_torch.data.targets import euler_to_pose
from multi_modal_regression_tpu_torch.dictionary.kmeans import KMeansDictionary
from multi_modal_regression_tpu_torch.geometry import so3
from multi_modal_regression_tpu_torch.losses.bin_delta import decode_bin_delta
from multi_modal_regression_tpu_torch.models.heads import MultiHeadMLP, select_class
from multi_modal_regression_tpu_torch.models.pretrained import from_jax_variables
from multi_modal_regression_tpu_torch.ops import _build, preprocess, stem_pool
from multi_modal_regression_tpu_torch.ops.fused_conv_bn import fold_bn

REPO = Path(__file__).resolve().parent.parent
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's CPU tests, whose models are small:
    as fast as many in one process, and the suite's parallel workers do
    not oversubscribe the cores (each would start one thread a core).
    Modules that import it run under it too; the setting is restored.
    test_torch_port_train.py does not: its float32 fits are ill-conditioned
    (its docstring), so their rounding follows the thread count, and its
    tolerances were set with the default one."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def bf16_ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in bf16 ulps between two arrays of bf16 values (as float32)."""

    def ordered(x):
        bits = (np.ascontiguousarray(x, np.float32).view(np.uint32) >> 16).astype(np.int64)
        return np.where(bits >= 0x8000, 0x8000 - bits, bits)

    return np.abs(ordered(a) - ordered(b))


def _interpreted(fn, *args):
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        return fn(*args)


# --- kernel 1: normalize ---------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 16, 8, 3), (4, 5, 8, 3)])
def test_normalize_plain_matches_jax(shape, dtype):
    """Port plain vs JAX normalize_images and vs the Pallas kernel run in
    interpret mode (8-row tiles, ragged tail for (4, 5, 8, 3)).
    f32: rtol 1e-6, atol 1e-7. bf16: at most 1 ulp."""
    x = np.random.default_rng(0).integers(0, 256, shape, np.uint8)
    got = _f32(normalize_images(torch.from_numpy(x), TORCH_DTYPE[dtype]))
    want_plain = _f32(jax_normalize(jnp.asarray(x), JAX_DTYPE[dtype]))
    want_kernel = _f32(
        _interpreted(_pallas_normalize, jnp.asarray(x), JAX_DTYPE[dtype], 8)
    )
    for want in (want_plain, want_kernel):
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        else:
            assert bf16_ulps(got, want).max() <= 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_normalize_wrapper_takes_plain_on_cpu(dtype):
    """On a CPU tensor the wrapper is the plain version, bit for bit, and no
    kernel launch is counted."""
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 8, 8, 3), np.uint8))
    before = preprocess.launches
    got = preprocess.normalize_images_cuda(x, TORCH_DTYPE[dtype])
    assert preprocess.launches == before == 0
    assert torch.equal(got, normalize_images(x, TORCH_DTYPE[dtype]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 5, 8, 3), (1, 7, 7, 3), (1, 3, 5, 3)])
def test_normalize_affine_plain_matches_jax(shape, dtype):
    """The kernel's arithmetic in eager ops (x * scale, + offset, each
    rounded to float32, then cast) against the Pallas kernel in interpret
    mode (8-row tiles; on the CPU XLA may fuse its multiply-add and round
    once) and against the plain normalize_images: f32 rtol 1e-6, atol 1e-7;
    bf16 at most 1 ulp. On CPU tensors the wrapper is normalize_images."""
    x = np.random.default_rng(2).integers(0, 256, shape, np.uint8)
    got = preprocess.normalize_affine_plain(torch.from_numpy(x), TORCH_DTYPE[dtype])
    assert got.dtype == TORCH_DTYPE[dtype] and got.shape == shape
    want_kernel = _f32(
        _interpreted(_pallas_normalize, jnp.asarray(x), JAX_DTYPE[dtype], 8)
    )
    want_plain = _f32(normalize_images(torch.from_numpy(x), TORCH_DTYPE[dtype]))
    for want in (want_kernel, want_plain):
        if dtype == "float32":
            np.testing.assert_allclose(_f32(got), want, rtol=1e-6, atol=1e-7)
        else:
            assert bf16_ulps(_f32(got), want).max() <= 1


@pytest.mark.parametrize(
    "n,misalign,want",
    [
        (64 * 224 * 224 * 3, 0, (200704, 0, 784)),  # a request: groups only
        (96 * 224 * 224 * 3, 0, (301056, 0, 1176)),  # a step's batch
        (147, 0, (3, 1, 1)),  # 49 pixels: n mod 48 = 3 after the groups
        (141, 0, (2, 15, 1)),  # 47 pixels: n mod 48 = 45
        (45, 0, (0, 15, 1)),  # under 48 values
        (3, 0, (0, 1, 1)),  # one pixel
        (0, 0, (0, 0, 0)),
        (315, 9, (0, 105, 1)),  # x[1:] of (3, 5, 7, 3): 105 bytes in
        (64 * 224 * 224 * 3, 4, (0, 3211264, 12544)),  # misaligned: pixels only
        (256 * 48 + 3, 0, (256, 1, 2)),  # one item past a block
        (2**31 * 3, 8, (0, 2**31, 2**23)),  # misaligned, 6.4 GB: 64-bit items
        (48 * 2**31, 0, (2**31, 0, 2**23)),  # 2**31 groups
    ],
)
def test_normalize_plan(n, misalign, want):
    """48-byte groups where x is on a 16-byte boundary, the n mod 48 values
    after them a pixel a thread, pixels only where x is not; blocks of 256
    cover the items."""
    plan = preprocess._normalize_plan(n, misalign)
    assert (plan.groups, plan.pixels, plan.blocks) == want
    assert 48 * plan.groups + 3 * plan.pixels == n
    assert plan.blocks * 256 >= plan.groups + plan.pixels > (plan.blocks - 1) * 256


@pytest.mark.parametrize("n,misalign", [
    (2**31 * 256 * 3, 8),  # 2**39 pixels a thread each: past the grid's 2**31 - 1 blocks
    (2**31 * 256 * 48, 0),  # 2**39 groups
    (10, 0),  # not whole pixels
    (-3, 0),
    (48, 16),
])
def test_normalize_plan_raises(n, misalign):
    with pytest.raises(ValueError):
        preprocess._normalize_plan(n, misalign)


def test_normalize_wrapper_rejects_bad_input():
    with pytest.raises(ValueError):
        preprocess.normalize_images_cuda(torch.zeros((2, 8, 8, 3), dtype=torch.float32))
    with pytest.raises(ValueError):
        preprocess.normalize_images_cuda(torch.zeros((2, 8, 8, 4), dtype=torch.uint8))
    with pytest.raises(ValueError, match="unsupported device"):
        preprocess.normalize_images_cuda(
            torch.zeros((2, 8, 8, 3), dtype=torch.uint8, device="meta")
        )


# --- kernel 2: stem BN + ReLU + max-pool ------------------------------------


def _stem_data(shape, seed):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal(shape).astype(np.float32)
    a = rng.uniform(0.5, 2.0, shape[-1]).astype(np.float32)
    b = (rng.standard_normal(shape[-1]) * 0.1).astype(np.float32)
    return y, a, b


def _to_port(y_nhwc: np.ndarray, dtype) -> torch.Tensor:
    """NHWC numpy -> (B, C, H, W) channels_last tensor (a view, no copy)."""
    return torch.from_numpy(y_nhwc).to(dtype).permute(0, 3, 1, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 16, 12, 8), (3, 8, 8, 4)])
def test_stem_plain_matches_jax(shape, dtype):
    """Port plain vs JAX stem_bn_relu_pool: the Pallas kernel in interpret
    mode for bf16, the 'xla' composite for f32. Bit-exact."""
    y, a, b = _stem_data(shape, seed=sum(shape))
    yt = _to_port(y, TORCH_DTYPE[dtype])
    assert yt.is_contiguous(memory_format=torch.channels_last)
    got = stem_pool._composite(yt, torch.from_numpy(a), torch.from_numpy(b))
    impl = "interpret" if dtype == "bfloat16" else "xla"
    want = jax_stem.stem_bn_relu_pool(
        jnp.asarray(y, JAX_DTYPE[dtype]), jnp.asarray(a), jnp.asarray(b), impl
    )
    np.testing.assert_array_equal(_f32(got.permute(0, 2, 3, 1)), _f32(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stem_wrapper_takes_plain_on_cpu(dtype):
    y, a, b = _stem_data((2, 8, 6, 4), seed=5)
    yt = _to_port(y, TORCH_DTYPE[dtype])
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    got = stem_pool.stem_bn_relu_pool(yt, at, bt, "kernel")
    assert stem_pool.launches == 0
    assert torch.equal(got, stem_pool._composite(yt, at, bt))
    assert torch.equal(got, stem_pool.stem_bn_relu_pool(yt, at, bt, "plain"))


def test_stem_wrapper_rejects_what_the_kernel_does_not_take():
    y, a, b = _stem_data((2, 8, 6, 4), seed=6)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    with pytest.raises(ValueError, match="even"):
        stem_pool.stem_bn_relu_pool(_to_port(y[:, :7], torch.float32), at, bt)
    with pytest.raises(ValueError, match="channels_last"):
        stem_pool.stem_bn_relu_pool(
            torch.from_numpy(y).permute(0, 3, 1, 2).contiguous(), at, bt
        )
    # the autograd Function backpropagates on the CPU through the plain vjp
    yg = _to_port(y, torch.float32).requires_grad_()
    ag, bg = at.clone().requires_grad_(), bt.clone().requires_grad_()
    stem_pool.stem_bn_relu_pool(yg, ag, bg).sum().backward()
    want = stem_pool._plain_bwd(
        torch.ones((2, 4, 4, 3)), yg.detach(), at, bt
    )
    for got, w in zip((yg.grad, ag.grad, bg.grad), want):
        assert torch.equal(got, w)
    assert stem_pool.bwd_launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        stem_pool.stem_bn_relu_pool(
            _to_port(y, torch.float32).to("meta"), at.to("meta"), bt.to("meta")
        )
    with pytest.raises(ValueError, match="impl"):
        stem_pool.stem_bn_relu_pool(_to_port(y, torch.float32), at, bt, "pallas")


# main-path shapes (a training step's two 48-image streams, a 64- and a
# 17-image request) and edge cases: the smallest image, a wide one, C = 3
# (no 16-byte chunks), C = 40, ragged tiles, one image, a B whose tensor
# passes 2**31 elements, channel tiles (C above 32 chunks)
_STEM_PLAN_SHAPES = [(48, 64, 112, 112), (64, 64, 112, 112), (17, 64, 112, 112),
                     (1, 64, 2, 2), (1, 3, 2, 2), (2, 64, 112, 150), (2, 3, 16, 12),
                     (3, 40, 18, 130), (2, 64, 34, 50), (1, 64, 112, 112),
                     (4096, 64, 112, 112), (2, 600, 8, 8)]


def _check_stem_axis(n: int, t: int, backward: bool) -> None:
    """One axis of the tiling (rows, or columns), as csrc/stem_pool.cu walks
    it: n pooled positions in tiles of t. Every input position (2n of them)
    is owned by exactly one tile; the windows a tile needs (forward: its
    own t outputs; backward: the t + 1 windows from its first, the <= 2
    windows of each owned position) lie in its window range, and each of
    their taps inside the image lies in its halo: 2 t + 1 (forward) or 2 t +
    3 (backward) positions from 2 o0 - 1."""
    span = 2 * t + (3 if backward else 1)
    owners = [0] * (2 * n)
    for o0 in range(0, n, t):
        halo = range(2 * o0 - 1, 2 * o0 - 1 + span)
        wins = range(o0, o0 + t + (1 if backward else 0))
        if backward:
            own = range(2 * o0, min(2 * (o0 + t), 2 * n))
            needed = {k for i in own for k in (i // 2, (i + 1) // 2) if k < n}
        else:
            own = range(2 * o0, min(2 * (o0 + t), 2 * n))  # the input under its outputs
            needed = set(range(o0, min(o0 + t, n)))
        for i in own:
            owners[i] += 1
        for k in needed:
            assert k in wins
            for i in (2 * k - 1, 2 * k, 2 * k + 1):
                assert i < 0 or i >= 2 * n or i in halo
    assert owners == [1] * (2 * n)


@pytest.mark.parametrize("itemsize", [4, 2], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", _STEM_PLAN_SHAPES, ids=str)
def test_stem_plan(shape, itemsize):
    """The stem kernels' launch shape (pure Python, mirrored by
    csrc/stem_pool.cu): 16-byte chunks exactly where C * itemsize allows
    them; whole chunk groups of threads; tiles that own every input element
    once and hold every window they need in their halo, in both axes and
    both directions; shared memory that keeps the planned (>= 2) blocks on
    an SM, and at least what the kernels lay out in it; a grid in bounds,
    no block idle, all blocks resident at once, no more walk steps than a
    full card needs."""
    bsz, c, h, w = shape
    plan = stem_pool._stem_plan(bsz, h, w, c, itemsize)
    vec = 16 // itemsize if (c * itemsize) % 16 == 0 else 1
    assert plan.vec == vec and not stem_pool._stem_plan(bsz, h, w, c, itemsize, False).vec > 1
    assert plan.cc % vec == 0 and plan.cc == min(c, 32 * vec)
    nch = plan.cc // vec
    assert plan.threads % nch == 0 and 128 <= plan.threads <= 256
    ctiles = -(-c // plan.cc)
    assert ctiles <= 65535
    oh, ow = h // 2, w // 2
    for tile, backward, per_sm in ((plan.fwd, False, 3), (plan.bwd, True, 2)):
        assert 1 <= tile.th <= min(8, oh) and 1 <= tile.tw <= min(8, ow)
        _check_stem_axis(oh, tile.th, backward)
        _check_stem_axis(ow, tile.tw, backward)
        halo_px = (2 * tile.th + (3 if backward else 1)) * (2 * tile.tw + (3 if backward else 1))
        need = 2 * halo_px * plan.cc * itemsize  # two slots of the halo
        if backward:  # and two slots of g, the argmax bytes, a and b
            need += (tile.th + 1) * (tile.tw + 1) * plan.cc * (2 * itemsize + 1) + 12 * plan.cc
            assert tile.smem >= 8 * vec * plan.threads  # the block's da, db sums
        assert tile.smem >= need
        assert per_sm >= 2 and per_sm * (tile.smem + 1024) <= 228 * 1024
        if (tile.th, tile.tw) != (min(8, oh), min(8, ow)):  # a smaller tile only to fit
            big = stem_pool._stem_smem(min(8, oh), min(8, ow), plan.cc, itemsize,
                                       plan.threads, vec, backward)
            assert per_sm * (big + 1024) > 228 * 1024
        tiles = bsz * -(-oh // tile.th) * -(-ow // tile.tw)
        assert 1 <= tile.blocks <= min(tiles, 132 * per_sm) < 2**31
        steps = -(-tiles // tile.blocks)
        assert (steps - 1) * tile.blocks < tiles  # every block has a tile
        assert steps == -(-tiles // (132 * per_sm))
    # the kernels' 32-bit tile indices and in-tile offsets
    with pytest.raises(ValueError, match="too many tiles"):
        stem_pool._stem_plan(2**31 // 49 + 1, 112, 112, 64, itemsize)
    with pytest.raises(ValueError, match="32-bit"):
        stem_pool._stem_plan(1, 2, 2**23, 64, itemsize)


def test_fold_bn_matches_jax():
    """f32, rtol 1e-6 (rsqrt may differ by an ulp between the two libraries)."""
    rng = np.random.default_rng(7)
    m, s, bi = (rng.standard_normal(16).astype(np.float32) for _ in range(3))
    v = rng.uniform(0.5, 2.0, 16).astype(np.float32)
    got = fold_bn(*(torch.from_numpy(t) for t in (m, v, s, bi)))
    want = jax_fold_bn(*(jnp.asarray(t) for t in (m, v, s, bi)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=1e-6, atol=1e-7)


# --- build and imports -------------------------------------------------------


def test_port_imports_without_nvcc_triton_or_jax():
    """Every port module imports in a fresh interpreter whose PATH has no
    nvcc, and none of them pulls in jax, flax, triton or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import multi_modal_regression_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'flax', 'optax', 'orbax', 'triton', 'PIL',\n"
        "        'multi_modal_regression_tpu')]\n"
        "assert not bad, bad\n"
        "assert pkg.__name__ + '.ops.fused_conv_bn' in sys.modules\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env["PATH"] = os.path.dirname(sys.executable)
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr


def test_build_library_path_follows_the_sources():
    """The library is named by a hash of the sources and flags, inside the
    git-ignored build directory; the argtypes cover every C entry point."""
    p = _build.library_path()
    assert p.parent == REPO / "build" / "torch_kernels"
    assert p == _build.library_path()
    names = {s.name for s in _build.sources()}
    assert {"normalize.cu", "stem_pool.cu", "fused_mm.cu", "fused_c3.cu"} <= names
    text = "".join(s.read_text() for s in _build.sources())
    for fn in _build._SIGNATURES:
        assert f'extern "C" int {fn}(' in text


# --- geometry, decode, heads, dictionary -------------------------------------


def _euler_cases(rng, n=256):
    az = rng.uniform(-180, 180, n)
    el = rng.uniform(-90, 90, n)
    ct = rng.uniform(-180, 180, n)
    rand = np.stack([az, el, ct], axis=1)
    special = np.array([
        [0, 0, 0], [1e-4, 0, 0], [0, 1e-3, -1e-3], [0.05, -0.02, 0.01],
        [180, 0, 0], [-180, 0, 0], [0, 180, 0], [90, 180, -90],
        [179.99, 0, 0], [0, 179.9, 0], [180, 0, -1e-3], [45, 90, 45],
    ])
    return np.concatenate([rand, special]).astype(np.float32)


def test_euler_to_pose_matches_jax():
    """Axis-angle targets of >= 256 seeded Euler triples plus angles near 0
    and near 180 degrees; f32, atol 1e-5. Near 180 degrees the axis is
    ill-conditioned in f32 (|skew| ~ sin(theta)), so those rows are
    compared through their rotations, to the same atol."""
    e = _euler_cases(np.random.default_rng(8))
    got = _f32(euler_to_pose(torch.from_numpy(e)))
    want = _f32(jax_euler_to_pose(jnp.asarray(e)))
    theta = np.linalg.norm(want, axis=-1)
    near_pi = theta > np.pi - 1e-2
    assert near_pi.sum() >= 3 and (theta < 1e-2).sum() >= 3
    np.testing.assert_allclose(got[~near_pi], want[~near_pi], rtol=0, atol=1e-5)
    R_got = _f32(so3.exp_so3(torch.from_numpy(got[near_pi])))
    R_want = _f32(jax_so3.exp_so3(jnp.asarray(want[near_pi])))
    np.testing.assert_allclose(R_got, R_want, rtol=0, atol=1e-5)


def test_so3_maps_match_jax():
    """exp_so3 / log_so3 / hat / rotation_from_euler on seeded inputs,
    including |v| below EPS; f32, atol 1e-5."""
    rng = np.random.default_rng(9)
    v = rng.standard_normal((64, 3)).astype(np.float32)
    v[:4] *= 1e-8
    R = _f32(so3.exp_so3(torch.from_numpy(v)))
    np.testing.assert_allclose(R, _f32(jax_so3.exp_so3(jnp.asarray(v))), atol=1e-5)
    np.testing.assert_allclose(
        _f32(so3.log_so3(torch.from_numpy(R))),
        _f32(jax_so3.log_so3(jnp.asarray(R))), atol=1e-5,
    )
    np.testing.assert_array_equal(
        _f32(so3.hat(torch.from_numpy(v))), _f32(jax_so3.hat(jnp.asarray(v)))
    )
    e = _euler_cases(rng, 32)
    np.testing.assert_allclose(
        _f32(so3.rotation_from_euler(*torch.from_numpy(e).T)),
        _f32(jax_so3.rotation_from_euler(*jnp.asarray(e).T)), atol=1e-6,
    )


def test_decode_and_select_match_jax():
    """Exact: argmax (first index on ties) + gather + one f32 add."""
    rng = np.random.default_rng(10)
    scores = rng.standard_normal((32, 8)).astype(np.float32)
    scores[0, 3] = scores[0, 5] = 10.0  # tie: the first index wins on both sides
    residual = rng.standard_normal((32, 3)).astype(np.float32)
    centers = rng.standard_normal((8, 3)).astype(np.float32)
    got = decode_bin_delta(*(torch.from_numpy(t) for t in (scores, residual, centers)))
    want = jax_decode_bin_delta(*(jnp.asarray(t) for t in (scores, residual, centers)))
    np.testing.assert_array_equal(_f32(got), _f32(want))
    per_head = rng.standard_normal((32, 5, 4)).astype(np.float32)
    label = rng.integers(0, 5, 32)
    np.testing.assert_array_equal(
        _f32(select_class(torch.from_numpy(per_head), torch.from_numpy(label))),
        _f32(jax_select_class(jnp.asarray(per_head), jnp.asarray(label, jnp.int32))),
    )


def randomize_batch_stats(tree, rng):
    """Running means ~ N(0, 0.1), variances ~ U(0.5, 2), so eval BN is not
    the identity."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(
            rng.uniform(0.5, 2.0, x.shape) if path[-1].key == "var"
            else rng.normal(0.0, 0.1, x.shape), np.float32,
        ),
        jax.device_get(tree),
    )


def test_head_bank_matches_jax():
    """MultiHeadMLP in eval mode with random (H, F) BN statistics, weights
    converted by from_jax_variables; f32, rtol 1e-5, atol 1e-6."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((6, 32)).astype(np.float32)
    jmodel = JaxMultiHeadMLP(num_heads=3, features=(16, 8, 5))
    variables = jax.jit(lambda k: jmodel.init(k, jnp.asarray(x)))(jax.random.PRNGKey(0))
    stats = randomize_batch_stats(variables["batch_stats"], rng)
    want = jmodel.apply(
        {"params": variables["params"], "batch_stats": stats}, jnp.asarray(x)
    )
    port = MultiHeadMLP(32, 3, (16, 8, 5), generator=torch.Generator().manual_seed(1))
    port.load_state_dict(from_jax_variables(jax.device_get(variables["params"]), stats))
    port.eval()  # the head BNs follow the module's mode; JAX applies train=False
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (6, 3, 5) and got.dtype == torch.float32
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-6)


def test_kmeans_dictionary_reads_jax_npz(tmp_path):
    rng = np.random.default_rng(12)
    centers = rng.standard_normal((200, 3)).astype(np.float32)
    JaxKMeansDictionary(cluster_centers=centers, inertia=1.5).save(tmp_path / "d.npz")
    d = KMeansDictionary.load(tmp_path / "d.npz")
    assert d.n_clusters == 200 and d.inertia == 1.5
    np.testing.assert_array_equal(d.cluster_centers, centers)
    # predict arrived with the assignment kernel: the JAX class's bins
    y = rng.standard_normal((64, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        d.predict(y, device="cpu"), JaxKMeansDictionary.load(tmp_path / "d.npz").predict(y)
    )
    d.save(tmp_path / "e.npz")
    np.testing.assert_array_equal(
        JaxKMeansDictionary.load(tmp_path / "e.npz").cluster_centers, centers
    )
