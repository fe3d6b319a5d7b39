"""The PyTorch port's fused conv+BN training trunk vs the JAX package, on CPU.

On CPU tensors the port's ops run their plain versions (the kernels' launch
counters stay 0). Each is held against the JAX package's
ops/fused_conv_bn.py from the same numpy-seeded inputs, both against its
'xla' composite and against the Pallas kernel in interpret mode; then the
fused bottleneck block and the fused geodesic_bd train step against the JAX
ones from the same weights (through `from_jax_variables`).

Layouts: activations are NHWC / (M, K) on both sides; JAX weights (K, N) and
HWIO become the torch parameters (N, K) and OIHW, and the port's dw comes
back in the parameter's layout.

Tolerances, and why (each test names the one it uses):
  - y (bf16): both sides form the same bf16 operands and accumulate in
    float32, in another order, so a float32 sum next to a bf16 rounding
    boundary may round the other way: at most 1 bf16 ulp apart, on under
    0.1% of the elements (measured 0.003%).
  - sums: float32 sums of the same values up to those flips: rtol 1e-5,
    atol 1e-3 (what tests/test_fused_conv_bn.py holds the JAX kernel to).
  - gradients against 'interpret' and the 1x1 'xla' branch, which round
    gy_eff to bf16 as the port does: within 5e-3 of each leaf's largest
    magnitude (measured 8e-4: dx is rounded to bf16, and 1-ulp flips of y
    move gy_eff).
  - 3x3 gradients against 'xla': the JAX 'xla' branch is autodiff of the
    composite, which adds the stats cotangent to gy in bf16 pieces instead
    of rounding gy_eff once; within 0.1 of each leaf's largest magnitude
    (measured 6.5e-2; the JAX package holds its own two impls to 6e-2).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_regression_tpu.dictionary.kmeans import (
    KMeansDictionary as JaxKMeansDictionary,
)
from multi_modal_regression_tpu.models.backbones import (
    BottleneckBlock as JaxBottleneckBlock,
)
from multi_modal_regression_tpu.ops import fused_conv_bn as jfcb
from multi_modal_regression_tpu.parallel.mesh import make_mesh
from multi_modal_regression_tpu.train import Trainer as JaxTrainer
from multi_modal_regression_tpu.train import get_config as jax_get_config
from multi_modal_regression_tpu_torch.models.backbones import (
    BottleneckBlock,
    make_backbone,
)
from multi_modal_regression_tpu_torch.models.pretrained import from_jax_variables
from multi_modal_regression_tpu_torch.ops import fused_conv_bn as fcb
from multi_modal_regression_tpu_torch.tools import time_fused
from multi_modal_regression_tpu_torch.train.presets import (
    build_model,
    build_problem,
    get_config,
)
from multi_modal_regression_tpu_torch.train.problems import make_problem
from multi_modal_regression_tpu_torch.train.trainer import Trainer

from test_torch_port_ops import bf16_ulps, one_torch_thread  # noqa: F401

JAX_IMPLS = ["xla", "interpret"]


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).to(torch.bfloat16)


def _assert_y_close(got, want):
    """At most 1 bf16 ulp apart, on under 0.1% of the elements."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    ulps = bf16_ulps(got, want)
    assert ulps.max() <= 1, f"{ulps.max()} ulps"
    assert (ulps > 0).mean() < 1e-3, f"{(ulps > 0).mean():.2%} of y differs"


def _assert_grads_close(got, want, tol):
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _f32(g), _f32(w)
        assert g.shape == w.shape
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-6)
        assert err < tol, f"leaf {i}: {err:.3g}"


def _affine(rng, k):
    return (rng.uniform(0.5, 2.0, k).astype(np.float32),
            (rng.standard_normal(k) * 0.1).astype(np.float32))


# --- (a) the 1x1 ops ---------------------------------------------------------


def _linear_inputs(seed, m=700, k=64, n=96):
    """Ragged M (700 rows: no multiple of the JAX or the CUDA tile)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)  # JAX (K, N)
    return x, w, *_affine(rng, k)


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("prologue", [True, False], ids=["prologue", "no_prologue"])
def test_linear_forward_matches_jax(prologue, impl):
    """linear_bn_stats / linear_stats on a CPU tensor (the plain version) vs
    the JAX op: y within the ulp tolerance, sums rtol 1e-5 / atol 1e-3."""
    x, w, a, b = _linear_inputs(0)
    xj = jnp.asarray(x, jnp.bfloat16)
    wt = torch.from_numpy(w.T.copy())  # the torch parameter (N, K)
    if prologue:
        want = jfcb.linear_bn_stats(xj, jnp.asarray(a), jnp.asarray(b), jnp.asarray(w), True, impl)
        got = fcb.linear_bn_stats(_bf16(x), torch.from_numpy(a), torch.from_numpy(b), wt,
                                  True, "kernel")
    else:
        want = jfcb.linear_stats(xj, jnp.asarray(w), impl)
        got = fcb.linear_stats(_bf16(x), wt[:, :, None, None], "kernel")
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    _assert_y_close(got[0], want[0])
    np.testing.assert_allclose(_f32(got[1]), _f32(want[1]), rtol=1e-5, atol=1e-3)
    assert (fcb.mm_launches, fcb.mm_bwd_launches) == (0, 0)


def _downstream_jax(y, s):
    """Uses both outputs, as tests/test_fused_conv_bn.py's downstream does."""
    count = y.size // y.shape[-1]
    mean, var = jfcb.stats_to_moments(s, count)
    z = (y.astype(jnp.float32) - mean) * jax.lax.rsqrt(var + 1e-5)
    return jnp.sum(jnp.tanh(z) ** 2) + 0.1 * jnp.sum(mean**2)


def _downstream_port(y, s):
    count = y.numel() // y.shape[-1]
    mean, var = fcb.stats_to_moments(s, count)
    z = (y.float() - mean) * torch.rsqrt(var + 1e-5)
    return (torch.tanh(z) ** 2).sum() + 0.1 * (mean**2).sum()


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("prologue", [True, False], ids=["prologue", "no_prologue"])
def test_linear_gradients_match_jax(prologue, impl):
    """d/d(x, a, b, w) through a downstream that uses y and the sums, so
    both cotangents reach the backward: within 5e-3 of each leaf's largest
    magnitude; dw comes back float32 in the parameter's (N, K) layout."""
    x, w, a, b = _linear_inputs(1, m=320, n=48)
    xt = _bf16(x).requires_grad_()
    wt = torch.from_numpy(w.T.copy()).requires_grad_()
    if prologue:
        at, bt = torch.tensor(a, requires_grad=True), torch.tensor(b, requires_grad=True)
        _downstream_port(*fcb.linear_bn_stats(xt, at, bt, wt, True, "plain")).backward()
        want = jax.grad(
            lambda x, a, b, w: _downstream_jax(*jfcb.linear_bn_stats(x, a, b, w, True, impl)),
            (0, 1, 2, 3),
        )(jnp.asarray(x, jnp.bfloat16), jnp.asarray(a), jnp.asarray(b), jnp.asarray(w))
        got = (xt.grad, at.grad, bt.grad, wt.grad.t())
    else:
        _downstream_port(*fcb.linear_stats(xt, wt, "plain")).backward()
        want = jax.grad(
            lambda x, w: _downstream_jax(*jfcb.linear_stats(x, w, impl)), (0, 1)
        )(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w))
        got = (xt.grad, wt.grad.t())
    assert xt.grad.dtype == torch.bfloat16 and wt.grad.dtype == torch.float32
    assert wt.grad.shape == wt.shape
    _assert_grads_close(got, want, 5e-3)


def test_linear_backward_takes_a_missing_cotangent():
    """A loss that uses only y, or only the sums, still differentiates: the
    other cotangent is zeros (the JAX custom VJP gets zeros from autodiff)."""
    x, w, a, b = _linear_inputs(2, m=64, k=16, n=24)
    for use in (0, 1):
        xt = _bf16(x).requires_grad_()
        out = fcb.linear_bn_stats(xt, torch.from_numpy(a), torch.from_numpy(b),
                                  torch.from_numpy(w.T.copy()), True, "plain")
        want = jax.grad(
            lambda x: jnp.sum(jfcb.linear_bn_stats(
                x, jnp.asarray(a), jnp.asarray(b), jnp.asarray(w), True, "xla"
            )[use].astype(jnp.float32) ** 2)
        )(jnp.asarray(x, jnp.bfloat16))
        (out[use].float() ** 2).sum().backward()
        _assert_grads_close((xt.grad,), (want,), 5e-3)


def test_conv1x1_strided_matches_jax():
    """stride 2 takes every second row and column first (a contiguous copy
    here, a slice in JAX): (2, 9, 8, 16) -> (2, 5, 4, 32); ulp tolerance on
    y, sums rtol 1e-5 / atol 1e-3; dx is zero at the skipped pixels."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 8, 16)).astype(np.float32)
    w = (rng.standard_normal((1, 1, 16, 32)) * 0.2).astype(np.float32)
    want = jfcb.conv1x1_bn_stats(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), None,
                                 stride=2, impl="xla")
    xt = _bf16(x).requires_grad_()
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())  # OIHW
    got = fcb.conv1x1_bn_stats(xt, wt, None, stride=2, impl="kernel")
    assert got[0].shape == (2, 5, 4, 32)
    _assert_y_close(got[0], want[0])
    np.testing.assert_allclose(_f32(got[1]), _f32(want[1]), rtol=1e-5, atol=1e-3)
    got[0].float().sum().backward()
    assert float(xt.grad[:, 1::2].abs().max()) == 0 and float(xt.grad[:, :, 1::2].abs().max()) == 0
    assert float(xt.grad[:, ::2, ::2].abs().max()) > 0


# --- (b) the 3x3 op ----------------------------------------------------------


def _conv3_inputs(seed, shape=(2, 7, 9, 16), cout=32):
    """Odd H and W: no multiple of any tile; borders on every side."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    w = (rng.standard_normal((3, 3, shape[-1], cout)) * 0.2).astype(np.float32)  # HWIO
    return x, w, *_affine(rng, shape[-1])


def _oihw(w_hwio: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(w_hwio.transpose(3, 2, 0, 1).copy())


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("prologue", [True, False], ids=["prologue", "no_prologue"])
def test_conv3x3_forward_matches_jax(prologue, impl):
    """conv3x3_bn_stats on a CPU tensor vs the JAX op: y within the ulp
    tolerance (border pixels included: the prologue comes before the zero
    padding), sums rtol 1e-5 / atol 1e-3."""
    x, w, a, b = _conv3_inputs(4)
    b = b + 0.5  # relu(b) > 0: padding before the prologue would show at the border
    abj = (jnp.asarray(a), jnp.asarray(b)) if prologue else None
    abt = (torch.from_numpy(a), torch.from_numpy(b)) if prologue else None
    want = jfcb.conv3x3_bn_stats(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), abj,
                                 relu=prologue, impl=impl)
    got = fcb.conv3x3_bn_stats(_bf16(x), _oihw(w), abt, relu=prologue, impl="kernel")
    _assert_y_close(got[0], want[0])
    np.testing.assert_allclose(_f32(got[1]), _f32(want[1]), rtol=1e-5, atol=1e-3)
    assert (fcb.c3_launches, fcb.c3_bwd_launches) == (0, 0)
    if prologue:  # padding before the prologue would indeed differ at the border
        padded = torch.nn.functional.pad(_bf16(x), (0, 0, 1, 1, 1, 1))
        wrong = torch.nn.functional.conv2d(
            torch.relu(padded * _bf16(a) + _bf16(b)).permute(0, 3, 1, 2).float(),
            _oihw(w).bfloat16().float())
        assert float((wrong.permute(0, 2, 3, 1) - got[0].float())[:, 0].abs().max()) > 0.1


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("prologue", [True, False], ids=["prologue", "no_prologue"])
def test_conv3x3_gradients_match_jax(prologue, impl):
    """d/d(x, a, b, w) through y and the sums; dw comes back in the
    parameter's (Cout, C, 3, 3) layout and is compared as HWIO. Against
    'interpret' within 5e-3 of each leaf's largest magnitude, against 'xla'
    (autodiff of the composite) within 0.1."""
    x, w, a, b = _conv3_inputs(5)
    xt, wt = _bf16(x).requires_grad_(), _oihw(w).requires_grad_()
    at, bt = torch.tensor(a, requires_grad=True), torch.tensor(b, requires_grad=True)
    abt = (at, bt) if prologue else None
    _downstream_port(*fcb.conv3x3_bn_stats(xt, wt, abt, relu=prologue, impl="plain")).backward()

    def loss(x, a, b, w):
        ab = (a, b) if prologue else None
        return _downstream_jax(*jfcb.conv3x3_bn_stats(x, w, ab, relu=prologue, impl=impl))

    argnums = (0, 1, 2, 3) if prologue else (0, 3)
    want = jax.grad(loss, argnums)(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(a), jnp.asarray(b), jnp.asarray(w))
    dw = wt.grad.permute(2, 3, 1, 0)  # OIHW -> HWIO
    got = (xt.grad, at.grad, bt.grad, dw) if prologue else (xt.grad, dw)
    assert wt.grad.shape == wt.shape and wt.grad.dtype == torch.float32
    _assert_grads_close(got, want, 5e-3 if impl == "interpret" else 0.1)


# --- (c) the fused bottleneck block ------------------------------------------


def _blocks(seed, shape, stride=2, features=8):
    """(JAX fused 'xla' block, its variables, port block fused 'plain' and
    port block unfused from the same weights, x NHWC)."""
    kw = dict(features=features, stride=stride, dtype=jnp.bfloat16)
    jblock = JaxBottleneckBlock(**kw, fused="xla")
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    variables = jblock.init(jax.random.PRNGKey(0), jnp.asarray(x, jnp.bfloat16), train=False)
    variables = jax.device_get(variables)
    stats = jax.tree.map(
        lambda v: np.asarray(rng.uniform(0.5, 1.5, v.shape), np.float32),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    sd = from_jax_variables(variables["params"], variables["batch_stats"])
    ports = []
    for fused in ("plain", None):
        block = BottleneckBlock(shape[-1], features, stride, torch.bfloat16, torch.float32,
                                **({"fused": fused} if fused else {}))
        block.load_state_dict(sd)
        ports.append(block)
    return jblock, variables, ports[0], ports[1], x


def _port_in(x: np.ndarray) -> torch.Tensor:
    return _bf16(x).permute(0, 3, 1, 2)  # NHWC -> a channels_last (B, C, H, W)


def _assert_running_stats(block, mut, rtol=1e-3, atol=1e-4):
    """Running statistics after one train forward: float32 moments of bf16
    values that differ by the 1-ulp flips: rtol 1e-3, atol 1e-4."""
    want = from_jax_variables({}, jax.device_get(mut["batch_stats"]))
    sd = block.state_dict()
    assert any("running_var" in k for k in want)
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            assert int(sd[k]) == 1, k
        else:
            np.testing.assert_allclose(_f32(sd[k]), _f32(w), rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("shape", [(16, 8, 8, 16), (4, 9, 9, 16)], ids=["even", "odd_9x9"])
def test_fused_block_train_forward_matches_jax(shape):
    """Train forward of a strided fused block (stride-2 3x3 as a library
    conv, downsample by slicing) vs the JAX block fused 'xla': output within
    rtol 0.02 / atol 0.02 (bf16 outputs after four convs whose inputs carry
    1-ulp flips; the JAX package holds fused to unfused within 0.1 / 0.08),
    running statistics rtol 1e-3 / atol 1e-4. Odd dims (9x9 -> 5x5): the BN
    count is the actual output's 4 * 25, not 4 * 81 // 4."""
    jblock, variables, block, _, x = _blocks(6, shape)
    want, mut = jblock.apply(variables, jnp.asarray(x, jnp.bfloat16), train=True,
                             mutable=["batch_stats"])
    block.train()
    with torch.no_grad():
        got = block(_port_in(x))
    oh = -(-shape[1] // 2)
    assert got.shape == (shape[0], 32, oh, oh) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got.permute(0, 2, 3, 1)), _f32(want), rtol=0.02, atol=0.02)
    _assert_running_stats(block, mut)


def test_fused_block_stride1_uses_the_fused_3x3():
    """A stride-1 block (conv3x3_bn_stats in the middle) against JAX 'xla',
    same tolerances; identity shortcut when cin == 4 * features."""
    for cin in (16, 32):
        jblock, variables, block, _, x = _blocks(7, (4, 6, 6, cin), stride=1)
        want, mut = jblock.apply(variables, jnp.asarray(x, jnp.bfloat16), train=True,
                                 mutable=["batch_stats"])
        assert (block.downsample_conv is None) == (cin == 32)
        block.train()
        with torch.no_grad():
            got = block(_port_in(x))
        np.testing.assert_allclose(_f32(got.permute(0, 2, 3, 1)), _f32(want),
                                   rtol=0.02, atol=0.02)
        _assert_running_stats(block, mut)


def test_fused_block_eval_forward_matches_jax():
    """Eval: library convs with the folded running-stat affine in bf16, no
    kernel, no statistic updated; rtol 0.02 / atol 0.02 against JAX 'xla'
    eval, and against the port's unfused block within the JAX package's own
    fused-to-unfused bound (rtol 0.1, atol 0.05)."""
    jblock, variables, block, unfused, x = _blocks(8, (16, 8, 8, 16))
    want = jblock.apply(variables, jnp.asarray(x, jnp.bfloat16), train=False)
    before = {k: v.clone() for k, v in block.state_dict().items()}
    with torch.no_grad():
        got = block.eval()(_port_in(x))
        ref = unfused.eval()(_port_in(x))
    np.testing.assert_allclose(_f32(got.permute(0, 2, 3, 1)), _f32(want), rtol=0.02, atol=0.02)
    np.testing.assert_allclose(_f32(got), _f32(ref), rtol=0.1, atol=0.05)
    assert all(torch.equal(v, before[k]) for k, v in block.state_dict().items())


def test_fused_block_gradients_match_jax():
    """d mean(y^2) / d params of the strided fused block, on the inputs of
    tests/test_fused_conv_bn.py's gradient test. Against the JAX block fused
    'xla': within 0.25 of each leaf's largest magnitude, the bound the JAX
    package holds its fused block to against its unfused one; it cannot be
    tighter, because the JAX fused block is itself up to 0.33 of a leaf's
    scale (bn2.bias) from a float64 run of the same block at these 16 x 4 x 4
    elements per channel, where the port's is 0.10. So the port is also held
    to the float64 run of its own unfused block, within 0.15."""
    jblock, variables, block, unfused, x = _blocks(4, (16, 8, 8, 16))

    def loss(params):
        y, _ = jblock.apply({"params": params, "batch_stats": variables["batch_stats"]},
                            jnp.asarray(x, jnp.bfloat16), train=True, mutable=["batch_stats"])
        return jnp.mean(y.astype(jnp.float32) ** 2)

    want = from_jax_variables(jax.device_get(jax.grad(loss)(variables["params"])), {})
    block.train()
    (block(_port_in(x)).float() ** 2).mean().backward()
    grads = {k: p.grad for k, p in block.named_parameters()}
    exact = BottleneckBlock(16, 8, 2, torch.float64, torch.float64)
    exact.load_state_dict(unfused.state_dict())
    (exact.train()(_port_in(x).double()) ** 2).mean().backward()
    assert set(grads) == set(want)
    for k, p in exact.named_parameters():
        assert grads[k].dtype == torch.float32
        for ref, tol in ((want[k], 0.25), (p.grad, 0.15)):
            err = float((grads[k] - ref).abs().max()) / max(float(ref.abs().max()), 1e-5)
            assert err < tol, f"{k}: {err:.3g} (limit {tol})"


def test_state_dict_is_the_same_with_and_without_fused():
    """The module tree does not depend on `fused`, so checkpoints and
    `from_jax_variables` cross between the two; BasicBlock trunks ignore the
    setting; a float32 fused trunk and an unknown value raise."""
    kw = dict(dtype=torch.bfloat16, param_dtype=torch.float32)
    plain = make_backbone("resnet50", "layer2", **kw)
    fused = make_backbone("resnet50", "layer2", fused="kernel", **kw)
    assert list(plain.state_dict()) == list(fused.state_dict())
    assert all(a.shape == b.shape and a.dtype == b.dtype for a, b in
               zip(plain.state_dict().values(), fused.state_dict().values()))
    fused.load_state_dict(plain.state_dict())
    assert fused.fused == "kernel" and fused.layer1_0.fused == "kernel"
    basic = make_backbone("resnet18", "layer2", fused="kernel", dtype=torch.float32)
    assert basic.fused is None and not hasattr(basic.layer1_0, "fused")
    with pytest.raises(ValueError, match="bfloat16"):
        make_backbone("resnet50", "layer2", fused="kernel", dtype=torch.float32)
    with pytest.raises(ValueError, match="fused"):
        make_backbone("resnet50", "layer2", fused="pallas", **kw)


# --- (d) the whole path: the fused geodesic_bd train step ----------------------


SMALL = dict(image_size=32, items_per_batch=2, dict_size=16, compute_dtype="bfloat16")


def test_fused_train_step_matches_jax_and_unfused():
    """The first main-phase step of geodesic_bd at 32 px, dictionary 16, 24
    images, bf16, from the same weights: the port fused 'plain' against the
    JAX step with fused_conv_bn='xla': loss, lc, lr and alpha within 5%, s (a
    log) within 0.05 absolute. Measured 0.6% (loss), 0.9% (lc), 2.9% (lr):
    bf16 through ResNet50 whose layer3/layer4 BNs see 96 and 24 elements per
    channel at 32 px, where the 1-ulp flips of each conv's output move the
    batch variances, and Lr goes through the argmax decode, where one
    flipped bin of 24 rows moves it by percents. And the port fused against the
    port unfused within the 10% that tests/test_fused_conv_bn.py allows
    (folded bf16 affine against float32 BN). Two more fused steps stay finite."""
    rng = np.random.default_rng(0)
    centers = (0.8 * rng.standard_normal((16, 3))).astype(np.float32)
    batch = {
        "xdata": rng.integers(0, 256, (24, 32, 32, 3), np.uint8),
        "euler": rng.uniform(-90, 90, (24, 3)).astype(np.float32),
        "label": (np.arange(24) % 12).astype(np.int32),
    }
    jtrainer = JaxTrainer(
        jax_get_config("geodesic_bd", fused_conv_bn="xla", **SMALL),
        dictionary=JaxKMeansDictionary(cluster_centers=centers),
        mesh=make_mesh(jax.devices()[:1]),
    )
    jstate = jtrainer.init_state(0)
    sd = from_jax_variables(jax.device_get(jstate.params), jax.device_get(jstate.batch_stats))
    _, want = jtrainer.train_step_fn("main")(jstate, jtrainer.shard_batch(dict(batch)))
    want = {k: float(v) for k, v in jax.device_get(want).items()}

    metrics = {}
    for mode in ("plain", None):
        trainer = Trainer(get_config("geodesic_bd", fused_conv_bn=mode, **SMALL),
                          dictionary=centers, device="cpu")
        assert trainer.model.feature_model.fused == mode
        trainer.model.load_state_dict(sd)
        step = trainer.train_step_fn("main")
        state, m = step(trainer.init_state(), trainer._to_device(batch))
        metrics[mode] = {k: float(v) for k, v in m.items()}
        if mode == "plain":
            for _ in range(2):
                state, m = step(state, trainer._to_device(batch))
            assert np.isfinite(float(m["loss"]))
    for k in ("loss", "lc", "lr", "s", "alpha"):
        rtol, atol = (0, 0.05) if k == "s" else (0.05, 0)
        np.testing.assert_allclose(metrics["plain"][k], want[k], rtol=rtol, atol=atol, err_msg=k)
    assert abs(metrics["plain"]["loss"] - metrics[None]["loss"]) < 0.10 * (
        abs(metrics[None]["loss"]) + 1e-3)
    assert (fcb.mm_launches, fcb.mm_bwd_launches, fcb.c3_launches, fcb.c3_bwd_launches) == (
        0, 0, 0, 0)


# --- (e) settings and defaults ---------------------------------------------------


def test_fused_setting_is_validated():
    """fused_conv_bn needs bfloat16 compute; unknown values raise; the
    default stays off, as the JAX 'auto' resolves."""
    assert get_config("geodesic_bd").fused_conv_bn is None
    for dtype in ("float32", "float64"):
        with pytest.raises(ValueError, match="bfloat16"):
            get_config("geodesic_bd", fused_conv_bn="kernel", compute_dtype=dtype)
    for value in ("pallas", "xla", "auto", True):
        with pytest.raises(ValueError, match="fused_conv_bn"):
            get_config("geodesic_bd", fused_conv_bn=value, compute_dtype="bfloat16")
    cfg = get_config("geodesic_bd", fused_conv_bn="kernel", compute_dtype="bfloat16")
    assert cfg.replace(fused_conv_bn="plain").fused_conv_bn == "plain"
    with pytest.raises(ValueError, match="bfloat16"):
        cfg.replace(compute_dtype="float32")


def test_ops_reject_what_they_do_not_take():
    x = torch.zeros((4, 16), dtype=torch.bfloat16)
    w = torch.zeros((8, 16))
    with pytest.raises(TypeError, match="bfloat16"):
        fcb.linear_stats(x.float(), w)
    with pytest.raises(ValueError, match="impl"):
        fcb.linear_stats(x, w, "pallas")
    with pytest.raises(ValueError, match="w must be"):
        fcb.linear_stats(x, torch.zeros((8, 12)))
    with pytest.raises(ValueError, match="both a and b"):
        fcb.linear_bn_stats(x, torch.ones(16), None, w)
    with pytest.raises(ValueError, match="a and b must be"):
        fcb.linear_bn_stats(x, torch.ones(8), torch.ones(8), w)
    with pytest.raises(ValueError, match="w must be"):
        fcb.conv3x3_bn_stats(torch.zeros((1, 4, 4, 16), dtype=torch.bfloat16),
                             torch.zeros((8, 16, 1, 1)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fcb._mm_stats(x, w.bfloat16(), None, False)  # the kernel wrapper itself


@pytest.mark.parametrize("fn", [build_model, build_problem, make_problem, Trainer.__init__],
                         ids=lambda f: f.__qualname__)
def test_entry_points_default_to_the_card(fn):
    """Whatever an entry point builds lies on the card unless the caller
    asks for the CPU, as the tests do."""
    assert inspect.signature(fn).parameters["device"].default == "cuda"


# the shapes a fused training step gives the backward kernels, the odd ones
# of tests/test_torch_port_cuda.py, and one wider than any halo
_MM_PLAN_SHAPES = [(m, k, n) for m, k, n, _, _ in time_fused.MM_SHAPES] + [
    (40, 64, 64), (20000, 64, 64), (300, 512, 2048), (500, 8, 64), (9413, 264, 1000)]
_C3_PLAN_SHAPES = [(*shape, shape[-1]) for shape, _ in time_fused.C3_SHAPES] + [
    (2, 5, 3, 16, 16), (3, 9, 13, 32, 32), (1, 14, 14, 64, 64), (1, 3, 150, 16, 16)]


def _check_splits(plan, m):
    """Whole 64-row ring steps; every row in exactly one split, none empty."""
    assert plan.rows % 64 == 0 and plan.rows >= 64
    assert (plan.splits - 1) * plan.rows < m <= plan.splits * plan.rows


@pytest.mark.parametrize("mkn", _MM_PLAN_SHAPES, ids=str)
def test_mm_bwd_plan(mkn):
    """Kernel #5's launch shape: dx tiles the C side takes (64 or 128 on
    each side), narrowed only while the card is not filled (264 blocks),
    never wider than K needs; dw splits cover M."""
    m, k, n = mkn
    plan = fcb._mm_bwd_plan(m, k, n)
    assert plan.bm in (64, 128) and plan.bn in (64, 128)
    assert plan.bn == 64 or k > 64
    blocks = -(-m // plan.bm) * -(-k // plan.bn)
    assert blocks >= fcb._FILL or (plan.bm, plan.bn) == (64, 64)
    _check_splits(plan, m)
    assert plan.tn in (64, 128) and plan.tk in (64, 128)
    assert (plan.tn == 128) == (n > 64) and (plan.tk == 128) == (k > 64)
    if plan.splits > 1:  # split only to fill the card, at most one split per 512 rows
        assert plan.splits <= -(-m // 512)
        assert plan.splits * -(-n // plan.tn) * -(-k // plan.tk) <= fcb._FILL


@pytest.mark.parametrize("shape", _C3_PLAN_SHAPES, ids=str)
def test_c3_bwd_plan(shape):
    """Kernel #7's launch shape: the gy_eff halo of a dx tile is one run of
    bm + 2 W + 2 pixels or three of bm + 2, whichever is shorter, so it fits
    shared memory at any W (csrc/fused_c3.cu checks the same pairs)."""
    b, h, w, c, cout = shape
    m = b * h * w
    plan = fcb._c3_bwd_plan(b, h, w, c, cout)
    assert plan.bm in (64, 128) and plan.bn == 64
    one, three = plan.bm + 2 * w + 2, plan.bm + 2
    assert (plan.nseg, plan.seg_rows) == ((1, one) if one <= 3 * three else (3, three))
    assert plan.nseg * plan.seg_rows <= 3 * (plan.bm + 2)
    _check_splits(plan, m)


def _ring_fits(slots, stage_bytes, other_bytes):
    """The kernel's fixed ring of `slots` slots keeps two blocks an SM."""
    assert slots * stage_bytes + other_bytes <= fcb._SMEM_HALF


def _check_blocks(plan, mtiles, ntiles, steps):
    """Every row tile in exactly one block's walk (g, g + mgroups, ..), as
    many blocks per column tile as fill the card or one per row tile; the
    reduction's steps split only where the tiles are fewer than the SMs,
    into splits of at least 2 steps that cover every step exactly once; at
    least one block an SM unless the reduction is too short to split."""
    walks = [t for g in range(plan.mgroups) for t in range(g, mtiles, plan.mgroups)]
    assert sorted(walks) == list(range(mtiles))
    tiles = mtiles * ntiles
    if plan.ksplit == 1:
        assert plan.mgroups == min(mtiles, max(1, fcb._FILL // ntiles))
        assert 2 * tiles > fcb._FILL or steps < 4
    else:
        assert plan.mgroups == mtiles and 2 * tiles <= fcb._FILL
        assert plan.ksplit == min(steps // 2, fcb._FILL // tiles)
        per = -(-steps // plan.ksplit)  # the kernels' steps a split
        covered = [q for sp in range(plan.ksplit)
                   for q in range(sp * per, min(steps, sp * per + per))]
        assert covered == list(range(steps)) and (plan.ksplit - 1) * per < steps
        assert per >= 2
    blocks = plan.ksplit * plan.mgroups * ntiles
    assert blocks >= fcb._FILL // 2 or plan.ksplit == max(1, steps // 2)


@pytest.mark.parametrize("mkn", _MM_PLAN_SHAPES, ids=str)
def test_mm_fwd_plan(mkn):
    """Kernel #4's launch shape: a y tile of the allowed set (at most 64
    accumulators a thread): 128 x 64 for N <= 64, 64 x 256 where K is one
    ring step and N >= 256, else 128 x 128; the 3 ring slots keep two
    blocks on an SM at that tile. The card is filled: by blocks that each walk several row
    tiles, or, where the tiles are fewer than the SMs, by splitting K (at
    least 2 steps a split) unless K is too short; every row tile and every
    64-deep step of K is covered exactly once."""
    m, k, n = mkn
    plan = fcb._mm_fwd_plan(m, k, n)
    if n <= 64:
        assert (plan.bm, plan.bn) == (128, 64)
    elif k <= 64 and n >= 256:
        assert (plan.bm, plan.bn) == (64, 256)
    else:
        assert (plan.bm, plan.bn) == (128, 128)
    mtiles, ntiles, ksteps = -(-m // plan.bm), -(-n // plan.bn), -(-k // 64)
    one = ksteps == 1  # one step: the ring holds x alone, w is loaded once
    _ring_fits(fcb._MM_FWD_SLOTS, (plan.bm + (0 if one else plan.bn)) * 72 * 2,
               (plan.bn * 72 * 2 if one else 0) + plan.bm // 32 * 2 * plan.bn * 4)
    _check_blocks(plan, mtiles, ntiles, ksteps)


@pytest.mark.parametrize("shape", _C3_PLAN_SHAPES + [(1, 3, 300, 16, 16)], ids=str)
def test_c3_fwd_plan(shape):
    """Kernel #6's launch shape: tiles of 256 pixels x 64 output channels,
    or of 128 where the halo of 256 would keep two blocks off an SM; the x
    halo a tile reads is one run of bm + 2 W + 2 pixels or three of bm + 2,
    whichever is shorter, and holds every neighbour of every pixel of the
    tile exactly once (each segment a run of consecutive pixels, the runs
    disjoint); the 2 ring slots keep two blocks on an SM; the card filled by
    blocks that walk several tiles or by a split of C."""
    b, h, w, c, cout = shape
    m = b * h * w
    plan = fcb._c3_fwd_plan(b, h, w, c, cout)
    assert plan.bm in (128, 256) and plan.bn == 64
    halo256 = min(256 + 2 * w + 2, 3 * 258)
    assert (plan.bm == 256) == (
        fcb._C3_FWD_SLOTS * (halo256 + 9 * 64) * 48 + 48 + 4096 <= fcb._SMEM_HALF)
    one, three = plan.bm + 2 * w + 2, plan.bm + 2
    assert (plan.nseg, plan.seg_rows) == ((1, one) if one <= 3 * three else (3, three))
    # the halo rows' pixels, relative to the tile's first pixel
    if plan.nseg == 1:
        rows = [j - w - 1 for j in range(plan.seg_rows)]
    else:
        rows = [(s - 1) * w - 1 + t for s in range(3) for t in range(plan.seg_rows)]
    assert len(set(rows)) == len(rows)  # no pixel held twice
    held = set(rows)
    for p in range(plan.bm):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                assert p + dy * w + dx in held
    _ring_fits(fcb._C3_FWD_SLOTS, (plan.nseg * plan.seg_rows + 9 * 64) * 24 * 2,
               48 + plan.bm // 32 * 2 * 64 * 4)
    _check_blocks(plan, -(-m // plan.bm), -(-cout // 64), -(-c // 16))


@pytest.mark.parametrize("prologue", [True, False], ids=["prologue", "no_prologue"])
@pytest.mark.parametrize("mkn", [(20000, 64, 64), (300, 512, 2048), (9413, 264, 1000)],
                         ids=str)
def test_bwd_scratch(mkn, prologue):
    """A backward call's scratch is one buffer: gy_eff (M, N) bf16, the dw
    partials of the splits, and with the prologue the da, db partials, their
    group sums and counters, each on a 256-byte boundary, none overlapping,
    all inside the buffer; absent parts have no address."""
    m, k, n = mkn
    plan = fcb._mm_bwd_plan(m, k, n)
    buf, ptrs = fcb._bwd_scratch(plan, m, k, n, n * k, torch.device("cpu"), prologue)
    mtiles = -(-m // plan.bm)
    groups = -(-mtiles // fcb._GROUP)
    sizes = [2 * m * n, 4 * plan.splits * n * k if plan.splits > 1 else 0]
    sizes += [8 * mtiles * k, 8 * groups * k, 4 * -(-k // plan.bn) * (groups + 1)] if prologue \
        else [0, 0, 0]
    assert len(ptrs) == 5 and buf.dtype == torch.uint8
    base, end = buf.data_ptr(), buf.data_ptr() + buf.numel()
    spans = []
    for ptr, size in zip(ptrs, sizes):
        assert (ptr is None) == (size == 0)
        if ptr is not None:
            assert (ptr - base) % 256 == 0 and base <= ptr and ptr + size <= end
            spans.append((ptr, ptr + size))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))

