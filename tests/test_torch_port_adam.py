"""The port's Adam on the CPU: which parameters the one-pass kernel takes
(ops/adam.fusable, same_layout), that a list off the CPU goes to the kernel
whole or raises, that the kernel's writes move autograd's version counters,
and that the CPU, float64 above all, keeps the foreach passes with the state
they always had. Meta tensors stand in for the card's, with the kernel's op
faked.

The kernel itself runs on the card only (tests/test_torch_port_cuda.py,
bit-equal to the foreach passes over 5 steps).
"""

import numpy as np
import pytest
import torch

from multi_modal_regression_tpu_torch.ops import adam as adam_ops
from multi_modal_regression_tpu_torch.train.presets import Adam

KW = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)


def _grads(rng, shapes, dtype):
    """Seeded gradients of magnitudes 1e-6 to 10, a few exact zeros."""
    out = []
    for s in shapes:
        g = rng.standard_normal(s) * 10.0 ** rng.integers(-6, 2, s)
        g[rng.random(s) < 0.05] = 0.0
        out.append(torch.from_numpy(g).to(dtype))
    return out


def _steps(params, mu_dtype, n=5, seed=3):
    """n Adam steps over params with seeded gradients; the optimizer."""
    opt = Adam(params, lr=KW["lr"], mu_dtype=mu_dtype)
    rng = np.random.default_rng(seed)
    for _ in range(n):
        for p, g in zip(params, _grads(rng, [tuple(q.shape) for q in params], params[0].dtype)):
            p.grad = torch.empty_like(p).copy_(g)
        opt.step()
    return opt


def _leaves(dtype, seed=0, channels_last=False):
    rng = np.random.default_rng(seed)
    shapes = [(6, 3, 5, 5), (6,), (4097,), (1,)]
    out = [torch.nn.Parameter(torch.from_numpy(rng.standard_normal(s)).to(dtype))
           for s in shapes]
    if channels_last:
        out[0] = torch.nn.Parameter(out[0].detach().contiguous(memory_format=torch.channels_last))
    return out


@pytest.mark.parametrize("mu_dtype", [None, torch.bfloat16], ids=["mu_f32", "mu_bf16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_and_float64_take_the_foreach_passes(dtype, mu_dtype):
    """On the CPU, in float32 and float64, every parameter takes the foreach
    passes: fused_share 0.0, no kernel launch, and p, mu, nu equal to
    adam_update_plain called step by step on copies."""
    params = _leaves(dtype)
    ref = [p.detach().clone() for p in params]
    mus = [torch.zeros_like(p, dtype=mu_dtype or p.dtype) for p in ref]
    nus = [torch.zeros_like(p) for p in ref]
    n0 = adam_ops.launches
    opt = _steps(params, mu_dtype)
    assert adam_ops.launches == n0 and opt.fused_share == 0.0
    rng = np.random.default_rng(3)
    for t in range(1, 6):
        grads = _grads(rng, [tuple(p.shape) for p in ref], dtype)
        bc1 = float(np.float32(1) - np.float32(0.9) ** np.float32(t))
        bc2 = float(np.float32(1) - np.float32(0.999) ** np.float32(t))
        adam_ops.adam_update_plain(ref, grads, mus, nus, **KW, bc1=bc1, bc2=bc2,
                                   mu_dtype=mu_dtype)
    for p, r, m, v in zip(params, ref, mus, nus):
        st = opt.state[p]
        assert torch.equal(p.detach(), r) and torch.equal(st["mu"], m) and torch.equal(st["nu"], v)


@pytest.mark.parametrize("mu_dtype", [None, torch.bfloat16], ids=["mu_f32", "mu_bf16"])
def test_state_keys_dtypes_and_layouts_are_unchanged(mu_dtype):
    """After 5 steps each parameter's state holds count, mu and nu, no more:
    mu in mu_dtype (or the parameter's), nu in the parameter's, both laid out
    as the parameter (a channels-last conv weight keeps its strides)."""
    params = _leaves(torch.float32, channels_last=True)
    opt = _steps(params, mu_dtype)
    assert params[0].stride() == (75, 1, 15, 3)
    for p in params:
        st = opt.state[p]
        assert sorted(st) == ["count", "mu", "nu"] and st["count"] == 5
        assert st["mu"].dtype == (mu_dtype or torch.float32) and st["nu"].dtype == torch.float32
        assert st["mu"].stride() == st["nu"].stride() == p.stride()


def _t(shape=(4, 6, 3, 3), dtype=torch.float32, channels_last=False):
    t = torch.zeros(shape, dtype=dtype)
    return t.contiguous(memory_format=torch.channels_last) if channels_last else t


@pytest.mark.parametrize("case,want", [
    ("contiguous", True), ("channels_last", True), ("bf16_mu", True),
    ("size_one_dims", True), ("size_one_grad_stride", True), ("permuted", True),
    ("gaps", False), ("expanded", False), ("f64", False), ("f16_mu", False),
    ("bf16_grad", False), ("grad_layout", False), ("mu_layout", False), ("shape", False),
])
def test_same_layout_takes_dense_float32_quadruples_of_one_layout(case, want):
    """same_layout: float32 p, g, nu and a float32 or bf16 mu of one shape and
    strides (a size-1 dim's stride aside), dense in any order of dims
    (contiguous, channels-last, permuted); a view with gaps, a stride of 0,
    another dtype or another layout of any one of the four is refused. On
    the CPU fusable is False whatever the layout."""
    p = g = mu = nu = _t()
    if case == "channels_last":
        p = g = mu = nu = _t(channels_last=True)
    elif case == "bf16_mu":
        mu = _t(dtype=torch.bfloat16)
    elif case == "permuted":  # dense, in neither contiguous nor channels-last order
        p = g = mu = nu = _t().permute(2, 0, 3, 1)
    elif case == "size_one_dims":
        p = g = mu = nu = torch.zeros(5, 1, 7).as_strided((5, 1, 7), (7, 99, 1))
    elif case == "size_one_grad_stride":  # a 1x1 conv's gradient, as autograd gives it
        p = mu = nu = torch.zeros(8, 4, 1, 1)
        g = torch.zeros(8, 4, 1, 1).as_strided((8, 4, 1, 1), (4, 1, 4, 4))
    elif case == "gaps":
        p = g = mu = nu = torch.zeros(4, 12)[:, ::2]
    elif case == "expanded":
        p = g = mu = nu = torch.zeros(4, 1).expand(4, 6)
    elif case == "f64":
        p = g = mu = nu = _t(dtype=torch.float64)
    elif case == "f16_mu":
        mu = _t(dtype=torch.float16)
    elif case == "bf16_grad":
        g = _t(dtype=torch.bfloat16)
    elif case == "grad_layout":
        g = _t(channels_last=True)
    elif case == "mu_layout":
        p = g = nu = _t(channels_last=True)
    elif case == "shape":
        nu = _t((4, 6, 9))
    assert adam_ops.same_layout(p, g, mu, nu) is want
    assert adam_ops.fusable(p, g, mu, nu) is False


def test_adam_update_refuses_lists_of_unequal_length():
    """adam_update given fewer gradients than parameters raises ValueError
    before it updates or launches anything."""
    p = torch.zeros(8)
    n0 = adam_ops.launches
    with pytest.raises(ValueError, match="as many"):
        adam_ops.adam_update([p], [], [p.clone()], [p.clone()], **KW, bc1=0.1, bc2=0.001,
                             mu_dtype=None)
    assert adam_ops.launches == n0 and torch.equal(p, torch.zeros(8))


def _meta_leaves(dtype=torch.float32):
    """_leaves' shapes as meta tensors: off the CPU, as the card's are."""
    return [torch.nn.Parameter(torch.empty(p.shape, dtype=dtype, device="meta"))
            for p in _leaves(torch.float32)]


def _fake_kernel(calls):
    """A stand-in for the op mmr::adam_ that records the elements of each
    tensor it is given and writes nothing."""
    def kernel(ps, gs, ms, vs, lr, b1, b2, eps, bc1, bc2):
        calls.append([p.numel() for p in ps])
    return kernel


@pytest.mark.parametrize("mu_dtype", [None, torch.bfloat16], ids=["mu_f32", "mu_bf16"])
def test_a_card_group_takes_the_kernel_whole(monkeypatch, mu_dtype):
    """Off the CPU, with fusable made to admit every tensor, Adam hands every
    parameter with a gradient to the kernel's op (mmr::adam_) in one call a
    step inside the span mmr.optim.adam_fused, fused_share reads 1.0, and a
    parameter without a gradient is in no call, has no state and keeps its
    version counter."""
    params = _meta_leaves()
    idle = torch.nn.Parameter(torch.empty(7, device="meta"))
    calls = []
    monkeypatch.setattr(adam_ops, "fusable", lambda p, g, mu, nu: True)
    monkeypatch.setattr(torch.ops.mmr, "adam_", _fake_kernel(calls))
    opt = Adam(params + [idle], lr=KW["lr"], mu_dtype=mu_dtype)
    v_idle = idle._version
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            for p in params:
                p.grad = torch.empty_like(p)
            opt.step()
    assert calls == [[450, 6, 4097, 1]] * 5 and opt.fused_share == 1.0
    assert [e.name for e in prof.events()].count("mmr.optim.adam_fused") == 5
    assert idle not in opt.state and idle._version == v_idle
    for p in params:
        assert opt.state[p]["count"] == 5 and opt.state[p]["mu"].dtype == (mu_dtype or p.dtype)


@pytest.mark.parametrize("case", ["float64_parameter", "mu_dtype"])
def test_a_card_group_with_a_parameter_the_kernel_cannot_take_raises(monkeypatch, case):
    """Off the CPU, adam_update raises ValueError naming the first parameter
    the kernel cannot take (a float64 one, with fusable made to admit
    float32 alone; or a mu in another dtype than mu_dtype), before the op
    runs or any version counter moves: no second path on the card."""
    params = _meta_leaves()
    if case == "float64_parameter":
        params[2] = torch.nn.Parameter(torch.empty(4097, dtype=torch.float64, device="meta"))
    mus = [torch.empty_like(p, dtype=torch.bfloat16 if case == "mu_dtype" and i == 1 else None)
           for i, p in enumerate(params)]
    nus = [torch.empty_like(p) for p in params]
    grads = [torch.empty_like(p) for p in params]
    calls = []
    monkeypatch.setattr(adam_ops, "fusable", lambda p, g, mu, nu: p.dtype == torch.float32)
    monkeypatch.setattr(torch.ops.mmr, "adam_", _fake_kernel(calls))
    versions = [t._version for t in params + mus + nus]
    want = "parameter 2 .*float64" if case == "float64_parameter" else "parameter 1 .*bfloat16"
    with pytest.raises(ValueError, match=want):
        adam_ops.adam_update(params, grads, mus, nus, **KW, bc1=0.1, bc2=0.001, mu_dtype=None)
    assert calls == [] and [t._version for t in params + mus + nus] == versions


@pytest.mark.parametrize("where", ["cpu", "card"])
def test_a_step_moves_the_version_of_a_saved_parameter(monkeypatch, where):
    """A parameter saved for backward and then changed by Adam's step makes
    that backward raise autograd's in-place error, on the CPU (the foreach
    passes) and off it (the kernel's op, faked here by one that writes
    nothing, so that only adam_update's own version bump can move the
    counters of p, mu and nu)."""
    if where == "card":
        params = _meta_leaves()
        monkeypatch.setattr(adam_ops, "fusable", lambda p, g, mu, nu: True)
        monkeypatch.setattr(torch.ops.mmr, "adam_", _fake_kernel([]))
    else:
        params = _leaves(torch.float32)
    opt = Adam(params, lr=KW["lr"], mu_dtype=torch.bfloat16)
    for p in params:
        p.grad = torch.ones_like(p)
    opt.step()
    saved = (params[0] * params[0]).sum()
    before = [(p._version, opt.state[p]["mu"]._version, opt.state[p]["nu"]._version)
              for p in params]
    opt.step()
    after = [(p._version, opt.state[p]["mu"]._version, opt.state[p]["nu"]._version)
             for p in params]
    assert all(a > b for pa, pb in zip(after, before) for a, b in zip(pa, pb))
    with pytest.raises(RuntimeError, match="modified by an inplace operation"):
        saved.backward()


def test_a_train_steps_parameters_all_have_the_kernels_layout():
    """After a main step of a small geodesic_bd Trainer on the CPU every
    trained parameter, its gradient and its moments are in same_layout (a
    1x1 downsample conv's gradient has other strides in its size-1 dims):
    on the card all of them take the kernel."""
    from multi_modal_regression_tpu_torch.train.presets import get_config
    from multi_modal_regression_tpu_torch.train.trainer import Trainer

    cfg = get_config("geodesic_bd", N1=16, N2=8, image_size=32, items_per_batch=2,
                     feature_network="resnet18", feature_layer="layer2", N0=128,
                     num_classes=3, dict_size=8, compute_dtype="bfloat16")
    rng = np.random.default_rng(4)
    t = Trainer(cfg, dictionary=rng.standard_normal((8, 3)).astype(np.float32), device="cpu")
    batch = t._to_device({"xdata": rng.integers(0, 256, (6, 32, 32, 3), np.uint8),
                          "euler": rng.uniform(-60, 60, (6, 3)).astype(np.float32),
                          "label": (np.arange(6) % 3).astype(np.int32),
                          "is_real": np.arange(6) < 3})
    t.train_step_fn("main", dual_stream=True)(t.init_state(), batch)
    opt = t.optimizer
    params = [p for group in opt.param_groups for p in group["params"]]
    assert any(p.shape[2:] == (1, 1) and p.grad.stride() != p.stride() for p in params)
    for p in params:
        st = opt.state[p]
        assert adam_ops.same_layout(p, p.grad, st["mu"], st["nu"]), tuple(p.shape)


def test_the_kernel_op_declares_its_writes_and_runs_only_on_the_card():
    """mmr::adam_ writes params, mus and nus (and reads grads), and has a
    CUDA kernel only: CPU tensors never reach it through adam_update, and
    raise if given to it directly."""
    schema = torch.ops.mmr.adam_.default._schema
    writes = [a.name for a in schema.arguments if a.alias_info is not None
              and a.alias_info.is_write]
    assert writes == ["params", "mus", "nus"]
    t = [torch.zeros(4)]
    with pytest.raises(NotImplementedError):
        torch.ops.mmr.adam_(t, t, t, t, 1e-3, 0.9, 0.999, 1e-8, 0.1, 0.001)
