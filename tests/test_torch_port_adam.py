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
    def kernel(ps, gs, ms, vs, step, b1, b2, eps):
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
        torch.ops.mmr.adam_(t, t, t, t, torch.zeros(3), 0.9, 0.999, 1e-8)


@pytest.mark.parametrize("lr,bc1,bc2", [(1e-3, 0.1, 0.001), (3e-4 / 7, 0.271, 0.002997),
                                        (1e-4, 1 - 0.9**50, 1 - 0.999**50)])
def test_the_step_scalars_round_as_the_launch_arguments_did(lr, bc1, bc2):
    """kernel_step gives -lr, 1 / bc1 and 1 / bc2 in float32, each the double
    rounded once: the bits the launch once took as ctypes float arguments,
    which the foreach passes' scalar products use on the card."""
    import ctypes

    want = [ctypes.c_float(-lr).value, ctypes.c_float(1.0 / bc1).value,
            ctypes.c_float(1.0 / bc2).value]
    got = adam_ops.kernel_step(lr, bc1, bc2)
    assert got.dtype == torch.float32 and torch.equal(got, torch.tensor(want, dtype=torch.float32))


def test_an_optimizer_with_no_moments_is_not_ready_to_capture():
    """ready_to_capture asks for the moments of every parameter with a
    gradient; holds_update is False with nothing captured (the CPU never
    captures)."""
    params = _leaves(torch.float32)
    opt = Adam(params, lr=KW["lr"])
    assert not opt.ready_to_capture() and not opt.holds_update()
    for p in params:
        p.grad = torch.ones_like(p)
    assert not opt.ready_to_capture()
    opt.step()
    assert opt.ready_to_capture() and not opt.holds_update()
    with pytest.raises(ValueError, match="moments"):
        Adam(_leaves(torch.float32), lr=KW["lr"]).capture_update()


# --- on the card (marked cuda: skipped where torch.cuda.is_available() is False)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _card_groups(dev, mu_dtype, seed=5):
    """Two groups of card tensors (a channels-last conv weight, BN-sized
    vectors, 4097 and 2**20 + 5 elements), their zero moments and seeded
    gradients, as (params, grads, mus, nus) lists."""
    rng = np.random.default_rng(seed)

    def t(*shape, channels_last=False):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
        return x.contiguous(memory_format=torch.channels_last) if channels_last else x

    shapes = [[(64, 3, 7, 7), (64,), (4097,)], [(2**20 + 5,), (3,)]]
    out = []
    for group in shapes:
        ps = [t(*s, channels_last=len(s) == 4) for s in group]
        out.append((ps, [torch.zeros_like(p) for p in ps],
                    [torch.zeros_like(p, dtype=mu_dtype or p.dtype) for p in ps],
                    [torch.zeros_like(p) for p in ps]))
    return out


def _fill_grads(grads, rng):
    for g in grads:
        x = rng.standard_normal(g.shape) * 10.0 ** rng.integers(-6, 2, g.shape)
        x[rng.random(g.shape) < 0.05] = 0.0
        g.copy_(torch.from_numpy(x.astype(np.float32)))


@pytest.mark.cuda
@pytest.mark.parametrize("mu_dtype", [torch.bfloat16, None], ids=["mu_bf16", "mu_f32"])
def test_a_captured_update_replays_what_the_eager_kernel_and_the_foreach_passes_give(
        dev, mu_dtype):
    """The kernel's launches over two groups captured once (CapturedUpdate),
    then replayed for 6 steps with a new rate each step and the counts 1..6,
    the gradients rewritten in place between replays: p, mu and nu bit-equal
    after every step to the kernel launched eagerly (its scalars written
    to the card before each launch) and to the foreach passes, from copies
    of the same state. A replay counts its 2 launches; the capture none."""
    graphed = _card_groups(dev, mu_dtype)
    eager = [[[x.clone() for x in lst] for lst in g] for g in graphed]
    plain = [[[x.clone() for x in lst] for lst in g] for g in graphed]
    n0 = adam_ops.launches
    cap = adam_ops.CapturedUpdate([(*g, 0.9, 0.999, 1e-8, mu_dtype) for g in graphed])
    assert adam_ops.launches == n0 and cap.launches == 2
    rng = np.random.default_rng(9)
    for count in range(1, 7):
        lrs = [1e-3 / count, 3e-3 * count]
        for g in graphed:
            _fill_grads(g[1], rng)
        for side in (eager, plain):
            for g, gg in zip(side, graphed):
                for a, b in zip(g[1], gg[1]):
                    a.copy_(b)
        bc1 = float(np.float32(1) - np.float32(0.9) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(0.999) ** np.float32(count))
        n1 = adam_ops.launches
        cap.replay(torch.stack([adam_ops.kernel_step(lr, bc1, bc2) for lr in lrs]))
        assert adam_ops.launches == n1 + 2
        for lr, g, f in zip(lrs, eager, plain):
            kw = dict(lr=lr, b1=0.9, b2=0.999, eps=1e-8, bc1=bc1, bc2=bc2, mu_dtype=mu_dtype)
            adam_ops.adam_update(*g, **kw)
            adam_ops.adam_update_plain(*f, **kw)
        torch.cuda.synchronize()
        for g, e, f in zip(graphed, eager, plain):
            for i in (0, 2, 3):
                for a, b, c in zip(g[i], e[i], f[i]):
                    assert torch.equal(a, b) and torch.equal(a, c), (count, i, tuple(a.shape))


@pytest.mark.cuda
def test_adam_replays_its_capture_while_it_holds_the_same_tensors(dev):
    """Adam.capture_update after one eager step, then step() replays it (the
    kernel's launches counted, the counts and fused_share kept as eager
    steps keep them) with the rate that param_groups gives each step,
    bit-equal to an Adam that never captured; a state whose moments were
    replaced (a restored checkpoint) no longer holds the capture, and
    step() launches the kernel eagerly over the new moments."""
    groups = _card_groups(dev, torch.bfloat16)
    params = [[torch.nn.Parameter(p) for p in g[0]] for g in groups]
    twins = [[torch.nn.Parameter(p.detach().clone()) for p in g] for g in params]
    opts = [Adam([{"params": ps} for ps in side], lr=1e-3, mu_dtype=torch.bfloat16)
            for side in (params, twins)]
    rng = np.random.default_rng(3)

    def grads():
        gs = [torch.empty_like(p) for ps in params for p in ps]
        _fill_grads(gs, rng)
        for side in (params, twins):
            for p, g in zip([p for ps in side for p in ps], gs):
                if p.grad is None:
                    p.grad = torch.empty_like(p)
                p.grad.copy_(g)

    grads()
    for opt in opts:
        opt.step()
    opts[0].capture_update()
    assert opts[0].holds_update()
    for count in range(2, 6):
        for opt in opts:
            opt.param_groups[1]["lr"] = 1e-3 * count
        grads()
        n0 = adam_ops.launches
        opts[0].step()
        assert adam_ops.launches == n0 + 2 and opts[0].fused_share == 1.0
        opts[1].step()
        torch.cuda.synchronize()
        for p, q in zip([p for ps in params for p in ps], [p for ps in twins for p in ps]):
            s, t = opts[0].state[p], opts[1].state[q]
            assert s["count"] == t["count"] == count
            assert torch.equal(p, q) and torch.equal(s["mu"], t["mu"]) and torch.equal(
                s["nu"], t["nu"])
    p0 = params[0][0]
    opts[0].state[p0]["mu"] = opts[0].state[p0]["mu"].clone()
    assert not opts[0].holds_update()
    grads()
    for opt in opts:
        opt.step()
    torch.cuda.synchronize()
    assert torch.equal(p0, twins[0][0]) and torch.equal(opts[0].state[p0]["mu"],
                                                         opts[1].state[twins[0][0]]["mu"])
