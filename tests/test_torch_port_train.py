"""The PyTorch port's geodesic_bd training path vs the JAX package, on CPU.

One small JAX Trainer (ResNet50 to layer2, N0 512, N1 16, N2 8, K 8, 3
classes, 32 px, 2 items per class per stream, float32, Adam with a float32
first moment, stem_pool 'xla') is built per module, with randomized BN
running statistics. Its weights cross to the port through
`from_jax_variables`; the port runs stem_pool 'kernel', which on CPU
tensors takes the stem kernels' plain versions. The same numpy-seeded
batches go through both sides. Each test states its tolerance.

The train-mode tests hold the port against the JAX path run in float64
(compute_dtype 'float64' under jax_enable_x64, the JAX package's x64 parity
harness). In float32, gradients at these 6-image stream batches are
ill-conditioned: the BN backward (dy - mean(dy) - xhat * mean(dy * xhat))
cancels, and float32 gradients of either side are off from float64 by
percents of some leaves' largest magnitude (up to 12% for JAX, whose fast
variance E[x^2] - E[x]^2 cancels too; up to 3% for the port). So the
gradient probe runs both sides in float64, where they agree to 4e-6 of each
leaf's scale; the forward and the Adam fit hold the port's float32 path
against float64 JAX. The float64 JAX steps use the flax stem
(stem_pool None): the JAX 'xla' stem cannot be differentiated in float64
(its reduce_window takes an array init value for non-f32 dtypes), and the
JAX package holds the two stems equal (tests/test_stem_pool.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multi_modal_regression_tpu.data.targets import (
    hard_bin_targets as jax_hard_bin_targets,
)
from multi_modal_regression_tpu.dictionary.common import (
    pairwise_sqeuclidean as jax_pairwise_sqeuclidean,
)
from multi_modal_regression_tpu.losses import primitives as jax_primitives
from multi_modal_regression_tpu.losses.self_balance import (
    self_balanced as jax_self_balanced,
)
from multi_modal_regression_tpu.ops import stem_pool as jax_stem
from multi_modal_regression_tpu.parallel.mesh import make_mesh
from multi_modal_regression_tpu.train import Trainer as JaxTrainer
from multi_modal_regression_tpu.train import get_config as jax_get_config
from multi_modal_regression_tpu.train.presets import build_model as jax_build_model
from multi_modal_regression_tpu.train.problems import make_problem as jax_make_problem
from multi_modal_regression_tpu.train.state import create_train_state
from multi_modal_regression_tpu.train.steps import make_train_step as jax_make_train_step
from multi_modal_regression_tpu.train.trainer import _interleave as jax_interleave
from multi_modal_regression_tpu_torch.data.targets import hard_bin_targets
from multi_modal_regression_tpu_torch.dictionary.common import pairwise_sqeuclidean
from multi_modal_regression_tpu_torch.losses import primitives
from multi_modal_regression_tpu_torch.losses.self_balance import self_balanced
from multi_modal_regression_tpu_torch.models.pretrained import from_jax_variables
from multi_modal_regression_tpu_torch.ops import stem_pool
from multi_modal_regression_tpu_torch.train.presets import (
    build_optimizer,
    get_config,
)
from multi_modal_regression_tpu_torch.train.problems import make_problem
from multi_modal_regression_tpu_torch.train.state import TrainState
from multi_modal_regression_tpu_torch.train.steps import (
    make_train_step,
    validate_dual_stream_layout,
)
from multi_modal_regression_tpu_torch.train.trainer import Trainer, _interleave

from test_torch_port_ops import randomize_batch_stats

SMALL = dict(
    feature_network="resnet50", feature_layer="layer2", N0=512, N1=16, N2=8,
    dict_size=8, num_classes=3, image_size=32, items_per_batch=2,
    compute_dtype="float32", optimizer_dtype="float32",
    max_iterations=2, num_warmup_epochs=1, num_epochs=1,
)
N_STREAM = 6  # 2 items x 3 classes per loader per step
PROBE_LR = 1.0


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _centers() -> np.ndarray:
    return (0.7 * np.random.default_rng(0).standard_normal((8, 3))).astype(np.float32)


def _loader(seed: int, n_batches: int = 2) -> list[dict]:
    """BalancedLoader-style batches: uint8 images, Euler degrees, int32 labels."""
    rng = np.random.default_rng(seed)
    return [
        {
            "xdata": rng.integers(0, 256, (N_STREAM, 32, 32, 3), np.uint8),
            "euler": np.stack([
                rng.uniform(-180, 180, N_STREAM), rng.uniform(-60, 60, N_STREAM),
                rng.uniform(-30, 30, N_STREAM),
            ], axis=1).astype(np.float32),
            "label": (np.arange(N_STREAM) % 3).astype(np.int32),
        }
        for _ in range(n_batches)
    ]


def _jax_trainer(**overrides) -> JaxTrainer:
    cfg = jax_get_config(
        "geodesic_bd", **{**SMALL, "stem_pool": "xla", "fused_conv_bn": None, **overrides}
    )
    return JaxTrainer(cfg, dictionary=_centers(), mesh=make_mesh(jax.devices("cpu")[:1]))


@pytest.fixture
def x64():
    """jax_enable_x64 for the length of one test."""
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


@pytest.fixture(scope="module")
def jax_side():
    """(JAX trainer, its initial state with random BN statistics on host)."""
    trainer = _jax_trainer()
    state = trainer.init_state()
    stats = randomize_batch_stats(state.batch_stats, np.random.default_rng(1))
    return trainer, jax.device_get(state.replace(batch_stats=stats))


def _port_sd(params, batch_stats) -> dict:
    return from_jax_variables(jax.device_get(params), jax.device_get(batch_stats))


def _port_trainer(jax_state, **overrides) -> Trainer:
    cfg = get_config("geodesic_bd", **{**SMALL, "stem_pool": "kernel", **overrides})
    trainer = Trainer(cfg, dictionary=_centers(), device="cpu")
    trainer.model.load_state_dict(_port_sd(jax_state.params, jax_state.batch_stats))
    return trainer


def _assert_state_dict_close(sd, want, rtol, atol, skip=()):
    """Every leaf of the port's state_dict against the JAX one, mapped."""
    for k, w in want.items():
        if k.endswith("num_batches_tracked") or k in skip:
            continue
        np.testing.assert_allclose(_f32(sd[k]), _f32(w), rtol=rtol, atol=atol, err_msg=k)


# --- (a) losses, self-balance, targets, the geodesic problem -----------------


def _poses(rng, n):
    v = rng.standard_normal((n, 3))
    v = v / np.linalg.norm(v, axis=1, keepdims=True) * rng.uniform(0, np.pi, (n, 1))
    v[0] = 0.0  # identity pose
    return v.astype(np.float32)


def test_primitive_losses_match_jax():
    """cross_entropy and mse: f32 rtol 1e-6, atol 1e-7. geodesic_aa
    (including an identity pose and reduce=False): rtol 1e-6, atol 2e-6,
    since acos amplifies the two libraries' 1-ulp cos/sin differences by
    2/sin(theta/2)."""
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((16, 8)).astype(np.float32) * 3
    labels = rng.integers(0, 8, 16)
    a, b = _poses(rng, 16), _poses(rng, 16)
    cases = [
        (primitives.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels)),
         jax_primitives.cross_entropy(jnp.asarray(logits), jnp.asarray(labels, jnp.int32))),
        (primitives.mse(torch.from_numpy(a), torch.from_numpy(b)),
         jax_primitives.mse(jnp.asarray(a), jnp.asarray(b))),
        (primitives.geodesic_aa(torch.from_numpy(a), torch.from_numpy(b)),
         jax_primitives.geodesic_aa(jnp.asarray(a), jnp.asarray(b))),
        (primitives.geodesic_aa(torch.from_numpy(a), torch.from_numpy(b), reduce=False),
         jax_primitives.geodesic_aa(jnp.asarray(a), jnp.asarray(b), reduce=False)),
        (primitives.geodesic_aa(torch.from_numpy(a), torch.from_numpy(a)),
         jax_primitives.geodesic_aa(jnp.asarray(a), jnp.asarray(a))),
    ]
    for i, (got, want) in enumerate(cases):
        atol = 1e-7 if i < 2 else 2e-6
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-6, atol=atol)


@pytest.mark.parametrize("mode", ["warmup", "main", "sigma"])
def test_self_balanced_matches_jax(mode):
    """loss, s_next and d loss / d(lc, lr), with s detached; f32 rtol 1e-6."""
    lc, lr, s = np.float32(1.7), np.float32(0.31), np.float32(-0.4)
    lct, lrt = torch.tensor(lc, requires_grad=True), torch.tensor(lr, requires_grad=True)
    st = torch.tensor(s, requires_grad=True)
    loss, s_next = self_balanced(lct, lrt, st, mode)
    loss.backward()
    assert st.grad is None and not s_next.requires_grad
    assert s_next.dtype == torch.float32 and s_next.ndim == 0

    def f(lc, lr):
        return jax_self_balanced(lc, lr, jnp.float32(s), mode)

    (want_loss, want_s), grads = jax.value_and_grad(f, (0, 1), has_aux=True)(lc, lr)
    for got, want in ((loss, want_loss), (s_next, want_s), (lct.grad, grads[0]),
                      (lrt.grad, grads[1])):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="mode"):
        self_balanced(lct, lrt, st, "other")


def test_distances_and_hard_bins_match_jax():
    """pairwise_sqeuclidean rtol 1e-6 / atol 1e-6; hard_bin_targets picks the
    same bins, residuals rtol 1e-6 / atol 1e-7; mixed f64 poses against an
    f32 dictionary are promoted before squaring on both sides."""
    rng = np.random.default_rng(3)
    y = _poses(rng, 256)
    C = (0.7 * rng.standard_normal((200, 3))).astype(np.float32)
    np.testing.assert_allclose(
        _f32(pairwise_sqeuclidean(torch.from_numpy(y), torch.from_numpy(C))),
        _f32(jax_pairwise_sqeuclidean(jnp.asarray(y), jnp.asarray(C))),
        rtol=1e-6, atol=1e-6,
    )
    bins, res = hard_bin_targets(torch.from_numpy(y), torch.from_numpy(C))
    jbins, jres = jax_hard_bin_targets(jnp.asarray(y), jnp.asarray(C))
    assert bins.dtype == torch.int64
    np.testing.assert_array_equal(bins.numpy(), np.asarray(jbins))
    np.testing.assert_allclose(_f32(res), _f32(jres), rtol=1e-6, atol=1e-7)
    d64 = pairwise_sqeuclidean(torch.from_numpy(y.astype(np.float64)), torch.from_numpy(C))
    assert d64.dtype == torch.float64
    x = y.astype(np.float64)
    exact = ((x[:, None, :] - C.astype(np.float64)[None]) ** 2).sum(-1)
    np.testing.assert_allclose(d64.numpy(), exact, rtol=0, atol=1e-12)


@pytest.mark.parametrize("phase", ["warmup", "main"])
def test_geodesic_problem_matches_jax(phase):
    """Targets, the phase's (lc, lr) and their gradients w.r.t. (scores,
    residual): no gradient through the decode's argmax. f32 rtol 1e-6,
    atol 1e-7 (gradients atol 1e-6)."""
    rng = np.random.default_rng(4)
    C = _centers()
    y = _poses(rng, 12)
    scores = rng.standard_normal((12, 8)).astype(np.float32)
    residual = (0.2 * rng.standard_normal((12, 3))).astype(np.float32)
    port, ref = make_problem("geodesic", C, "cpu"), jax_make_problem("geodesic", C)
    assert (port.warmup_balance, port.main_balance) == (ref.warmup_balance, ref.main_balance)
    tg, jtg = port.targets(torch.from_numpy(y)), ref.targets(jnp.asarray(y))
    np.testing.assert_array_equal(tg["bins"].numpy(), np.asarray(jtg["bins"]))
    np.testing.assert_allclose(_f32(tg["res"]), _f32(jtg["res"]), rtol=1e-6, atol=1e-7)
    st, rt = torch.tensor(scores, requires_grad=True), torch.tensor(residual, requires_grad=True)
    losses = getattr(port, f"{phase}_losses")((st, rt), tg)
    jlosses_fn = getattr(ref, f"{phase}_losses")
    want = jlosses_fn((jnp.asarray(scores), jnp.asarray(residual)), jtg)
    for got, w in zip(losses, want):
        np.testing.assert_allclose(_f32(got), _f32(w), rtol=1e-6, atol=1e-7)
    sum(losses).backward()
    jgrads = jax.grad(lambda s, r: sum(jlosses_fn((s, r), jtg)), (0, 1))(
        jnp.asarray(scores), jnp.asarray(residual)
    )
    for got, w in zip((st.grad, rt.grad), jgrads):
        np.testing.assert_allclose(_f32(got), _f32(w), rtol=1e-6, atol=1e-6)


# --- (b) the stem backward ---------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stem_backward_matches_jax(dtype):
    """d/d(y, a, b) of sum(tanh(stem(y, a, b))**2): the port's autograd
    Function (plain vjp on CPU) against jax.grad through the JAX custom VJP
    with the Pallas kernel in interpret mode and with 'xla'. f32 against
    'xla': rtol 1e-6 plus 2e-6 of the largest magnitude (about 10 f32 ulps:
    the two frameworks' tanh-loss gradients differ by ulps, and overlapping
    windows add them). Otherwise the tie tolerance of
    tests/test_stem_pool.py (under 1% of dy rerouted, per-channel sums of dy
    within 2e-2, da and db within 2e-2 of their largest magnitude): in bf16
    for ties, and in f32 against 'interpret' because the JAX kernel rounds
    its row-routed gradient to bf16 whatever y's dtype."""
    rng = np.random.default_rng(5)
    y = rng.standard_normal((2, 16, 12, 8)).astype(np.float32)
    a = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    b = (rng.standard_normal(8) * 0.1).astype(np.float32)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    yt = torch.from_numpy(y).to(tdt).permute(0, 3, 1, 2).requires_grad_()
    at, bt = torch.tensor(a, requires_grad=True), torch.tensor(b, requires_grad=True)
    out = stem_pool.stem_bn_relu_pool(yt, at, bt, "kernel")
    (torch.tanh(out.float()) ** 2).sum().backward()
    assert stem_pool.bwd_launches == 0
    got = (_f32(yt.grad.permute(0, 2, 3, 1)), _f32(at.grad), _f32(bt.grad))
    for impl in ("interpret", "xla"):
        want = jax.grad(
            lambda y, a, b: jnp.sum(
                jnp.tanh(jax_stem.stem_bn_relu_pool(y, a, b, impl).astype(jnp.float32)) ** 2
            ),
            (0, 1, 2),
        )(jnp.asarray(y, jdt), jnp.asarray(a), jnp.asarray(b))
        want = tuple(_f32(w) for w in want)
        if dtype == "float32" and impl == "xla":
            for g, w in zip(got, want):
                np.testing.assert_allclose(
                    g, w, rtol=1e-6, atol=2e-6 * np.abs(w).max(), err_msg=impl
                )
            continue
        mism = np.abs(got[0] - want[0]) / max(np.abs(want[0]).max(), 1e-6) > 2e-2
        assert mism.mean() < 0.01, f"{impl}: {mism.sum()} rerouted positions"
        np.testing.assert_allclose(
            got[0].sum(axis=(0, 1, 2)), want[0].sum(axis=(0, 1, 2)), rtol=2e-2, atol=1e-2
        )
        for g, w in zip(got[1:], want[1:]):
            assert np.abs(g - w).max() / max(np.abs(w).max(), 1e-6) < 2e-2, impl


# --- (c) train-mode forward ----------------------------------------------------


@pytest.mark.parametrize("stem", [(None, None), ("kernel", "xla")],
                         ids=["flax_stem", "folded_stem"])
def test_train_mode_forward_matches_jax(jax_side, x64, stem):
    """One train-mode forward on a 6-image batch: scores and residual within
    rtol 1e-4 / atol 1e-5 of JAX apply(train=True, mutable=['batch_stats'])
    in float64, and every updated running statistic within rtol 1e-5 /
    atol 1e-6: backbone BNs, the explicit stem BN and the head BNs, whose
    running variance takes n/(n-1) with n = 6."""
    port_stem, jax_stem_impl = stem
    trainer, state = jax_side
    jmodel = jax_build_model(
        trainer.config.replace(stem_pool=jax_stem_impl, compute_dtype="float64")
    )
    batch = _loader(6, 1)[0]
    x = (batch["xdata"].astype(np.float32) / 255.0 - 0.45) / 0.225
    (scores, residual), mut = jax.jit(
        lambda v, x, l: jmodel.apply(v, x, l, train=True, mutable=["batch_stats"])
    )({"params": _f64(state.params), "batch_stats": _f64(state.batch_stats)},
      jnp.asarray(x, jnp.float64), jnp.asarray(batch["label"]))
    model = _port_trainer(state, stem_pool=port_stem).model
    model.train()
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(batch["label"]))
    assert model.training
    for g, w in zip(got, (scores, residual)):
        np.testing.assert_allclose(_f32(g), np.asarray(w), rtol=1e-4, atol=1e-5)
    want = _port_sd(state.params, mut["batch_stats"])
    _assert_state_dict_close(
        {k: v for k, v in model.state_dict().items() if "running" in k},
        {k: v for k, v in want.items() if "running" in k}, rtol=1e-5, atol=1e-6,
    )


# --- (d) one step, gradients through an SGD(1.0) probe -------------------------


def _jax_batch():
    return next(jax_interleave(_loader(7, 1), _loader(8, 1)))


@pytest.mark.parametrize("fused", [False, True], ids=["literal", "fused"])
@pytest.mark.parametrize("phase", ["warmup", "main"])
def test_train_step_gradients_match_jax(jax_side, x64, phase, fused):
    """One dual-stream step in float64 with SGD(1.0) on both sides, so the
    parameter delta is the gradient: metrics within rtol 1e-4, gradients
    elementwise within 1e-4 of each leaf's largest magnitude, running
    statistics (two per-stream updates, real first) within rtol/atol 1e-5.
    The JAX step runs dual_stream_fused as given; the port runs the two
    forwards either way."""
    trainer, state = jax_side
    jtrainer = _jax_trainer(compute_dtype="float64", stem_pool=None)
    cfg = jtrainer.config
    tx = optax.sgd(PROBE_LR)
    jstep = jax.jit(jax_make_train_step(
        jtrainer.apply_fn, jtrainer.problem, tx, phase=phase,
        alpha=cfg.alpha if phase == "main" else cfg.warmup_alpha,
        dual_stream_bn=True, dual_stream_fused=fused, **jtrainer._step_kwargs,
    ))
    jstate = create_train_state(
        {"params": _f64(state.params), "batch_stats": _f64(state.batch_stats)}, tx
    )
    batch = _jax_batch()
    jnew, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    port = _port_trainer(state, compute_dtype="float64")
    sgd = torch.optim.SGD(port.model.parameters(), lr=PROBE_LR)
    step = make_train_step(
        port.model, port.problem, sgd, phase=phase, dual_stream_bn=True,
        dual_stream_fused=fused,
    )
    pstate = TrainState(step=0, model=port.model, optimizer=sgd, s=torch.zeros(()))
    before = {k: v.clone() for k, v in port.model.state_dict().items()}
    validate_dual_stream_layout(batch)
    pnew, metrics = step(pstate, port._to_device(batch))
    assert pnew.step == 1 and not port.model.training
    for k in ("loss", "lc", "lr", "s", "alpha"):
        np.testing.assert_allclose(
            _f32(metrics[k]), np.asarray(jmetrics[k]), rtol=1e-4, atol=1e-6, err_msg=k
        )
    want_before = _port_sd(jstate.params, jstate.batch_stats)
    want_after = _port_sd(jnew.params, jnew.batch_stats)
    after = port.model.state_dict()
    for k, w in want_after.items():
        if k.endswith("num_batches_tracked"):
            continue
        if "running" in k:
            np.testing.assert_allclose(_f32(after[k]), _f32(w), rtol=1e-5, atol=1e-5, err_msg=k)
            continue
        g_port = (before[k] - after[k]).double().numpy() / PROBE_LR
        g_jax = (want_before[k].double() - w.double()).numpy() / PROBE_LR
        scale = max(np.abs(g_jax).max(), 1e-12)
        assert np.abs(g_port - g_jax).max() <= 1e-4 * scale, k


# --- (e) Trainer.fit with Adam ---------------------------------------------------


def _jax_steps(trainer, state, real, render):
    """The JAX fit's steps one by one (its compiled dual-stream steps), with
    every step's metrics."""
    out = []
    for phase in ("warmup", "main"):
        step_fn = trainer.train_step_fn(phase, dual_stream=True)
        for i, batch in enumerate(jax_interleave(real, render)):
            state, m = step_fn(state, trainer.shard_batch(batch))
            out.append(jax.device_get(m))
            if i + 1 >= trainer.config.max_iterations:
                break
        if phase == "warmup":
            state = state.replace(s=jnp.zeros((), jnp.float32))
    return out


@pytest.mark.parametrize("optimizer_dtype", ["float32", "bfloat16"])
def test_fit_matches_jax(jax_side, x64, optimizer_dtype):
    """2 warm-up + 2 main steps of Trainer.fit (dual loaders, Adam at lr
    1e-4, s reset between the phases) against the JAX Trainer.fit in
    float64 from the same weights, both with Adam's first moment in
    `optimizer_dtype`: every step's metrics within rtol 1e-3 (s, a log,
    within 1e-3 absolute: the relative error of Lr), the final
    parameters within 4 lr (Adam moves an element whose float32 gradient
    is rounding noise by a full +/-lr per step: measured 2.3 lr after 4
    steps) and the running statistics within rtol 1e-3 /
    atol 1e-4."""
    _, state = jax_side
    jtrainer = _jax_trainer(
        compute_dtype="float64", stem_pool=None, optimizer_dtype=optimizer_dtype
    )
    real, render = _loader(9), _loader(10)

    def jstate():  # a fresh one each time: the JAX steps donate their state
        return create_train_state(
            {"params": _f64(state.params), "batch_stats": _f64(state.batch_stats)},
            jtrainer.tx,
        )

    jmetrics = _jax_steps(jtrainer, jstate(), real, render)
    jfinal = jtrainer.fit(jstate(), real, render)

    port = _port_trainer(state, optimizer_dtype=optimizer_dtype)
    pfinal = port.fit(port.init_state(), real, render, log_every=1)
    assert pfinal.step == 4 and [r["phase"] for r in port.history] == [
        "warmup", "warmup", "main", "main"]
    for rec, want in zip(port.history, jmetrics):
        for k in ("loss", "lc", "lr", "s", "alpha"):
            rtol, atol = (0, 1e-3) if k == "s" else (1e-3, 1e-5)
            np.testing.assert_allclose(rec[k], float(want[k]), rtol=rtol, atol=atol,
                                       err_msg=f"step {rec['step']} {k}")
    mu = next(iter(port.optimizer.state.values()))["mu"]
    assert mu.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[optimizer_dtype]
    want = _port_sd(jfinal.params, jfinal.batch_stats)
    sd = port.model.state_dict()
    lr = port.config.init_lr
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        if "running" in k:
            np.testing.assert_allclose(_f32(sd[k]), _f32(w), rtol=1e-3, atol=1e-4, err_msg=k)
        else:
            assert np.abs(sd[k].double().numpy() - w.double().numpy()).max() <= 4 * lr, k


# --- (f) the optimizer alone ---------------------------------------------------


@pytest.mark.parametrize("optimizer_dtype", ["float32", "bfloat16"])
def test_build_optimizer_matches_optax(optimizer_dtype):
    """5 Adam steps on a small parameter dict with seeded gradients against
    optax.adam(1e-4, mu_dtype): parameters within rtol 1e-6 / atol 1e-9,
    first moments in the same dtype within rtol 1e-6 (bf16: 1 ulp), second
    moments within rtol 1e-6."""
    rng = np.random.default_rng(11)
    shapes = {"w": (4, 3), "b": (3,), "k": (2, 2, 3, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 10.0 ** rng.integers(-3, 2)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]
    cfg = get_config("geodesic_bd", optimizer_dtype=optimizer_dtype)
    mu_dtype = jnp.bfloat16 if optimizer_dtype == "bfloat16" else None
    tx = optax.adam(cfg.init_lr, mu_dtype=mu_dtype)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jopt = tx.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = build_optimizer(cfg, tp.values())
    for g in grads:
        upd, jopt = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jopt, jp)
        jp = optax.apply_updates(jp, upd)
        for k, t in tp.items():
            t.grad = torch.from_numpy(g[k])
        opt.step()
    mu_tol = 2**-7 if optimizer_dtype == "bfloat16" else 1e-6
    for k, t in tp.items():
        st = opt.state[t]
        assert st["count"] == 5
        assert st["mu"].dtype == (torch.float32 if mu_dtype is None else torch.bfloat16)
        np.testing.assert_allclose(_f32(t), _f32(jp[k]), rtol=1e-6, atol=1e-9, err_msg=k)
        np.testing.assert_allclose(_f32(st["mu"]), _f32(jopt[0].mu[k]), rtol=mu_tol,
                                   atol=1e-12, err_msg=k)
        np.testing.assert_allclose(_f32(st["nu"]), _f32(jopt[0].nu[k]), rtol=1e-6,
                                   atol=1e-15, err_msg=k)


# --- (g) what is refused ---------------------------------------------------------


@pytest.mark.parametrize("setting", [
    dict(remat="everything"), dict(remat="checkpoint"),
    dict(device_resize_from=0), dict(epoch_lr_decay="cosine"),
    dict(fused_conv_bn="kernel"),
])
def test_unported_settings_raise(setting):
    """Settings outside what the config takes raise ValueError: a remat mode
    that train/remat does not have, a device_resize_from that is no size;
    fused_conv_bn refuses the default float32 compute dtype; epoch_lr_decay
    takes 'objectnet' | 'step' | 'inv' and refuses any other kind."""
    if "remat" in setting or "device_resize_from" in setting:
        with pytest.raises(ValueError, match=next(iter(setting))):
            get_config("geodesic_bd", **setting)
        assert get_config("geodesic_bd", remat="stage", device_resize_from=256).remat == "stage"
        return
    if "fused_conv_bn" in setting:
        with pytest.raises(ValueError, match="bfloat16"):
            get_config("geodesic_bd", **setting)
        return
    if "epoch_lr_decay" in setting:
        with pytest.raises(ValueError, match="unknown epoch_lr_decay"):
            get_config("geodesic_bd", **setting)
        assert get_config("geodesic_bd", epoch_lr_decay="step").epoch_lr_decay == "step"


def test_trainer_refuses_what_it_does_not_do(jax_side, tmp_path):
    """A test batch of out-of-range labels, mismatched stream halves, a
    state of another model, and a bad optimizer dtype raise; the
    interleave carries the is_real mask. TensorBoard output, which raised
    before it was ported, writes its event file beside metrics.jsonl."""
    from multi_modal_regression_tpu_torch.utils.metrics_writer import read_scalars

    cfg = get_config("geodesic_bd", **SMALL, tensorboard=True)
    tb = Trainer(cfg, dictionary=_centers(), workdir=tmp_path, device="cpu")
    tb._log({"step": 2, "loss": 0.5})
    (events,) = (tmp_path / "tb").glob("events.out.tfevents.*")
    assert read_scalars(events) == [("loss", 2, 0.5)]
    with pytest.raises(ValueError, match="optimizer_dtype"):
        get_config("geodesic_bd", optimizer_dtype="float16")
    port = _port_trainer(jax_side[1])
    state = port.init_state()
    bad = [{**b, "label": b["label"] + 3, "valid": np.ones(N_STREAM, bool)} for b in _loader(14)]
    with pytest.raises(ValueError, match="labels must lie"):
        port.fit(state, _loader(12), _loader(13), test_loader=bad)
    batch = next(_interleave(_loader(12), _loader(13)))
    np.testing.assert_array_equal(batch["is_real"], np.arange(12) < 6)
    validate_dual_stream_layout(batch)
    uneven = next(_interleave(_loader(12), [{k: v[:3] for k, v in _loader(13)[0].items()}]))
    with pytest.raises(ValueError, match="equal real/render halves"):
        validate_dual_stream_layout(uneven)
    with pytest.raises(ValueError, match="equal real/render halves"):
        port.run_epoch(state, _loader(12), [{k: v[:3] for k, v in b.items()}
                                            for b in _loader(13)], "main")
    other = torch.optim.SGD(port.model.parameters(), lr=1.0)
    step = port.train_step_fn("main", dual_stream=True)
    with pytest.raises(ValueError, match="another model or optimizer"):
        step(state.replace(optimizer=other), port._to_device(batch))
    with pytest.raises(ValueError, match="phase"):
        port.train_step_fn("other")
