"""The PyTorch port's soft-bin presets vs the JAX package, on CPU.

`probabilistic_bd` (GMM posterior soft bins, expected geodesic loss) and
`relaxed_bd` / `ablation_xbd` (RBF soft bins over a kmeans dictionary): the
soft targets, the KL and expected-loss primitives, the two problems, the
presets, the epoch learning-rate factors, and the slice as a whole: one
float64 dual-stream train step of each preset from the same weights
(`from_jax_variables`), the same dictionary and the same numpy-seeded
batches, and a 2-epoch fit under the step decay. The step tests use a small
model (ResNet18 to layer2, N0 128, N1 16, N2 8, K 8, 3 classes, 32 px, 2
items per class per stream). Each test states its tolerance.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multi_modal_regression_tpu.data import targets as jax_targets
from multi_modal_regression_tpu.dictionary.common import get_gamma as jax_get_gamma
from multi_modal_regression_tpu.dictionary.gmm import GMMDictionary as JaxGMMDictionary
from multi_modal_regression_tpu.losses import bin_delta as jax_bin_delta
from multi_modal_regression_tpu.losses import primitives as jax_primitives
from multi_modal_regression_tpu.parallel.mesh import make_mesh
from multi_modal_regression_tpu.train import Trainer as JaxTrainer
from multi_modal_regression_tpu.train import get_config as jax_get_config
from multi_modal_regression_tpu.train import schedules as jax_schedules
from multi_modal_regression_tpu.train.presets import build_problem as jax_build_problem
from multi_modal_regression_tpu.train.problems import make_problem as jax_make_problem
from multi_modal_regression_tpu.train.state import create_train_state
from multi_modal_regression_tpu.train.steps import make_train_step as jax_make_train_step
from multi_modal_regression_tpu.train.trainer import _interleave as jax_interleave
from multi_modal_regression_tpu_torch.data import targets
from multi_modal_regression_tpu_torch.dictionary.gmm import GMMDictionary
from multi_modal_regression_tpu_torch.dictionary.kmeans import KMeansDictionary
from multi_modal_regression_tpu_torch.losses import bin_delta, primitives
from multi_modal_regression_tpu_torch.train import schedules
from multi_modal_regression_tpu_torch.train.presets import (
    PRESETS,
    build_problem,
    get_config,
    scaled_lr,
)
from multi_modal_regression_tpu_torch.train.problems import make_problem
from multi_modal_regression_tpu_torch.train.state import TrainState
from multi_modal_regression_tpu_torch.train.steps import make_train_step
from multi_modal_regression_tpu_torch.train.trainer import Trainer

from test_torch_port_ops import one_torch_thread  # noqa: F401
from test_torch_port_train import _f32, _f64, _loader, _port_sd, _poses, x64  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(
    feature_network="resnet18", feature_layer="layer2", N0=128, N1=16, N2=8,
    dict_size=8, num_classes=3, image_size=32, items_per_batch=2,
    compute_dtype="float32", optimizer_dtype="float32", max_iterations=2,
)
PROBE_LR = 1.0


def _centers() -> np.ndarray:
    return (0.7 * np.random.default_rng(0).standard_normal((8, 3))).astype(np.float32)


def _gmm_arrays(k=8):
    rng = np.random.default_rng(1)
    means = (0.7 * rng.standard_normal((k, 3))).astype(np.float32)
    a = (0.4 * rng.standard_normal((k, 3, 3))).astype(np.float32)
    covs = a @ a.transpose(0, 2, 1) + 0.2 * np.eye(3, dtype=np.float32)
    w = rng.uniform(0.5, 1.5, k).astype(np.float32)
    return means, covs, (w / w.sum()).astype(np.float32)


def _dictionary(preset: str, jax_side: bool = False):
    if preset == "probabilistic_bd":
        return (JaxGMMDictionary if jax_side else GMMDictionary)(*_gmm_arrays())
    return _centers()


# --- soft targets and loss primitives ---------------------------------------------


def test_soft_targets_match_jax():
    """gmm_log_responsibilities, gmm_soft_targets and rbf_soft_targets on
    the same poses and parameters: rtol 1e-5, atol 1e-6 (log responsibilities
    atol 1e-5: they reach -40)."""
    rng = np.random.default_rng(2)
    y = _poses(rng, 64)
    means, covs, w = _gmm_arrays()
    t = [torch.from_numpy(a) for a in (y, means, covs, w)]
    j = [jnp.asarray(a) for a in (y, means, covs, w)]
    np.testing.assert_allclose(
        _f32(targets.gmm_log_responsibilities(*t)),
        _f32(jax_targets.gmm_log_responsibilities(*j)), rtol=1e-5, atol=1e-5,
    )
    for got, want in zip(targets.gmm_soft_targets(*t), jax_targets.gmm_soft_targets(*j)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-6)
    C = _centers()
    for gamma in (10.0, 0.7):
        got = targets.rbf_soft_targets(t[0], torch.from_numpy(C), gamma)
        want = jax_targets.rbf_soft_targets(j[0], jnp.asarray(C), gamma)
        for g, w_ in zip(got, want):
            np.testing.assert_allclose(_f32(g), _f32(w_), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(_f32(got[0]).sum(-1), 1.0, atol=1e-6)
    # float64 poses against the float32 mixture and dictionary are promoted
    y64 = torch.from_numpy(y.astype(np.float64))
    assert targets.gmm_soft_targets(y64, *t[1:])[1].dtype == torch.float64
    assert targets.rbf_soft_targets(y64, torch.from_numpy(C))[1].dtype == torch.float64


def test_kl_div_and_expected_regression_match_jax():
    """kl_div_mean (mean over ALL elements, 0 * log 0 = 0 in value and in
    gradient) and expected_regression with the per-sample geodesic loss:
    rtol 1e-5, atol 1e-7; gradients rtol 1e-5, atol 1e-7."""
    rng = np.random.default_rng(3)
    scores = rng.standard_normal((12, 8)).astype(np.float32) * 2
    soft = rng.dirichlet(np.ones(8), 12).astype(np.float32)
    soft[0, :3] = 0.0
    soft[0] /= soft[0].sum()
    st = torch.tensor(scores, requires_grad=True)
    got = primitives.kl_div_mean(torch.log_softmax(st, -1), torch.from_numpy(soft))
    got.backward()
    want, grad = jax.value_and_grad(
        lambda s: jax_primitives.kl_div_mean(jax.nn.log_softmax(s, -1), jnp.asarray(soft))
    )(jnp.asarray(scores))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(_f32(st.grad), _f32(grad), rtol=1e-5, atol=1e-7)
    minus_inf = torch.full((1, 3), -float("inf"))
    assert float(primitives.kl_div_mean(minus_inf, torch.zeros((1, 3)))) == 0.0

    cand = np.stack([_poses(rng, 9)[1:] for _ in range(12)])  # (B, K, D), no zero pose
    y = _poses(rng, 12)
    st = torch.tensor(scores, requires_grad=True)
    ct = torch.tensor(cand, requires_grad=True)
    got = bin_delta.expected_regression(
        st, ct, torch.from_numpy(y), lambda p, t: primitives.geodesic_aa(p, t, reduce=False)
    )
    got.backward()
    want, grads = jax.value_and_grad(
        lambda s, c: jax_bin_delta.expected_regression(
            s, c, jnp.asarray(y), lambda p, t: jax_primitives.geodesic_aa(p, t, reduce=False)
        ), (0, 1),
    )(jnp.asarray(scores), jnp.asarray(cand))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(_f32(st.grad), _f32(grads[0]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(_f32(ct.grad), _f32(grads[1]), rtol=1e-4, atol=1e-6)


# --- the two problems ---------------------------------------------------------------


def _problems(name, gamma=10.0):
    kw = {}
    if name == "probabilistic":
        means, covs, w = _gmm_arrays()
        kw = dict(gmm_means=means, gmm_covariances=covs, gmm_weights=w)
    C = _centers()
    return (make_problem(name, C, "cpu", gamma=gamma, **kw),
            jax_make_problem(name, C, gamma=gamma, **kw))


@pytest.mark.parametrize("phase", ["warmup", "main"])
@pytest.mark.parametrize("name", ["relaxed_kmeans", "probabilistic"])
def test_soft_problems_match_jax(name, phase):
    """Targets, the phase's (lc, lr) and the decode against the JAX
    make_problem on the same scores, residuals and poses: float32 rtol 1e-5,
    atol 1e-6; the balance modes are equal."""
    rng = np.random.default_rng(4)
    y = _poses(rng, 12)
    scores = rng.standard_normal((12, 8)).astype(np.float32)
    residual = (0.2 * rng.standard_normal((12, 3))).astype(np.float32)
    port, ref = _problems(name, gamma=3.0)
    assert (port.warmup_balance, port.main_balance) == (ref.warmup_balance, ref.main_balance)
    assert (port.name, port.ydata_type) == (ref.name, ref.ydata_type)
    tg, jtg = port.targets(torch.from_numpy(y)), ref.targets(jnp.asarray(y))
    assert sorted(tg) == sorted(jtg)
    for k in tg:
        np.testing.assert_allclose(_f32(tg[k]), _f32(jtg[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    out = (torch.from_numpy(scores), torch.from_numpy(residual))
    jout = (jnp.asarray(scores), jnp.asarray(residual))
    got = getattr(port, f"{phase}_losses")(out, tg)
    want = getattr(ref, f"{phase}_losses")(jout, jtg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_f32(port.decode(out)), _f32(ref.decode(jout)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["relaxed_kmeans", "probabilistic"])
def test_soft_problems_main_gradients_match_jax_f64(x64, name):
    """d(lc + lr)/d(scores, residual) of the main losses in float64: rtol
    1e-6, atol 1e-9 (the mixture and the dictionary stay float32 on both
    sides and are promoted)."""
    rng = np.random.default_rng(5)
    y = _poses(rng, 12).astype(np.float64)
    scores = rng.standard_normal((12, 8))
    residual = 0.2 * rng.standard_normal((12, 3))
    port, ref = _problems(name)
    tg, jtg = port.targets(torch.from_numpy(y)), ref.targets(jnp.asarray(y))
    st, rt = torch.tensor(scores, requires_grad=True), torch.tensor(residual, requires_grad=True)
    losses = port.main_losses((st, rt), tg)
    assert losses[1].dtype == torch.float64
    sum(losses).backward()
    want = ref.main_losses((jnp.asarray(scores), jnp.asarray(residual)), jtg)
    for g, w in zip(losses, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-6, atol=1e-9)
    jgrads = jax.grad(lambda s, r: sum(ref.main_losses((s, r), jtg)), (0, 1))(
        jnp.asarray(scores), jnp.asarray(residual)
    )
    for g, w in zip((st.grad, rt.grad), jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-9)


def test_problems_refuse_what_is_not_ported():
    means, covs, w = _gmm_arrays()
    kw = dict(gmm_means=means, gmm_covariances=covs, gmm_weights=w)
    with pytest.raises(ValueError, match="unknown problem"):
        make_problem("objectnet_quaternion", _centers(), "cpu", **kw)
    with pytest.raises(ValueError, match="make_joint_problem"):
        make_problem("joint_bd", _centers(), "cpu", **kw)
    cfg = get_config("probabilistic_bd", dict_size=8)
    with pytest.raises(ValueError, match="GMMDictionary"):
        build_problem(cfg, _centers(), "cpu")
    with pytest.raises(ValueError, match="shape"):
        build_problem(cfg.replace(dict_size=9), GMMDictionary(means, covs, w), "cpu")


# --- presets, gamma, schedules ------------------------------------------------------


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_preset_fields_match_jax(preset):
    """Every field the port's config has (model_kind, N3, multires and
    nonlinearity among them) equals the JAX get_config's, except stem_pool
    and fused_conv_bn, whose JAX default 'auto' resolves to off."""
    cfg, ref = get_config(preset), jax_get_config(preset)
    for f in cfg.__dataclass_fields__:
        if f in ("stem_pool", "fused_conv_bn"):
            continue
        assert getattr(cfg, f) == getattr(ref, f), f
    with pytest.raises(ValueError, match="unknown preset"):
        get_config("objectnet_quaternion")


def test_build_problem_resolves_gamma_and_dictionaries():
    """gamma None -> get_gamma of the atoms (as the JAX build_problem): the
    soft targets of the two sides agree (rtol 1e-4: gamma itself is held to
    1e-5); a KMeansDictionary and raw centers give the same problem; a
    GMMDictionary's means are the atoms; self_balance False on a
    self-balanced problem drops both balances."""
    C = _centers()
    y = _poses(np.random.default_rng(6), 16)
    cfg = get_config("ablation_xbd", dict_size=8)
    assert cfg.gamma is None
    port = build_problem(cfg, KMeansDictionary(C), "cpu")
    ref = jax_build_problem(jax_get_config("ablation_xbd", dict_size=8), C)
    got, want = port.targets(torch.from_numpy(y)), ref.targets(jnp.asarray(y))
    np.testing.assert_allclose(_f32(got["soft"]), _f32(want["soft"]), rtol=1e-4, atol=1e-6)
    raw = build_problem(cfg, C, "cpu").targets(torch.from_numpy(y))
    assert torch.equal(raw["soft"], got["soft"])
    sharp = build_problem(cfg.replace(gamma=50.0), C, "cpu").targets(torch.from_numpy(y))
    assert not torch.allclose(sharp["soft"], got["soft"])
    np.testing.assert_allclose(
        _f32(got["soft"]),
        _f32(targets.rbf_soft_targets(torch.from_numpy(y), torch.from_numpy(C),
                                      jax_get_gamma(C))[0]), rtol=1e-4, atol=1e-6)
    g = GMMDictionary(*_gmm_arrays())
    prob = build_problem(get_config("probabilistic_bd", dict_size=8), g, "cpu")
    assert (prob.warmup_balance, prob.main_balance) == ("warmup", "main")
    out = (torch.zeros((2, 8)), torch.zeros((2, 3)))
    np.testing.assert_array_equal(_f32(prob.decode(out)), np.stack([g.means[0]] * 2))
    fixed = build_problem(get_config("probabilistic_bd", dict_size=8, self_balance=False), g, "cpu")
    assert (fixed.warmup_balance, fixed.main_balance) == (None, None)


@pytest.mark.parametrize("kind", sorted(schedules.EPOCH_LR_FACTORS))
def test_epoch_lr_factor_matches_jax(kind):
    """Equal floats for epochs 0-25; an unknown kind raises here and when a
    config is made."""
    for epoch in range(26):
        assert schedules.epoch_lr_factor(kind, epoch) == jax_schedules.epoch_lr_factor(kind, epoch)
    assert sorted(schedules.EPOCH_LR_FACTORS) == sorted(jax_schedules.EPOCH_LR_FACTORS)
    with pytest.raises(ValueError, match="unknown epoch_lr_decay"):
        schedules.epoch_lr_factor("cosine", 1)
    with pytest.raises(ValueError, match="unknown epoch_lr_decay"):
        get_config("geodesic_bd", epoch_lr_decay="cosine")


# --- the slice as a whole -------------------------------------------------------------


def _jax_trainer(preset, **overrides) -> JaxTrainer:
    cfg = jax_get_config(
        preset, **{**SMALL, "stem_pool": None, "fused_conv_bn": None, **overrides}
    )
    return JaxTrainer(
        cfg, dictionary=_dictionary(preset, jax_side=True),
        mesh=make_mesh(jax.devices("cpu")[:1]),
    )


def _port_trainer(preset, jax_state, **overrides) -> Trainer:
    cfg = get_config(preset, **{**SMALL, **overrides})
    trainer = Trainer(cfg, dictionary=_dictionary(preset), device="cpu")
    trainer.model.load_state_dict(_port_sd(jax_state.params, jax_state.batch_stats))
    return trainer


@pytest.mark.parametrize("preset", ["probabilistic_bd", "relaxed_bd"])
def test_soft_preset_train_step_matches_jax(x64, preset):
    """One dual-stream main step of each preset in float64 with SGD(1.0) on
    both sides (the parameter delta is the gradient), from the same weights,
    dictionary and two batches (real, render): loss, lc, lr within rtol
    1e-6; gradients elementwise within 1e-4 of each leaf's largest magnitude
    and running statistics within rtol/atol 1e-5, the tolerances of
    tests/test_torch_port_train.py. relaxed_bd sums the two streams' losses
    (x2) under fixed weights; probabilistic_bd self-balances."""
    jtrainer = _jax_trainer(preset, compute_dtype="float64")
    cfg = jtrainer.config
    assert cfg.loss_stream_sum == (preset == "relaxed_bd")
    state = jax.device_get(jtrainer.init_state())
    tx = optax.sgd(PROBE_LR)
    jstep = jax.jit(jax_make_train_step(
        jtrainer.apply_fn, jtrainer.problem, tx, phase="main", alpha=cfg.alpha,
        dual_stream_bn=True, dual_loss_sum=cfg.loss_stream_sum,
        dual_stream_fused=False, **jtrainer._step_kwargs,
    ))
    jstate = create_train_state(
        {"params": _f64(state.params), "batch_stats": _f64(state.batch_stats)}, tx
    )
    batch = next(jax_interleave(_loader(7, 1), _loader(8, 1)))
    jnew, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    port = _port_trainer(preset, state, compute_dtype="float64")
    sgd = torch.optim.SGD(port.model.parameters(), lr=PROBE_LR)
    step = make_train_step(
        port.model, port.problem, sgd, phase="main", alpha=port.config.alpha,
        dual_stream_bn=True, dual_loss_sum=port.config.loss_stream_sum,
    )
    before = {k: v.clone() for k, v in port.model.state_dict().items()}
    _, metrics = step(
        TrainState(step=0, model=port.model, optimizer=sgd, s=torch.zeros(())),
        port._to_device(batch),
    )
    for k in ("loss", "lc", "lr", "s", "alpha"):
        np.testing.assert_allclose(
            float(metrics[k]), float(jmetrics[k]), rtol=1e-6, atol=1e-9, err_msg=k
        )
    assert float(metrics["lc"]) > 0 and float(metrics["lr"]) > 0
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


@pytest.mark.parametrize("preset", ["probabilistic_bd", "relaxed_bd"])
def test_fit_applies_the_step_decay_like_jax(preset):
    """Trainer.fit over 2 main epochs of 2 steps with epoch_lr_decay 'step':
    the rate each logged step ran at equals the rate the JAX Trainer injects
    for that epoch (apply_epoch_lr: scaled_lr * 0.1 ** (e + 1), warm-up at
    factor 1), to float32 rounding (the JAX rate is a float32 leaf);
    probabilistic_bd runs no warm-up epoch, relaxed_bd one; Adam's moments
    survive the rate changes; init_state restores the base rate."""
    jtrainer = _jax_trainer(preset, num_epochs=2)
    jstate = jtrainer.init_state()
    base = scaled_lr(get_config(preset, **SMALL))
    want_main = []
    for e in range(2):
        jstate = jtrainer.apply_epoch_lr(jstate, e)
        want_main.append(float(jstate.opt_state.hyperparams["learning_rate"]))
    np.testing.assert_allclose(want_main, [base * 0.1, base * 0.01], rtol=1e-6)

    port = _port_trainer(preset, jax.device_get(jtrainer.init_state()), num_epochs=2)
    n_warm = port.config.num_warmup_epochs
    assert n_warm == (0 if preset == "probabilistic_bd" else 1)
    state = port.fit(port.init_state(), _loader(9), _loader(10), log_every=1)
    phases = [r["phase"] for r in port.history]
    assert phases == ["warmup"] * (2 * n_warm) + ["main"] * 4 and state.step == len(phases)
    want = [base] * (2 * n_warm) + [want_main[0]] * 2 + [want_main[1]] * 2
    np.testing.assert_allclose([r["learning_rate"] for r in port.history], want, rtol=1e-6)
    for rec in port.history:
        assert all(np.isfinite(rec[k]) for k in ("loss", "lc", "lr", "s", "alpha"))
        assert rec["lc"] > 0 and rec["lr"] > 0
    moments = next(iter(port.optimizer.state.values()))
    assert moments["count"] == len(phases)
    port.init_state()
    assert port.optimizer.param_groups[0]["lr"] == base
    other = torch.optim.SGD(port.model.parameters(), lr=1.0)
    with pytest.raises(ValueError, match="another optimizer"):
        port.apply_epoch_lr(state.replace(optimizer=other), 0)


def test_new_modules_import_without_jax():
    """The modules of the dictionary path and the soft-bin presets import in
    a fresh interpreter without pulling in jax, flax, optax or the JAX
    package; `python -m ...cli dictionary --help` runs."""
    pkg = "multi_modal_regression_tpu_torch"
    mods = ["cli", "tools", "tools.parity", "dictionary", "dictionary.gmm", "dictionary.kmeans",
            "train.schedules", "ops.assign", "data.naming", "data.index"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        f"    importlib.import_module('{pkg}.' + m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'flax', 'optax', 'orbax', 'triton', 'PIL',\n"
        "        'multi_modal_regression_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env["PATH"] = os.path.dirname(sys.executable)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    res = subprocess.run([sys.executable, "-m", f"{pkg}.cli", "dictionary", "--help"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "--device" in res.stdout, res.stderr
    assert "--compile-cache" in res.stdout  # the kernel library's directory
