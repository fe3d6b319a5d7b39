"""The port's joint and two-stage training against the JAX package: the
seven new problems, one train step of each family under its freezing
(frozen_bn, train_only, bn_train_only), the Adam state of a partly frozen
model, the analysis protocol and the category-accuracy `best` checkpoint.

The JAX package's tiny joint config (ResNet18, N0 512, N1 32, N2 16, N3 8,
K 5, 32 px, 3 classes; tests/test_joint_train.py), float64 on both sides
(x64 on for the test), weights carried by from_jax_variables.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.io as spio
import torch

from multi_modal_regression_tpu.train.analysis import analysis_report as jax_analysis_report
from multi_modal_regression_tpu.train.analysis import run_joint_analysis as jax_run_analysis
from multi_modal_regression_tpu.train.analysis import save_analysis_mat as jax_save_mat
from multi_modal_regression_tpu.train.joint_problems import make_joint_problem as jax_joint_problem
from multi_modal_regression_tpu.train.joint_problems import (
    masked_cross_entropy as jax_masked_ce,
)
from multi_modal_regression_tpu.train.presets import build_problem as jax_build_problem
from multi_modal_regression_tpu.train.problems import make_problem as jax_make_problem
from multi_modal_regression_tpu.train.state import create_train_state
from multi_modal_regression_tpu.train.steps import make_train_step as jax_make_train_step
from multi_modal_regression_tpu.train.trainer import _interleave as jax_interleave
from multi_modal_regression_tpu_torch.metrics.pose_error import mean_class_accuracy
from multi_modal_regression_tpu_torch.train.analysis import (
    analysis_report,
    parse_analysis_runs,
    run_joint_analysis,
    save_analysis_mat,
)
from multi_modal_regression_tpu_torch.train.joint_problems import (
    make_joint_problem,
    masked_cross_entropy,
)
from multi_modal_regression_tpu_torch.train.presets import (
    build_problem,
    get_config,
    trained_parameters,
)
from multi_modal_regression_tpu_torch.train.problems import make_problem
from multi_modal_regression_tpu_torch.train.state import TrainState
from multi_modal_regression_tpu_torch.train.steps import make_train_step
from multi_modal_regression_tpu_torch.train.trainer import Trainer

from test_torch_port_joint_models import TINY, _pair
from test_torch_port_ops import one_torch_thread  # noqa: F401
from test_torch_port_train import _loader, x64  # noqa: F401
from test_torch_port_zoo_models import _jax_leaf, _np


def _centers() -> np.ndarray:
    return (0.7 * np.random.default_rng(5).standard_normal((5, 3))).astype(np.float32)


def test_masked_cross_entropy_matches_jax(x64):
    """The CE over the masked rows within 1e-12 of JAX's, for a partial, a
    full and an empty mask (0, the denominator floored at 1)."""
    rng = np.random.default_rng(1)
    logits, labels = rng.standard_normal((6, 4)), rng.integers(0, 4, 6).astype(np.int32)
    for mask in ([1, 1, 1, 0, 0, 0], [1] * 6, [0] * 6):
        m = np.asarray(mask, bool)
        got = masked_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                   torch.from_numpy(m))
        want = jax_masked_ce(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-12, atol=1e-15)


# (name, maker kwargs): the five joint problems (joint_bd both ways of its
# category CE) and the two _rene problems
PROBLEMS = {
    "joint_bd": ("joint_bd", dict(cat_on_real_only=True)),
    "joint_bd_all_rows": ("joint_bd", dict(cat_on_real_only=False)),
    "joint_reg": ("joint_reg", dict(cat_on_real_only=True)),
    "elhoseiny_bd": ("elhoseiny_bd", {}),
    "elhoseiny_reg": ("elhoseiny_reg", {}),
    "category": ("category", {}),
    "simple_rene": ("simple_rene", {}),
    "euclidean_rene": ("euclidean_rene", {}),
}


@pytest.mark.parametrize("case", sorted(PROBLEMS))
def test_new_problems_match_jax(x64, case):
    """Targets, the warm-up and main (Lc, Lr) and the decode of each new
    problem on the same float64 outputs and targets within 1e-9 (relative;
    1e-12 absolute), balances and metric as JAX's; the category decode is
    int32 class ids."""
    name, kw = PROBLEMS[case]
    rng = np.random.default_rng(len(case))
    n, C = 8, _centers()
    y = 0.8 * rng.standard_normal((n, 3))
    labels = rng.integers(0, 3, n).astype(np.int32)
    is_real = np.arange(n) < n // 2
    if name.endswith("rene"):
        port, ref = make_problem(name, C, "cpu"), jax_make_problem(name, C)
        outs = (rng.standard_normal((n, 5)), 0.3 * rng.standard_normal((n, 3)))
    else:
        port = make_joint_problem(name, None if name in ("joint_reg", "elhoseiny_reg",
                                                         "category") else C, "cpu", **kw)
        ref = jax_joint_problem(name, C, **kw)
        cat = rng.standard_normal((n, 3))
        outs = ((cat, rng.standard_normal((n, 5)), 0.3 * rng.standard_normal((n, 3)))
                if name.endswith("bd") else (cat, y + 0.2 * rng.standard_normal((n, 3))))
    tg = port.targets(torch.from_numpy(y))
    jtg = dict(ref.targets(jnp.asarray(y)))
    for k in jtg:
        np.testing.assert_allclose(_np(tg[k]), np.asarray(jtg[k]), rtol=1e-12, atol=1e-12,
                                   err_msg=k)
    tg = {**tg, "class_label": torch.from_numpy(labels), "is_real": torch.from_numpy(is_real)}
    jtg = {**jtg, "class_label": jnp.asarray(labels), "is_real": jnp.asarray(is_real)}
    t_outs = tuple(torch.from_numpy(o) for o in outs)
    j_outs = tuple(jnp.asarray(o) for o in outs)
    for phase in ("warmup_losses", "main_losses"):
        got = getattr(port, phase)(t_outs, tg)
        want = getattr(ref, phase)(j_outs, jtg)
        for g, w in zip(got, want, strict=True):
            np.testing.assert_allclose(float(g), float(w), rtol=1e-9, atol=1e-12, err_msg=phase)
    got, want = port.decode(t_outs), ref.decode(j_outs)
    assert got.dtype == (torch.int32 if name == "category" else torch.float64)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-12, atol=1e-12)
    assert (port.warmup_balance, port.main_balance, port.metric, port.ydata_type) == (
        ref.warmup_balance, ref.main_balance, ref.metric, ref.ydata_type)


def _masked_sgd(train_only):
    """SGD(1) on the named top-level collections, zero elsewhere (the JAX
    build_optimizer's masking, with SGD so a leaf's change is its gradient)."""
    if train_only is None:
        return optax.sgd(1.0)
    keep = set(train_only)

    def label_fn(params):
        return {k: jax.tree.map(lambda _: "train" if k in keep else "freeze", v)
                for k, v in params.items()}

    return optax.multi_transform({"train": optax.sgd(1.0), "freeze": optax.set_to_zero()},
                                 label_fn)


# one step of each family: (preset, overrides)
STEPS = {
    "joint_bd_v1_weighted": ("joint_cat_pose_weighted", {}),
    "joint_reg_v3": ("joint_cat_pose3_top1", {}),
    "elhoseiny_bd": ("elhoseiny_bd", dict(dict_size=5)),
    "categorization": ("categorization", {}),
    "simple_bd_rene": ("simple_bd_rene", {}),
}


@pytest.mark.parametrize("case", sorted(STEPS))
def test_family_train_step_matches_jax(x64, case):
    """One main step in float64, SGD(1) over the preset's trained leaves on
    both sides (JAX: optax.multi_transform with set_to_zero elsewhere), from
    the same weights and (real, render) batches with the is_real mask:
    loss, lc, lr, s, alpha within rtol 1e-6 / atol 1e-9; each trained
    leaf's change (its gradient) within 1e-6 of its largest magnitude (the
    tolerances of test_torch_port_zoo_models' steps: train-mode BN over 6
    rows of 1x1 layer4 features is ill-conditioned); every frozen leaf
    bit-equal to its start on both sides; running statistics as JAX's
    within rtol/atol 1e-8, and bit-equal where BN does not train (all of
    them under frozen_bn; the trunk and bin heads under bn_train_only).
    frozen_bn runs one forward over the whole batch, the others per
    stream."""
    preset, extra = STEPS[case]
    small = dict(TINY, **extra)
    model, jmodel, apply_fn, variables, jcfg = _pair(preset, small, seed=3)
    cfg = get_config(preset, **small)
    dual = not cfg.frozen_bn
    jproblem = jax_build_problem(jcfg, _centers())
    jstep = jax.jit(jax_make_train_step(
        apply_fn, jproblem, _masked_sgd(jcfg.train_only), phase="main", alpha=jcfg.alpha,
        dual_stream_bn=dual, dual_loss_sum=jcfg.loss_stream_sum, dual_stream_fused=False,
        compute_dtype=jnp.float64, frozen_bn=jcfg.frozen_bn,
    ))
    batch = next(jax_interleave(_loader(7, 1), _loader(8, 1)))
    jnew, jm = jstep(create_train_state(variables, _masked_sgd(jcfg.train_only)),
                     {k: jnp.asarray(v) for k, v in batch.items()})

    sgd = torch.optim.SGD(trained_parameters(cfg, model), lr=1.0)
    step = make_train_step(model, build_problem(cfg, _centers(), "cpu"), sgd, phase="main",
                           alpha=cfg.alpha, dual_stream_bn=dual,
                           dual_loss_sum=cfg.loss_stream_sum, compute_dtype=torch.float64,
                           frozen_bn=cfg.frozen_bn)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    _, m = step(TrainState(0, model, sgd, torch.zeros(())),
                {k: torch.as_tensor(batch[k]) for k in ("xdata", "euler", "label", "is_real")})
    for k in ("loss", "lc", "lr", "s", "alpha"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6, atol=1e-9, err_msg=k)
    assert float(m["loss"]) != 0
    new_params, new_stats = jax.device_get((jnew.params, jnew.batch_stats))
    trained = {id(p) for p in trained_parameters(cfg, model)}
    names = {id(p): k for k, p in model.named_parameters()}
    trained_keys = {names[i] for i in trained}
    assert all(p.requires_grad for p in model.parameters())  # restored after the step
    scope = cfg.bn_train_only
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        if "running" in k:
            bn_trains = not cfg.frozen_bn and (scope is None or k.split(".")[0] in scope)
            if not bn_trains:
                assert torch.equal(v, before[k]), k
            np.testing.assert_allclose(_np(v), _jax_leaf(new_stats, k), rtol=1e-8, atol=1e-8,
                                       err_msg=k)
            continue
        if k not in trained_keys:
            assert torch.equal(v, before[k]), k
            np.testing.assert_array_equal(_jax_leaf(new_params, k),
                                          _jax_leaf(variables["params"], k))
            continue
        g_port = (before[k] - v).numpy()
        g_jax = _jax_leaf(variables["params"], k) - _jax_leaf(new_params, k)
        assert np.abs(g_port - g_jax).max() <= 1e-6 * max(np.abs(g_jax).max(), 1e-300), k
    if cfg.train_only is not None:
        assert trained_keys and len(trained_keys) < len(names)
        assert {k.split(".")[0] for k in trained_keys} == set(cfg.train_only)


def test_partly_frozen_adam_state_and_resume(tmp_path):
    """Under train_only the Trainer's Adam holds exactly the trained
    parameters (moments for them alone, as optax.multi_transform keeps
    them); the frozen ones stay bit-equal through a fit; a checkpoint
    restored into a fresh Trainer is bit-equal, and one more step from
    each is bit-equal too. The 'inv' per-epoch rate reaches the trained
    group (after the preset's warm-up epoch at the base rate)."""
    cfg = get_config("cat_given_pose", **dict(TINY, compute_dtype="float32", num_epochs=2,
                                              max_iterations=1))
    a = Trainer(cfg, dictionary=_centers(), workdir=tmp_path / "a", device="cpu")
    fc = {id(p) for p in a.model.fc.parameters()}
    opt_params = [p for g in a.optimizer.param_groups for p in g["params"]]
    assert {id(p) for p in opt_params} == fc
    frozen = {k: v.clone() for k, v in a.model.state_dict().items() if not k.startswith("fc.")}
    state = a.fit(a.init_state(), _loader(1, 2), _loader(2, 2))
    assert [r["learning_rate"] for r in a.history] == [
        cfg.init_lr, cfg.init_lr / 2, cfg.init_lr / 3]
    assert len(a.optimizer.state) == len(fc)
    for k, v in a.model.state_dict().items():
        if k in frozen:
            assert torch.equal(v, frozen[k]), k
    b = Trainer(cfg, dictionary=_centers(), workdir=tmp_path / "a", device="cpu")
    sb = b.restore_checkpoint("last")
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    batch = next(iter(_loader(3, 1)))
    for t, s in ((a, state), (b, sb)):
        t.train_step_fn("main")(s, t._to_device(batch))
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k


def _test_batches(seed: int) -> list[dict]:
    """Two test batches of 6 (TestLoader layout), the second padded by 2."""
    out = []
    for i, b in enumerate(_loader(seed, 2)):
        valid = np.ones(len(b["label"]), bool)
        if i == 1:
            valid[-2:] = False
        out.append({**b, "valid": valid})
    return out


def test_joint_analysis_matches_jax(x64, tmp_path):
    """run_joint_analysis of a multires variant-1 model (per-class residuals
    at each class's own bin argmax) against JAX's over the same padded test
    batches: every key, class ids equal, predicted poses (N, D, C) within
    1e-9 of the largest magnitude, the float32 true poses within 1e-6;
    analysis_report's numbers within 1e-6 (errors against those float32
    poses); save_analysis_mat writes the same structs as JAX's, key for
    key, values as above; parse_analysis_runs names runs as JAX's."""
    small = dict(TINY, multires=True)
    model, jmodel, _, variables, jcfg = _pair("joint_cat_pose_top1", small, seed=5)
    cfg = get_config("joint_cat_pose_top1", **small)
    trainer = Trainer(cfg, dictionary=_centers(), device="cpu")
    trainer.model.load_state_dict(model.state_dict())
    got = run_joint_analysis(trainer, trainer.init_state(), _test_batches(9), _centers())
    jtrainer = types.SimpleNamespace(config=jcfg, model=jmodel,
                                     problem=jax_build_problem(jcfg, _centers()))
    jstate = create_train_state(variables, optax.sgd(1.0))
    want = jax_run_analysis(jtrainer, jstate, _test_batches(9), _centers(), shard=False)
    assert sorted(got) == sorted(want)
    assert got["ypred_pose"].shape == (10, 3, 3)
    for k in ("ytrue_cat", "ypred_cat"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the true poses come from float32 Euler angles on both sides (float32
    # poses, an ulp apart); the predicted ones are float64
    for k, tol in (("ytrue_pose", 1e-6), ("ypred_pose", 1e-9)):
        scale = np.abs(want[k]).max()
        assert np.abs(got[k] - want[k]).max() <= tol * scale, k
    rep, jrep = analysis_report(got, 3), jax_analysis_report(want, 3)
    assert sorted(rep) == sorted(jrep)
    for k in rep:
        np.testing.assert_allclose(rep[k], jrep[k], rtol=1e-6, atol=1e-9, err_msg=k)
    results = {"pose": got, "top1": got}
    save_analysis_mat(tmp_path / "port.mat", results)
    jax_save_mat(tmp_path / "jax.mat", {"pose": want, "top1": want})
    p, j = spio.loadmat(tmp_path / "port.mat"), spio.loadmat(tmp_path / "jax.mat")
    assert sorted(k for k in p if not k.startswith("__")) == ["pose_results", "top1_results"]
    assert sorted(k for k in p if not k.startswith("__")) == sorted(
        k for k in j if not k.startswith("__"))
    for run in ("pose_results", "top1_results"):
        assert p[run].dtype.names == j[run].dtype.names
        for field in p[run].dtype.names:
            a, b = p[run][field][0, 0], j[run][field][0, 0]
            assert a.shape == b.shape and a.dtype.kind == b.dtype.kind, field
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * np.abs(b).max(),
                                       err_msg=field)
    assert parse_analysis_runs(["a", "b"], None) == [("pose", "a"), ("cat", "b")]
    with pytest.raises(SystemExit, match="names for"):
        parse_analysis_runs(["a", "b"], ["x"])
    with pytest.raises(SystemExit, match="more than 4"):
        parse_analysis_runs(list("abcde"), None)


def test_category_accuracy_and_best_checkpoint(tmp_path):
    """A category problem evaluates to the mean per-class accuracy of its
    int32 class ids (not MedErr), printed as 'Acc'; fit keeps `best` at the
    HIGHEST accuracy (JAX trainer.py:406-407): with the evaluation scripted
    to 0.2, 0.5, 0.3 over three main epochs (after one warm-up step),
    `best` holds the second main epoch's state."""
    cfg = get_config("categorization", **dict(TINY, compute_dtype="float32", num_epochs=3,
                                              max_iterations=1))
    trainer = Trainer(cfg, workdir=tmp_path, device="cpu")
    state = trainer.init_state()
    test = _test_batches(4)
    ytrue, ypred, labels = trainer.predict(state, test)
    assert ypred.dtype == np.int32 and ypred.shape == (10,)
    acc = trainer.evaluate(state, test)
    assert acc == mean_class_accuracy(labels, ypred, 3)
    assert trainer.metric_label(acc).startswith("Acc ")
    scripted = iter([0.2, 0.5, 0.3])
    trainer.evaluate = lambda state, loader: next(scripted)
    trainer.fit(state, _loader(1, 2), _loader(2, 2), test_loader=test)
    best = torch.load(tmp_path / "checkpoints" / "best", weights_only=True)
    last = torch.load(tmp_path / "checkpoints" / "last", weights_only=True)
    assert (best["step"], last["step"], trainer.val_history) == (3, 4, [0.2, 0.5, 0.3])


def test_joint_entry_points_default_to_the_card():
    """make_joint_problem places its atoms on the card unless the caller
    asks for the CPU; `cli train`'s warm start defaults to the JAX CLI's
    (checkpoint final, kind oracle) and trains on the card."""
    import inspect

    from multi_modal_regression_tpu_torch import cli

    assert inspect.signature(make_joint_problem).parameters["device"].default == "cuda"
    args = cli.build_parser().parse_args(
        ["train", "--preset", "cat_given_pose", "--data-root", "x", "--warm-start-workdir",
         "w", "--warm-start-preset", "joint_cat_pose_top1"])
    assert (args.device, args.warm_start_checkpoint, args.warm_start_kind) == (
        "cuda", "final", "oracle")
