"""The PyTorch port's pose-model zoo vs the JAX package, on CPU, in float64
(the JAX side under a scoped jax_enable_x64).

The six model classes the single-model zoo adds (OneDeltaPerBinModel,
ProbabilisticOneDeltaPerBinModel, PerClassRegressionModel,
PerClassClassificationModel, IndependentRegressionModel,
IndependentBDModel) at the small width of tests/test_torch_port_train.py
(ResNet50 to layer2, N0 512, N1 16, N2 8, N3 4, K 8, 3 classes, 32 px), in
eval and train mode, from the same weights: a port model's weights, with
random BN running statistics, written as flax variables (checked against
the JAX init's tree, leaf by leaf, by shape) and carried back into a second
port model by `from_jax_variables`. One dual-stream train step per model
kind against JAX make_train_step, at ResNet18 to layer2 (N0 128) to keep
the JAX compiles short. Each test states its tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from multi_modal_regression_tpu.models.heads import SharedMLP as JaxSharedMLP
from multi_modal_regression_tpu.train import get_config as jax_get_config
from multi_modal_regression_tpu.train.presets import PRESETS as JAX_PRESETS
from multi_modal_regression_tpu.train.presets import build_model as jax_build_model
from multi_modal_regression_tpu.train.presets import build_problem as jax_build_problem
from multi_modal_regression_tpu.train.presets import make_apply_fn as jax_make_apply_fn
from multi_modal_regression_tpu.train.state import create_train_state
from multi_modal_regression_tpu.train.steps import make_train_step as jax_make_train_step
from multi_modal_regression_tpu.train.trainer import _interleave as jax_interleave
from multi_modal_regression_tpu_torch import cli
from multi_modal_regression_tpu_torch.data.loader import normalize_images
from multi_modal_regression_tpu_torch.dictionary.gmm import GMMDictionary
from multi_modal_regression_tpu_torch.geometry.quaternion import quat_from_axis_angle
from multi_modal_regression_tpu_torch.models.heads import HeadBatchNorm, SharedMLP
from multi_modal_regression_tpu_torch.models.pretrained import from_jax_variables
from multi_modal_regression_tpu_torch.train.presets import (
    PRESETS,
    build_model,
    build_problem,
    get_config,
)
from multi_modal_regression_tpu_torch.train.problems import make_problem
from multi_modal_regression_tpu_torch.train.state import TrainState
from multi_modal_regression_tpu_torch.train.steps import make_eval_step, make_train_step
from multi_modal_regression_tpu_torch.train.trainer import Trainer

from test_torch_port_ops import one_torch_thread  # noqa: F401
from test_torch_port_softbins import _gmm_arrays
from test_torch_port_train import _loader, x64  # noqa: F401

SMALL = dict(
    feature_network="resnet50", feature_layer="layer2", N0=512, N1=16, N2=8, N3=4,
    dict_size=8, num_classes=3, image_size=32, items_per_batch=2,
    compute_dtype="float64", optimizer_dtype="float32",
)
STEP = dict(SMALL, feature_network="resnet18", N0=128)
# one preset of each new model kind; the quaternion regression adds ndim 4
# and the 'quat' output
KINDS = {
    "one_delta_per_bin": "geodesic_bd_multires",
    "probabilistic": "probabilistic_bd_multires",
    "per_class_regression": "geodesic_regression",
    "per_class_regression_quat": "geodesic_regression_quaternion",
    "per_class_classification": "classification",
    "independent_regression": "independent_regression",
    "independent_bd": "independent_bd",
}
NEW_PRESETS = (
    "simple_bd", "euclidean_bd", "laplacian_bd", "riemannian_bd", "log_euclidean_bd",
    "geodesic_bd_quaternion", "probabilistic_bd_quaternion", "geodesic_bd_multires",
    "probabilistic_bd_multires", "probabilistic_bd_quaternion_multires", "classification",
    "geodesic_regression", "geodesic_regression_quaternion", "independent_regression",
    "independent_bd", "rendered_bd", "ablation_geodesic_bd", "ablation_gbd_augmentation",
    "ablation_c0",
)
PROBE_LR = 1.0


def _centers() -> np.ndarray:
    return (0.7 * np.random.default_rng(0).standard_normal((8, 3))).astype(np.float32)


def _dictionary(preset: str, jax_side: bool = False):
    if get_config(preset).problem == "probabilistic_multires":
        if jax_side:
            from multi_modal_regression_tpu.dictionary.gmm import GMMDictionary as JaxGMM

            return JaxGMM(*_gmm_arrays())
        return GMMDictionary(*_gmm_arrays())
    return _centers()


def _set(tree: dict, path: list[str], value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


_BNS = (nn.BatchNorm1d, nn.BatchNorm2d, HeadBatchNorm)


def to_jax_variables(model: nn.Module) -> tuple[dict, dict]:
    """The flax (params, batch_stats) trees of a port model, as numpy
    arrays: the layouts from_jax_variables maps back."""
    params: dict = {}
    stats: dict = {}
    modules = dict(model.named_modules())
    for name, p in model.named_parameters():
        mod_name, _, leaf = name.rpartition(".")
        mod = modules[mod_name]
        a = p.detach().numpy()
        path = mod_name.split(".")
        if isinstance(mod, nn.Conv2d):
            _set(params, path + ["kernel"], a.transpose(2, 3, 1, 0))
        elif isinstance(mod, nn.Linear):
            _set(params, path + ["kernel" if leaf == "weight" else "bias"],
                 a.T if leaf == "weight" else a)
        elif isinstance(mod, _BNS):
            _set(params, path + ["scale" if leaf == "weight" else "bias"], a)
        else:  # head-bank leaves fc<i>_kernel / fc<i>_bias
            _set(params, path + [leaf], a)
    for name, b in model.named_buffers():
        mod_name, _, leaf = name.rpartition(".")
        if leaf in ("running_mean", "running_var"):
            _set(stats, mod_name.split(".") + [leaf.removeprefix("running_")], b.numpy())
    return params, stats


def _random_stats(model: nn.Module, rng) -> None:
    """Running means ~ N(0, 0.1), variances ~ U(0.5, 2), float32 values."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, _BNS):
                shape = tuple(m.running_mean.shape)
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.1, shape).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2, shape).astype(np.float32)))


def _pair(preset: str, small: dict, seed: int = 0):
    """(port model built from the JAX-layout trees, JAX model, apply_fn,
    variables, config): the first port model's weights (seed `seed`, random
    BN statistics) as flax trees, loaded into a second port model through
    from_jax_variables."""
    cfg = get_config(preset, **small, seed=seed)
    src = build_model(cfg, "cpu")
    _random_stats(src, np.random.default_rng(seed + 1))
    # from_jax_variables carries float32 values: the JAX side takes the
    # same values, held in float64
    params, stats = jax.tree.map(lambda a: a.astype(np.float32).astype(np.float64),
                                 to_jax_variables(src))
    model = build_model(cfg.replace(seed=seed + 7), "cpu")
    model.load_state_dict(from_jax_variables(params, stats))
    jcfg = jax_get_config(preset, **small, seed=seed, stem_pool=None, fused_conv_bn=None)
    jmodel = jax_build_model(jcfg)
    variables = {"params": params, "batch_stats": stats}
    return model, jmodel, jax_make_apply_fn(jmodel, jcfg), variables, jcfg


def _images(seed: int, n: int = 6):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (n, 32, 32, 3)).astype(np.float64) / 255.0
    return (x - 0.45) / 0.225, (np.arange(n) % 3).astype(np.int32)


def _outs(o):
    return o if isinstance(o, tuple) else (o,)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --- the models, eval and train mode --------------------------------------------------


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_zoo_models_match_jax(x64, kind, mode):
    """The model's outputs (scores and residual(s), or poses, or scores)
    from the same weights and images within rtol 1e-8 / atol 1e-10; in
    train mode every updated running statistic within rtol 1e-8 / atol
    1e-10 as well (torch's unbiased running variance on both sides). The
    JAX model takes labels only for the kinds it defines so; the port's
    every model is called as model(images, labels). The flax trees written
    from the port model have the JAX init's structure and shapes."""
    preset = KINDS[kind]
    model, jmodel, apply_fn, variables, jcfg = _pair(preset, SMALL)
    x, labels = _images(3)
    init_shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), *(
            (jnp.zeros((2, 32, 32, 3)), jnp.zeros(2, jnp.int32))
            if jcfg.model_kind not in ("independent_regression", "independent_bd")
            else (jnp.zeros((2, 32, 32, 3)),)), train=False))
    got_shapes = jax.tree.map(lambda a: a.shape, variables)
    assert got_shapes == jax.tree.map(lambda a: a.shape, dict(init_shapes))
    train = mode == "train"
    jout = jax.jit(lambda v, x, l: apply_fn(v, x, l, train))(
        variables, jnp.asarray(x), jnp.asarray(labels))
    if train:
        jout, mut = jout
        model.train()
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(labels).long())
    assert model.training == train
    for g, w in zip(_outs(out), _outs(jout), strict=True):
        assert g.dtype == torch.float64 and g.shape == w.shape
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-8, atol=1e-10)
    if train:
        stats = jax.device_get(mut["batch_stats"])
        for k, v in model.state_dict().items():
            if "running" in k:
                np.testing.assert_allclose(_np(v), _jax_leaf(stats, k), rtol=1e-8, atol=1e-10,
                                           err_msg=k)


def test_from_jax_variables_carries_shared_mlp_trees(x64):
    """A flax SharedMLP's tree (Dense kernels (I, O), the last bias, two BNs
    with statistics) loads strictly into the port's SharedMLP: Linear
    weights are the kernels transposed, the BNs get num_batches_tracked 0,
    and both heads give the same output in eval and train mode within
    1e-12 (float64); other kernel ranks are refused."""
    rng = np.random.default_rng(4)
    jhead = JaxSharedMLP(features=(16, 8, 3), output_nonlinearity="pi_tanh", dtype=jnp.float64)
    x = rng.standard_normal((6, 32))
    shapes = jax.eval_shape(lambda: jhead.init(jax.random.PRNGKey(0), jnp.zeros((2, 32))))
    variables = jax.tree.map(lambda s: rng.standard_normal(s.shape) * 0.3, dict(shapes))
    variables["batch_stats"] = jax.tree.map(np.abs, variables["batch_stats"])
    sd = from_jax_variables(variables["params"], variables["batch_stats"])
    assert sorted(sd) == sorted(
        [f"fc{i}.weight" for i in (1, 2, 3)] + ["fc3.bias"]
        + [f"bn{i}.{k}" for i in (1, 2) for k in
           ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")])
    np.testing.assert_array_equal(
        sd["fc1.weight"].numpy(), variables["params"]["fc1"]["kernel"].T.astype(np.float32))
    assert int(sd["bn2.num_batches_tracked"]) == 0
    head = SharedMLP(32, (16, 8, 3), generator=torch.Generator().manual_seed(0),
                     output_nonlinearity="pi_tanh", dtype=torch.float64)
    head.load_state_dict(sd)
    f32 = jax.tree.map(lambda a: np.asarray(a, np.float32).astype(np.float64), variables)
    for train in (False, True):
        head.train(train)
        with torch.no_grad():
            got = head(torch.from_numpy(x))
        want = jhead.apply(f32, jnp.asarray(x), train=train, mutable=["batch_stats"])[0]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="Dense kernel"):
        from_jax_variables({"fc": {"kernel": np.zeros((2, 3, 4))}}, {})


# --- one dual-stream train step per model kind ----------------------------------------


@pytest.mark.parametrize("kind", sorted(set(KINDS) - {"per_class_regression_quat"}))
def test_zoo_train_step_matches_jax(x64, kind):
    """One dual-stream main step in float64 with SGD(1.0) on both sides (the
    parameter delta is the gradient), from the same weights, dictionary and
    (real, render) batches: loss, lc, lr, s, alpha within rtol 1e-6 / atol
    1e-9; gradients elementwise within 1e-6 of each leaf's largest
    magnitude; running statistics within rtol/atol 1e-8. The regression and
    classification kinds return one tensor per stream, which the step joins
    as it joins the bin-delta models' tuples."""
    preset = KINDS[kind]
    model, jmodel, apply_fn, variables, jcfg = _pair(preset, STEP, seed=3)
    cfg = get_config(preset, **STEP)
    tx = optax.sgd(PROBE_LR)
    jproblem = jax_build_problem(jcfg, _dictionary(preset, jax_side=True))
    jstep = jax.jit(jax_make_train_step(
        apply_fn, jproblem, tx, phase="main", alpha=jcfg.alpha, dual_stream_bn=True,
        dual_loss_sum=jcfg.loss_stream_sum, dual_stream_fused=False,
        compute_dtype=jnp.float64,
    ))
    jstate = create_train_state(variables, tx)
    batch = next(jax_interleave(_loader(7, 1), _loader(8, 1)))
    jnew, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    problem = build_problem(cfg, _dictionary(preset), "cpu")
    sgd = torch.optim.SGD(model.parameters(), lr=PROBE_LR)
    step = make_train_step(model, problem, sgd, phase="main", alpha=cfg.alpha,
                           dual_stream_bn=True, dual_loss_sum=cfg.loss_stream_sum,
                           compute_dtype=torch.float64)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    _, m = step(TrainState(0, model, sgd, torch.zeros(())),
                {k: torch.as_tensor(batch[k]) for k in ("xdata", "euler", "label")})
    for k in ("loss", "lc", "lr", "s", "alpha"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6, atol=1e-9, err_msg=k)
    new_params, new_stats = jax.device_get((jnew.params, jnew.batch_stats))
    after = model.state_dict()
    for k, v in after.items():
        if k.endswith("num_batches_tracked"):
            continue
        if "running" in k:
            np.testing.assert_allclose(_np(v), _jax_leaf(new_stats, k), rtol=1e-8, atol=1e-8,
                                       err_msg=k)
            continue
        g_port = (before[k] - v).numpy() / PROBE_LR
        g_jax = (_jax_leaf(variables["params"], k) - _jax_leaf(new_params, k)) / PROBE_LR
        scale = max(np.abs(g_jax).max(), 1e-12)
        assert np.abs(g_port - g_jax).max() <= 1e-6 * scale, k


def _jax_leaf(tree: dict, key: str) -> np.ndarray:
    """The float64 flax leaf (params or batch_stats) behind a port
    state_dict key, in the port's layout."""
    *path, leaf = key.split(".")
    node = tree
    for p in path:
        node = node[p]
    if leaf.startswith("running_"):
        return np.asarray(node[leaf.removeprefix("running_")], np.float64)
    if leaf == "weight" and "kernel" in node:
        a = np.asarray(node["kernel"], np.float64)
        return a.T if a.ndim == 2 else a.transpose(3, 2, 0, 1)
    return np.asarray(node["scale" if leaf == "weight" else leaf], np.float64)


def test_dual_stream_join_takes_a_single_tensor():
    """The dual-stream forward joins a model's single-tensor output row-wise
    (the streams' poses, real first), as it joins (scores, residual)
    tuples; a regression problem's losses then see all 12 rows."""
    class Poses(nn.Module):
        def __init__(self):
            super().__init__()
            self.w = nn.Parameter(torch.ones(3))

        def forward(self, x, label):
            return x.mean(dim=(1, 2)) * self.w

    model = Poses()
    seen = []
    base = make_problem("regression", None, "cpu")
    spy = dataclasses.replace(
        base, main_losses=lambda out, tg: seen.append(out) or base.main_losses(out, tg))
    sgd = torch.optim.SGD(model.parameters(), lr=0.1)
    step = make_train_step(model, spy, sgd, phase="main", dual_stream_bn=True)
    batch = next(jax_interleave(_loader(7, 1), _loader(8, 1)))
    with torch.no_grad():  # before the step moves w
        want = model(normalize_images(torch.as_tensor(batch["xdata"]), torch.float32), None)
    _, m = step(TrainState(0, model, sgd, torch.zeros(())),
                {k: torch.as_tensor(batch[k]) for k in ("xdata", "euler", "label")})
    assert seen[0].shape == (12, 3) and torch.isfinite(m["loss"])
    np.testing.assert_allclose(seen[0].detach().numpy(), want.numpy(), rtol=1e-6, atol=1e-7)


def test_eval_step_turns_mat_poses_into_quaternions():
    """A test batch that ships axis-angle `ydata` (the .mat crop sets) is
    compared in quaternions for a quaternion problem, as the JAX eval step
    converts it; axis-angle problems take it as it is."""
    rng = np.random.default_rng(5)
    model = build_model(get_config("geodesic_regression_quaternion", **{
        **STEP, "compute_dtype": "float32"}), "cpu")
    ydata = torch.from_numpy((0.5 * rng.standard_normal((6, 3))).astype(np.float32))
    batch = {"xdata": torch.from_numpy(rng.integers(0, 256, (6, 32, 32, 3), np.uint8)),
             "label": torch.from_numpy((np.arange(6) % 3).astype(np.int64)), "ydata": ydata}
    ypred, y = make_eval_step(model, make_problem("regression_quat", None, "cpu"))(batch)
    assert ypred.shape == (6, 4) and torch.equal(y, quat_from_axis_angle(ydata))
    _, y = make_eval_step(model, make_problem("regression", None, "cpu"))(batch)
    assert torch.equal(y, ydata)


# --- build_model, the presets ------------------------------------------------------------


@pytest.mark.parametrize("kind", ["per_class_regression", "per_class_classification",
                                  "independent_regression", "independent_bd"])
def test_build_model_refuses_stem_and_fused_for_pose_kinds(kind):
    """The models/pose kinds have no stem or fused trunk option (the JAX
    _BackboneModel has none): build_model raises rather than ignore one;
    the bin-delta kinds take both."""
    preset = KINDS[kind]
    for bad in (dict(stem_pool="kernel"), dict(stem_pool="plain"),
                dict(fused_conv_bn="plain", compute_dtype="bfloat16")):
        cfg = get_config(preset, **{**SMALL, "compute_dtype": "float32", **bad})
        with pytest.raises(ValueError, match="stem_pool or fused_conv_bn"):
            build_model(cfg, "cpu")
    multires = get_config("geodesic_bd_multires", **{**SMALL, "compute_dtype": "bfloat16"},
                          stem_pool="plain", fused_conv_bn="plain")
    m = build_model(multires, "cpu")
    assert m.feature_model.stem_pool == "plain" and m.feature_model.fused == "plain"


def test_presets_cover_the_single_model_zoo():
    """The port has all 42 of the JAX package's presets, the zoo's 19 among
    them, buildable and trainable at the small width (one Trainer each on
    the CPU); the CLI offers exactly those; an unknown preset or model kind
    raises."""
    assert len(PRESETS) == 42 and set(NEW_PRESETS) <= set(PRESETS)
    assert set(PRESETS) == set(JAX_PRESETS)
    with pytest.raises(ValueError, match="unknown preset"):
        get_config("objectnet_quaternion")
    parse = cli.build_parser().parse_args
    for p in PRESETS:
        assert parse(["train", "--preset", p, "--data-root", "x"]).preset == p
    with pytest.raises(SystemExit):
        parse(["train", "--preset", "objectnet_quaternion", "--data-root", "x"])
    small = dict(STEP, compute_dtype="float32", N1=4, N2=4)
    for preset in NEW_PRESETS:
        cfg = get_config(preset, **small)
        trainer = Trainer(cfg, dictionary=_dictionary(preset), device="cpu")
        assert trainer.problem.ydata_type == ("quaternion" if cfg.ndim == 4 else "axis_angle")
    with pytest.raises(ValueError, match="unknown model_kind"):
        build_model(get_config("geodesic_bd", model_kind="labelconcat"), "cpu")
    with pytest.raises(ValueError, match="needs a pose dictionary"):
        build_problem(get_config("geodesic_bd", dict_size=8), None, "cpu")
    with pytest.raises(ValueError, match="axis-angle dictionary"):
        build_problem(get_config("geodesic_bd_quaternion", dict_size=8),
                      np.zeros((8, 4), np.float32), "cpu")
    assert build_problem(get_config("geodesic_regression"), None, "cpu").name == "regression"
