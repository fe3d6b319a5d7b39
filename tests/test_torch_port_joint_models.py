"""The port's joint category + pose models, stages, mixings and grafts
against the JAX package, at the JAX package's tiny joint config (ResNet18,
N0 512, N1 32, N2 16, N3 8, K 5, 32 px, 3 classes; tests/test_joint_train.py).

Weights: a port model's (seed, random BN statistics) written as flax trees
(`to_jax_variables`) and carried back into a second port model by
`from_jax_variables`, the JAX side holding the same float32 values in
float64 (x64 on for the test). Outputs are held within 1e-9 of their
largest magnitude; the grafts are plain copies and held bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_regression_tpu.models.backbones import ResNetBackbone as JaxResNetBackbone
from multi_modal_regression_tpu.models.backbones import ResNetStage as JaxResNetStage
from multi_modal_regression_tpu.models.joint import class_weights as jax_class_weights
from multi_modal_regression_tpu.models.surgery import (
    graft_classifier_into_bd as jax_graft_classifier,
)
from multi_modal_regression_tpu.models.surgery import (
    graft_oracle_into_joint as jax_graft_oracle,
)
from multi_modal_regression_tpu.train import get_config as jax_get_config
from multi_modal_regression_tpu.train.presets import build_model as jax_build_model
from multi_modal_regression_tpu.train.presets import make_apply_fn as jax_make_apply_fn
from multi_modal_regression_tpu_torch.models.backbones import (
    ResNetBackbone,
    ResNetStage,
    init_conv_weights,
)
from multi_modal_regression_tpu_torch.models.joint import (
    MIXINGS,
    JointCatPoseBDModel,
    class_weights,
    mix_heads,
)
from multi_modal_regression_tpu_torch.models.pretrained import from_jax_variables
from multi_modal_regression_tpu_torch.models.surgery import (
    graft_classifier_into_bd,
    graft_oracle_into_joint,
)
from multi_modal_regression_tpu_torch.train.presets import build_model, get_config

from test_torch_port_ops import one_torch_thread  # noqa: F401
from test_torch_port_train import x64  # noqa: F401
from test_torch_port_zoo_models import (
    _images,
    _jax_leaf,
    _np,
    _outs,
    _random_stats,
    to_jax_variables,
)

TINY = dict(
    feature_network="resnet18", feature_layer="layer4", num_classes=3, N0=512, N1=32,
    N2=16, N3=8, dict_size=5, image_size=32, items_per_batch=2,
    compute_dtype="float64", optimizer_dtype="float32",
)
TOL = 1e-9  # of the largest magnitude, float64 on both sides

# (preset, overrides): every joint kind, all four mixings of variant 1 and
# its multires bank under top1 and joint_top1
CASES = {
    "v1_top1": ("joint_cat_pose_top1", {}),
    "v1_joint_top1": ("joint_cat_pose_top1_new", {}),
    "v1_top1_st": ("joint_cat_pose_top1", dict(mixing="top1_st")),
    "v1_weighted": ("joint_cat_pose_weighted", {}),
    "v1_multires_top1": ("joint_cat_pose_top1", dict(multires=True)),
    "v1_multires_joint_top1": ("joint_cat_pose_top1_new", dict(multires=True)),
    "v2_weighted": ("joint_cat_pose2_weighted", {}),
    "v3_top1": ("joint_cat_pose3_top1", {}),
    "elhoseiny_bd": ("elhoseiny_bd", dict(dict_size=5)),
    "elhoseiny_regression": ("elhoseiny_regression", {}),
    "categorization": ("categorization", {}),
}


def _pair(preset: str, small: dict, seed: int = 0):
    """(port model, JAX model, apply_fn, variables, JAX config): the port
    model's weights (seed `seed`, random BN statistics) written as flax
    trees and carried back into it by from_jax_variables (float32 values,
    which the JAX side holds in float64)."""
    cfg = get_config(preset, **small, seed=seed)
    model = build_model(cfg, "cpu")
    _random_stats(model, np.random.default_rng(seed + 1))
    params, stats = jax.tree.map(lambda a: a.astype(np.float32).astype(np.float64),
                                 to_jax_variables(model))
    model.load_state_dict(from_jax_variables(params, stats))
    jcfg = jax_get_config(preset, **small, seed=seed, stem_pool=None, fused_conv_bn=None)
    jmodel = jax_build_model(jcfg)
    variables = {"params": params, "batch_stats": stats}
    return model, jmodel, jax_make_apply_fn(jmodel, jcfg), variables, jcfg


def _close(got, want, tol=TOL, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= tol * scale, (what, np.abs(got - want).max(), scale)


@pytest.mark.parametrize("case", sorted(CASES))
def test_joint_models_match_jax(x64, case):
    """The forward (category logits and scores + residual, or poses, or the
    classifier's logits) and, for variants 1 and 2, the `analysis` forward
    (logits, per-class scores (B, C, K), per-class residuals (B, C, D)) in
    eval mode from the same weights and images within 1e-9 of the largest
    magnitude; the flax trees written from the port model have the JAX
    init's structure and shapes. The models ignore the labels."""
    preset, extra = CASES[case]
    model, jmodel, apply_fn, variables, jcfg = _pair(preset, dict(TINY, **extra))
    x, labels = _images(3)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3))))
    assert jax.tree.map(lambda a: a.shape, variables) == jax.tree.map(
        lambda a: a.shape, dict(shapes))
    analysis = hasattr(jmodel, "analysis")

    def jax_forwards(v, x):
        out = apply_fn(v, x, None, False)
        return out, (jmodel.apply(v, x, False, method=type(jmodel).analysis) if analysis
                     else None)

    jout, ja = jax.jit(jax_forwards)(variables, jnp.asarray(x))
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(labels[::-1].copy()).long())
        got = model.analysis(torch.from_numpy(x)) if analysis else None
    for i, (g, w) in enumerate(zip(_outs(out), _outs(jout), strict=True)):
        assert g.dtype == torch.float64
        _close(g, w, what=f"output {i}")
    assert hasattr(model, "analysis") == analysis
    if analysis:
        assert got[1].shape == (6, 3, 5) and got[2].shape == (6, 3, 3)
        for i, (g, w) in enumerate(zip(got, ja, strict=True)):
            _close(g, w, what=f"analysis {i}")


def test_unpooled_trunk_and_stage_match_jax(x64):
    """ResNetBackbone(resnet18, 3 stages, pool=False) returns the JAX
    trunk's spatial (B, H, W, C) features, and ResNetStage(stage 4) over
    them the JAX stage's pooled (and, pool=False, spatial) output, in
    train mode with the BN statistics updated as JAX's, within 1e-9 (eval
    mode: variant 2's model cases above)."""
    g = torch.Generator().manual_seed(2)
    trunk = ResNetBackbone("resnet18", 3, dtype=torch.float64, pool=False)
    stage = ResNetStage("resnet18", 4, dtype=torch.float64)
    spatial = ResNetStage("resnet18", 4, dtype=torch.float64, pool=False)
    for m in (trunk, stage):
        init_conv_weights(m, g)
        _random_stats(m, np.random.default_rng(3))
    spatial.load_state_dict(stage.state_dict())
    x, _ = _images(5)
    jt, js = JaxResNetBackbone("resnet18", 3, pool=False, dtype=jnp.float64), JaxResNetStage(
        "resnet18", 4, dtype=jnp.float64)
    # copies: to_jax_variables' arrays share the port's buffers
    vt, vs = (dict(zip(("params", "batch_stats"), jax.tree.map(np.array, to_jax_variables(m))))
              for m in (trunk, stage))
    for m in (trunk, stage, spatial):
        m.train()
    with torch.no_grad():
        feat = trunk(torch.from_numpy(x))
        got, got_spatial = stage(feat), spatial(feat)

    def jax_forwards(vt, vs, x):
        jfeat, jmut = jt.apply(vt, x, train=True, mutable=["batch_stats"])
        want, smut = js.apply(vs, jfeat, train=True, mutable=["batch_stats"])
        jspatial = JaxResNetStage("resnet18", 4, pool=False, dtype=jnp.float64).apply(
            vs, jfeat, train=True, mutable=["batch_stats"])[0]
        return jfeat, want, jspatial, jmut, smut

    jfeat, want, jspatial, jmut, smut = jax.jit(jax_forwards)(vt, vs, jnp.asarray(x))
    assert feat.shape == (6, 2, 2, 256) and got.shape == (6, 512)
    assert got_spatial.shape == (6, 1, 1, 512)
    _close(feat, jfeat, what="trunk")
    _close(got, want, what="stage")
    _close(got_spatial, jspatial, what="spatial stage")
    for m, mut in ((trunk, jmut), (stage, smut)):
        stats = jax.device_get(mut["batch_stats"])
        for k, v in m.state_dict().items():
            if "running" in k:
                _close(v, _jax_leaf(stats, k), what=k)


def test_class_weights_and_straight_through_gradient(x64):
    """class_weights under top1, top1_st and weighted equal JAX's (one-hots
    exactly, softmax within 1e-12); mix_heads is the einsum; top1_st's
    forward is top1's one-hot and its gradient softmax's, JAX's within
    1e-12; top1 passes no gradient (JAX's is 0); an unknown mixing raises."""
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((5, 4))
    per_head = rng.standard_normal((5, 4, 3))
    probe = rng.standard_normal((5, 3))
    for mixing in ("top1", "top1_st", "weighted"):
        t = torch.from_numpy(logits).requires_grad_(True)
        w = class_weights(t, mixing)
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(
            jax_class_weights(jnp.asarray(logits), mixing)), rtol=0, atol=1e-12)
        loss = (mix_heads(torch.from_numpy(per_head), w) * torch.from_numpy(probe)).sum()

        def jloss(l, mixing=mixing):
            w = jax_class_weights(l, mixing)
            return jnp.sum(jnp.einsum("bcd,bc->bd", jnp.asarray(per_head), w) * probe)

        jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(logits)))
        if mixing == "top1":  # detached: no path back to the logits
            assert not loss.requires_grad and not jgrad.any()
            continue
        loss.backward()
        np.testing.assert_allclose(t.grad.numpy(), jgrad, rtol=0, atol=1e-12)
        if mixing == "top1_st":
            assert t.grad.abs().max() > 0
            np.testing.assert_array_equal(w.detach().numpy(), np.asarray(
                jax_class_weights(jnp.asarray(logits), "top1")))
    assert set(MIXINGS) == {"top1", "joint_top1", "top1_st", "weighted"}
    with pytest.raises(ValueError, match="unknown mixing"):
        class_weights(torch.zeros(2, 3), "soft")
    with pytest.raises(ValueError, match="mixing"):
        build_model(get_config("joint_cat_pose_top1", **dict(TINY, mixing="soft")), "cpu")
    with pytest.raises(ValueError, match="mixing"):
        build_model(get_config("joint_cat_pose2_top1", **dict(TINY, mixing="joint_top1")), "cpu")


def _carry(model) -> dict:
    return from_jax_variables(*to_jax_variables(model))


def _jax_tree(model) -> dict:
    params, stats = to_jax_variables(model)
    return {"params": params, "batch_stats": stats}


@pytest.mark.parametrize("kind", ["classifier", "joint_bd_v1", "joint_bd_v2", "joint_reg_v3"])
def test_grafts_equal_the_jax_grafts(kind):
    """Port graft of the carried weights == carry of the JAX graft, every
    tensor bit-equal, and the grafted model loads strictly; the new
    branches keep their own init, the grafted ones are the source's bits.
    The oracle of the BD grafts is built with stem_pool 'plain' (the chain
    on the card trains it with the stem kernels) and the joint model
    without: the stem BN keys coincide. v2 splits the oracle's layer4 into
    pose_stage and category_stage."""
    small = dict(TINY, compute_dtype="float32")
    src_preset, dst_preset = {
        "classifier": ("classification", "simple_bd_rene"),
        "joint_bd_v1": ("geodesic_bd", "joint_cat_pose_top1"),
        "joint_bd_v2": ("geodesic_bd", "joint_cat_pose2_weighted"),
        "joint_reg_v3": ("geodesic_regression", "joint_cat_pose3_top1"),
    }[kind]
    stem = dict(stem_pool="plain") if src_preset == "geodesic_bd" else {}
    src = build_model(get_config(src_preset, **small, **stem, seed=1), "cpu")
    dst = build_model(get_config(dst_preset, **small, seed=2), "cpu")
    for m, seed in ((src, 3), (dst, 4)):
        _random_stats(m, np.random.default_rng(seed))
    src_sd, dst_sd = _carry(src), _carry(dst)
    if kind == "classifier":
        got = graft_classifier_into_bd(dst_sd, src_sd)
        want = jax_graft_classifier(_jax_tree(dst), _jax_tree(src))
    else:
        got = graft_oracle_into_joint(dst_sd, src_sd, kind)
        want = jax_graft_oracle(_jax_tree(dst), _jax_tree(src), kind)
    want = from_jax_variables(want["params"], want["batch_stats"])
    assert sorted(got) == sorted(want) == sorted(dst.state_dict())
    for k in got:
        assert torch.equal(got[k], want[k]), k
    dst.load_state_dict(got)
    grafted = {
        "classifier": {"feature_model": "feature_model", "bin_models": "pose_models"},
        "joint_bd_v1": {m: m for m in ("feature_model", "bin_models", "res_models")},
        "joint_reg_v3": {m: m for m in ("feature_model", "pose_models")},
    }.get(kind)
    for k, v in got.items():
        top, rest = k.split(".", 1)
        if kind == "joint_bd_v2":
            src_key = {"feature_trunk": "feature_model." + rest,
                       "pose_stage": "feature_model." + rest,
                       "category_stage": "feature_model." + rest,
                       "bin_models": k, "res_models": k}.get(top)
        else:
            src_key = f"{grafted[top]}.{rest}" if top in grafted else None
        if src_key is None:
            assert torch.equal(v, dst_sd[k]), k
        else:
            assert torch.equal(v, src_sd[src_key]), k
    with pytest.raises(ValueError, match="unknown model_kind"):
        graft_oracle_into_joint(dst_sd, src_sd, "one_bin_delta")


def test_joint_kinds_refuse_stem_and_fused_and_scope():
    """The joint and categorization kinds build their trunk without the stem
    or fused conv+BN options, as the JAX package does; bn_train_only is
    refused on every kind but one_bin_delta (JAX presets.py:225-229);
    train_only names the model's own top-level modules; a v2 model whose N0
    is not its layer4 width raises."""
    for preset in ("joint_cat_pose_top1", "joint_cat_pose2_top1", "elhoseiny_bd",
                   "categorization"):
        with pytest.raises(ValueError, match="no stem_pool or fused_conv_bn"):
            build_model(get_config(preset, **TINY, stem_pool="plain"), "cpu")
    with pytest.raises(ValueError, match="bn_train_only"):
        build_model(get_config("joint_cat_pose_top1", **TINY, bn_train_only=("fc",)), "cpu")
    with pytest.raises(ValueError, match="N0"):
        build_model(get_config("joint_cat_pose2_top1", **dict(TINY, N0=256)), "cpu")
    model = build_model(get_config("simple_bd_rene", **TINY), "cpu")
    assert model.bn_train_scope == ("res_models",)
    model.train()
    assert model.training and model.res_models.training and model.res_models.bn1.training
    assert not model.feature_model.training and not model.bin_models.bn1.training
    assert isinstance(build_model(get_config("cat_given_pose", **TINY), "cpu"),
                      JointCatPoseBDModel)
