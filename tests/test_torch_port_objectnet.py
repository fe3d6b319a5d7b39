"""The PyTorch port's ObjectNet3D slice vs the JAX package, on CPU: the VGG
trunks, the four label-concat models, the `objectnet_quat` problem and its
fixed dictionary, one step of each `objectnet_*` preset fed by the flat
loader, `load_reference_bd_checkpoint` for every family, serving a VGG
model, and `cli train` over a prepared ObjectNet3D tree.

Weights cross from the JAX layout through `from_jax_variables`; inputs come
from numpy seeds. The models run at ResNet18 to layer2 (N0 128, N1 16, N2
8, N3 4, 5 classes, 32 px) and the VGG trunks at 32 px, to keep the JAX
compiles short. Each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from multi_modal_regression_tpu.models.backbones import VGGBackbone as JaxVGG
from multi_modal_regression_tpu.models.pretrained import (
    load_reference_bd_checkpoint as jax_load_reference,
)
from multi_modal_regression_tpu.models.pretrained import load_torchvision_vgg as jax_load_vgg
from multi_modal_regression_tpu.parallel.mesh import make_mesh
from multi_modal_regression_tpu.train import Trainer as JaxTrainer
from multi_modal_regression_tpu.train import get_config as jax_get_config
from multi_modal_regression_tpu.train.problems import make_problem as jax_make_problem
from multi_modal_regression_tpu.train.problems import (
    objectnet_quaternion_dictionary as jax_quat_dictionary,
)
from multi_modal_regression_tpu.train.state import create_train_state
from multi_modal_regression_tpu_torch import PASCAL3D_CLASSES, cli
from multi_modal_regression_tpu_torch.data import FlatLoader, FlatTestIndex
from multi_modal_regression_tpu_torch.models.backbones import VGG_CONFIGS, make_backbone
from multi_modal_regression_tpu_torch.models.pretrained import (
    from_jax_variables,
    load_reference_bd_checkpoint,
    load_torchvision_backbone,
    load_torchvision_vgg,
)
from multi_modal_regression_tpu_torch.serving import make_inference_fn
from multi_modal_regression_tpu_torch.tools.synthetic import (
    generate_objectnet3d_release,
    generate_pose_dataset,
)
from multi_modal_regression_tpu_torch.train.presets import (
    PRESETS,
    build_model,
    build_problem,
    get_config,
)
from multi_modal_regression_tpu_torch.train.problems import (
    make_problem,
    objectnet_quaternion_dictionary,
)
from multi_modal_regression_tpu_torch.train.trainer import Trainer

from test_torch_port_ops import one_torch_thread, randomize_batch_stats  # noqa: F401
from test_torch_port_train import _f64, _port_sd, x64  # noqa: F401
from test_torch_port_zoo_models import _jax_leaf, _pair, _random_stats, _set

CLASSES = PASCAL3D_CLASSES[:5]
SMALL = dict(
    feature_network="resnet18", feature_layer="layer2", N0=128, N1=16, N2=8, N3=4,
    dict_size=8, num_classes=5, image_size=32, items_per_batch=1,
    compute_dtype="float64", optimizer_dtype="float32", max_iterations=1,
)
OBJECTNET = ("objectnet_bd", "objectnet_bd_multires", "objectnet_classification",
             "objectnet_quat", "objectnet_regression")
KINDS = {
    "labelconcat_bd": "objectnet_bd",
    "labelconcat_delta_per_bin": "objectnet_bd_multires",
    "labelconcat_regression": "objectnet_regression",
    "labelconcat_classification": "objectnet_classification",
}
KEYS = ("loss", "lc", "lr", "s", "alpha")


def _centers(k: int = 8) -> np.ndarray:
    return (0.7 * np.random.default_rng(0).standard_normal((k, 3))).astype(np.float32)


def _small(preset: str) -> dict:
    # objectnet_quat's 16 atoms are fixed
    return dict(SMALL, dict_size=16) if preset == "objectnet_quat" else SMALL


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _outs(o):
    return o if isinstance(o, tuple) else (o,)


# --- the VGG trunks -------------------------------------------------------------------


def _vgg_variables(arch: str, rng) -> dict:
    """Random flax trees (BN statistics too) of a VGG trunk at fc7; less
    `fc7`, the fc6 trunk's."""
    jmodel = JaxVGG(arch=arch, layer="fc7")
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    return jax.tree_util.tree_map_with_path(
        lambda p, s: (rng.uniform(0.5, 2.0, s.shape) if p[-1].key == "var"
                      else rng.standard_normal(s.shape) * (0.05 if p[-1].key == "kernel" else 0.3)
                      ).astype(np.float32), dict(shapes))


@pytest.mark.parametrize("arch", sorted(VGG_CONFIGS))
def test_vgg_trunks_match_jax(arch):
    """VGG13 and VGG16 at 32 px, batch 2, float32, from the same weights
    (carried by from_jax_variables): fc6 in eval and train mode (batch
    statistics; every updated running statistic too) and fc7 in eval,
    within rtol 1e-5 of JAX's features (atol 1e-5 of their largest
    magnitude); 4096-d. The flattening is channel-major on both sides (the
    JAX package transposes its NHWC activations)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    full = _vgg_variables(arch, rng)
    for layer, train in (("fc6", False), ("fc6", True), ("fc7", False)):
        var = full if layer == "fc7" else {
            "params": {k: v for k, v in full["params"].items() if k != "fc7"},
            "batch_stats": full["batch_stats"]}
        trunk = make_backbone(arch, layer, image_size=32)
        trunk.load_state_dict(from_jax_variables(var["params"], var["batch_stats"]))
        jmodel = JaxVGG(arch=arch, layer=layer)
        if train:
            want, mut = jmodel.apply(var, x, train=True, mutable=["batch_stats"])
        else:
            want = jmodel.apply(var, x, train=False)
        trunk.train(train)
        with torch.no_grad():
            got = trunk(torch.from_numpy(x))
        assert got.shape == (2, 4096) and trunk.feature_dim == 4096
        scale = np.abs(np.asarray(want)).max()
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=f"{layer} train={train}")
        if train:
            stats = jax.device_get(mut["batch_stats"])
            for k, v in trunk.state_dict().items():
                if "running" in k:
                    np.testing.assert_allclose(_np(v), _jax_leaf(stats, k), rtol=1e-5,
                                               atol=1e-6, err_msg=k)


def _torchvision_vgg(arch: str, rng) -> dict:
    """A torchvision vggNN_bn state_dict at 32 px (fc6 512 -> 4096), numpy."""
    sd, ti, cin = {}, 0, 3
    for v in VGG_CONFIGS[arch]:
        if v == "M":
            ti += 1
            continue
        sd[f"features.{ti}.weight"] = rng.standard_normal((v, cin, 3, 3))
        sd[f"features.{ti}.bias"] = rng.standard_normal(v)
        for leaf in ("weight", "bias", "running_mean"):
            sd[f"features.{ti + 1}.{leaf}"] = rng.standard_normal(v)
        sd[f"features.{ti + 1}.running_var"] = rng.uniform(0.5, 2, v)
        sd[f"features.{ti + 1}.num_batches_tracked"] = np.array(7)
        ti, cin = ti + 3, v
    for i, fin in ((0, 512), (3, 4096), (6, 4096)):
        sd[f"classifier.{i}.weight"] = rng.standard_normal((4096 if i < 6 else 1000, fin))
        sd[f"classifier.{i}.bias"] = rng.standard_normal(4096 if i < 6 else 1000)
    return {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()}


@pytest.mark.parametrize("layer", ["fc6", "fc7"])
def test_load_torchvision_vgg_matches_jax(layer, tmp_path):
    """From one torchvision-layout vgg16_bn state_dict (a .pth file): the
    port's load_torchvision_vgg and the JAX package's, carried by
    from_jax_variables, give the same tensors (equal, float32), and the
    port's trunk loads them strictly; `load_torchvision_backbone`
    dispatches the VGG names to it."""
    sd = _torchvision_vgg("vgg16", np.random.default_rng(5))
    path = tmp_path / "vgg16_bn.pth"
    torch.save(sd, path)
    got = load_torchvision_vgg(str(path), "vgg16", layer)
    want = from_jax_variables(*jax_load_vgg(str(path), "vgg16", layer))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert ("fc7.weight" in got) == (layer == "fc7")
    trunk = make_backbone("vgg16", layer, image_size=32)
    trunk.load_state_dict(got)
    assert torch.equal(trunk.conv12.bias, sd["features.40.bias"])
    assert torch.equal(trunk.fc6.weight, sd["classifier.0.weight"])
    for k, v in load_torchvision_backbone(sd, "vgg16", layer).items():
        assert torch.equal(v, got[k]), k


# --- the label-concat models ----------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_label_concat_models_match_jax(x64, kind):
    """Each label-concat model (ResNet18 to layer2, 5 classes) in eval and
    train mode from the same weights, float64: outputs within rtol 1e-8 /
    atol 1e-10 of JAX's, the updated running statistics too; the heads take
    N0 + num_classes = 133 inputs (the features and the one-hot label)."""
    small = dict(SMALL, N0=128)
    model, jmodel, apply_fn, variables, _ = _pair(KINDS[kind], small)
    head = next(m for m in model.modules() if isinstance(m, nn.Linear))
    assert head.in_features == 128 + 5
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 32, 32, 3))
    labels = np.array([0, 4, 2, 1, 4, 3], np.int32)
    for train in (False, True):
        jout = apply_fn(variables, jnp.asarray(x), jnp.asarray(labels), train)
        if train:
            jout, mut = jout
        model.train(train)
        with torch.no_grad():
            out = model(torch.from_numpy(x), torch.from_numpy(labels).long())
        for g, w in zip(_outs(out), _outs(jout), strict=True):
            assert g.dtype == torch.float64 and g.shape == w.shape
            np.testing.assert_allclose(_np(g), _np(w), rtol=1e-8, atol=1e-10)
        if train:
            stats = jax.device_get(mut["batch_stats"])
            for k, v in model.state_dict().items():
                if "running" in k:
                    np.testing.assert_allclose(_np(v), _jax_leaf(stats, k), rtol=1e-8,
                                               atol=1e-10, err_msg=k)


# --- objectnet_quat -------------------------------------------------------------------


def test_objectnet_quat_problem_matches_jax(x64):
    """The fixed dictionary equals JAX's within 1e-7 (16 unit atoms in its
    order); from 64 float64 quaternions, the bins (argmax |<atom, q>|),
    residuals q - atom (R^4), the warm-up and main losses and the
    renormalized decode equal JAX's (bins exactly, the rest within 1e-12);
    the problem takes no fitted dictionary."""
    atoms = objectnet_quaternion_dictionary()
    np.testing.assert_allclose(atoms, np.asarray(jax_quat_dictionary()), rtol=0, atol=1e-7)
    assert atoms.shape == (16, 4) and atoms.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(atoms, axis=1), 1.0, atol=1e-7)
    rng = np.random.default_rng(6)
    q = rng.standard_normal((64, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    scores = rng.standard_normal((64, 16))
    residual = 0.1 * rng.standard_normal((64, 4))
    port = make_problem("objectnet_quat", None, "cpu")
    ref = jax_make_problem("objectnet_quat", None)
    assert port.ydata_type == ref.ydata_type == "quaternion"
    tg, jtg = port.targets(torch.from_numpy(q)), ref.targets(jnp.asarray(q))
    np.testing.assert_array_equal(_np(tg["bins"]), np.asarray(jtg["bins"]))
    np.testing.assert_allclose(_np(tg["res"]), np.asarray(jtg["res"]), rtol=0, atol=1e-12)
    out = (torch.from_numpy(scores), torch.from_numpy(residual))
    jout = (jnp.asarray(scores), jnp.asarray(residual))
    for phase in ("warmup_losses", "main_losses"):
        for g, w in zip(getattr(port, phase)(out, tg), getattr(ref, phase)(jout, jtg)):
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-12, err_msg=phase)
    dec = _np(port.decode(out))
    np.testing.assert_allclose(dec, np.asarray(ref.decode(jout)), rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.linalg.norm(dec, axis=1), 1.0, atol=1e-12)
    assert build_problem(get_config("objectnet_quat"), None, "cpu").name == "objectnet_quat"


# --- one step of each objectnet preset ------------------------------------------------


@pytest.fixture(scope="module")
def flat_batch(tmp_path_factory):
    """One batch of 12 from the flat loader over a 5-class 32 px tree."""
    root = tmp_path_factory.mktemp("objectnet_flat")
    generate_pose_dataset(root / "train", CLASSES, 3, 32, seed=2, pattern="pose")
    index = FlatTestIndex(str(root / "train"), classes=CLASSES)
    batch = next(iter(FlatLoader(index, batch_size=12, image_size=32, num_workers=1, seed=0)))
    return [batch]


@pytest.mark.parametrize("preset", OBJECTNET)
def test_objectnet_preset_step_matches_jax(x64, preset, flat_batch):
    """Trainer.fit of one main step, single flat loader, float64, from the
    same weights (the JAX init with random BN statistics) and the same
    batch, against the JAX Trainer.fit: loss, lc, lr, s and alpha within
    rtol 1e-5 (s within 1e-6 absolute), the parameters within 0.1 of a
    learning rate and the running statistics within rtol 1e-5 / atol 1e-7,
    the tolerances of test_torch_port_zoo_fit.py; the preset's fields equal
    the JAX preset's."""
    small = _small(preset)
    over = dict(num_warmup_epochs=0, num_epochs=1)
    dictionary = None if preset in ("objectnet_quat", "objectnet_regression") else _centers()
    jcfg = jax_get_config(preset, **small, **over, stem_pool=None, fused_conv_bn=None)
    jtrainer = JaxTrainer(jcfg, dictionary=dictionary, mesh=make_mesh(jax.devices("cpu")[:1]))
    init = jax.device_get(jtrainer.init_state())
    stats = randomize_batch_stats(init.batch_stats, np.random.default_rng(1))
    jrecs = []
    jtrainer._log = jrecs.append
    jfinal = jtrainer.fit(create_train_state(
        {"params": _f64(init.params), "batch_stats": _f64(stats)}, jtrainer.tx),
        flat_batch, None)
    jsteps = [r for r in jrecs if "loss" in r]

    cfg = get_config(preset, **small, **over)
    port = Trainer(cfg, dictionary=dictionary, device="cpu")
    port.model.load_state_dict(_port_sd(init.params, stats))
    port.fit(port.init_state(), flat_batch, None, log_every=1)
    hist = port.history
    assert len(hist) == len(jsteps) == 1
    for k in KEYS:
        rtol, atol = (0, 1e-6) if k == "s" else (1e-5, 1e-12)
        np.testing.assert_allclose(hist[0][k], jsteps[0][k], rtol=rtol, atol=atol, err_msg=k)
    want = jax.device_get((jfinal.params, jfinal.batch_stats))
    for k, v in port.model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == 1, k
            continue
        w = _jax_leaf(want[1] if "running" in k else want[0], k)
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), w, rtol=1e-5, atol=1e-7, err_msg=k)
        else:
            assert np.abs(v.numpy() - w).max() <= 0.1 * cfg.init_lr, k
    ref = jax_get_config(preset)
    for f in get_config(preset).__dataclass_fields__:
        if f not in ("stem_pool", "fused_conv_bn"):
            assert getattr(get_config(preset), f) == getattr(ref, f), f


# --- reference checkpoints ------------------------------------------------------------

# one preset of each family load_reference_bd_checkpoint takes
FAMILIES = {
    "one_bin_delta": "geodesic_bd", "one_delta_per_bin": "geodesic_bd_multires",
    "probabilistic": "probabilistic_bd_multires", "labelconcat_bd": "objectnet_bd",
    "labelconcat_delta_per_bin": "objectnet_bd_multires",
    "labelconcat_regression": "objectnet_regression",
    "labelconcat_classification": "objectnet_classification",
    "independent_bd": "independent_bd", "independent_regression": "independent_regression",
    "per_class_regression": "geodesic_regression",
    "per_class_classification": "classification", "elhoseiny_bd": "elhoseiny_bd",
    "elhoseiny_reg": "elhoseiny_regression", "categorization": "categorization",
    "joint_bd_v1": "joint_cat_pose_top1", "joint_bd_v1_multires": "joint_cat_pose_top1",
    "joint_reg_v3": "joint_cat_pose3_top1",
}
# the reference's positions of the trunk's torchvision children (featureModels.py:34)
_SEQ = {"conv1": "0", "bn1": "1"} | {f"layer{s}": str(3 + s) for s in range(1, 5)}
# the reference's bare nn.Linear heads, by the port's one-layer SharedMLP
_LINEAR = {"category_model": {"categorization": "fc"}, "fc": {}}


def _reference_layout(model: nn.Module, kind: str, trunk: bool = True) -> dict:
    """A reference model.state_dict() for the port model's structure, with
    seeded numpy values: positional trunk keys, one module per head of each
    bank (`name.<i>.fc<l>.weight` (O, I), ...), bare nn.Linear category
    heads."""
    rng = np.random.default_rng(8)
    sd = {}
    for k, v in model.state_dict().items():
        a = rng.standard_normal(tuple(v.shape)).astype(np.float32)
        if k.endswith("num_batches_tracked"):
            continue
        top, _, rest = k.partition(".")
        if top == "feature_model" and not trunk:
            continue
        if top == "feature_model":
            head, _, tail = rest.partition(".")
            if head.startswith("layer"):
                stage, _, block = head.partition("_")
                tail = tail.replace("downsample_conv", "downsample.0").replace(
                    "downsample_bn", "downsample.1")
                sd[f"feature_model.features.{_SEQ[stage]}.{block}.{tail}"] = a
            else:
                sd[f"feature_model.features.{_SEQ[head]}.{tail}"] = a
        elif top in _LINEAR and rest.startswith("fc1."):
            sd[f"{_LINEAR[top].get(kind, top)}.{rest[4:]}"] = a
        elif rest.split(".")[0].endswith(("_kernel", "_bias")):
            # a head bank's fc<l>_kernel (H, I, O) / fc<l>_bias (H, O)
            layer, leaf = rest.split("_")
            for i in range(v.shape[0]):
                sd[f"{top}.{i}.{layer}.{'weight' if leaf == 'kernel' else 'bias'}"] = (
                    a[i].T if leaf == "kernel" else a[i])
        elif rest.startswith("bn") and v.ndim == 2:
            # a head bank's per-(head, feature) BN leaves (H, F)
            for i in range(v.shape[0]):
                sd[f"{top}.{i}.{rest}"] = np.abs(a[i]) if "var" in rest else a[i]
        else:
            sd[k] = np.abs(a) if "running_var" in k else a
    return sd


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_load_reference_checkpoint_matches_jax(family):
    """A reference-layout state_dict of each family (ResNet18 to layer2, 3
    classes, K 4), from numpy: the port's load_reference_bd_checkpoint and
    the JAX function carried by from_jax_variables give equal tensors, which
    the port model loads strictly."""
    preset = FAMILIES[family]
    multires = family == "joint_bd_v1_multires"
    cfg = get_config(preset, **dict(SMALL, num_classes=3, dict_size=4, compute_dtype="float32"),
                     multires=multires)
    model = build_model(cfg, "cpu")
    sd = _reference_layout(model, cfg.model_kind)
    got = load_reference_bd_checkpoint(sd, cfg)
    jcfg = jax_get_config(preset, **dict(SMALL, num_classes=3, dict_size=4),
                          multires=multires)
    want_vars = jax_load_reference(sd, jcfg)
    want = from_jax_variables(want_vars["params"], want_vars["batch_stats"])
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    model.load_state_dict(got)


def test_load_reference_checkpoint_reads_a_vgg_trunk():
    """A VGG-trunk reference checkpoint (the wrapper's named `features` /
    `classifier` submodules) loads: the trunk equals load_torchvision_vgg
    of the same keys. The JAX function maps `features.0`, `.1` and `.4`-`.7`
    as ResNet positions and fails on it with a KeyError."""
    cfg = get_config("objectnet_bd", **dict(SMALL, feature_network="vgg13",
                                             feature_layer="fc6", N0=4096, dict_size=4,
                                             compute_dtype="float32"))
    model = build_model(cfg, "cpu")
    trunk = _torchvision_vgg("vgg13", np.random.default_rng(9))
    heads = _reference_layout(model, cfg.model_kind, trunk=False)
    sd = {**{f"feature_model.{k}": v for k, v in trunk.items()}, **heads}
    got = load_reference_bd_checkpoint(sd, cfg)
    for k, v in load_torchvision_vgg(trunk, "vgg13", "fc6").items():
        assert torch.equal(got[f"feature_model.{k}"], v), k
    model.load_state_dict(got)
    with pytest.raises(KeyError):
        jax_load_reference(sd, jax_get_config("objectnet_bd", feature_network="vgg13",
                                              feature_layer="fc6", dict_size=4))


# --- serving, presets, the command line -----------------------------------------------


def test_serving_takes_any_trunk():
    """make_inference_fn serves a VGG-trunk label-concat model (it took its
    compute dtype from the first ResNet trunk, which a VGG model has none
    of): float32 poses of (B, 3), the labels fed as one-hot features (two
    labels give two poses from one image), equal to the eval step's."""
    cfg = get_config("objectnet_bd", **dict(SMALL, feature_network="vgg13",
                                             feature_layer="fc6", N0=4096,
                                             compute_dtype="float32"))
    model = build_model(cfg, "cpu")
    _random_stats(model, np.random.default_rng(2))
    problem = build_problem(cfg, _centers(), "cpu")
    infer = make_inference_fn(model, problem)
    x = np.random.default_rng(3).integers(0, 256, (1, 32, 32, 3), np.uint8)
    x = np.repeat(x, 2, axis=0)
    poses = infer(x, np.array([0, 4], np.int32))
    assert poses.dtype == torch.float32 and poses.shape == (2, 3)
    assert not torch.equal(poses[0], poses[1])
    np.testing.assert_array_equal(_np(infer(x[:1], np.array([4], np.int32)))[0],
                                  _np(poses[1]))


def test_all_presets_and_trunks_build():
    """get_config builds all 42 of the JAX package's presets, with no
    refused field left; the label-concat kinds and the VGG trunks build."""
    from multi_modal_regression_tpu.train.presets import PRESETS as JAX_PRESETS

    assert sorted(PRESETS) == sorted(JAX_PRESETS) and len(PRESETS) == 42
    for preset in PRESETS:
        get_config(preset)
    cfg = get_config("objectnet_bd", remat="stage", train_flip=True, device_resize_from=256)
    assert (cfg.remat, cfg.train_flip, cfg.device_resize_from) == ("stage", True, 256)
    with pytest.raises(ValueError, match="remat"):
        get_config("objectnet_bd", remat="everything")
    with pytest.raises(ValueError, match="stem_pool"):
        make_backbone("vgg16", "fc6", stem_pool="kernel")
    with pytest.raises(ValueError, match="fc6"):
        make_backbone("vgg16", "layer4")


@pytest.fixture(scope="module")
def objectnet_tree(tmp_path_factory):
    """`cli prepare-data --dataset objectnet3d` over a synthesized release
    (3 classes), and a K 8 dictionary."""
    from multi_modal_regression_tpu_torch.dictionary.kmeans import KMeansDictionary

    root = tmp_path_factory.mktemp("objectnet_cli")
    release = generate_objectnet3d_release(root / "release")
    assert cli.main(["prepare-data", "--dataset", "objectnet3d", "--db-path", str(release),
                     "--out", str(root / "data"), "--workers", "2"]) == 0
    KMeansDictionary(cluster_centers=_centers()).save(root / "kmeans.npz")
    return root


@pytest.mark.parametrize("extra", [
    ["--device-resize-from", "40", "--train-flip", "--remat", "block"],
    ["--feature-network", "vgg13", "--feature-layer", "fc6"],
], ids=["resize-flip-remat", "vgg13"])
def test_cli_trains_objectnet_bd(objectnet_tree, extra, capsys):
    """`cli train --preset objectnet_bd --device cpu` over the prepared tree
    (the flat protocol by default, 3 classes from its dbinfo.mat), 1 warm-up
    + 1 main epoch of 2 steps: exit 0, a finite final MedErr, the flags in
    the checkpoint's config; on a VGG13 trunk N0 defaults to its 4096."""
    root = objectnet_tree
    work = root / ("run_" + extra[1])
    args = ["train", "--preset", "objectnet_bd", "--data-root", str(root / "data"),
            "--dbinfo", str(root / "data" / "dbinfo.mat"), "--dictionary",
            str(root / "kmeans.npz"), "--feature-network", "resnet18", "--feature-layer",
            "layer2", "--N0", "128", "--N1", "16", "--N2", "8", "--image-size", "32",
            "--items-per-batch", "1", "--num-warmup-epochs", "1", "--num-epochs", "1",
            "--max-iterations", "2", "--num-workers", "2", "--compute-dtype", "float32",
            "--workdir", str(work), "--device", "cpu"]
    if "vgg13" in extra:
        drop = args.index("--feature-network")
        del args[drop:drop + 6]  # the ResNet trunk and its N0
    assert cli.main(args + extra) == 0
    med = float(capsys.readouterr().out.split("final MedErr ")[1].split()[0])
    assert np.isfinite(med)
    ck = torch.load(work / "checkpoints" / "final", weights_only=True)
    c = ck["config"]
    assert ck["step"] in (2, 4) and c["num_classes"] == 3 and c["model_kind"] == "labelconcat_bd"
    if "vgg13" in extra:
        assert (c["feature_network"], c["N0"]) == ("vgg13", 4096)
    else:
        assert (c["device_resize_from"], c["train_flip"], c["remat"]) == (40, True, "block")
        assert ck["rng"] is not None
