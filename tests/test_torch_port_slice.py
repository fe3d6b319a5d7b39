"""The PyTorch port's geodesic_bd serving slice vs the JAX package, on CPU.

One small JAX Trainer (ResNet50 to layer4 at 32 px, 3 classes, N1 16, N2 8,
K 8, float32) is built per module; its weights, with randomized BN running
statistics, cross to the port through `from_jax_variables`, and its
dictionary through a `.npz` file written by the JAX package. The same
numpy-seeded batches then go through both sides. Each test states its
tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_regression_tpu.dictionary.kmeans import (
    KMeansDictionary as JaxKMeansDictionary,
)
from multi_modal_regression_tpu.data.targets import euler_to_pose as jax_euler_to_pose
from multi_modal_regression_tpu.models.heads import select_class as jax_select_class
from multi_modal_regression_tpu.serving import make_inference_fn as jax_make_inference_fn
from multi_modal_regression_tpu.train import Trainer
from multi_modal_regression_tpu.train import get_config as jax_get_config
from multi_modal_regression_tpu.train.presets import build_model as jax_build_model
from multi_modal_regression_tpu_torch.dictionary.kmeans import KMeansDictionary
from multi_modal_regression_tpu_torch.models.backbones import make_backbone
from multi_modal_regression_tpu_torch.models.pretrained import from_jax_variables
from multi_modal_regression_tpu_torch.ops import preprocess, stem_pool
from multi_modal_regression_tpu_torch.serving import make_inference_fn
from multi_modal_regression_tpu_torch.train.presets import (
    build_model,
    build_problem,
    get_config,
)
from multi_modal_regression_tpu_torch.train.steps import make_eval_step

from test_torch_port_ops import one_torch_thread, randomize_batch_stats  # noqa: F401

SMALL = dict(
    feature_network="resnet50", feature_layer="layer4", num_classes=3,
    N0=2048, N1=16, N2=8, dict_size=8, image_size=32,
)
BATCH = 4


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """(trainer, state with random BN stats, path of the JAX-written .npz)."""
    rng = np.random.default_rng(0)
    centers = (0.7 * rng.standard_normal((8, 3))).astype(np.float32)
    path = tmp_path_factory.mktemp("dict") / "kmeans.npz"
    JaxKMeansDictionary(cluster_centers=centers).save(path)
    cfg = jax_get_config("geodesic_bd", **SMALL)
    trainer = Trainer(cfg, dictionary=JaxKMeansDictionary.load(path))
    state = trainer.init_state()
    state = state.replace(batch_stats=randomize_batch_stats(state.batch_stats, rng))
    return trainer, state, path


def _port_model(jax_side, **overrides):
    trainer, state, _ = jax_side
    cfg = get_config("geodesic_bd", **SMALL, **overrides)
    model = build_model(cfg, "cpu")
    model.load_state_dict(
        from_jax_variables(jax.device_get(state.params), state.batch_stats)
    )
    return cfg, model


def _jax_forward(model, variables, x, label):
    """Eval-mode (features, scores, residual) of a JAX OneBinDeltaModel."""

    def fwd(m, x, label):
        feat = m.feature_model(x, train=False)
        scores = jax_select_class(m.bin_models(feat, train=False), label)
        residual = jax_select_class(m.res_models(feat, train=False), label)
        return feat, scores, residual

    return jax.jit(lambda v, x, l: model.apply(v, x, l, method=fwd))(
        variables, x, label
    )


def _batch(seed, b=BATCH):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (b, 32, 32, 3), np.uint8)
    labels = (np.arange(b) % 3).astype(np.int32)
    euler = np.stack([
        rng.uniform(-180, 180, b), rng.uniform(-90, 90, b), rng.uniform(-180, 180, b)
    ], axis=1).astype(np.float32)
    return images, labels, euler


@pytest.mark.parametrize("stem", [(None, None), ("plain", "xla")], ids=["flax_stem", "folded_stem"])
def test_model_matches_jax(jax_side, stem):
    """Backbone features, scores and residual of the converted port model vs
    the JAX model in eval mode; f32, rtol 1e-4, atol 1e-5. The port's
    stem_pool None / 'plain' is held against JAX's None / 'xla'."""
    port_stem, jax_stem = stem
    trainer, state, _ = jax_side
    jmodel = jax_build_model(trainer.config.replace(stem_pool=jax_stem))
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    rng = np.random.default_rng(1)
    x = rng.standard_normal((BATCH, 32, 32, 3)).astype(np.float32)
    label = np.array([0, 2, 1, 2], np.int32)
    want = _jax_forward(jmodel, variables, jnp.asarray(x), jnp.asarray(label))
    _, model = _port_model(jax_side, stem_pool=port_stem)
    with torch.no_grad():
        xt, lt = torch.from_numpy(x), torch.from_numpy(label)
        got = (model.feature_model(xt),) + model(xt, lt)
    for name, g, w in zip(("features", "scores", "residual"), got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(
            g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5, err_msg=name
        )


def test_stem_kernel_setting_equals_plain_on_cpu(jax_side):
    """stem_pool='kernel' on CPU tensors takes the plain stem: same bits as
    'plain', and no kernel launch is counted."""
    _, plain = _port_model(jax_side, stem_pool="plain")
    _, kernel = _port_model(jax_side, stem_pool="kernel")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(plain.feature_model(x), kernel.feature_model(x))
    assert stem_pool.launches == 0


def test_slice_matches_jax_serving(jax_side):
    """JAX serving.make_inference_fn vs the port's make_inference_fn on the
    same uint8 batch (dictionary read from the JAX-written .npz): poses
    within 1e-4 wherever the top-2 bin-score margin exceeds 1e-3 (below it
    the argmax may flip on rounding), and the eval step's ytrue within 1e-5."""
    trainer, state, path = jax_side
    images, labels, euler = _batch(3, b=8)
    want = np.asarray(jax.jit(jax_make_inference_fn(trainer, state))(images, labels))

    cfg, model = _port_model(jax_side)
    problem = build_problem(cfg, KMeansDictionary.load(path), "cpu")
    got = make_inference_fn(model, problem)(images, labels)
    assert got.shape == (8, 3) and got.dtype == torch.float32
    assert preprocess.launches == 0
    with torch.no_grad():
        scores, _ = model(
            preprocess.normalize_images_cuda(torch.from_numpy(images)),
            torch.from_numpy(labels),
        )
    top2 = torch.topk(scores, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]).numpy() > 1e-3
    assert clear.sum() >= 4
    np.testing.assert_allclose(got.numpy()[clear], want[clear], rtol=0, atol=1e-4)

    batch = {
        "xdata": torch.from_numpy(images), "label": torch.from_numpy(labels),
        "euler": torch.from_numpy(euler),
    }
    ypred, ytrue = make_eval_step(model, problem)(batch)
    assert torch.equal(ypred, got)
    np.testing.assert_allclose(
        ytrue.numpy(), np.asarray(jax_euler_to_pose(jnp.asarray(euler))),
        rtol=0, atol=1e-5,
    )


def test_bf16_slice_runs_on_cpu(jax_side):
    """The bfloat16 serving configuration (stem kernel setting, weights in
    bf16, BN in f32) gives finite float32 poses of the right shape, within
    0.1 of the float32 port on the rows whose float32 top-2 margin exceeds
    0.1 (bf16 keeps ~3 significant digits through 50 layers)."""
    _, path = jax_side[0], jax_side[2]
    images, labels, _ = _batch(4)
    dictionary = KMeansDictionary.load(path)
    cfg32, m32 = _port_model(jax_side)
    cfg16, m16 = _port_model(jax_side, compute_dtype="bfloat16", stem_pool="kernel")
    assert m16.feature_model.conv1.weight.dtype == torch.bfloat16
    assert m16.feature_model.bn1.running_var.dtype == torch.float32
    p32 = make_inference_fn(m32, build_problem(cfg32, dictionary, "cpu"))(images, labels)
    p16 = make_inference_fn(m16, build_problem(cfg16, dictionary, "cpu"))(images, labels)
    assert p16.shape == (BATCH, 3) and p16.dtype == torch.float32
    assert torch.isfinite(p16).all()
    with torch.no_grad():
        scores, _ = m32(
            preprocess.normalize_images_cuda(torch.from_numpy(images)),
            torch.from_numpy(labels),
        )
    top2 = torch.topk(scores, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 0.1
    np.testing.assert_allclose(p16[clear].numpy(), p32[clear].numpy(), atol=0.1)


def test_inputs_outside_the_contract_raise(jax_side):
    cfg, model = _port_model(jax_side)
    problem = build_problem(cfg, np.zeros((8, 3), np.float32), "cpu")
    infer = make_inference_fn(model, problem)
    images, labels, _ = _batch(5)
    with pytest.raises(ValueError, match="labels must be in"):
        infer(images, labels + 1)
    with pytest.raises(TypeError):
        infer(images, labels.astype(np.float32))
    with pytest.raises(ValueError):
        infer(images, labels[:2])
    with pytest.raises(NotImplementedError, match="augment"):
        make_eval_step(model, problem, resize_to=64)
    with pytest.raises(ValueError, match="dictionary"):
        build_problem(cfg, np.zeros((5, 3), np.float32), "cpu")
    # eval is eval whatever mode the module was left in (the JAX eval step
    # always applies with train=False): a model in train mode serves the
    # eval-mode poses, updates no running statistic, and stays in train mode
    want = infer(images, labels)
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if "running" in k or "num_batches" in k}
    model.train()
    model.bin_models.eval()  # a mixed mode is restored module by module
    got = infer(images, labels)
    assert torch.equal(got, want)
    for k, v in model.state_dict().items():
        if k in stats:
            assert torch.equal(v, stats[k]), k
    assert model.training and model.feature_model.bn1.training
    assert not model.bin_models.training and not model.bin_models.bn1.training


def test_presets_and_backbones_not_yet_ported_raise():
    cfg = get_config("geodesic_bd")
    assert (cfg.feature_network, cfg.feature_layer, cfg.N0, cfg.N1, cfg.N2,
            cfg.dict_size, cfg.num_classes, cfg.image_size) == (
        "resnet50", "layer4", 2048, 1000, 500, 200, 12, 224)
    for preset in ("simple_bd_rene", "joint_cat_pose_top1", "objectnet_quat"):
        with pytest.raises(ValueError, match="ROADMAP.md"):
            get_config(preset)
    with pytest.raises(ValueError, match="ROADMAP.md"):
        make_backbone("vgg16", "fc6")
    with pytest.raises(ValueError, match="stem_pool"):
        make_backbone("resnet50", "layer4", stem_pool="pallas")
