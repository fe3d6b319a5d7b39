"""The PyTorch port's on-device resize and flip (ops/augment), its train-step
flips and their generator, and remat (train/remat) vs the JAX package, on
CPU.

Resize and flip are held to the JAX functions on numpy-seeded inputs; a
train step and an eval step with `device_resize_from` and an injected flip
mask to the JAX Trainer's in float64 (the mask patched into
`jax.random.bernoulli` on the JAX side and `steps.flip_mask` on the port's;
nothing in the JAX package changes); a resumed run to an unbroken one; and
each remat mode's step to the same step without remat. The models run at
ResNet18 to layer2 (N0 128, N1 16, N2 8, K 8, 3 classes, 32 px). Each test
states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_regression_tpu.ops import augment as jax_augment
from multi_modal_regression_tpu.parallel.mesh import make_mesh
from multi_modal_regression_tpu.train import Trainer as JaxTrainer
from multi_modal_regression_tpu.train import get_config as jax_get_config
from multi_modal_regression_tpu.train.state import create_train_state
from multi_modal_regression_tpu_torch.ops import augment
from multi_modal_regression_tpu_torch.train import steps
from multi_modal_regression_tpu_torch.train.presets import get_config
from multi_modal_regression_tpu_torch.train.remat import REMAT_MODES
from multi_modal_regression_tpu_torch.train.trainer import Trainer

from test_torch_port_ops import one_torch_thread, randomize_batch_stats  # noqa: F401
from test_torch_port_train import _f64, _port_sd, x64  # noqa: F401
from test_torch_port_zoo_models import _jax_leaf

SMALL = dict(
    feature_network="resnet18", feature_layer="layer2", N0=128, N1=16, N2=8, N3=4,
    dict_size=8, num_classes=3, image_size=32, items_per_batch=2, max_iterations=1,
)
KEYS = ("loss", "lc", "lr", "s", "alpha")


def _centers() -> np.ndarray:
    return (0.7 * np.random.default_rng(0).standard_normal((8, 3))).astype(np.float32)


def _batches(seed: int, size: int, n: int = 6, count: int = 1) -> list[dict]:
    """Loader-style batches of n images at `size` px, 3 classes."""
    rng = np.random.default_rng(seed)
    return [{
        "xdata": rng.integers(0, 256, (n, size, size, 3), np.uint8),
        "euler": np.stack([rng.uniform(-180, 180, n), rng.uniform(-60, 60, n),
                           rng.uniform(-30, 30, n)], axis=1).astype(np.float32),
        "label": (np.arange(n) % 3).astype(np.int32),
    } for _ in range(count)]


# --- resize and flip ------------------------------------------------------------------


@pytest.mark.parametrize("n_in,n_out", [(64, 32), (40, 32), (32, 32), (24, 32), (256, 224),
                                        (17, 5)])
def test_resize_matrix_is_the_jax_one(n_in, n_out):
    """PIL's antialiased BILINEAR weights, bit-equal to the JAX package's
    (the same float64 construction cast to float32); rows sum to 1."""
    got = augment._resize_matrix(n_in, n_out)
    want = jax_augment._resize_matrix(n_in, n_out)
    assert got.dtype == want.dtype == np.float32 and got.shape == (n_out, n_in)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-6)


def test_resize_flip_and_preprocess_match_jax():
    """resize_images on uint8 and on float (4, 40, 36, 3) -> (32, 32) within
    1e-3 of JAX's on the 0..255 scale; flip_images and flip_pose_euler
    exactly; device_preprocess (resize -> flip -> normalize, float32 and
    bfloat16 out) within 1e-5 (bfloat16: one ulp) of JAX's, and without
    out_size or flip it is the plain normalize."""
    rng = np.random.default_rng(11)
    x = rng.integers(0, 256, (4, 40, 36, 3), np.uint8)
    flip = np.array([True, False, True, False])
    for inp in (x, x.astype(np.float32) + 0.25):
        got = augment.resize_images(torch.from_numpy(inp), 32, 32)
        want = jax_augment.resize_images(jnp.asarray(inp), 32, 32)
        assert got.dtype == torch.float32 and got.shape == (4, 32, 32, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)
    tf = torch.from_numpy(flip)
    np.testing.assert_array_equal(
        augment.flip_images(torch.from_numpy(x), tf).numpy(),
        np.asarray(jax_augment.flip_images(jnp.asarray(x), jnp.asarray(flip))))
    euler = rng.uniform(-180, 180, (4, 3)).astype(np.float32)
    got = augment.flip_pose_euler(torch.from_numpy(euler), tf).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_augment.flip_pose_euler(jnp.asarray(euler), jnp.asarray(flip))))
    np.testing.assert_array_equal(got[0], euler[0] * np.array([-1, 1, -1], np.float32))
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = augment.device_preprocess(torch.from_numpy(x), 32, tf, dtype)
        want = np.asarray(jax_augment.device_preprocess(jnp.asarray(x), 32, jnp.asarray(flip),
                                                         jdtype), np.float32)
        tol = 1e-5 if dtype == torch.float32 else 2 ** -7 * np.abs(want).max()
        assert got.dtype == dtype
        np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-5, atol=tol)
    same = augment.device_preprocess(torch.from_numpy(x[:, :32, :32]), 32)
    np.testing.assert_array_equal(same.numpy(),
                                  steps.normalize_images_cuda(torch.from_numpy(
                                      np.ascontiguousarray(x[:, :32, :32]))).numpy())


# --- the steps against JAX ------------------------------------------------------------


def test_resize_and_flip_steps_match_jax(x64, monkeypatch):
    """geodesic_bd with device_resize_from 16 and train_flip, dual loaders of
    16 px images resized to 32 px in the step, one warm-up step from the
    same weights with the same flip mask on both sides (injected), float64:
    the step's metrics within rtol 1e-5 (s within 1e-6), the parameters
    within 0.1 of a learning rate and the running statistics within rtol
    1e-5 / atol 1e-7 of the JAX Trainer's (the tolerances of
    test_torch_port_zoo_fit.py); then the eval step over 16 px test images
    (resized on the device) gives poses within rtol 1e-6 of JAX's (the
    Euler angles' poses, ytrue, within 1e-6). The 2x
    upscale's weights are 1/4 and 3/4 (1 at the border), so both sides'
    float32 resize is exact: a downscale's float32 sums round in each
    library's order, and Adam's first step turns a near-zero gradient's
    rounding into a whole learning rate."""
    mask = np.array([True, False, False, True, True, False, False, True, False, True,
                     True, False])
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(mask))
    drawn = []

    def fixed(rng, n, device):
        drawn.append(n)
        return torch.from_numpy(mask).to(device)

    monkeypatch.setattr(steps, "flip_mask", fixed)
    over = dict(SMALL, compute_dtype="float64", optimizer_dtype="float32",
                device_resize_from=16, train_flip=True, num_warmup_epochs=1, num_epochs=0)
    jtrainer = JaxTrainer(jax_get_config("geodesic_bd", **over, stem_pool=None,
                                         fused_conv_bn=None),
                          dictionary=_centers(), mesh=make_mesh(jax.devices("cpu")[:1]))
    init = jax.device_get(jtrainer.init_state())
    stats = randomize_batch_stats(init.batch_stats, np.random.default_rng(1))
    jrecs = []
    jtrainer._log = jrecs.append
    real, render = _batches(1, 16), _batches(2, 16)
    jfinal = jtrainer.fit(create_train_state(
        {"params": _f64(init.params), "batch_stats": _f64(stats)}, jtrainer.tx), real, render)
    jstep = [r for r in jrecs if "loss" in r]

    port = Trainer(get_config("geodesic_bd", **over), dictionary=_centers(), device="cpu")
    port.model.load_state_dict(_port_sd(init.params, stats))
    final = port.fit(port.init_state(), real, render, log_every=1)
    assert drawn == [12] and len(port.history) == len(jstep) == 1
    for k in KEYS:
        rtol, atol = (0, 1e-6) if k == "s" else (1e-5, 1e-12)
        np.testing.assert_allclose(port.history[0][k], jstep[0][k], rtol=rtol, atol=atol,
                                   err_msg=k)
    want = jax.device_get((jfinal.params, jfinal.batch_stats))
    for k, v in port.model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        w = _jax_leaf(want[1] if "running" in k else want[0], k)
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), w, rtol=1e-5, atol=1e-7, err_msg=k)
        else:
            assert np.abs(v.numpy() - w).max() <= 0.1 * 1e-4, k
    def test():  # the JAX predict takes `valid` out of its batches
        return [dict(b, valid=np.ones(6, bool)) for b in _batches(3, 16)]

    jtrue, jpred, _ = jtrainer.predict(jfinal, test())
    ytrue, ypred, _ = port.predict(final, test())
    # ytrue: float32 Euler angles to poses in float32 on both sides, where
    # the two libraries' sin and cos differ by an ulp
    np.testing.assert_allclose(ytrue, jtrue, rtol=0, atol=1e-6)
    # ypred: from parameters within 0.1 lr of each other after the step
    np.testing.assert_allclose(ypred, jpred, rtol=1e-6, atol=1e-9)


# --- the flip generator ---------------------------------------------------------------


def test_flip_masks_resume_bit_equal(tmp_path, monkeypatch):
    """train_flip draws its masks from the state's generator, seeded from
    cfg.seed: a run resumed from its `last` checkpoint after one main epoch
    draws the masks of the unbroken run's second epoch and ends with the
    same weights, bit for bit; a checkpoint written before the state
    carried the generator restores with a fresh one seeded from cfg.seed;
    a state without a generator is refused."""
    masks = []
    orig = steps.flip_mask
    monkeypatch.setattr(steps, "flip_mask",
                        lambda rng, n, device: masks.append(orig(rng, n, device)) or masks[-1])
    # fixed loss weights: `fit` starts a phase at s = 0, so a self-balanced
    # run would not resume bit-equal mid-phase
    cfg = get_config("geodesic_bd", **SMALL, train_flip=True, num_warmup_epochs=0,
                     num_epochs=2, checkpoint_async=False, compute_dtype="float32",
                     self_balance=False)
    real, render = _batches(4, 32, count=1), _batches(5, 32, count=1)
    whole = Trainer(cfg, dictionary=_centers(), device="cpu")
    init = {k: v.clone() for k, v in whole.model.state_dict().items()}
    whole.fit(whole.init_state(), real, render)
    unbroken, masks[:] = list(masks), []
    first = Trainer(cfg.replace(num_epochs=1), dictionary=_centers(), workdir=tmp_path,
                    device="cpu")
    first.model.load_state_dict(init)
    first.fit(first.init_state(), real, render)
    second = Trainer(cfg.replace(num_epochs=1), dictionary=_centers(), workdir=tmp_path,
                     device="cpu")
    second.fit(second.restore_checkpoint("last"), real, render)
    assert len(unbroken) == len(masks) == 2 and not torch.equal(unbroken[0], unbroken[1])
    for a, b in zip(unbroken, masks):
        assert torch.equal(a, b)
    for k, v in whole.model.state_dict().items():
        assert torch.equal(v, second.model.state_dict()[k]), k
    path = tmp_path / "checkpoints" / "last"
    payload = torch.load(path, weights_only=True)
    del payload["rng"]
    torch.save(payload, path)
    old = second.restore_checkpoint("last")
    fresh = torch.Generator().manual_seed(cfg.seed)
    assert torch.equal(old.rng.get_state(), fresh.get_state())
    step = second.train_step_fn("main", dual_stream=True)
    with pytest.raises(ValueError, match="flip generator"):
        step(old.replace(rng=None), second._to_device(
            {**real[0], "is_real": np.ones(6, bool)}))


# --- remat ----------------------------------------------------------------------------

# (preset, mode, overrides): every mode on geodesic_bd with the folded stem
# BN ('plain' stem: its running statistics are updated by hand); one mode on
# the multires model, one on the bfloat16 fused trunk, one on a VGG trunk
# with fc7's dropout under a selective policy
REMAT_CASES = [("geodesic_bd", m, dict(stem_pool="plain")) for m in REMAT_MODES[1:]] + [
    ("geodesic_bd_multires", "stage", {}),
    ("geodesic_bd", "block", dict(feature_network="resnet50", N0=512, N1=8, N2=8,
                                  compute_dtype="bfloat16", fused_conv_bn="plain")),
    ("objectnet_bd", "conv", dict(feature_network="vgg13", feature_layer="fc7", N0=4096,
                                  num_classes=3)),
]


@pytest.mark.parametrize("preset,mode,over", REMAT_CASES,
                         ids=[f"{p}-{m}-{'-'.join(o) or 'default'}" for p, m, o in REMAT_CASES])
def test_remat_step_is_the_step(preset, mode, over):
    """One main step under each remat mode against the same step without
    remat, from the same weights and batches: the loss, lc and lr, every
    gradient the backward left on the parameters (what the recomputed
    segments feed), every parameter and running statistic equal, bit for
    bit on the CPU (the recompute replays the same ops); every BN's
    num_batches_tracked advanced by exactly one per stream (2 for the
    dual-loader presets, 1 for the single-loader ObjectNet one), so the
    replay updated no statistic; the fc7 dropout replays the forward's mask
    and the state's generator ends where the step without remat leaves it."""
    cfg = get_config(preset, **{**SMALL, **over}, num_warmup_epochs=0, num_epochs=1)
    real, render = _batches(6, 32), _batches(7, 32)
    if preset.startswith("objectnet"):  # one loader; 2 images through VGG13
        real, render = _batches(6, 32, n=2), None
    runs = []
    for remat in (None, mode):
        t = Trainer(cfg.replace(remat=remat), dictionary=_centers(), device="cpu")
        if runs:
            t.model.load_state_dict(runs[0][1])
        before = {k: v.clone() for k, v in t.model.state_dict().items()}
        state = t.fit(t.init_state(), real, render, log_every=1)
        grads = {n: p.grad for n, p in t.model.named_parameters() if p.grad is not None}
        runs.append((t, before, t.model.state_dict(), grads, state.rng.get_state()))
    (base, init, want, g0, rng0), (_, _, got, g1, rng1) = runs
    streams = 1 if render is None else 2
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
        if k.endswith("num_batches_tracked"):
            assert int(v) - int(init[k]) == streams, k
    assert g0.keys() == g1.keys() and len(g0) > 0
    for k, v in g1.items():
        assert torch.equal(v, g0[k]), k
    h0, h1 = base.history[0], runs[1][0].history[0]
    assert all(h0[k] == h1[k] for k in ("loss", "lc", "lr"))
    assert torch.equal(rng0, rng1)


def test_vgg_dropout_resume_bit_equal(tmp_path):
    """A VGG13/fc7 trunk's dropout draws from the state's generator (no
    flips here, so the dropout alone draws), so its state is in the
    checkpoint: a run that goes on from its own state after one main epoch
    and a new trainer resumed from that epoch's `last` checkpoint end with
    the same weights, bit for bit, where masks drawn again from the seed
    would differ (one learning rate for both epochs: each `fit` starts its
    epoch count at 0); a training-mode fc7 forward outside a train step has
    no generator and raises."""
    vgg = dict(feature_network="vgg13", feature_layer="fc7", N0=4096, N1=8, N2=8)
    cfg = get_config("objectnet_bd", **{**SMALL, **vgg}, num_warmup_epochs=0, num_epochs=1,
                     checkpoint_async=False, compute_dtype="float32", self_balance=False,
                     epoch_lr_decay=None)
    real = _batches(8, 32, n=2)
    whole = Trainer(cfg, dictionary=_centers(), workdir=tmp_path, device="cpu")
    state = whole.fit(whole.init_state(), real, None)
    (tmp_path / "resumed" / "checkpoints").mkdir(parents=True)
    (tmp_path / "checkpoints" / "last").rename(tmp_path / "resumed" / "checkpoints" / "last")
    whole.fit(state, real, None)
    resumed = Trainer(cfg, dictionary=_centers(), workdir=tmp_path / "resumed", device="cpu")
    resumed.fit(resumed.restore_checkpoint("last"), real, None)
    for k, v in whole.model.state_dict().items():
        assert torch.equal(v, resumed.model.state_dict()[k]), k
    trunk = resumed.model.feature_model.train()
    with pytest.raises(ValueError, match="dropout"):
        trunk(torch.zeros(1, 32, 32, 3))
