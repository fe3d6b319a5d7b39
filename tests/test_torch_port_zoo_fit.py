"""The PyTorch port's single-model zoo as a whole vs the JAX package, on
CPU: Trainer.fit of four presets against the JAX Trainer.fit in float64
(the JAX side under a scoped jax_enable_x64), and the user's commands on a
quaternion preset.

The fits run 2 steps of dual loaders (2 items a class a stream, 3 classes,
32 px) from the same weights (the JAX init with random BN statistics,
carried by `from_jax_variables`), the same dictionary and the same
numpy-seeded batches, at ResNet18 to layer2 (N0 128, N1 16, N2 8, N3 4, K
8) to keep the JAX compiles short, with Adam's moments in float64 on both
sides. Each test states its tolerance.
"""

import json

import jax
import numpy as np
import pytest
import torch

from multi_modal_regression_tpu.dictionary.gmm import GMMDictionary as JaxGMMDictionary
from multi_modal_regression_tpu.parallel.mesh import make_mesh
from multi_modal_regression_tpu.train import Trainer as JaxTrainer
from multi_modal_regression_tpu.train import get_config as jax_get_config
from multi_modal_regression_tpu.train.state import create_train_state
from multi_modal_regression_tpu_torch import PASCAL3D_CLASSES, cli
from multi_modal_regression_tpu_torch.dictionary.gmm import GMMDictionary
from multi_modal_regression_tpu_torch.dictionary.kmeans import KMeansDictionary
from multi_modal_regression_tpu_torch.metrics import mean_class_median_error
from multi_modal_regression_tpu_torch.tools.synthetic import generate_pose_dataset
from multi_modal_regression_tpu_torch.train.evaluator import ensemble_poses
from multi_modal_regression_tpu_torch.train.presets import get_config
from multi_modal_regression_tpu_torch.train.trainer import Trainer

from test_torch_port_ops import one_torch_thread, randomize_batch_stats  # noqa: F401
from test_torch_port_softbins import _gmm_arrays
from test_torch_port_train import _f64, _loader, _port_sd, x64  # noqa: F401
from test_torch_port_zoo_models import _jax_leaf

SMALL = dict(
    feature_network="resnet18", feature_layer="layer2", N0=128, N1=16, N2=8, N3=4,
    dict_size=8, num_classes=3, image_size=32, items_per_batch=2,
    compute_dtype="float64", optimizer_dtype="float32", max_iterations=1,
)
# 2 steps each: one warm-up and one main epoch, or two main epochs
FITS = {
    "riemannian_bd": dict(num_warmup_epochs=1, num_epochs=1),
    "log_euclidean_bd": dict(num_epochs=2),
    "geodesic_regression": dict(num_warmup_epochs=1, num_epochs=1),
    "probabilistic_bd_multires": dict(num_epochs=2),
}
KEYS = ("loss", "lc", "lr", "s", "alpha")


def _centers() -> np.ndarray:
    return (0.7 * np.random.default_rng(0).standard_normal((8, 3))).astype(np.float32)


def _dictionary(preset: str, jax_side: bool = False):
    if preset == "probabilistic_bd_multires":
        return (JaxGMMDictionary if jax_side else GMMDictionary)(*_gmm_arrays())
    return None if preset == "geodesic_regression" else _centers()


@pytest.mark.parametrize("preset", sorted(FITS))
def test_zoo_fit_matches_jax(x64, preset):
    """Trainer.fit against the JAX Trainer.fit: every step's loss, lc, lr,
    s and alpha within rtol 1e-5 (s, a log, within 1e-6 absolute), the
    learning rate each step ran at equal to the JAX schedule's, the final
    parameters within 0.1 of a learning rate and the running statistics
    within rtol 1e-5 / atol 1e-7. Both sides turn the loaders' float32
    Euler angles into poses in float32, where the two libraries' sin and
    cos differ by an ulp, and keep s in float32: measured 1e-8-5e-7 apart
    on the metrics (3.5e-6 on a near-zero s), 0.021 lr on the parameters,
    where Adam's first steps move elements of small gradient by about lr
    whatever their size, and 4.3e-8 on the running statistics that the
    second step's forward updates. riemannian_bd carries its warm-up s into
    the main phase (reset_s_between_phases False); geodesic_regression sums
    the two streams' losses (x2) under fixed weights, with lc = 0;
    probabilistic_bd_multires trains per-cluster deltas on a GMM."""
    overrides = FITS[preset]
    jcfg = jax_get_config(preset, **SMALL, **overrides, stem_pool=None, fused_conv_bn=None)
    jtrainer = JaxTrainer(jcfg, dictionary=_dictionary(preset, jax_side=True),
                          mesh=make_mesh(jax.devices("cpu")[:1]))
    init = jax.device_get(jtrainer.init_state())
    stats = randomize_batch_stats(init.batch_stats, np.random.default_rng(1))
    jrecs = []
    jtrainer._log = jrecs.append  # the per-step records the JAX fit logs
    real, render = _loader(9, 1), _loader(10, 1)
    jfinal = jtrainer.fit(create_train_state(
        {"params": _f64(init.params), "batch_stats": _f64(stats)}, jtrainer.tx), real, render)
    jsteps = [r for r in jrecs if "loss" in r]

    cfg = get_config(preset, **SMALL, **overrides)
    assert cfg.reset_s_between_phases == (preset != "riemannian_bd")
    port = Trainer(cfg, dictionary=_dictionary(preset), device="cpu")
    port.model.load_state_dict(_port_sd(init.params, stats))
    final = port.fit(port.init_state(), real, render, log_every=1)
    hist = port.history
    assert final.step == 2 and len(hist) == len(jsteps) == 2
    for rec, want in zip(hist, jsteps):
        assert (rec["step"], rec["phase"]) == (want["step"], want["phase"])
        for k in KEYS:
            rtol, atol = (0, 1e-6) if k == "s" else (1e-5, 1e-12)
            np.testing.assert_allclose(rec[k], want[k], rtol=rtol, atol=atol,
                                       err_msg=f"step {rec['step']} {k}")
        assert all(np.isfinite(rec[k]) for k in KEYS)
    if preset == "riemannian_bd":
        assert hist[0]["phase"] == "warmup" and hist[0]["s"] != 0.0
    if preset == "geodesic_regression":
        assert hist[1]["lc"] == 0.0 and hist[1]["lr"] > 0
    base = cfg.init_lr
    want_rates = {"riemannian_bd": [base, base], "log_euclidean_bd": [base, base],
                  "geodesic_regression": [base, base * 0.1],
                  "probabilistic_bd_multires": [base * 0.1, base * 0.01]}[preset]
    np.testing.assert_allclose([r["learning_rate"] for r in hist], want_rates, rtol=1e-12)
    sd = port.model.state_dict()
    want = jax.device_get((jfinal.params, jfinal.batch_stats))
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        w = _jax_leaf(want[1] if "running" in k else want[0], k)
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), w, rtol=1e-5, atol=1e-7, err_msg=k)
        else:
            assert np.abs(v.numpy() - w).max() <= 0.1 * base, k


@pytest.fixture(scope="module")
def quat_tree(tmp_path_factory):
    """augmented2/, renderforcnn/ (2 PNGs a class) and test/ (1 a class),
    32 px, 3 classes; a K = 8 axis-angle dictionary."""
    root = tmp_path_factory.mktemp("zoo_cli")
    for sub, n, seed in (("augmented2", 2, 1), ("renderforcnn", 2, 2), ("test", 1, 3)):
        generate_pose_dataset(root / "data" / sub, PASCAL3D_CLASSES[:3], n, 32, seed=seed,
                              pattern="pose")
    KMeansDictionary(cluster_centers=_centers()).save(root / "kmeans.npz")
    return root


def _args(cmd: str, root, preset: str, *extra: str) -> list[str]:
    dictionary = [] if preset == "geodesic_regression" else [
        "--dictionary", str(root / "kmeans.npz")]
    return [cmd, "--preset", preset, "--data-root", str(root / "data"), *dictionary,
            "--feature-network", "resnet18", "--feature-layer", "layer2", "--N0", "128",
            "--N1", "16", "--N2", "8", "--image-size", "32", "--items-per-batch", "2",
            "--num-classes", "3", "--num-workers", "2", "--compute-dtype", "float32",
            "--workdir", str(root / preset), "--device", "cpu", *extra]


def test_cli_on_a_quaternion_preset(quat_tree, capsys):
    """`cli train --preset geodesic_bd_quaternion --device cpu` (1 warm-up +
    1 main epoch of 2 steps) exits 0 with a finite final MedErr from the
    quaternion error; `cli predict` writes unit quaternions (within 1e-6)
    whose MedErr equals the train run's printed one (3 decimals);
    `cli evaluate --eval-num-epochs 1` ensembles its snapshot's quaternions
    (the ensembled MedErr recomputed from the snapshot file within 1e-6
    deg); `cli train --preset geodesic_regression` takes no dictionary."""
    preset = "geodesic_bd_quaternion"
    train = _args("train", quat_tree, preset, "--num-warmup-epochs", "1", "--num-epochs", "1",
                  "--max-iterations", "2")
    assert cli.main(train) == 0
    med = float(capsys.readouterr().out.split("final MedErr ")[1].split()[0])
    assert np.isfinite(med)
    assert cli.main(_args("predict", quat_tree, preset, "--checkpoint", "final")) == 0
    capsys.readouterr()
    with np.load(quat_tree / preset / "results_run.npz") as z:
        ypred, ytrue, labels = z["yhat_test"], z["ytest"], z["test_labels"]
    assert ypred.shape == ytrue.shape == (len(labels), 4) and len(labels) >= 3
    np.testing.assert_allclose(np.linalg.norm(ypred, axis=1), 1.0, atol=1e-6)
    got = mean_class_median_error(ytrue, ypred, labels, 3, representation="quaternion")
    assert abs(got - med) <= 5e-4  # printed to 3 decimals
    assert cli.main(_args("evaluate", quat_tree, preset, "--checkpoint", "final",
                          "--eval-num-epochs", "1")) == 0
    out = capsys.readouterr().out
    printed = float(out.split("ensembled MedErr: ")[1].split()[0])
    snaps = sorted((quat_tree / preset / "results_run").glob("num*.npz"))
    assert snaps
    with np.load(snaps[0]) as z:
        assert z["yhat_test"].shape[1] == 4
    preds = []
    for p in snaps:
        with np.load(p) as z:
            preds.append(z["yhat_test"])
            yt, lab = z["ytest"], z["test_labels"]
    ens = mean_class_median_error(yt, ensemble_poses(preds, "quaternion"), lab, 3,
                                  representation="quaternion")
    assert abs(ens - printed) <= 1e-4 and np.isfinite(ens)
    reg = _args("train", quat_tree, "geodesic_regression", "--num-warmup-epochs", "1",
                "--num-epochs", "1", "--max-iterations", "1")
    assert cli.main(reg) == 0
    ck = torch.load(quat_tree / "geodesic_regression" / "checkpoints" / "final",
                    weights_only=True)
    assert ck["config"]["model_kind"] == "per_class_regression" and ck["step"] == 2
    recs = [json.loads(line) for line in
            (quat_tree / "geodesic_regression" / "metrics.jsonl").read_text().splitlines()]
    assert all(r["lc"] == 0.0 for r in recs if "lc" in r)
