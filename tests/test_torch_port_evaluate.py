"""The port's cyclical SGD, snapshot-ensemble evaluator and its commands
(`cli pack`, `train --packed-cache`, `evaluate`, `predict`) against the JAX
package where it has a counterpart, on CPU.

The model is ResNet18 to layer2 (N0 128, N1 16, N2 8, K 8, 3 classes,
32 px, streams of 2 items x 3 classes). Tolerances: the cyclical rate and
the SGD's float32 updates bit-equal; ensembled poses within 1e-12; the
evaluator against the JAX one in float64 from the same weights, the
snapshot steps equal, MedErr within 1e-6 deg and poses within 1e-8.
"""

import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as spio
import torch

from multi_modal_regression_tpu.parallel.mesh import make_mesh
from multi_modal_regression_tpu.tools.synthetic import generate_pose_dataset
from multi_modal_regression_tpu.train import SnapshotEnsembleEvaluator as JaxEvaluator
from multi_modal_regression_tpu.train import Trainer as JaxTrainer
from multi_modal_regression_tpu.train import evaluator as jax_evaluator
from multi_modal_regression_tpu.train import get_config as jax_get_config
from multi_modal_regression_tpu.train import schedules as jax_schedules
from multi_modal_regression_tpu.train.state import create_train_state
from multi_modal_regression_tpu_torch import PASCAL3D_CLASSES, cli
from multi_modal_regression_tpu_torch.dictionary.kmeans import KMeansDictionary
from multi_modal_regression_tpu_torch.metrics import mean_class_median_error
from multi_modal_regression_tpu_torch.models.pretrained import from_jax_variables
from multi_modal_regression_tpu_torch.train import evaluator, schedules
from multi_modal_regression_tpu_torch.train.evaluator import SnapshotEnsembleEvaluator
from multi_modal_regression_tpu_torch.train.presets import get_config
from multi_modal_regression_tpu_torch.train.trainer import Trainer

from test_torch_port_ops import one_torch_thread, randomize_batch_stats  # noqa: F401

CLASSES = PASCAL3D_CLASSES[:3]
SMALL = dict(
    feature_network="resnet18", feature_layer="layer2", N0=128, N1=16, N2=8,
    dict_size=8, num_classes=3, image_size=32, items_per_batch=2,
)
N_STREAM = 6  # 2 items x 3 classes per loader per step
# raised from 1e-6 / 1e-8 so that the weights visibly move in the fine-tune
# and a wrong rate would show in the poses
ALPHAS = dict(eval_alpha1=1e-2, eval_alpha2=1e-4)


def _centers() -> np.ndarray:
    return (0.7 * np.random.default_rng(0).standard_normal((8, 3))).astype(np.float32)


def _batches(seed: int, n: int, test: bool = False) -> list[dict]:
    """Loader-style batches with float64 Euler angles (so that the targets
    and ground truth are float64 on both sides); test batches carry
    `valid`, the last one padded."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        b = {
            "xdata": rng.integers(0, 256, (N_STREAM, 32, 32, 3), np.uint8),
            "euler": np.stack([
                rng.uniform(-180, 180, N_STREAM), rng.uniform(-60, 60, N_STREAM),
                rng.uniform(-30, 30, N_STREAM),
            ], axis=1),
            "label": (np.arange(N_STREAM) % 3).astype(np.int32),
        }
        if test:
            b["valid"] = np.arange(N_STREAM) < (N_STREAM if i < n - 1 else 4)
        out.append(b)
    return out


# --- the cyclical rate and its SGD ------------------------------------------------


@pytest.mark.parametrize("alphas", [(1e-6, 1e-8), (1e-2, 1e-4), (0.3, 7e-4)], ids=str)
@pytest.mark.parametrize("c", [4, 7])
def test_cyclical_rate_is_bit_equal_to_jax(c, alphas):
    """The rate of every step over three cycles equals the JAX schedule's
    float32 value bit for bit (op by op, as written), and is_snapshot_step
    agrees. Inside a jit XLA folds the division by the constant c into a
    multiplication, a few ulps away for c = 7; the port forms the quotient
    as written."""
    ours = schedules.cyclical_triangular(c, *alphas)
    theirs = jax_schedules.cyclical_triangular(c, *alphas)
    jitted = jax.jit(theirs)
    for k in range(3 * c + 1):
        got, want = ours(k), np.asarray(theirs(jnp.int32(k)))
        assert got.dtype == want.dtype == np.float32
        assert got.view(np.uint32) == want.view(np.uint32), (k, got, want)
        np.testing.assert_allclose(got, np.asarray(jitted(jnp.int32(k))), rtol=1e-6)
        assert schedules.is_snapshot_step(k, c) == jax_schedules.is_snapshot_step(k, c)
    assert [k for k in range(3 * c) if schedules.is_snapshot_step(k, c)] == [
        c // 2 - 1, c + c // 2 - 1, 2 * c + c // 2 - 1]


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_cyclical_sgd_is_bit_equal_to_optax(momentum):
    """CyclicalSGD over 2 cycles of seeded float32 gradients against the
    JAX package's optax chain (applied op by op): the parameters equal bit
    for bit after every step, the count from 0 in the optimizer's state,
    with momentum the optax trace too."""
    rng = np.random.default_rng(3)
    c, a1, a2 = 6, 1e-2, 1e-4
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in
            (("w", (4, 5)), ("b", (5,)))}
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = schedules.cyclical_sgd(params.values(), c, a1, a2, momentum=momentum)
    tx = jax_schedules.cyclical_sgd(c, a1, a2, momentum=momentum)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jparams)
    for _ in range(2 * c):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in init.items()}
        for k, p in params.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        upd, jstate = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, jstate)
        jparams = {k: jparams[k] + upd[k] for k in jparams}
        for k, p in params.items():
            np.testing.assert_array_equal(p.detach().numpy(), np.asarray(jparams[k]))
    st = opt.state[params["w"]]
    assert st["count"] == 2 * c and ("trace" in st) == bool(momentum)
    with pytest.raises(ValueError, match="no closure"):
        opt.step(lambda: 0.0)


# --- ensembling -----------------------------------------------------------------------


@pytest.mark.parametrize("representation", ["axis_angle", "quaternion"])
def test_ensemble_poses_matches_jax(representation):
    """ensemble_poses over 3 snapshots of 64 poses (quaternions of mixed
    signs, a zero rotation, a rotation near pi) within 1e-12 of JAX's."""
    rng = np.random.default_rng(5)
    if representation == "quaternion":
        q = rng.standard_normal((64, 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        snaps = [q * rng.choice([-1.0, 1.0], (64, 1))
                 + 0.05 * rng.standard_normal((64, 4)) for _ in range(3)]
    else:
        v = rng.standard_normal((64, 3))
        v *= rng.uniform(0, np.pi, (64, 1)) / np.linalg.norm(v, axis=1, keepdims=True)
        v[0], v[1] = 0.0, [np.pi - 1e-3, 0.0, 0.0]
        snaps = [v + 0.05 * rng.standard_normal((64, 3)) for _ in range(3)]
    got = evaluator.ensemble_poses(snaps, representation)
    want = jax_evaluator.ensemble_poses(snaps, representation)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(evaluator._project_to_so3(np.eye(3)[None] * 2.0),
                               np.eye(3)[None], atol=1e-12)


# --- the evaluator against the JAX one ----------------------------------------------

class _Copies:
    """An iterable of copies of the batches each pass (the JAX Trainer's
    predict pops `valid` from the dicts it is given)."""

    def __init__(self, batches: list[dict]):
        self.batches = batches

    def __iter__(self):
        return (dict(b) for b in self.batches)


REAL, RENDER, TEST = _batches(1, 2), _batches(2, 2), _batches(3, 2, test=True)
EPOCHS = 3  # c = 2 x 2 batches = 4: snapshots after local steps 1 and 5


@pytest.fixture(scope="module")
def jax_run():
    """The JAX evaluator's run in float64 (jax_enable_x64 for this fixture
    only) from seeded weights with random BN statistics: (its variables
    before the run, its snapshots)."""
    jax.config.update("jax_enable_x64", True)
    try:
        trainer = JaxTrainer(
            jax_get_config("geodesic_bd", **SMALL, **ALPHAS, compute_dtype="float64",
                           stem_pool=None, fused_conv_bn=None),
            dictionary=_centers(), mesh=make_mesh(jax.devices("cpu")[:1]),
        )
        state = jax.device_get(trainer.init_state())
        stats = randomize_batch_stats(state.batch_stats, np.random.default_rng(1))
        f64 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
        params, stats = f64(state.params), f64(stats)
        ev = JaxEvaluator(trainer)
        ev.run(create_train_state({"params": params, "batch_stats": stats}, trainer.tx),
               REAL, RENDER, _Copies(TEST), num_epochs=EPOCHS)
        med, ypred = ev.ensemble()
        return (params, stats), ev.snapshots, med, ypred
    finally:
        jax.config.update("jax_enable_x64", False)


def _port_trainer(variables, workdir=None) -> Trainer:
    cfg = get_config("geodesic_bd", **SMALL, **ALPHAS, compute_dtype="float64")
    trainer = Trainer(cfg, dictionary=_centers(), workdir=workdir, device="cpu")
    trainer.model.load_state_dict(from_jax_variables(*variables))
    return trainer


@pytest.fixture(scope="module")
def port_run(jax_run, tmp_path_factory):
    """The port's evaluator run from the same weights, writing snapshots."""
    wd = tmp_path_factory.mktemp("snapshots")
    trainer = _port_trainer(jax_run[0])
    adam = trainer.optimizer
    ev = SnapshotEnsembleEvaluator(trainer, workdir=wd, record_history=True)
    state = ev.run(trainer.init_state(), REAL, RENDER, TEST, num_epochs=EPOCHS)
    return trainer, adam, ev, state


def test_evaluator_matches_jax(jax_run, port_run):
    """Snapshot steps equal (2 and 6), each snapshot's MedErr within 1e-6
    deg and poses within 1e-8 of the JAX evaluator's in float64, the
    ensembled MedErr within 1e-6 deg and poses within 1e-8."""
    _, jsnaps, jmed, jypred = jax_run
    _, _, ev, _ = port_run
    assert [s.step for s in ev.snapshots] == [s.step for s in jsnaps] == [2, 6]
    for s, js in zip(ev.snapshots, jsnaps):
        assert s.ypred.dtype == np.float64 and s.ypred.shape == js.ypred.shape == (10, 3)
        np.testing.assert_array_equal(s.labels, js.labels)
        np.testing.assert_allclose(s.ytrue, js.ytrue, rtol=0, atol=1e-8)
        np.testing.assert_allclose(s.ypred, js.ypred, rtol=0, atol=1e-8)
        assert abs(s.med_err - js.med_err) <= 1e-6
    # the fine-tune moved the poses: a wrong rate would show
    assert np.abs(ev.snapshots[1].ypred - ev.snapshots[0].ypred).max() > 1e-3
    med, ypred = ev.ensemble()
    np.testing.assert_allclose(ypred, jypred, rtol=0, atol=1e-8)
    assert abs(med - jmed) <= 1e-6


def test_evaluator_leaves_adam_and_resets_the_state(port_run):
    """The run fine-tunes with its own SGD (count 6 = the steps) from step 0
    and s 0; the Trainer's Adam keeps no moments; every step's metrics are
    in the history; a second run starts afresh."""
    trainer, adam, ev, state = port_run
    assert trainer.optimizer is adam and not adam.state
    assert isinstance(state.optimizer, schedules.CyclicalSGD) and state.step == 6
    assert {st["count"] for st in state.optimizer.state.values()} == {6}
    assert len(ev.history) == 6 and set(ev.history[0]) == {"loss", "lc", "lr", "s", "alpha"}
    assert ev.history[0]["s"] != 0.0
    again = SnapshotEnsembleEvaluator(trainer)
    state = again.run(state, REAL, None, TEST, num_epochs=1)
    # one loader: c = 4 from its 2 batches, no minimum within 2 steps, so
    # the final state is the one snapshot
    assert state.step == 2 and [s.step for s in again.snapshots] == [2]


def test_load_saved_round_trip(port_run):
    """num<k>.npz hold ytest, yhat_test, test_labels and step; load_saved
    gives back the snapshots and the ensemble."""
    trainer, _, ev, _ = port_run
    with np.load(ev.workdir / "num1.npz") as z:
        assert sorted(z.files) == ["step", "test_labels", "yhat_test", "ytest"]
        assert int(z["step"]) == 6
    loaded = SnapshotEnsembleEvaluator(trainer, workdir=ev.workdir)
    assert loaded.load_saved() == 2
    for a, b in zip(loaded.snapshots, ev.snapshots, strict=True):
        assert a.step == b.step and a.med_err == b.med_err
        for k in ("ytrue", "ypred", "labels"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert loaded.ensemble()[0] == ev.ensemble()[0]
    with pytest.raises(RuntimeError, match="no workdir"):
        SnapshotEnsembleEvaluator(trainer).load_saved()
    with pytest.raises(RuntimeError, match="no snapshots"):
        SnapshotEnsembleEvaluator(trainer).ensemble()


# --- the commands ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_tree(tmp_path_factory) -> Path:
    """augmented2/, renderforcnn/ (2-4 PNGs a class: 2 steps an epoch at 2
    items), test/ (1-3), 32 px; original/ .mat crop sets (1-2 crops, 40 px);
    a K = 8 dictionary."""
    root = tmp_path_factory.mktemp("cli")
    for sub, n, seed in (("augmented2", 2, 1), ("renderforcnn", 2, 2), ("test", 1, 3)):
        generate_pose_dataset(root / "data" / sub, CLASSES, n, 32, seed=seed, pattern="pose")
    rng = np.random.default_rng(6)
    for cls in CLASSES:
        (root / "data" / "original" / cls).mkdir(parents=True)
        names = [f"{cls}_{i}" for i in range(2)]
        for name in names:
            n = int(rng.integers(1, 3))
            spio.savemat(str(root / "data" / "original" / cls / f"{name}.mat"), {
                "xdata": rng.integers(0, 256, (n, 40, 40, 3), np.uint8),
                "ydata": rng.standard_normal((n, 3)).astype(np.float32),
            })
        spio.savemat(str(root / "data" / "original" / f"{cls}_info.mat"),
                     {"pascal_val": np.array(names, dtype=object)})
    KMeansDictionary(cluster_centers=_centers()).save(root / "kmeans.npz")
    return root


SMALL_FLAGS = ["--feature-network", "resnet18", "--feature-layer", "layer2", "--N0", "128",
               "--N1", "16", "--N2", "8", "--image-size", "32", "--items-per-batch", "2",
               "--num-classes", "3", "--num-workers", "2", "--compute-dtype", "float32"]


def _args(cmd: str, root: Path, *extra: str) -> list[str]:
    """The command's arguments on the small tree; `pack` takes no
    dictionary and no device; `verify-parity` no preset, dictionary or
    cache flag."""
    if cmd == "verify-parity":
        return [cmd, "--data-root", str(root / "data"), *SMALL_FLAGS, "--workdir",
                str(root / "gate"), "--device", "cpu", *extra]
    model = [] if cmd == "pack" else ["--dictionary", str(root / "kmeans.npz"),
                                      "--device", "cpu"]
    return [cmd, "--preset", "geodesic_bd", "--data-root", str(root / "data"), *model,
            *SMALL_FLAGS, "--workdir", str(root / "run"), "--packed-cache", "auto", *extra]


def _metas(root: Path) -> dict:
    return {p.parent.name: p.stat().st_mtime_ns
            for p in (root / "data" / ".packed").glob("*/meta.json")}


@pytest.fixture(scope="module")
def trained(cli_tree) -> tuple[Path, float, dict]:
    """`cli pack`, then `cli train --packed-cache auto` (1 warm-up + 1 main
    epoch): (the tree, the printed final MedErr, the caches' meta.json
    mtimes after pack)."""
    assert cli.main(_args("pack", cli_tree)) == 0
    metas = _metas(cli_tree)
    out = _run(_args("train", cli_tree, "--num-warmup-epochs", "1", "--num-epochs", "1"))
    return cli_tree, float(out.split("final MedErr ")[1].split()[0]), metas


def _run(argv: list[str]) -> str:
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    return buf.getvalue()


def test_cli_pack_then_train_reuses_the_caches(trained):
    """`pack` writes the three caches beside the trees (the JAX package's
    `auto` names); `train --packed-cache auto` trains from them without
    repacking and writes its checkpoints."""
    root, med, metas = trained
    assert sorted(metas) == ["augmented2_32px", "renderforcnn_32px", "test_32px"]
    assert _metas(root) == metas and np.isfinite(med)
    assert torch.load(root / "run" / "checkpoints" / "final", weights_only=True)["step"] == 4


def test_cli_evaluate(trained):
    """`evaluate --checkpoint final --eval-num-epochs 3` from the packed
    caches: snapshots at local steps 1 and 5 (c = 4) in num0.npz, num1.npz;
    the printed per-snapshot and ensembled MedErrs are the files'."""
    root, _, metas = trained
    out = _run(_args("evaluate", root, "--checkpoint", "final", "--eval-num-epochs", "3"))
    assert _metas(root) == metas
    res = root / "run" / "results_run"
    assert sorted(p.name for p in res.iterdir()) == ["num0.npz", "num1.npz"]
    snaps = [dict(np.load(res / f"num{k}.npz")) for k in range(2)]
    assert [int(s["step"]) for s in snaps] == [2, 6]
    meds = [mean_class_median_error(s["ytest"], s["yhat_test"], s["test_labels"], 3)
            for s in snaps]
    printed = eval(re.search(r"snapshot MedErrs: (\[.*\])", out).group(1))
    np.testing.assert_allclose(printed, meds, atol=1e-4)
    ens = evaluator.ensemble_poses([s["yhat_test"] for s in snaps], "axis_angle")
    med = mean_class_median_error(snaps[0]["ytest"], ens, snaps[0]["test_labels"], 3)
    assert abs(float(re.search(r"ensembled MedErr: (\S+) deg", out).group(1)) - med) <= 1e-4


@pytest.mark.parametrize("protocol", ["filenames", "mat"])
def test_cli_predict(trained, protocol):
    """`predict --checkpoint final` over the packed test tree gives the
    train command's final MedErr (within its 3 printed decimals) and
    writes results_<save>.npz with the JAX keys; over the .mat crop sets
    (packed once, resized to 32 px) it reads every crop."""
    root, med, _ = trained
    extra = ["--test-protocol", "mat"] if protocol == "mat" else []
    out = _run(_args("predict", root, "--checkpoint", "final", *extra))
    with np.load(root / "run" / "results_run.npz") as z:
        assert sorted(z.files) == ["test_labels", "yhat_test", "ytest"]
        n = len(z["test_labels"])
    got = float(out.split("MedErr ")[-1])
    assert np.isfinite(got) and "wrote " in out and "mean: MedErr" in out
    if protocol == "filenames":
        assert n == 6 and abs(got - med) <= 1e-3
    else:
        meta = root / "data" / ".packed" / "original_test_32px_mat" / "meta.json"
        crops = sum(len(spio.loadmat(str(p))["xdata"])
                    for p in (root / "data" / "original").glob("*/*.mat"))
        assert n == crops == sum(r[2] for r in json.loads(meta.read_text())["file_rows"])


@pytest.mark.parametrize("cmd,flag", [
    ("verify-parity", ["--compile-cache", "off"]), ("evaluate", ["--distributed"]),
    ("predict", ["--coordinator-address", "localhost:1"]), ("pack", ["--compile-cache", "off"]),
], ids=lambda f: f if isinstance(f, str) else f[0])
def test_cli_refuses_what_is_not_ported(cli_tree, cmd, flag):
    """Multi-host runs and the compile cache (of the gate too) raise
    NotImplementedError naming ROADMAP.md."""
    with pytest.raises(NotImplementedError, match=r"not ported yet \(ROADMAP.md\)"):
        cli.main(_args(cmd, cli_tree, *flag))


def test_cli_new_commands_default_to_the_card():
    """evaluate and predict run on the card unless --device cpu; their
    checkpoints default to the JAX CLI's (last, final); predict's data root
    to '.'; pack takes no device."""
    parse = cli.build_parser().parse_args
    ev = parse(["evaluate", "--preset", "geodesic_bd", "--data-root", "x"])
    assert ev.device == "cuda" and ev.fn is cli.cmd_evaluate and ev.checkpoint == "last"
    assert ev.eval_num_epochs is None and ev.packed_cache is None
    pr = parse(["predict", "--preset", "geodesic_bd"])
    assert pr.device == "cuda" and pr.fn is cli.cmd_predict and pr.checkpoint == "final"
    assert pr.data_root == "."
    pk = parse(["pack", "--preset", "geodesic_bd", "--data-root", "x"])
    assert pk.fn is cli.cmd_pack and not hasattr(pk, "device")
