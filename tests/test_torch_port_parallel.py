"""Data and tensor parallelism of the port over torch.distributed, on CPU.

Multi-process runs start this file as a script, one process a rank, joined
by a gloo process group on a free localhost port (parallel/multihost:
MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK), or through `python -m
torch.distributed.run` for the CLI. Every group has a gloo timeout of 120 s
and a subprocess timeout that kills the whole process group, so a hang
fails one test; only a failed bring-up (the port taken) is retried.

The model is ResNet18 to layer2 (N0 128, N1 16, N2 8, K 8, 32 px), float64
where values are compared. Tolerances: the 2-rank data-parallel fit within
1e-9 relative (to each leaf's largest magnitude; metrics to their own
value) of the port's one-process fit over the same global batches, and of
the JAX Trainer on the 8-device CPU mesh within JAX_METRIC_TOL /
JAX_LEAF_TOL (below: float32 input paths); tensor-parallel steps within 1e-9
of one process; checkpoints across layouts bit-equal where nothing ran and
within 1e-9 after a step; the CLI's gathered predict equal to one
process's.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(
    feature_network="resnet18", feature_layer="layer2", N0=128, N1=16, N2=8, N3=4,
    dict_size=8, num_classes=3, image_size=32, items_per_batch=2,
    compute_dtype="float64", max_iterations=2, num_warmup_epochs=1, num_epochs=1,
)
ROWS = 12  # a global stream: 2 items x 3 classes on each of 2 ranks
TOL = 1e-9
# Against the JAX Trainer the two packages' float32 input paths (the uint8
# normalize, Euler -> pose, the float32 dictionary) round in different op
# orders before the float64 model; the first step's loss is 2.7e-9 apart,
# and Adam's first steps move an element whose gradient is near zero by a
# full +/-lr either way, so after 4 steps the metrics are 1.7e-6 and the
# leaves 1.4e-5 apart (measured on this CPU). The port's own one-process
# fit, which shares those paths, is held at TOL.
JAX_METRIC_TOL, JAX_LEAF_TOL = 1e-5, 1e-4
TIMEOUT = 300
# a rendezvous that failed before any rank trained: the port was taken
BRINGUP_SIGNATURES = ("EADDRINUSE", "Address already in use")


def _centers() -> np.ndarray:
    return (0.7 * np.random.default_rng(0).standard_normal((8, 3))).astype(np.float32)


def _loader(seed: int, n_batches: int = 2, rows: int = ROWS, classes: int = 3) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [
        {
            "xdata": rng.integers(0, 256, (rows, 32, 32, 3), np.uint8),
            "euler": np.stack([
                rng.uniform(-180, 180, rows), rng.uniform(-60, 60, rows),
                rng.uniform(-30, 30, rows),
            ], axis=1).astype(np.float32),
            "label": (np.arange(rows) % classes).astype(np.int32),
        }
        for _ in range(n_batches)
    ]


def _rank_rows(batches: list[dict], rank: int, world: int) -> list[dict]:
    """A rank's stride of each stream batch: its block of rows."""
    n = len(batches[0]["label"]) // world
    return [{k: v[rank * n:(rank + 1) * n] for k, v in b.items()} for b in batches]


def _trainer(mesh=None, preset="geodesic_bd", workdir=None, **over):
    from multi_modal_regression_tpu_torch.train.presets import get_config
    from multi_modal_regression_tpu_torch.train.trainer import Trainer

    cfg = get_config(preset, **{**SMALL, **over})
    return Trainer(cfg, dictionary=_centers(), device="cpu", mesh=mesh, workdir=workdir)


def _fit(trainer, init_sd, real, render):
    if init_sd is not None:
        trainer.model.load_state_dict(init_sd)
    trainer.fit(trainer.init_state(), real, render, log_every=1)
    return trainer.history


def _tp_batch(seed: int = 3, rows: int = 16, classes: int = 4) -> dict:
    b = _loader(seed, 1, rows, classes)[0]
    b["is_real"] = np.arange(rows) < rows // 2
    return b


def _grads(trainer) -> dict:
    """Each parameter's gradient after a step, with the first head of its
    bank shard (None where the parameter is whole on the rank)."""
    from multi_modal_regression_tpu_torch.parallel import tp

    shards = tp.param_shards(trainer.model)
    return {n: (p.grad.clone(), shards[id(p)].lo if id(p) in shards else None)
            for n, p in trainer.model.named_parameters() if p.grad is not None}


def _tp_step(trainer, batch):
    st = trainer.init_state()
    _, m = trainer.train_step_fn("main", dual_stream=True)(st, trainer._to_device(batch))
    return {k: float(v) for k, v in m.items()}


# --- the ranks' side (this file run as a script) ----------------------------------


def _worker(job: str, out: str, arg: str) -> None:
    from multi_modal_regression_tpu_torch.parallel import multihost, tp
    from multi_modal_regression_tpu_torch.parallel.mesh import make_mesh, shard_batch

    torch.set_num_threads(1)
    world, rank = multihost.initialize(device="cpu", timeout_seconds=120)
    result = {}
    assert multihost.host_info() == (world, rank)
    if job == "dp":
        local, rows = multihost.global_batch_from_local(_loader(9)[0], make_mesh())
        assert rows == world * ROWS and local["xdata"].shape[0] == ROWS
        init_sd = torch.load(arg, weights_only=True)
        for flip in (False, True):
            t = _trainer(make_mesh(), train_flip=flip)
            real, render = (_rank_rows(_loader(s), rank, world) for s in (9, 10))
            hist = _fit(t, init_sd, real, render)
            result[flip] = (hist, t.model.state_dict(), _grads(t))
    else:  # tp: "<n_data>x<n_model>"
        n_data, n_model = map(int, job.split("x"))
        mesh = tp.make_2d_mesh(n_data, n_model)
        cases = [("geodesic_bd", dict(num_classes=4)),
                 ("geodesic_bd_multires", dict())]  # 3 bin heads: stay whole at tp 2
        for preset, over in cases:
            t = _trainer(mesh, preset, **over)
            batch = shard_batch(_tp_batch(classes=over.get("num_classes", 3)), mesh)
            sharded = [n for n, m in t.model.named_children() if getattr(m, "tp", None)]
            shapes = {k: tuple(v.shape) for k, v in t.model.state_dict().items()}
            result[preset] = (_tp_step(t, batch), tp.full_state_dict(t.model), sharded, shapes,
                              _grads(t))
        if arg:  # checkpoints: restore a one-process file at tp, step, write
            t = _trainer(mesh, num_classes=4, workdir=arg)
            st = t.restore_checkpoint("one")
            restored = {k: v.clone() for k, v in tp.full_state_dict(t.model).items()}
            batch = shard_batch(_tp_batch(seed=4), mesh)
            st, _ = t.train_step_fn("main", dual_stream=True)(st, t._to_device(batch))
            t.save_checkpoint(st, "tp")
            result["restored"] = restored
    if rank == 0:
        torch.save(result, out)
    multihost.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_group(cmds_env, attempts: int = 3) -> list[str]:
    """Start every (cmd, env) of one group at once, each in its own session;
    wait with a timeout that kills every process group; retry on a
    bring-up failure only. Returns the outputs."""
    for attempt in range(attempts):
        port = str(_free_port())
        procs = [subprocess.Popen(cmd, cwd=REPO, env={**env, "MASTER_PORT": port},
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True, start_new_session=True)
                 for cmd, env in cmds_env]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                os.killpg(p.pid, signal.SIGKILL)
            raise
        if all(p.returncode == 0 for p in procs):
            return outs
        if attempt + 1 < attempts and any(s in o for o in outs for s in BRINGUP_SIGNATURES):
            continue
        raise AssertionError("\n".join(f"rank {i} rc {p.returncode}:\n{o[-3000:]}"
                                       for i, (p, o) in enumerate(zip(procs, outs))))
    raise AssertionError("unreachable")


def _env(**kw) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith(("RANK", "WORLD_SIZE"))}
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    env["OMP_NUM_THREADS"] = "1"
    return {**env, "MASTER_ADDR": "127.0.0.1", **{k: str(v) for k, v in kw.items()}}


if __name__ == "__main__":
    _worker(*sys.argv[1:4])
    raise SystemExit(0)


# --- the tests ----------------------------------------------------------------------

import pytest  # noqa: E402

from test_torch_port_ops import one_torch_thread  # noqa: E402,F401


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-300))


def _assert_sd_close(got: dict, want: dict, tol: float = TOL) -> None:
    assert got.keys() == want.keys()
    for k, w in want.items():
        if w.is_floating_point():
            assert _rel(got[k], w) <= tol, (k, _rel(got[k], w))
        else:
            assert torch.equal(got[k], w), k


def _assert_grads_close(got: dict, trainer, tol: float = TOL) -> None:
    """A rank's gradients (`_grads`) against the one-process trainer's after
    the same step, a bank shard against its heads."""
    want = {n: p.grad for n, p in trainer.model.named_parameters() if p.grad is not None}
    assert got.keys() == want.keys()
    for k, (g, lo) in got.items():
        w = want[k] if lo is None else want[k][lo:lo + g.shape[0]]
        assert _rel(g, w) <= tol, (k, _rel(g, w))


def _assert_metrics_close(got: list[dict], want: list[dict], tol: float = TOL) -> None:
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for k in ("loss", "lc", "lr", "s", "alpha"):
            assert abs(g[k] - w[k]) <= tol * max(abs(w[k]), 1e-12), (g["step"], k, g[k], w[k])


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """The 2-rank data-parallel fits, the dp1 x tp2 steps and checkpoints
    and the dp2 x tp2 steps, run as three process groups at once. The
    fits start from weights the JAX Trainer drew, converted by
    from_jax_variables; the checkpoint case restores a one-process
    checkpoint written here after one step."""
    import jax

    from multi_modal_regression_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from multi_modal_regression_tpu.train import Trainer as JaxTrainer
    from multi_modal_regression_tpu.train import get_config as jax_get_config
    from multi_modal_regression_tpu_torch.models.pretrained import from_jax_variables

    tmp = tmp_path_factory.mktemp("groups")
    jax.config.update("jax_enable_x64", True)
    try:
        jt = JaxTrainer(
            jax_get_config("geodesic_bd", **{**SMALL, "stem_pool": None,
                                             "fused_conv_bn": None}),
            dictionary=_centers(), mesh=jax_make_mesh())
        assert jt.mesh.shape["data"] == 8
        jstate = jax.device_get(jt.init_state())
        init_sd = from_jax_variables(jstate.params, jstate.batch_stats)
        torch.save(init_sd, tmp / "init.pt")
        one = _trainer(num_classes=4, workdir=tmp / "ckpt")
        st = one.init_state()
        st, _ = one.train_step_fn("main", dual_stream=True)(st, one._to_device(_tp_batch()))
        one.save_checkpoint(st, "one")
        one.wait_for_checkpoints()
        jobs = [("dp", 2, tmp / "dp.pt", str(tmp / "init.pt")),
                ("1x2", 2, tmp / "tp12.pt", str(tmp / "ckpt")),
                ("2x2", 4, tmp / "tp22.pt", "")]
        cmds = [([sys.executable, str(Path(__file__).resolve()), job, str(out), arg],
                 _env(WORLD_SIZE=w, RANK=r, MMR_JOB=job))
                for job, w, out, arg in jobs for r in range(w)]
        # one port a group: MASTER_PORT is set per group below
        ports = {job: str(_free_port()) for job, *_ in jobs}
        for cmd, env in cmds:
            env["MASTER_PORT"] = ports[env.pop("MMR_JOB")]
        procs = [subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True,
                                  start_new_session=True) for cmd, env in cmds]
        # meanwhile: the JAX fit on the 8-device mesh and the one-process port fit
        real, render = _loader(9), _loader(10)
        jax_hist = _jax_fit(jt, jstate, real, render)
    finally:
        jax.config.update("jax_enable_x64", False)
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            os.killpg(p.pid, signal.SIGKILL)
        raise
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    return {"jax": jax_hist, "init": init_sd, "tmp": tmp,
            **{job: torch.load(out, weights_only=False) for job, _, out, _ in jobs}}


def _jax_fit(jt, jstate, real, render):
    """The JAX fit's steps one by one, each step's metrics, and the final
    parameters and statistics (as a port state_dict)."""
    import jax
    import jax.numpy as jnp

    from multi_modal_regression_tpu.train.state import create_train_state
    from multi_modal_regression_tpu.train.trainer import _interleave as jax_interleave
    from multi_modal_regression_tpu_torch.models.pretrained import from_jax_variables

    f64 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
    state = create_train_state({"params": f64(jstate.params),
                                "batch_stats": f64(jstate.batch_stats)}, jt.tx)
    metrics = []
    for phase in ("warmup", "main"):
        step_fn = jt.train_step_fn(phase, dual_stream=True)
        for i, batch in enumerate(jax_interleave(real, render)):
            state, m = step_fn(state, jt.shard_batch(batch))
            metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
            if i + 1 >= jt.config.max_iterations:
                break
        if phase == "warmup":
            state = state.replace(s=jnp.zeros((), jnp.float32))
    state = jax.device_get(state)
    return metrics, from_jax_variables(state.params, state.batch_stats)


@pytest.mark.parametrize("flip", [False, True], ids=["dual_stream", "train_flip"])
def test_dp_fit_equals_one_process(groups, flip):
    """2 warm-up + 2 main dual-stream steps on 2 ranks (each its 6 rows of
    a 12-row stream): every step's loss, lc, lr, s and alpha and every leaf
    of the final state_dict (weights and running statistics) within 1e-9
    relative of the one-process fit over the 24-row global batches, and so
    is the last step's gradient (Adam's update hides a misscaled one); with
    train_flip each row is flipped as in the one-process run."""
    hist, sd, grads = groups["dp"][flip]
    one = _trainer(train_flip=flip)
    want = _fit(one, groups["init"], _loader(9), _loader(10))
    _assert_metrics_close(hist, want)
    _assert_sd_close(sd, one.model.state_dict())
    _assert_grads_close(grads, one)


def test_dp_fit_equals_jax_mesh(groups):
    """The same 2-rank fit against the JAX Trainer over the 8-device CPU
    mesh (make_mesh(), jit over the global batch), float64, from the same
    weights: metrics within JAX_METRIC_TOL and every leaf within
    JAX_LEAF_TOL relative."""
    hist, sd, _ = groups["dp"][False]
    jmetrics, jsd = groups["jax"]
    _assert_metrics_close(hist, jmetrics, JAX_METRIC_TOL)
    for k, w in jsd.items():
        if not k.endswith("num_batches_tracked"):
            assert _rel(sd[k], w) <= JAX_LEAF_TOL, (k, _rel(sd[k], w))


@pytest.mark.parametrize("job", ["1x2", "2x2"])
def test_tp_step_equals_one_process(groups, job):
    """One main dual-stream step at dp1 x tp2 and dp2 x tp2 (4 ranks):
    geodesic_bd's 4-head banks cut to 2 heads a rank, the multires model's
    24-head delta bank cut while its 3-head bin bank stays whole; metrics,
    the gathered state_dict and the gradients (rank 0's, a bank shard
    against its heads) within 1e-9 of one process."""
    from multi_modal_regression_tpu_torch.parallel.tp import HEAD_BANK_NAMES

    out = groups[job]
    for preset, over in (("geodesic_bd", dict(num_classes=4)), ("geodesic_bd_multires", {})):
        metrics, sd, sharded, shapes, grads = out[preset]
        one = _trainer(preset=preset, **over)
        want = _tp_step(one, _tp_batch(classes=over.get("num_classes", 3)))
        for k, w in want.items():
            assert abs(metrics[k] - w) <= TOL * max(abs(w), 1e-12), (preset, k)
        _assert_sd_close(sd, one.model.state_dict())
        _assert_grads_close(grads, one)
        assert sharded == (["bin_models", "res_models"] if preset == "geodesic_bd"
                           else ["res_models"])
        full = one.model.state_dict()
        for k, shape in shapes.items():
            cut = k.split(".")[0] in sharded
            assert shape == ((full[k].shape[0] // 2, *full[k].shape[1:]) if cut
                             and full[k].ndim else tuple(full[k].shape)), k
        assert set(sharded) <= set(HEAD_BANK_NAMES)


def test_checkpoints_move_between_one_process_and_tp(groups):
    """A one-process checkpoint restored at tp2 gives back its state
    bit-equal when gathered; a step there and its checkpoint (written by
    rank 0 in the one-process layout, moments gathered) restore in one
    process equal, within 1e-9, to the same step run in one process."""
    tmp = groups["tmp"]
    one = _trainer(num_classes=4, workdir=tmp / "ckpt")
    st = one.restore_checkpoint("one")
    _assert_sd_close(groups["1x2"]["restored"], one.model.state_dict(), tol=0.0)
    st, _ = one.train_step_fn("main", dual_stream=True)(st, one._to_device(_tp_batch(seed=4)))
    back = _trainer(num_classes=4, workdir=tmp / "ckpt")
    back.restore_checkpoint("tp")
    _assert_sd_close(back.model.state_dict(), one.model.state_dict())
    want = {id(p): st.optimizer.state[p] for p in one._params()}
    for p, q in zip(back._params(), one._params()):
        for k in ("mu", "nu"):
            assert _rel(back.optimizer.state[p][k], want[id(q)][k]) <= TOL


# --- the command line --------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_tree(tmp_path_factory) -> Path:
    """augmented2/ and renderforcnn/ with 4 PNGs a class (2 steps an epoch a
    rank at 1 item), test/ with 3; a K 8 dictionary."""
    from multi_modal_regression_tpu_torch import PASCAL3D_CLASSES
    from multi_modal_regression_tpu_torch.dictionary.kmeans import KMeansDictionary
    from multi_modal_regression_tpu_torch.tools.synthetic import generate_pose_dataset

    root = tmp_path_factory.mktemp("cli")
    for sub, n, seed in (("augmented2", 4, 1), ("renderforcnn", 4, 2), ("test", 3, 3)):
        generate_pose_dataset(root / "data" / sub, PASCAL3D_CLASSES[:3], n, 32, seed=seed,
                              pattern="pose")
    KMeansDictionary(cluster_centers=_centers()).save(root / "kmeans.npz")
    return root


def _loader_of(root: Path):
    """The one-process real loader of the CLI's flags (1 item a batch)."""
    from multi_modal_regression_tpu_torch import PASCAL3D_CLASSES
    from multi_modal_regression_tpu_torch.data import BalancedLoader, ClassBalancedIndex

    index = ClassBalancedIndex(str(root / "data" / "augmented2"), "real",
                               classes=PASCAL3D_CLASSES[:3])
    return BalancedLoader(index, 1, 32, num_workers=1)


def _cli(cmd: str, root: Path, *extra: str) -> list[str]:
    return [cmd, "--preset", "geodesic_bd", "--data-root", str(root / "data"),
            "--dictionary", str(root / "kmeans.npz"), "--feature-network", "resnet18",
            "--feature-layer", "layer2", "--N0", "128", "--N1", "16", "--N2", "8",
            "--image-size", "32", "--items-per-batch", "1", "--num-classes", "3",
            "--num-warmup-epochs", "1", "--num-epochs", "1", "--num-workers", "2",
            "--compute-dtype", "float32", "--device", "cpu", "--workdir",
            str(root / "run"), *extra]


def _torchrun(args: list[str]) -> str:
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "multi_modal_regression_tpu_torch.cli", *args,
           "--distributed"]
    return _run_group([(cmd, _env())])[0]


def test_cli_train_resume_predict_distributed(cli_tree, capsys):
    """`cli train --distributed --device cpu` over 2 ranks (torchrun), then
    `--resume`, then `predict --distributed`: checkpoints from rank 0, each
    epoch's records written once, the resume continuing from the saved
    step, and the gathered predict's rows, in the one-process order, and
    MedErr equal to a one-process predict of the same checkpoint."""
    import json

    from multi_modal_regression_tpu_torch import cli

    out = _torchrun(_cli("train", cli_tree))
    assert out.count("distributed: process") == 2 and "final MedErr" in out
    wd = cli_tree / "run"
    steps = torch.load(wd / "checkpoints" / "final", weights_only=True)["step"]
    assert steps == 2 * len(_loader_of(cli_tree)) // 2  # warm-up + main epoch, half each
    recs = [json.loads(line) for line in (wd / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs if "epoch" in r] == [steps]  # one writer
    out = _torchrun(_cli("train", cli_tree, "--resume"))
    assert f"resumed from step {steps}" in out
    assert torch.load(wd / "checkpoints" / "final", weights_only=True)["step"] == 2 * steps
    out = _torchrun(_cli("predict", cli_tree, "--checkpoint", "final"))
    with np.load(wd / "results_run.npz") as z:
        got = {k: z[k] for k in z.files}
    med = float(out.split("MedErr ")[-1].split()[0])
    assert cli.main(_cli("predict", cli_tree, "--checkpoint", "final")) == 0
    want_med = float(capsys.readouterr().out.split("MedErr ")[-1].split()[0])
    with np.load(wd / "results_run.npz") as z:
        assert len(z["test_labels"]) >= 9  # 3 a class or more
        for k in z.files:
            np.testing.assert_allclose(got[k], z[k], rtol=0, atol=1e-6, err_msg=k)
    assert abs(med - want_med) <= 1e-4
