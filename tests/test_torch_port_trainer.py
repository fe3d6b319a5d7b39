"""The port's Trainer evaluation, checkpoints, torchvision weight loading and
`cli train`, against the JAX package where it has a counterpart, on CPU.

The model is ResNet18 to layer2 (N0 128, N1 16, N2 8, K 8, 3 classes,
32 px, streams of 2 items x 3 classes); the trees are written inside
tmp_path by the JAX package's tools/synthetic. Tolerances: MedErr within
1e-6 deg and poses within 1e-8 of the JAX Trainer in float64; torchvision
weights exact; a resumed run bit-equal to an uninterrupted one.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import scipy.io as spio
import torch

from multi_modal_regression_tpu.data import FlatTestIndex as JaxFlatTestIndex
from multi_modal_regression_tpu.data import TestLoader as JaxTestLoader
from multi_modal_regression_tpu.models.pretrained import (
    load_torchvision_resnet as jax_load_torchvision_resnet,
)
from multi_modal_regression_tpu.parallel.mesh import make_mesh
from multi_modal_regression_tpu.tools.synthetic import generate_pose_dataset
from multi_modal_regression_tpu.train import Trainer as JaxTrainer
from multi_modal_regression_tpu.train import get_config as jax_get_config
from multi_modal_regression_tpu_torch import PASCAL3D_CLASSES, cli
from multi_modal_regression_tpu_torch.data import FlatTestIndex
from multi_modal_regression_tpu_torch.data import TestLoader as PortTestLoader
from multi_modal_regression_tpu_torch.dictionary.kmeans import KMeansDictionary
from multi_modal_regression_tpu_torch.models.backbones import make_backbone
from multi_modal_regression_tpu_torch.models.pretrained import (
    from_jax_variables,
    load_torchvision_backbone,
)
from multi_modal_regression_tpu_torch.train import trainer as trainer_module
from multi_modal_regression_tpu_torch.train.presets import get_config
from multi_modal_regression_tpu_torch.train.trainer import Trainer

from test_torch_port_ops import one_torch_thread, randomize_batch_stats  # noqa: F401

CLASSES = PASCAL3D_CLASSES[:3]
SMALL = dict(
    feature_network="resnet18", feature_layer="layer2", N0=128, N1=16, N2=8,
    dict_size=8, num_classes=3, image_size=32, items_per_batch=2,
    compute_dtype="float32", max_iterations=1, num_warmup_epochs=1, num_epochs=1,
)
N_STREAM = 6  # 2 items x 3 classes per loader per step
# the keys of the JAX Trainer's metrics.jsonl records (its trainer.py:375-380,
# 391, 455-457): a logged step, an eval every eval_every steps, an epoch
STEP_KEYS = {"step", "loss", "lc", "lr", "s", "alpha", "train_loss", "images_per_sec"}
EVAL_KEYS = {"step", "med_err", "val_loss"}
EPOCH_KEYS = {"step", "epoch", "med_err"}


def _centers() -> np.ndarray:
    return (0.7 * np.random.default_rng(0).standard_normal((8, 3))).astype(np.float32)


def _loader(seed: int, n_batches: int = 1) -> list[dict]:
    """BalancedLoader-style batches: uint8 images, Euler degrees, int32 labels."""
    rng = np.random.default_rng(seed)
    return [
        {
            "xdata": rng.integers(0, 256, (N_STREAM, 32, 32, 3), np.uint8),
            "euler": np.stack([
                rng.uniform(-180, 180, N_STREAM), rng.uniform(-60, 60, N_STREAM),
                rng.uniform(-30, 30, N_STREAM),
            ], axis=1).astype(np.float32),
            "label": (np.arange(N_STREAM) % 3).astype(np.int32),
        }
        for _ in range(n_batches)
    ]


def _trainer(workdir=None, **overrides) -> Trainer:
    cfg = get_config("geodesic_bd", **{**SMALL, **overrides})
    return Trainer(cfg, dictionary=_centers(), workdir=workdir, device="cpu")


@pytest.fixture(scope="module")
def test_tree(tmp_path_factory) -> Path:
    """9 test PNGs (2, 3, 4 a class) at 32 px: with batches of 4, the last
    of 3 batches holds 1 image and 3 padded rows."""
    root = tmp_path_factory.mktemp("test")
    generate_pose_dataset(root, CLASSES, 2, 32, seed=3, pattern="pose")
    return root


def _port_test_loader(root) -> PortTestLoader:
    return PortTestLoader(FlatTestIndex(str(root), CLASSES), 4, 32, num_workers=2)


# --- evaluation against the JAX Trainer ------------------------------------------


def test_predict_and_evaluate_match_jax(test_tree):
    """From the same weights (random BN statistics) and the same test
    batches, the port's predict and evaluate give the JAX Trainer's poses
    within 1e-8 and its MedErr within 1e-6 deg, both in float64; the padded
    rows are dropped. The batches are the TestLoader's (the two packages'
    byte-equal) with the Euler angles widened to float64, so that the
    ground-truth poses are float64 on both sides too."""
    want = list(JaxTestLoader(JaxFlatTestIndex(str(test_tree), CLASSES), 4, 32, num_workers=2))
    batches = list(_port_test_loader(test_tree))
    assert len(batches) == len(want) == 3 and int(batches[-1]["valid"].sum()) == 1
    for b, w in zip(batches, want):
        for k in w:
            np.testing.assert_array_equal(b[k], w[k])
        b["euler"] = b["euler"].astype(np.float64)
    jax.config.update("jax_enable_x64", True)
    try:
        jtrainer = JaxTrainer(
            jax_get_config("geodesic_bd", **{**SMALL, "compute_dtype": "float64",
                                             "stem_pool": None, "fused_conv_bn": None}),
            dictionary=_centers(), mesh=make_mesh(jax.devices("cpu")[:1]),
        )
        state = jax.device_get(jtrainer.init_state())
        stats = randomize_batch_stats(state.batch_stats, np.random.default_rng(1))
        f64 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
        jstate = state.replace(params=f64(state.params), batch_stats=f64(stats))
        jtrue, jpred, jlabels = jtrainer.predict(jstate, [dict(b) for b in batches])
        jmed = jtrainer.evaluate(jstate, [dict(b) for b in batches])
    finally:
        jax.config.update("jax_enable_x64", False)
    port = _trainer(compute_dtype="float64")
    port.model.load_state_dict(from_jax_variables(state.params, stats))
    pstate = port.init_state()
    ytrue, ypred, labels = port.predict(pstate, batches)
    assert ytrue.shape == ypred.shape == (9, 3)
    assert ytrue.dtype == ypred.dtype == jtrue.dtype == np.float64
    np.testing.assert_array_equal(labels, jlabels)
    np.testing.assert_allclose(ytrue, jtrue, rtol=0, atol=1e-8)
    np.testing.assert_allclose(ypred, jpred, rtol=0, atol=1e-8)
    med = port.evaluate(pstate, batches)
    assert np.isfinite(med) and abs(med - jmed) <= 1e-6
    assert port.metric_label(med) == jtrainer.metric_label(med)


# --- checkpoints -------------------------------------------------------------------


def _assert_same_state(a, b) -> None:
    """Weights, BN statistics, Adam's counts and moments, s and step equal."""
    assert a.step == b.step
    assert torch.equal(a.s, b.s)
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k
    pa = [p for g in a.optimizer.param_groups for p in g["params"]]
    pb = [p for g in b.optimizer.param_groups for p in g["params"]]
    for p, q in zip(pa, pb, strict=True):
        st, su = a.optimizer.state[p], b.optimizer.state[q]
        assert st.keys() == su.keys() == {"count", "mu", "nu"}
        assert st["count"] == su["count"]
        for k in ("mu", "nu"):
            assert st[k].dtype == su[k].dtype and torch.equal(st[k], su[k])
    assert a.optimizer.param_groups[0]["lr"] == b.optimizer.param_groups[0]["lr"]


def test_resume_is_bit_equal_to_an_uninterrupted_run(tmp_path):
    """Two fits of 1 warm-up + 1 main step in one trainer, against a fit
    that saves `last`, a new trainer (other initial weights) that restores
    it, and a second fit: every weight, BN statistic, Adam count and moment
    (bf16 mu), s and step equal bit for bit on CPU."""
    real, render = _loader(1, 2), _loader(2, 2)
    a = _trainer()
    sa = a.fit(a.init_state(), real[:1], render[:1])
    sa = a.fit(sa, real[1:], render[1:])
    b = _trainer(tmp_path)
    b.fit(b.init_state(), real[:1], render[:1])
    c = _trainer(tmp_path, seed=1)
    assert not torch.equal(c.model.feature_model.conv1.weight,
                           _trainer().model.feature_model.conv1.weight)
    sc = c.restore_checkpoint("last")
    assert sc.step == 2
    mu = next(iter(c.optimizer.state.values()))["mu"]
    assert mu.dtype == torch.bfloat16
    sc = c.fit(sc, real[1:], render[1:])
    assert sa.step == 4
    _assert_same_state(sa, sc)
    saved = torch.load(tmp_path / "checkpoints" / "last", weights_only=True)
    assert saved["step"] == 4 and saved["config"]["seed"] == 1
    assert sorted(p.name for p in (tmp_path / "checkpoints").iterdir()) == ["last"]


def test_best_checkpoint_metrics_and_plots(tmp_path):
    """With MedErr scripted per evaluation (eval_every 1: one eval after each
    step, one after each of 3 main epochs), `best` holds the epoch of the
    lowest epoch MedErr, `last` the last; plots.npz holds every MedErr; the
    metrics records carry the JAX Trainer's keys."""
    t = _trainer(tmp_path, num_warmup_epochs=0, num_epochs=3, eval_every=1)
    meds = iter([9.0, 5.0, 9.0, 3.0, 9.0, 4.0])
    t.evaluate = lambda state, loader: next(meds)
    state = t.fit(t.init_state(), _loader(3), _loader(4), test_loader=[], log_every=1)
    assert state.step == 3
    ck = tmp_path / "checkpoints"
    assert torch.load(ck / "best", weights_only=True)["step"] == 2
    assert torch.load(ck / "last", weights_only=True)["step"] == 3
    with np.load(tmp_path / "plots.npz") as f:
        assert f.files == ["val_loss"]
        np.testing.assert_array_equal(f["val_loss"], [9, 5, 9, 3, 9, 4])
    recs = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [set(r) for r in recs] == [STEP_KEYS, EVAL_KEYS, EPOCH_KEYS] * 3
    assert [r["step"] for r in recs] == [1, 1, 1, 2, 2, 2, 3, 3, 3]
    assert [r["med_err"] for r in recs if "epoch" in r] == [5, 3, 4]


def test_failed_background_write_surfaces(tmp_path, monkeypatch):
    """A background save that fails leaves the previous checkpoint and no
    temporary file, and wait_for_checkpoints raises from its error."""
    t = _trainer(tmp_path)
    state = t.init_state()
    t.save_checkpoint(state, "last")
    t.wait_for_checkpoints()

    def broken_save(obj, f):
        f.write(b"partial")
        raise OSError("no space left on device")

    monkeypatch.setattr(trainer_module.torch, "save", broken_save)
    state.step = 7
    t.save_checkpoint(state, "last")
    with pytest.raises(RuntimeError, match="background checkpoint save failed") as err:
        t.wait_for_checkpoints()
    assert isinstance(err.value.__cause__, OSError)
    t.wait_for_checkpoints()  # reported once
    monkeypatch.undo()
    assert [p.name for p in (tmp_path / "checkpoints").iterdir()] == ["last"]
    assert t.restore_checkpoint("last").step == 0


def test_labels_out_of_range_are_refused_on_the_host(test_tree):
    """A batch whose labels fall outside [0, num_classes) raises before any
    step or eval batch reaches the device; the model is untouched."""
    t = _trainer()
    before = {k: v.clone() for k, v in t.model.state_dict().items()}
    bad = _loader(5)
    bad[0]["label"] = bad[0]["label"] + 1  # 1..3 with 3 classes
    state = t.init_state()
    with pytest.raises(ValueError, match=r"labels must lie in \[0, 3\)"):
        t.fit(state, bad, _loader(6))
    neg = _loader(5)
    neg[0]["label"][0] = -1
    with pytest.raises(ValueError, match="labels must lie"):
        t.fit(state, neg, _loader(6))
    with pytest.raises(ValueError, match="labels must lie"):
        t.evaluate(state, [{**bad[0], "valid": np.ones(N_STREAM, bool)}])
    assert state.step == 0 and not t.history and not t.optimizer.state
    for k, v in t.model.state_dict().items():
        assert torch.equal(v, before[k]), k


# --- torchvision weights ------------------------------------------------------------


def _torchvision_resnet(arch: str, stages: int, rng) -> dict:
    """A seeded state_dict in torchvision's resnet layout for stages 1..stages
    (plus torchvision's `fc`, which the loaders do not read)."""
    blocks, bottleneck = {"resnet18": ((2, 2, 2, 2), False),
                          "resnet50": ((3, 4, 6, 3), True)}[arch]
    sd = {}

    def conv(name, o, i, k):
        sd[f"{name}.weight"] = rng.standard_normal((o, i, k, k)).astype(np.float32)

    def bn(name, c):
        sd[f"{name}.weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f"{name}.bias"] = rng.standard_normal(c).astype(np.float32)
        sd[f"{name}.running_mean"] = rng.standard_normal(c).astype(np.float32)
        sd[f"{name}.running_var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        sd[f"{name}.num_batches_tracked"] = np.array(1000, np.int64)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for s in range(stages):
        w = 64 * 2**s
        out = 4 * w if bottleneck else w
        for b in range(blocks[s]):
            t = f"layer{s + 1}.{b}"
            shapes = ([(w, cin, 1), (w, w, 3), (out, w, 1)] if bottleneck
                      else [(w, cin, 3), (w, w, 3)])
            for ci, (o, i, k) in enumerate(shapes, 1):
                conv(f"{t}.conv{ci}", o, i, k)
                bn(f"{t}.bn{ci}", o)
            if b == 0 and (s > 0 or cin != out):
                conv(f"{t}.downsample.0", out, cin, 1)
                bn(f"{t}.downsample.1", out)
            cin = out
    sd["fc.weight"] = rng.standard_normal((10, cin)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in sd.items()}


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_torchvision_backbone_matches_jax(tmp_path, arch):
    """load_torchvision_backbone of a torchvision-layout file equals
    from_jax_variables of the JAX load_torchvision_resnet trees exactly and
    loads strictly into the port's trunk; a missing key raises, VGG is not
    ported."""
    path = tmp_path / f"{arch}.pth"
    sd = _torchvision_resnet(arch, 2, np.random.default_rng(2))
    torch.save(sd, path)
    got = load_torchvision_backbone(str(path), arch, "layer2")
    want = from_jax_variables(*jax_load_torchvision_resnet(str(path), arch, 2))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    trunk = make_backbone(arch, "layer2")
    trunk.load_state_dict(got)
    assert torch.equal(trunk.layer2_0.downsample_conv.weight, sd["layer2.0.downsample.0.weight"])
    del sd["layer2.0.bn1.running_var"]
    with pytest.raises(KeyError, match="layer2.0.bn1.running_var"):
        load_torchvision_backbone(sd, arch, "layer2")
    with pytest.raises(KeyError, match="features.0.weight"):
        load_torchvision_backbone(sd, "vgg13", "fc6")


# --- cli train ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_tree(tmp_path_factory) -> Path:
    """augmented2/, renderforcnn/ (2-4 PNGs a class: 2 steps an epoch at 2
    items) and test/ (1-3), 32 px; a K = 8 dictionary; a torchvision
    resnet18 file."""
    root = tmp_path_factory.mktemp("cli")
    for sub, n, seed in (("augmented2", 2, 1), ("renderforcnn", 2, 2), ("test", 1, 3)):
        generate_pose_dataset(root / "data" / sub, CLASSES, n, 32, seed=seed, pattern="pose")
    KMeansDictionary(cluster_centers=_centers()).save(root / "kmeans.npz")
    torch.save(_torchvision_resnet("resnet18", 2, np.random.default_rng(5)), root / "r18.pth")
    return root


def _cli_args(root: Path, *extra: str) -> list[str]:
    return ["train", "--preset", "geodesic_bd", "--data-root", str(root / "data"),
            "--dictionary", str(root / "kmeans.npz"), "--feature-network", "resnet18",
            "--feature-layer", "layer2", "--N0", "128", "--N1", "16", "--N2", "8",
            "--image-size", "32", "--items-per-batch", "2", "--num-classes", "3",
            "--num-warmup-epochs", "1", "--num-epochs", "2", "--num-workers", "2",
            "--compute-dtype", "float32", "--device", "cpu", *extra]


def test_cli_train_and_resume(cli_tree, tmp_path, capsys):
    """`train` on a tiny tree exits 0 and writes checkpoints last, best and
    final, plots.npz with one MedErr a main epoch and med_err records;
    `--resume` continues from the saved step."""
    wd = tmp_path / "run"
    args = _cli_args(cli_tree, "--workdir", str(wd), "--pretrained-backbone",
                     str(cli_tree / "r18.pth"))
    assert cli.main(args) == 0
    out = capsys.readouterr().out
    assert "loaded pretrained backbone" in out
    med = float(out.split("final MedErr ")[1].split()[0])
    assert np.isfinite(med)
    assert sorted(p.name for p in (wd / "checkpoints").iterdir()) == ["best", "final", "last"]
    with np.load(wd / "plots.npz") as f:
        assert f["val_loss"].shape == (2,)
    recs = [json.loads(line) for line in (wd / "metrics.jsonl").read_text().splitlines()]
    assert sum("med_err" in r for r in recs) == 2
    final = torch.load(wd / "checkpoints" / "final", weights_only=True)
    assert final["step"] == 6 and final["config"]["num_classes"] == 3
    assert cli.main(args + ["--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 6" in out and "[warmup] step 7 " in out
    assert torch.load(wd / "checkpoints" / "final", weights_only=True)["step"] == 12


def test_cli_train_refuses_mismatched_classes(cli_tree, tmp_path):
    """--num-classes that disagrees with the --dbinfo class list exits."""
    dbinfo = tmp_path / "dbinfo.mat"
    spio.savemat(str(dbinfo), {"classes": np.array(CLASSES, dtype=object)})
    args = _cli_args(cli_tree, "--workdir", str(tmp_path / "run"), "--dbinfo", str(dbinfo))
    args[args.index("--num-classes") + 1] = "2"
    with pytest.raises(SystemExit, match="disagrees"):
        cli.main(args)


@pytest.mark.parametrize("flag", [
    ["--coordinator-address", "localhost:1"], ["--distributed"], ["--compile-cache", "off"],
], ids=lambda f: f[0])
def test_cli_train_takes_what_it_once_refused(cli_tree, tmp_path, monkeypatch, flag):
    """The flags that raised before they were ported now train: with
    `--distributed` and an explicit `--coordinator-address` (or torchrun's
    variables) a world of one joins a gloo process group, trains, writes
    its checkpoints and leaves the group; `--compile-cache off` builds the
    kernel library into a temporary directory of the process."""
    import socket
    import torch.distributed as dist

    from multi_modal_regression_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    default = _build.BUILD_DIR
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    if flag[0] == "--coordinator-address":
        flag = ["--distributed", flag[0], f"127.0.0.1:{port}", "--num-processes", "1",
                "--process-id", "0"]
    elif flag[0] == "--distributed":
        for k, v in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(port)),
                     ("WORLD_SIZE", "1"), ("RANK", "0")):
            monkeypatch.setenv(k, v)
    wd = tmp_path / "run"
    assert cli.main(_cli_args(cli_tree, "--workdir", str(wd), "--num-epochs", "1", *flag)) == 0
    assert not dist.is_initialized()
    assert torch.load(wd / "checkpoints" / "final", weights_only=True)["step"] == 4
    if flag[0] == "--compile-cache":
        assert _build.BUILD_DIR != default and _build.BUILD_DIR.name.startswith("mmr_kernels_")


@pytest.mark.parametrize("flag,field,value", [
    (["--N3", "8"], "N3", 8), (["--multires"], "multires", True),
], ids=lambda f: f[0] if isinstance(f, list) else None)
def test_cli_train_takes_the_multires_flags(cli_tree, flag, field, value):
    """--N3 and --multires reach the config (fields of the JAX names, ported
    with the multires models); without them the preset's values stand."""
    parse = cli.build_parser().parse_args
    base = cli._config_from_args(parse(_cli_args(cli_tree)))
    assert getattr(base, field) == {"N3": 100, "multires": False}[field]
    assert getattr(cli._config_from_args(parse(_cli_args(cli_tree, *flag))), field) == value


def test_cli_train_defaults_to_the_card():
    args = cli.build_parser().parse_args(["train", "--preset", "geodesic_bd", "--data-root", "x"])
    assert args.device == "cuda" and args.fn is cli.cmd_train
    assert args.num_workers == 8 and args.real_subdir == "augmented2"
