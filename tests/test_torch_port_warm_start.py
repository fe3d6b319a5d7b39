"""The two-stage pipelines through the port's command line, on the CPU: `cli
train --warm-start-*` (classifier into a `_rene` bin-delta model, a BD
oracle into a joint model, the joint model into cat-given-pose),
`--frozen-bn` in train and evaluate, `cli predict --analysis` and its two
refusals, and serving of the new model kinds. The grafts are plain copies:
what a preset freezes stays bit-equal to its source through training.
"""

from pathlib import Path

import numpy as np
import pytest
import scipy.io as spio
import torch

from multi_modal_regression_tpu_torch import cli
from multi_modal_regression_tpu_torch.models import surgery
from multi_modal_regression_tpu_torch.serving import make_inference_fn
from multi_modal_regression_tpu_torch.train.presets import (
    build_model,
    build_problem,
    get_config,
)

from test_torch_port_ops import one_torch_thread  # noqa: F401
from test_torch_port_trainer import cli_tree  # noqa: F401

# ResNet18 to layer2 (N0 128), 32 px, 3 classes, K 8 (the tree's dictionary),
# one step an epoch
FLAGS = ["--feature-network", "resnet18", "--feature-layer", "layer2", "--N0", "128",
         "--N1", "16", "--N2", "8", "--N3", "4", "--image-size", "32", "--items-per-batch",
         "2", "--num-classes", "3", "--max-iterations", "1", "--num-workers", "2",
         "--compute-dtype", "float32", "--device", "cpu"]


def _train(root: Path, preset: str, workdir: Path, *extra: str) -> dict:
    """`cli train` of a preset (1 main epoch, no warm-up); its `final`."""
    args = ["train", "--preset", preset, "--data-root", str(root / "data"), "--dictionary",
            str(root / "kmeans.npz"), *FLAGS, "--num-warmup-epochs", "0", "--num-epochs", "1",
            "--workdir", str(workdir), *extra]
    assert cli.main(args) == 0
    return torch.load(workdir / "checkpoints" / "final", weights_only=True)


def _sub(sd: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in sd.items() if k.startswith(prefix + ".")}


def _same(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b) and a
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_classifier_warm_start_into_rene(cli_tree, tmp_path, capsys):
    """classification -> simple_bd_rene --warm-start-kind classifier: the
    classifier's trunk and bin heads seed the model and, frozen (train_only
    res_models, BN in eval outside res_models), are still the classifier's
    bits after the fine-tune; the delta heads trained and their BN
    statistics moved."""
    cls = _train(cli_tree, "classification", tmp_path / "cls")
    rene = _train(cli_tree, "simple_bd_rene", tmp_path / "rene", "--warm-start-workdir",
                  str(tmp_path / "cls"), "--warm-start-preset", "classification",
                  "--warm-start-kind", "classifier")
    assert f"warm-started (classifier) from {tmp_path / 'cls'}" in capsys.readouterr().out
    sd, src = rene["model"], cls["model"]
    _same(_sub(sd, "feature_model"), _sub(src, "feature_model"))
    _same(_sub(sd, "bin_models"), _sub(src, "pose_models"))
    assert tuple(rene["config"]["train_only"]) == ("res_models",)
    # Adam's state for res_models' 8 leaves alone (3 kernels, a bias, 2 BNs)
    assert len(rene["optimizer"]) == 8
    assert not torch.equal(sd["res_models.bn1.running_mean"],
                           torch.zeros_like(sd["res_models.bn1.running_mean"]))


def test_oracle_chain_and_analysis(cli_tree, tmp_path, capsys, monkeypatch):
    """geodesic_bd (the oracle) -> joint_cat_pose_top1 --warm-start-kind
    oracle -> cat_given_pose --warm-start-kind oracle, then `predict
    --analysis` over the joint run's two checkpoints: the joint model's
    grafted trunk and head banks are the oracle's `final` bits, its fc its
    own init; cat_given_pose keeps the joint run's trunk and banks
    bit-equal through its frozen fine-tune (frozen_bn, train_only fc, no BN
    statistic moved) and prints its accuracy; the analysis .mat holds
    pose_results and top1_results with ypred_pose (N, 3, 3) and a finite
    report line for each. --analysis refuses a non-joint preset and
    --det-path."""
    grafts = []
    graft = surgery.graft_oracle_into_joint

    def spy(dst, src, kind):
        out = graft(dst, src, kind)
        # a copy: the entries it does not graft are the live model's tensors
        grafts.append({k: v.clone() for k, v in out.items()})
        return out

    monkeypatch.setattr(surgery, "graft_oracle_into_joint", spy)
    oracle = _train(cli_tree, "geodesic_bd", tmp_path / "oracle")
    joint = _train(cli_tree, "joint_cat_pose_top1", tmp_path / "joint", "--warm-start-workdir",
                   str(tmp_path / "oracle"), "--warm-start-preset", "geodesic_bd")
    assert len(grafts) == 1
    for m in ("feature_model", "bin_models", "res_models"):
        _same(_sub(grafts[0], m), _sub(oracle["model"], m))
    assert not torch.equal(grafts[0]["fc.fc1.weight"], joint["model"]["fc.fc1.weight"])
    cat = _train(cli_tree, "cat_given_pose", tmp_path / "cat", "--warm-start-workdir",
                 str(tmp_path / "joint"), "--warm-start-preset", "joint_cat_pose_top1")
    out = capsys.readouterr().out
    assert "final Acc " in out and out.count("warm-started (oracle)") == 2
    for m in ("feature_model", "bin_models", "res_models"):
        _same(_sub(cat["model"], m), _sub(joint["model"], m))
    assert len(cat["optimizer"]) == 2  # the fc's weight and bias

    pred = ["predict", "--preset", "joint_cat_pose_top1", "--data-root",
            str(cli_tree / "data"), "--dictionary", str(cli_tree / "kmeans.npz"), *FLAGS,
            "--workdir", str(tmp_path / "joint")]
    assert cli.main([*pred, "--analysis", "--checkpoint", "final,last",
                     "--analysis-names", "pose,top1"]) == 0
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if "cat acc" in ln]
    assert [ln.split(":")[0] for ln in lines] == ["pose", "top1"]
    mat = spio.loadmat(tmp_path / "joint" / "results_run_analysis.mat")
    assert {"pose_results", "top1_results"} <= set(mat)
    r = mat["pose_results"][0, 0]
    n = len(r["ytrue_cat"].ravel())
    assert r["ypred_pose"].shape == (n, 3, 3) and r["ytrue_pose"].shape == (n, 3)
    assert np.isfinite(r["ypred_pose"]).all() and n > 0
    with pytest.raises(SystemExit, match="needs a joint BD preset"):
        cli.main([*pred[:2], "geodesic_bd", *pred[3:], "--analysis"])
    with pytest.raises(SystemExit, match="mutually exclusive"):
        cli.main([*pred, "--analysis", "--det-path", str(tmp_path)])


def test_frozen_bn_train_and_evaluate(cli_tree, tmp_path, capsys):
    """`train --frozen-bn` trains every weight with BN in eval mode: no
    running statistic moves from its init (means 0, variances 1) while the
    weights do; `evaluate --frozen-bn` fine-tunes from that `final` with
    the statistics still untouched and prints the ensembled MedErr."""
    wd = tmp_path / "fz"
    init = build_model(get_config("geodesic_bd", **dict(
        feature_network="resnet18", feature_layer="layer2", N0=128, N1=16, N2=8,
        dict_size=8, num_classes=3)), "cpu").state_dict()
    final = _train(cli_tree, "geodesic_bd", wd, "--frozen-bn")
    assert final["config"]["frozen_bn"] is True
    for k, v in final["model"].items():
        if "running" in k:
            assert torch.equal(v, init[k]), k
    assert not torch.equal(final["model"]["feature_model.conv1.weight"],
                           init["feature_model.conv1.weight"])
    args = ["evaluate", "--preset", "geodesic_bd", "--data-root", str(cli_tree / "data"),
            "--dictionary", str(cli_tree / "kmeans.npz"), *FLAGS, "--workdir", str(wd),
            "--checkpoint", "final", "--eval-num-epochs", "1", "--frozen-bn"]
    assert cli.main(args) == 0
    assert "ensembled MedErr" in capsys.readouterr().out


# the six new model kinds and a preset of each
SERVED = {
    "joint_bd_v1": "joint_cat_pose_top1_new", "joint_bd_v2": "joint_cat_pose2_weighted",
    "joint_reg_v3": "joint_cat_pose3_top1", "elhoseiny_bd": "elhoseiny_bd",
    "elhoseiny_reg": "elhoseiny_regression", "categorization": "categorization",
}


@pytest.mark.parametrize("kind", sorted(SERVED))
def test_new_kinds_serve(kind):
    """make_inference_fn serves each new kind on the CPU: poses (B, 3)
    equal to the problem's decode of the model's eval-mode output, or int32
    class ids for the category problem; the labels do not change them."""
    small = dict(feature_network="resnet18", feature_layer="layer4", N0=512, N1=16, N2=8,
                 N3=4, dict_size=5, num_classes=3)
    cfg = get_config(SERVED[kind], **small)
    centers = (0.5 * np.random.default_rng(0).standard_normal((5, 3))).astype(np.float32)
    model = build_model(cfg, "cpu")
    problem = build_problem(cfg, centers, "cpu")
    infer = make_inference_fn(model, problem)
    images = np.random.default_rng(1).integers(0, 256, (4, 32, 32, 3), np.uint8)
    got = infer(images, np.array([0, 1, 2, 0], np.int32))
    again = infer(images, np.array([2, 2, 1, 1], np.int64))
    assert torch.equal(got, again)
    if cfg.problem == "category":
        assert got.dtype == torch.int32 and got.shape == (4,)
    else:
        assert got.dtype == torch.float32 and got.shape == (4, 3)
    with pytest.raises(ValueError, match="labels must be in"):
        infer(images, np.array([0, 1, 2, 3], np.int32))
