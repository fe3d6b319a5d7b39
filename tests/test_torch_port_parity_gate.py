"""The port's quality-parity gate (`cli verify-parity --device cpu`, the port's
tools/parity.run_parity_gate) end to end on the synthesized mini PASCAL3D+
release, at tests/test_parity_gate.py's tiny settings (ResNet18, N0 512, N1
16, N2 8, K 4, 32 px, 1 item a class, 2 steps an epoch, 1 warm-up + 1 main
epoch, 1 fine-tune epoch), checked as that test checks the JAX gate: five
stages with finite numbers, the no-pretrained deviation flagged, the same
evaluate and detections stages on resume. Also: stage 1's tree equal to
the JAX package's prepare_pascal3d tree of the same release (the tolerances
of test_torch_port_prep.same_tree, `ydata` within 1e-6); `cli predict
--det-path` then `cli evaluate-detections` on the gate's ensembled
checkpoint give the gate's detection table; `cli prepare-data --dataset
synthetic` writes the JAX command's tree; the device-running subcommand
defaults to the card.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from multi_modal_regression_tpu.cli import main as jax_main
from multi_modal_regression_tpu.tools.ingest import prepare_pascal3d as jax_prepare_pascal3d
from multi_modal_regression_tpu.tools.synthetic import generate_pascal3d_release
from multi_modal_regression_tpu_torch import cli
from multi_modal_regression_tpu_torch.tools.ingest import (
    load_annotations_for_images,
    read_image_set,
)

from test_torch_port_ops import one_torch_thread  # noqa: F401
from test_torch_port_prep import same_tree

CLASSES = ("aeroplane", "bicycle", "boat")
TINY = ["--classes", ",".join(CLASSES), "--feature-network", "resnet18", "--N0", "512",
        "--N1", "16", "--N2", "8", "--dict-size", "4", "--image-size", "32",
        "--items-per-batch", "1", "--max-iterations", "2", "--num-epochs", "1",
        "--num-warmup-epochs", "1", "--eval-num-epochs", "1", "--num-workers", "2"]
STAGES = {"prepare_data", "dictionary", "train", "evaluate", "detections"}


def _run(argv: list[str]) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def release(tmp_path_factory):
    """(root, release db, VOC dir, a detection set): the VOC val images' GT
    boxes of each class as 'detections' (the maskrcnn txt protocol),
    cropped by the port's `cli prepare-detections`."""
    root = tmp_path_factory.mktemp("gate")
    db, voc = generate_pascal3d_release(root / "release", classes=CLASSES)
    det_src = root / "dets"
    det_src.mkdir()
    names = read_image_set(voc / "ImageSets" / "Main" / "val.txt")
    for cls in CLASSES:
        rows = []
        for n in names:
            for a in load_annotations_for_images(db / "Annotations" / f"{cls}_pascal", [n])[0] or ():
                b = a.bbox
                rows.append(f"{n} {b[0]} {b[1]} {b[2]} {b[3]} 0.9")
        (det_src / f"results_{cls}.txt").write_text("\n".join(rows) + "\n")
    _run(["prepare-detections", "--detector", "maskrcnn", "--det-source", str(det_src),
          "--images-dir", str(voc / "JPEGImages"),
          "--image-set", str(voc / "ImageSets" / "Main" / "val.txt"),
          "--out", str(det_src / "det_set"), "--image-size", "32", "--workers", "2",
          "--detector-classes", ",".join(CLASSES)])
    return root, db, voc, det_src / "det_set"


@pytest.fixture(scope="module")
def gate(release):
    """The gate from the raw release, then again on its artifacts:
    (workdir, first table, second table, second run's output)."""
    root, db, voc, det_set = release
    common = ["verify-parity", "--data-root", str(root / "prepared"),
              "--det-path", str(det_set), "--annotations", str(db / "Annotations"),
              "--workdir", str(root / "run"), *TINY, "--device", "cpu"]
    _run([*common, "--db-path", str(db), "--voc-dir", str(voc)])
    first = json.loads((root / "run" / "parity.json").read_text())
    out = _run(common)
    second = json.loads((root / "run" / "parity.json").read_text())
    return root / "run", first, second, out


def test_verify_parity_gate_end_to_end(gate):
    """Every stage ran with finite numbers in range; the scratch-trained
    run flags the missing pretrained backbone; the resumed run reuses
    every artifact (final, the snapshots and done.json, detections.json)
    and writes the same evaluate and detections stages."""
    workdir, table, table2, out = gate
    stages = table["stages"]
    assert set(stages) == STAGES
    assert np.isfinite(stages["train"]["med_err_deg"])
    ev = stages["evaluate"]
    assert np.isfinite(ev["ensembled_med_err_deg"]) and 0.0 <= ev["acc_pi_6_pct"] <= 100.0
    assert len(ev["snapshot_med_errs"]) >= 1
    assert set(ev["per_class"]) == set(CLASSES) | {"mean"}
    det = stages["detections"]
    assert set(det) == set(CLASSES) | {"mean"}
    for cls in CLASSES:
        assert 0.0 <= det[cls]["ap"] <= 1.0 and np.isfinite(det[cls]["arp"])
    assert any("pretrained" in d for d in table["deviations"])
    assert json.loads((workdir / "snapshots" / "done.json").read_text()) == {
        "snapshots": len(ev["snapshot_med_errs"])}
    for name in ("final", "ensemble_final"):
        assert (workdir / "checkpoints" / name).exists()
    assert "skipping training" in out and "skipping fine-tune" in out
    assert "cached results exist" in out
    assert set(table2["stages"]) == STAGES
    for k in ("dictionary", "train", "evaluate", "detections"):
        assert table2["stages"][k] == stages[k], k


def test_stage_one_tree_matches_jax(release, gate, tmp_path):
    """The tree the gate ingested (beside its packed caches) is the JAX
    package's prepare_pascal3d tree of the same release."""
    root, db, voc, _ = release
    jax_prepare_pascal3d(db, voc, tmp_path / "jax", classes=CLASSES, log=lambda s: None)
    assert same_tree(tmp_path / "jax", root / "prepared", approx={"ydata": 1e-6},
                     skip=(".packed",)) > 500


def test_predict_det_path_then_evaluate_detections_give_the_gate_table(release, gate):
    """`cli predict --det-path` from the gate's ensembled checkpoint writes
    results_<save>_<set>.mat; `cli evaluate-detections` on it writes the
    AP / AVP / ARP table the gate's detections stage holds."""
    root, db, _, det_set = release
    workdir, table, _, _ = gate
    out = _run(["predict", "--preset", "geodesic_bd", "--dictionary",
                str(workdir / "kmeans_4.npz"), "--checkpoint", "ensemble_final",
                "--det-path", str(det_set), "--workdir", str(workdir), "--num-classes", "3",
                *TINY[2:14], "--device", "cpu"])
    results = workdir / f"results_run_{det_set.name}.mat"
    assert f"wrote {results}" in out
    _run(["evaluate-detections", "--results", str(results), "--det-path", str(det_set),
          "--annotations", str(db / "Annotations"), "--dbinfo", str(root / "prepared" /
                                                                  "dbinfo.mat"),
          "--out", str(workdir / "det_table.json")])
    got = json.loads((workdir / "det_table.json").read_text())
    rounded = {cls: {k: round(float(v), 4) for k, v in row.items()} for cls, row in got.items()}
    assert rounded == table["stages"]["detections"]


def test_prepare_data_synthetic_matches_jax(tmp_path):
    """`prepare-data --dataset synthetic` (the default) writes the JAX
    command's three trees: the same names (poses in them) and pixels."""
    args = ["prepare-data", "--images-per-class", "2", "--image-size", "24",
            "--classes", "car,chair", "--seed", "4", "--pattern", "pose"]
    assert jax_main([*args, "--out", str(tmp_path / "jax")]) == 0
    _run([*args, "--out", str(tmp_path / "port")])
    assert same_tree(tmp_path / "jax", tmp_path / "port") == 3 * (2 + 3)


def test_new_subcommands_default_to_the_card(tmp_path):
    """verify-parity runs on the card unless --device cpu, and an unusable
    card fails before any stage (no tree written); predict --det-path
    takes predict's device; the data-prep and detection-scoring commands
    are host code and take no device."""
    parse = cli.build_parser().parse_args
    vp = parse(["verify-parity", "--data-root", "x"])
    assert vp.device == "cuda" and vp.fn is cli.cmd_verify_parity
    assert not vp.no_packed_cache and vp.num_workers == 8 and vp.workdir is None
    pr = parse(["predict", "--preset", "geodesic_bd", "--det-path", "d"])
    assert pr.device == "cuda" and pr.det_path == "d"
    for argv, fn in ((["prepare-data", "--out", "o"], cli.cmd_prepare_data),
                     (["prepare-detections", "--detector", "vk", "--det-source", "s",
                       "--images-dir", "i", "--out", "o"], cli.cmd_prepare_detections),
                     (["evaluate-detections", "--results", "r", "--det-path", "d",
                       "--annotations", "a"], cli.cmd_evaluate_detections)):
        args = parse(argv)
        assert args.fn is fn and not hasattr(args, "device")
    assert parse(["prepare-data", "--out", "o"]).dataset == "synthetic"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            cli.main(["verify-parity", "--data-root", str(tmp_path / "data"),
                      "--workdir", str(tmp_path / "w")])
        assert not (tmp_path / "data").exists() and not (tmp_path / "w").exists()
