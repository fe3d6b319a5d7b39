"""The one-command quality-parity gate (`cli verify-parity`; port of the
JAX package's tools/parity.py).

The acceptance gate for the rebuild is quality parity with the reference
chain on PASCAL3D+ (BASELINE.json): MedErr and Acc@pi/6 from
  setupDataFlipped_pascal3d.m:39-74  (data prep)
  -> learnKmeansDictionary.py:41-47  (pose dictionary)
  -> learnGeodesicBDModel.py:106-263 (train)
  -> evaluateGeodesicBDModel.py:92-145 (fine-tune + snapshot ensemble)
  -> computeAVP.m:40-145 / computeARP.m (detection metrics)
with the headline metric at axisAngle.py:70-95 (get_error2).

`run_parity_gate` composes the port's pieces of that chain into one call,
every device stage on `device` (the card unless the caller asks for the
CPU):

  python -m multi_modal_regression_tpu_torch.cli verify-parity \
      --db-path PASCAL3D+_release1.1 --render-root data/renderforcnn \
      --pretrained-backbone resnet50.pth --workdir runs/parity \
      [--det-path <detection set> --annotations <Annotations root>]

Every stage is skipped if its artifact already exists (idempotent resume),
and the final table (per-snapshot MedErr, ensembled MedErr, Acc@pi/6,
optional per-class AP/AVP/ARP) is printed and written to
<workdir>/parity.json, in the JAX package's layout.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable, Mapping

import numpy as np
import torch

from multi_modal_regression_tpu_torch.data.index import ClassBalancedIndex
from multi_modal_regression_tpu_torch.data.naming import parse_name
from multi_modal_regression_tpu_torch.data.targets import euler_to_pose
from multi_modal_regression_tpu_torch.dictionary.kmeans import fit_kmeans


def gather_tree_poses(
    tree_root: str | Path, db_type: str = "render",
    classes: tuple[str, ...] | None = None,
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """Axis-angle poses (N, 3) float32 of every filename-encoded image in
    the tree, with the db tilt-sign convention applied (real uses +ct,
    render uses -ct, dataGenerators.py:57-62; the loaders train against the
    same signs). The Euler -> axis-angle map runs on `device`."""
    ct_sign = 1.0 if db_type == "real" else -1.0
    kw = {"classes": classes} if classes is not None else {}
    index = ClassBalancedIndex(str(tree_root), db_type, **kw)
    eulers = []
    for c in range(index.num_classes):
        for name in index.list_image_names[c]:
            p = parse_name(name)
            eulers.append((p.az, p.el, ct_sign * p.ct))
    euler = torch.as_tensor(np.asarray(eulers, np.float32), device=device)
    return euler_to_pose(euler).cpu().numpy()


def fit_pose_dictionary(
    tree_root: str | Path, size: int, out_path: str | Path, seed: int = 0,
    classes: tuple[str, ...] | None = None, db_type: str = "render",
    log: Callable[[str], None] = print,
    device: torch.device | str = "cuda",
) -> None:
    """learnKmeansDictionary.py:25-47: parse every filename-encoded pose in
    the tree, fit kmeans on `device`, save npz. db_type selects the
    tilt-sign convention the poses are parsed with; it must match the tree
    the training loader reads (the no-render fallback fits on the REAL train
    tree, whose targets use +ct)."""
    y = gather_tree_poses(tree_root, db_type, classes, device)
    log(f"[dictionary] {len(y)} poses; fitting kmeans K={size}")
    d = fit_kmeans(y, size, seed=seed, device=device)
    d.save(out_path)


def run_parity_gate(
    workdir: str | Path,
    data_root: str | Path,
    db_path: str | Path | None = None,
    voc_dir: str | Path | None = None,
    render_root: str | Path | None = None,
    pretrained_backbone: str | Path | None = None,
    det_path: str | Path | None = None,
    annotations: str | Path | None = None,
    classes: tuple[str, ...] | None = None,
    overrides: Mapping[str, Any] | None = None,
    eval_num_epochs: int | None = None,
    workers: int = 8,
    packed_cache: bool = True,
    log: Callable[[str], None] = print,
    device: torch.device | str = "cuda",
) -> dict:
    """Run the full chain; returns (and writes) the parity table.

    packed_cache (default ON): pack the train/render/test trees into
    uint8 memmap shards on first use, so that each PNG is decoded once
    and not in every epoch, where the host's decode would bound the gate
    (PERF.md §5). Each cache lives in a `.packed` directory NEXT TO its
    tree (`<tree parent>/.packed/<tree>_<size>px`) — the same location
    `train/evaluate --packed-cache auto` uses — so a data root that
    already trained with the packed cache pays no second decode pass and
    stores no second copy. Pixels are byte-identical to the PNG decode
    path (tests/test_torch_port_packed.py).

    data_root: the prepared tree (train/ test/ augmented2/ original/). If
    missing and db_path is given, stage 1 ingests the release into it.
    render_root: a RenderForCNN-style filename-encoded render tree; absent
    -> the dictionary is learned from the real train tree and training
    runs real-only (documented deviation, flagged in the table).
    det_path: a prepared detection set (dbinfo.mat + all/) for the AVP/ARP
    stage; requires `annotations` (PASCAL3D+ Annotations root).
    device: where the dictionary fit, training, the fine-tune and the
    detection inference run.
    """
    from multi_modal_regression_tpu_torch.data import (
        PASCAL3D_CLASSES,
        BalancedLoader,
        FlatTestIndex,
        TestLoader,
    )
    from multi_modal_regression_tpu_torch.dictionary.kmeans import KMeansDictionary
    from multi_modal_regression_tpu_torch.metrics import per_class_report
    from multi_modal_regression_tpu_torch.train.evaluator import SnapshotEnsembleEvaluator
    from multi_modal_regression_tpu_torch.train.presets import get_config
    from multi_modal_regression_tpu_torch.train.trainer import Trainer

    torch.empty(0, device=device)  # an unusable device fails before any stage runs
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    data_root = Path(data_root)
    classes = tuple(classes) if classes else PASCAL3D_CLASSES
    table: dict[str, Any] = {"stages": {}, "deviations": []}

    # -- stage 1: data prep (setupData*_pascal3d.m) -----------------------
    if not (data_root / "train").exists():
        if db_path is None:
            raise FileNotFoundError(
                f"{data_root}/train missing and no --db-path to ingest from"
            )
        from multi_modal_regression_tpu_torch.tools.ingest import prepare_pascal3d

        voc = Path(voc_dir) if voc_dir else (
            Path(db_path) / "PASCAL" / "VOCdevkit" / "VOC2012"
        )
        log(f"[prepare-data] ingesting {db_path} -> {data_root}")
        prepare_pascal3d(
            db_path, voc, data_root, classes=classes, workers=workers,
            log=log,
        )
    table["stages"]["prepare_data"] = str(data_root)

    # -- stage 2: pose dictionary (learnKmeansDictionary.py) --------------
    cfg_overrides = dict(overrides or {})
    dict_size = cfg_overrides.get("dict_size", 200)
    dict_path = workdir / f"kmeans_{dict_size}.npz"
    dict_tree = Path(render_root) if render_root else data_root / "train"
    dict_db_type = "render" if render_root else "real"
    if render_root is None:
        table["deviations"].append(
            "no render tree: dictionary learned from real train poses "
            "(reference uses RenderForCNN poses, learnKmeansDictionary.py:25)"
        )
    if not dict_path.exists():
        fit_pose_dictionary(
            dict_tree, dict_size, dict_path, classes=classes,
            db_type=dict_db_type, log=log, device=device,
        )
    table["stages"]["dictionary"] = str(dict_path)
    dictionary = KMeansDictionary.load(dict_path)

    # -- stage 3: train (learnGeodesicBDModel.py) -------------------------
    cfg_overrides.setdefault("num_classes", len(classes))
    cfg = get_config("geodesic_bd", **cfg_overrides)
    trainer = Trainer(cfg, dictionary=dictionary, workdir=workdir, device=device)
    # real data: the pose-jittered augmented2 tree when the release had CAD
    # models (the reference default), otherwise the flipped train tree
    real_sub = "augmented2" if (data_root / "augmented2").exists() else "train"
    if real_sub == "train":
        table["deviations"].append(
            "no augmented2 tree (release lacked CAD models): training on "
            "the flipped train crops"
        )
    load_size = cfg.device_resize_from or cfg.image_size

    def packed(index, tree: Path):
        """Pack next to the tree (the shared `auto` layout,
        data/packed.py default_cache_dir); a READ-ONLY data volume falls
        back to a workdir-local cache instead of crashing the gate."""
        from multi_modal_regression_tpu_torch.data.packed import default_cache_dir, pack_index

        try:
            return pack_index(
                index, default_cache_dir(tree, load_size),
                image_size=load_size, num_workers=workers,
            )
        except OSError as e:
            fallback = workdir / "packed" / f"{tree.name}_{load_size}px"
            log(f"[pack] {tree}: cache next to tree unavailable ({e}); "
                f"using {fallback}")
            return pack_index(
                index, fallback, image_size=load_size, num_workers=workers,
            )

    def balanced_loader(tree: Path, db_type: str):
        index = ClassBalancedIndex(str(tree), db_type, classes=classes)
        if packed_cache:
            from multi_modal_regression_tpu_torch.data import PackedBalancedLoader

            pack = packed(index, tree)
            return PackedBalancedLoader(
                index, pack, items_per_batch=cfg.items_per_batch,
                seed=cfg.seed,
            )
        return BalancedLoader(
            index, cfg.items_per_batch, load_size, num_workers=workers,
            seed=cfg.seed,
        )

    real = balanced_loader(data_root / real_sub, "real")
    render = (
        balanced_loader(Path(render_root), "render")
        if render_root else None
    )
    test_index = FlatTestIndex(str(data_root / "test"), classes=classes)
    if packed_cache:
        from multi_modal_regression_tpu_torch.data import PackedTestLoader

        test = PackedTestLoader(
            test_index,
            packed(test_index, data_root / "test"),
            batch_size=cfg.eval_batch,
        )
    else:
        test = TestLoader(
            test_index, cfg.eval_batch, load_size, num_workers=workers,
        )
    ckpt = workdir / "checkpoints" / "final"
    if ckpt.exists():
        log("[train] final checkpoint exists; skipping training")
        state = trainer.restore_checkpoint("final")
    else:
        state = trainer.init_state()
        if pretrained_backbone:
            from multi_modal_regression_tpu_torch.models.pretrained import (
                load_torchvision_backbone,
            )

            trainer.model.feature_model.load_state_dict(load_torchvision_backbone(
                pretrained_backbone, cfg.feature_network, cfg.feature_layer
            ))
            log(f"[train] loaded pretrained backbone {pretrained_backbone}")
        else:
            table["deviations"].append(
                "no pretrained backbone: training from scratch (the "
                "reference always starts from torchvision weights, "
                "binDeltaModels.py:106)"
            )
        state = trainer.fit(state, real, render, test_loader=test)
        trainer.save_checkpoint(state, "final")
    med_plain = trainer.evaluate(state, test)
    table["stages"]["train"] = {"med_err_deg": round(float(med_plain), 4)}
    log(f"[train] MedErr (pre-ensemble): {med_plain:.3f} deg")

    # -- stage 4: snapshot-ensemble evaluation (evaluateGeodesicBDModel.py)
    # idempotent resume: the fine-tune costs as much as training, so a
    # completed run (marked by snapshots/done.json) is reloaded from its
    # num<k>.npz artifacts + the ensemble_final checkpoint instead of
    # re-running
    ev = SnapshotEnsembleEvaluator(trainer, workdir=workdir / "snapshots")
    done_marker = workdir / "snapshots" / "done.json"
    if done_marker.exists() and ev.load_saved() > 0:
        log(
            f"[evaluate] {len(ev.snapshots)} saved snapshots exist; "
            "skipping fine-tune"
        )
        state = trainer.restore_checkpoint("ensemble_final")
    else:
        state = ev.run(state, real, render, test, num_epochs=eval_num_epochs)
        # save with the trainer's own Adam, its moments cleared, so that
        # restore_checkpoint reads it back: the fine-tune's cyclical-SGD
        # state is not needed downstream (stage 5 is inference-only)
        trainer.save_checkpoint(
            state.replace(optimizer=trainer.init_state().optimizer),
            "ensemble_final",
        )
        # the marker must never exist without its checkpoint committed
        trainer.wait_for_checkpoints()
        done_marker.write_text(json.dumps({"snapshots": len(ev.snapshots)}))
    med_ens, ypred_ens = ev.ensemble()
    first = ev.snapshots[0]
    report = per_class_report(
        first.ytrue, ypred_ens, first.labels, classes,
        representation="axis_angle",
    )
    table["stages"]["evaluate"] = {
        "snapshot_med_errs": [round(s.med_err, 4) for s in ev.snapshots],
        "ensembled_med_err_deg": round(float(med_ens), 4),
        "acc_pi_6_pct": round(float(report["mean"]["acc_30deg"]), 2),
        "per_class": {
            k: {
                "med_err_deg": round(v["median_err_deg"], 3),
                "acc_pi_6_pct": round(v["acc_30deg"], 2),
            }
            for k, v in report.items()
        },
    }
    log(
        f"[evaluate] ensembled MedErr {med_ens:.3f} deg, "
        f"Acc@pi/6 {report['mean']['acc_30deg']:.2f}%"
    )

    # -- stage 5: detection metrics (computeAVP.m / computeARP.m) ---------
    if det_path is not None:
        if annotations is None:
            raise ValueError("det_path requires annotations")
        det_cache = workdir / "detections.json"
        if det_cache.exists():
            table["stages"]["detections"] = json.loads(det_cache.read_text())
            log(f"[detections] cached results exist ({det_cache}); skipping")
        else:
            from multi_modal_regression_tpu_torch.detection import (
                DetectionSetIndex,
                build_voc_ground_truth,
                evaluate_detection_results,
                run_detection_inference,
            )

            index = DetectionSetIndex(str(det_path))
            bboxes, ypred, labels, scores = run_detection_inference(
                state.model, trainer.problem, index, batch_size=cfg.eval_batch,
            )
            annos = build_voc_ground_truth(
                annotations, index.image_names, classes
            )
            det_table = evaluate_detection_results(
                annos, bboxes, ypred, labels, classes, scores=scores
            )
            table["stages"]["detections"] = {
                cls: {k: round(float(v), 4) for k, v in row.items()}
                for cls, row in det_table.items()
            }
            det_cache.write_text(
                json.dumps(table["stages"]["detections"], indent=2)
            )
        m = table["stages"]["detections"]["mean"]
        log(
            f"[detections] mean AP {m['ap']:.4f} AVP {m['avp']:.4f} "
            f"ARP {m['arp']:.4f}"
        )

    (workdir / "parity.json").write_text(json.dumps(table, indent=2))
    log(f"[verify-parity] wrote {workdir / 'parity.json'}")
    return table
