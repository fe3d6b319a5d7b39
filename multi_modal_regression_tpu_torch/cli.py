"""Command line of the port (the JAX package's cli.py, as far as ported).

    python -m multi_modal_regression_tpu_torch.cli train \\
        --preset geodesic_bd --data-root data/ \\
        --dictionary kmeans_dictionary_axis_angle_200.npz [--save-str g0] \\
        [--workdir runs/g0] [--resume] [--pretrained-backbone resnet50.pth] \\
        [--device cuda|cpu] [config overrides ...]

    python -m multi_modal_regression_tpu_torch.cli dictionary \\
        --data-root <render tree> --out kmeans_dictionary_axis_angle_200.npz \\
        [--type kmeans|gmm] [--size 200] [--seed 0] [--db-type render|real] \\
        [--dbinfo dbinfo.mat | --num-classes N] [--device cuda|cpu]

`train` trains a preset on the device (the card unless `--device cpu`)
from the PNG trees under --data-root (<real-subdir>, <render-subdir> and
<test-subdir>, each <class>/*.png with the pose in the file name),
evaluates MedErr after every main epoch and writes checkpoints `last`,
`best` and `final` under <workdir>/checkpoints; `--resume` continues from
`last`. `dictionary` parses the pose of every image of a tree from its file
name and fits a kmeans or GMM pose dictionary on the device. Both take the
JAX package's arguments. Those whose machinery is not ported yet
(`--packed-cache`, `--distributed`, `--warm-start-*`, `--compile-cache`,
and the config settings that presets.py refuses) raise NotImplementedError
when given; the other subcommands arrive with their slices (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

import numpy as np

from multi_modal_regression_tpu_torch import PASCAL3D_CLASSES


def _add_common_data_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--data-root", type=str, required=True)
    p.add_argument("--real-subdir", type=str, default="augmented2")
    p.add_argument("--render-subdir", type=str, default="renderforcnn")
    p.add_argument("--test-subdir", type=str, default="test")
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--dbinfo", type=str, default=None,
                   help="dbinfo.mat with a 'classes' list (ObjectNet3D, "
                        "learnObjectnetBDModel.py:54-56); default: the 12 "
                        "PASCAL3D+ classes")
    p.add_argument("--protocol", choices=("balanced", "flat"), default=None,
                   help="'balanced' = class-balanced real+render loaders; "
                        "'flat' = single shuffled flat train loader "
                        "(ObjectNet protocol). Default: flat for "
                        "objectnet_* presets, balanced otherwise")
    p.add_argument("--test-protocol", choices=("filenames", "mat"),
                   default="filenames",
                   help="'filenames' = PNG test tree with pose-encoded "
                        "names (TestImages); 'mat' = precomputed per-image "
                        ".mat crop sets (the Pascal3dAll protocol: "
                        "ablationGeodesicBDModel.py:72-74, "
                        "learnClassificationModel.py:146-149)")
    p.add_argument("--mat-root", type=str, default=None,
                   help="root of the .mat crop trees for --test-protocol "
                        "mat (default <data-root>/original)")
    p.add_argument("--mat-split", choices=("val", "test"), default="test",
                   help="'val' = pascal_train crops (ablation model "
                        "selection), 'test' = pascal_val")
    p.add_argument("--packed-cache", type=str, default=None,
                   help="pre-decoded uint8 crop cache: not ported yet")


def _add_config_overrides(p: argparse.ArgumentParser) -> None:
    # reference flag spellings kept where they exist
    p.add_argument("--save-str", type=str, default="run")
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--dict-size", type=int, default=None)
    p.add_argument("--N0", type=int, default=None)
    p.add_argument("--N1", type=int, default=None)
    p.add_argument("--N2", type=int, default=None)
    p.add_argument("--N3", type=int, default=None)
    p.add_argument("--init-lr", type=float, default=None)
    p.add_argument("--num-epochs", type=int, default=None)
    p.add_argument("--num-warmup-epochs", type=int, default=None)
    p.add_argument("--max-iterations", type=int, default=None)
    p.add_argument("--items-per-batch", type=int, default=None)
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--feature-network", type=str, default=None)
    p.add_argument("--feature-layer", type=str, default=None)
    p.add_argument("--multires", action="store_true", default=None)
    p.add_argument("--compute-dtype", type=str, default=None,
                   choices=("float32", "bfloat16"))
    p.add_argument("--remat", type=str, default=None,
                   choices=("none", "block", "stage", "conv", "dots",
                            "nothing"),
                   help="backward-pass rematerialization: not ported yet")
    p.add_argument("--optimizer-dtype", type=str, default=None,
                   choices=("float32", "bfloat16"),
                   help="Adam first-moment storage (bfloat16 default; "
                        "float32 = the reference's torch.optim.Adam)")
    p.add_argument("--lr-scaling", type=str, default=None,
                   choices=("none", "linear", "sqrt"),
                   help="global-batch LR rule: scale init_lr by "
                        "(items-per-batch/8) [linear] or its sqrt")
    p.add_argument("--frozen-bn", action="store_true", default=None,
                   help="BatchNorm in eval mode during training: not "
                        "ported yet")
    p.add_argument("--device-resize-from", type=int, default=None,
                   help="resize on the device: not ported yet")
    p.add_argument("--checkpoint-async",
                   action=argparse.BooleanOptionalAction, default=None,
                   help="write checkpoints on a background thread "
                        "(default on; the copy to the host stays on the "
                        "caller's thread)")
    p.add_argument("--train-flip", action="store_true", default=None,
                   help="random horizontal flips in the step: not ported yet")
    p.add_argument("--workdir", type=str, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--compile-cache", type=str, default=None,
                   help="persistent compilation cache: not ported yet")


# the ExperimentConfig fields _add_config_overrides exposes; shared by every
# subcommand that builds a config so no flag is silently dropped
_OVERRIDE_FIELDS = (
    "num_classes", "dict_size", "N0", "N1", "N2", "N3", "init_lr",
    "num_epochs", "num_warmup_epochs", "max_iterations",
    "items_per_batch", "image_size", "feature_network", "feature_layer",
    "multires", "compute_dtype", "device_resize_from", "train_flip",
    "remat", "optimizer_dtype", "lr_scaling", "frozen_bn",
    "checkpoint_async",
)

# flags whose machinery is not ported: giving one raises
_NOT_PORTED_FLAGS = (
    "packed_cache", "distributed", "coordinator_address", "num_processes",
    "process_id", "warm_start_workdir", "warm_start_preset",
    "warm_start_checkpoint", "warm_start_kind", "compile_cache",
)


def _refuse_not_ported(args) -> None:
    for name in _NOT_PORTED_FLAGS:
        if getattr(args, name, None) not in (None, False):
            raise NotImplementedError(
                f"--{name.replace('_', '-')} is not ported yet (ROADMAP.md)"
            )


def _overrides_from_args(args) -> dict:
    from multi_modal_regression_tpu_torch.train.presets import ExperimentConfig

    fields = {f.name for f in dataclasses.fields(ExperimentConfig)}
    overrides = {}
    for field in _OVERRIDE_FIELDS:
        v = getattr(args, field, None)
        if v is None:
            continue
        if field not in fields:
            raise NotImplementedError(
                f"--{field.replace('_', '-')} is not ported yet (ROADMAP.md)"
            )
        overrides[field] = v
    return overrides


def _config_from_args(args):
    from multi_modal_regression_tpu_torch.train.presets import get_config

    overrides = _overrides_from_args(args)
    if "num_classes" not in overrides and getattr(args, "dbinfo", None):
        overrides["num_classes"] = len(_classes_from_args(args))
    if "dict_size" not in overrides and getattr(args, "dictionary", None):
        # the reference reads num_clusters off the pickle
        # (`num_clusters = kmeans.n_clusters`, learnGeodesicBDModel.py:59);
        # likewise the loaded dictionary defines dict_size unless
        # explicitly overridden
        d = _load_dictionary_cached(args.dictionary)
        atoms = getattr(d, "cluster_centers", None)
        if atoms is None:
            atoms = d.means  # GMMDictionary
        overrides["dict_size"] = int(len(atoms))
    return get_config(args.preset, **overrides)


# one read per CLI invocation: _config_from_args reads dict_size off the
# dictionary and cmd_train hands the same object to its Trainer. Keyed by
# the literal path string; cmd_dictionary's write-then-reload check
# bypasses it on purpose (the file changes under the same path there).
_DICTIONARY_CACHE: dict = {}


def _load_dictionary_cached(path: str | None):
    if path is None:
        return None
    if path not in _DICTIONARY_CACHE:
        _DICTIONARY_CACHE[path] = _load_dictionary(path)
    return _DICTIONARY_CACHE[path]


def _load_dictionary(path: str | None):
    """The dictionary saved at `path`: a GMMDictionary if the file holds
    `means`, else a KMeansDictionary; None for no path."""
    if path is None:
        return None
    from multi_modal_regression_tpu_torch.dictionary.gmm import GMMDictionary
    from multi_modal_regression_tpu_torch.dictionary.kmeans import KMeansDictionary

    with np.load(path) as f:
        keys = set(f.files)
    if "means" in keys:
        return GMMDictionary.load(path)
    return KMeansDictionary.load(path)


def _classes_from_args(args) -> tuple[str, ...]:
    if getattr(args, "dbinfo", None):
        import scipy.io as spio

        tmp = spio.loadmat(args.dbinfo, squeeze_me=True)
        return tuple(str(c).strip() for c in np.atleast_1d(tmp["classes"]))
    # --num-classes N without --dbinfo means "the first N PASCAL3D+
    # classes": the data index MUST agree with the model's per-class head
    # bank, or labels beyond num_classes would gather past it in the step
    n = getattr(args, "num_classes", None)
    if n:
        if n > len(PASCAL3D_CLASSES):
            raise SystemExit(
                f"--num-classes {n} exceeds the {len(PASCAL3D_CLASSES)} "
                "PASCAL3D+ classes; pass --dbinfo for a custom class list"
            )
        return PASCAL3D_CLASSES[:n]
    return PASCAL3D_CLASSES


def _make_test_loader(args, cfg, classes, load_size: int):
    from multi_modal_regression_tpu_torch.data import (
        FlatTestIndex,
        MatCropIndex,
        MatCropLoader,
        TestLoader,
    )

    root = Path(args.data_root)
    if getattr(args, "test_protocol", "filenames") == "mat":
        mat_root = args.mat_root or str(root / "original")
        # evaluate at the resolution the experiment trains at: the .mat
        # crops are whatever the prep wrote (224)
        index = MatCropIndex(mat_root, args.mat_split, classes=classes)
        return MatCropLoader(
            index, batch_size=cfg.eval_batch, image_size=cfg.image_size,
            num_workers=args.num_workers,
        )
    index = FlatTestIndex(str(root / args.test_subdir), classes=classes)
    return TestLoader(index, cfg.eval_batch, load_size, num_workers=args.num_workers)


def _make_loaders(args, cfg):
    """(real, render, test) loaders; render is None for the flat protocol
    and for --train-data real|render (the one loader drives the loop)."""
    from multi_modal_regression_tpu_torch.data import (
        BalancedLoader,
        ClassBalancedIndex,
        FlatLoader,
        FlatTestIndex,
    )

    classes = _classes_from_args(args)
    if cfg.num_classes != len(classes):
        # e.g. --dbinfo naming 100 classes combined with --num-classes 4:
        # the index's labels must match the head bank exactly
        raise SystemExit(
            f"--num-classes {cfg.num_classes} disagrees with the "
            f"{len(classes)}-class list from --dbinfo/defaults"
        )
    protocol = args.protocol or (
        "flat" if cfg.preset.startswith("objectnet") else "balanced"
    )
    load_size = cfg.image_size
    root = Path(args.data_root)
    if protocol == "flat":
        # single shuffled flat train loader over <root>/train, test over
        # <root>/test (learnObjectnetBDModel.py:50-51,74-75)
        train_index = FlatTestIndex(str(root / "train"), classes=classes)
        train = FlatLoader(
            train_index, batch_size=cfg.items_per_batch * 12, image_size=load_size,
            num_workers=args.num_workers, seed=cfg.seed,
        )
        return train, None, _make_test_loader(args, cfg, classes, load_size)
    # --train-data selects real/render/both (the ablationGBDAugmentation.py
    # --type protocol; 'both' is the standard two-loader training)
    which = getattr(args, "train_data", "both")

    def balanced(subdir: str, db_type: str):
        index = ClassBalancedIndex(str(root / subdir), db_type, classes=classes)
        return BalancedLoader(
            index, cfg.items_per_batch, load_size,
            num_workers=args.num_workers, seed=cfg.seed,
        )

    real = render = None
    if which in ("both", "real"):
        real = balanced(args.real_subdir, "real")
    if which in ("both", "render"):
        render = balanced(args.render_subdir, "render")
    if real is None:  # render-only: it drives the loop
        real, render = render, None
    return real, render, _make_test_loader(args, cfg, classes, load_size)


def _load_pretrained(trainer, path: str) -> None:
    """Load a local torchvision resnet state_dict into the model's trunk
    (up to cfg.feature_layer); the heads keep their weights."""
    from multi_modal_regression_tpu_torch.models.pretrained import (
        load_torchvision_backbone,
    )

    cfg = trainer.config
    sd = load_torchvision_backbone(path, cfg.feature_network, cfg.feature_layer)
    trainer.model.feature_model.load_state_dict(sd)
    print(f"loaded pretrained backbone from {path}", flush=True)


def cmd_train(args) -> int:
    _refuse_not_ported(args)
    from multi_modal_regression_tpu_torch.train.trainer import Trainer

    cfg = _config_from_args(args)
    workdir = args.workdir or f"runs/{args.save_str}"
    trainer = Trainer(
        cfg, dictionary=_load_dictionary_cached(args.dictionary), workdir=workdir,
        device=args.device,
    )
    real, render, test = _make_loaders(args, cfg)
    if args.resume:
        state = trainer.restore_checkpoint()
        print(f"resumed from step {state.step}", flush=True)
    else:
        state = trainer.init_state()
        if args.pretrained_backbone:
            _load_pretrained(trainer, args.pretrained_backbone)
    state = trainer.fit(state, real, render, test_loader=test)
    trainer.save_checkpoint(state, "final")
    med = trainer.evaluate(state, test)  # overlaps the background save
    trainer.wait_for_checkpoints()
    print(f"final {trainer.metric_label(med)}", flush=True)
    return 0


def cmd_dictionary(args) -> int:
    from multi_modal_regression_tpu_torch.tools.parity import gather_tree_poses

    # gather all render poses from filenames (learnKmeansDictionary.py:25-37)
    y = gather_tree_poses(
        args.data_root, args.db_type, classes=_classes_from_args(args),
        device=args.device,
    )
    print(f"{len(y)} poses parsed", flush=True)
    if args.type == "kmeans":
        from multi_modal_regression_tpu_torch.dictionary.kmeans import fit_kmeans

        d = fit_kmeans(y, args.size, seed=args.seed, device=args.device)
        print(f"kmeans fitted: inertia {d.inertia:.4f}", flush=True)
    else:
        from multi_modal_regression_tpu_torch.dictionary.gmm import fit_gmm

        d = fit_gmm(y, args.size, seed=args.seed, device=args.device)
        print(f"gmm fitted: log-likelihood {d.log_likelihood:.4f}", flush=True)
    d.save(args.out)
    # reload sanity check (learnKmeansDictionary.py:49-53)
    reloaded = _load_dictionary(args.out)
    n = getattr(reloaded, "n_clusters", None) or reloaded.n_components
    print(f"saved {args.out} ({n} atoms); reload OK", flush=True)
    return 0


def _add_device_arg(p: argparse.ArgumentParser, what: str) -> None:
    p.add_argument("--device", type=str, default="cuda",
                   help=f"where {what} runs: 'cuda' (the default) or 'cpu'")


def build_parser() -> argparse.ArgumentParser:
    from multi_modal_regression_tpu_torch.train.presets import PRESETS

    parser = argparse.ArgumentParser(prog="multi_modal_regression_tpu_torch.cli")
    sub = parser.add_subparsers(dest="command", required=True)

    p_train = sub.add_parser("train", help="train a preset")
    p_train.add_argument("--preset", choices=sorted(PRESETS), required=True)
    p_train.add_argument("--dictionary", type=str, default=None,
                         help="pose dictionary .npz (kmeans or gmm)")
    p_train.add_argument("--pretrained-backbone", type=str, default=None,
                         help="torchvision resnet state_dict .pth for the "
                              "backbone (a local file)")
    p_train.add_argument("--train-data", choices=("both", "real", "render"),
                         default="both",
                         help="training data selection (augmentation ablation)")
    for flag in ("--warm-start-workdir", "--warm-start-preset",
                 "--warm-start-checkpoint", "--warm-start-kind"):
        p_train.add_argument(flag, type=str, default=None,
                             help="two-stage chaining: not ported yet")
    p_train.add_argument("--distributed", action="store_true",
                         help="multi-host runs: not ported yet")
    p_train.add_argument("--coordinator-address", type=str, default=None)
    p_train.add_argument("--num-processes", type=int, default=None)
    p_train.add_argument("--process-id", type=int, default=None)
    _add_common_data_args(p_train)
    _add_config_overrides(p_train)
    _add_device_arg(p_train, "training")
    p_train.set_defaults(fn=cmd_train)

    p_dict = sub.add_parser("dictionary", help="learn a pose dictionary")
    p_dict.add_argument("--type", choices=("kmeans", "gmm"), default="kmeans")
    p_dict.add_argument("--data-root", type=str, required=True,
                        help="render image tree (poses parsed from filenames)")
    p_dict.add_argument("--size", type=int, default=200)
    p_dict.add_argument("--out", type=str, required=True)
    p_dict.add_argument("--seed", type=int, default=0)
    p_dict.add_argument("--dbinfo", type=str, default=None,
                        help="dbinfo.mat naming the classes (default: the "
                             "12 PASCAL3D+ classes)")
    p_dict.add_argument("--num-classes", type=int, default=None,
                        help="without --dbinfo: use the first N PASCAL3D+ "
                             "classes (matches train --num-classes)")
    p_dict.add_argument("--db-type", choices=("render", "real"),
                        default="render",
                        help="tilt-sign convention of the tree "
                             "(dataGenerators.py:57-62; the reference "
                             "learns from RenderForCNN trees)")
    _add_device_arg(p_dict, "the fit")
    p_dict.set_defaults(fn=cmd_dictionary)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
