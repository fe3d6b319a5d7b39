"""Command line of the port (the JAX package's cli.py, as far as ported).

    python -m multi_modal_regression_tpu_torch.cli train \\
        --preset geodesic_bd --data-root data/ \\
        --dictionary kmeans_dictionary_axis_angle_200.npz [--save-str g0] \\
        [--workdir runs/g0] [--resume] [--pretrained-backbone resnet50.pth] \\
        [--warm-start-workdir runs/oracle --warm-start-preset geodesic_bd \\
         [--warm-start-checkpoint final] [--warm-start-kind oracle|classifier]] \\
        [--device cuda|cpu] [config overrides ...]

    python -m multi_modal_regression_tpu_torch.cli pack \\
        --preset geodesic_bd --data-root data/ [--packed-cache auto|<root>]

    python -m multi_modal_regression_tpu_torch.cli evaluate \\
        --preset geodesic_bd --data-root data/ --dictionary d.npz \\
        [--checkpoint last] [--eval-num-epochs 9] [--packed-cache auto] \\
        [--device cuda|cpu]

    python -m multi_modal_regression_tpu_torch.cli predict \\
        --preset geodesic_bd --data-root data/ --dictionary d.npz \\
        [--checkpoint final] [--packed-cache auto] [--det-path <set>] \\
        [--analysis [--analysis-names pose,cat]] [--device cuda|cpu]

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m multi_modal_regression_tpu_torch.cli train|evaluate|predict \
        --distributed ... (one process a rank)

    python -m multi_modal_regression_tpu_torch.cli dictionary \\
        --data-root <render tree> --out kmeans_dictionary_axis_angle_200.npz \\
        [--type kmeans|gmm] [--size 200] [--seed 0] [--db-type render|real] \\
        [--dbinfo dbinfo.mat | --num-classes N] [--device cuda|cpu]

    python -m multi_modal_regression_tpu_torch.cli prepare-data \\
        --dataset synthetic|pascal3d|objectnet3d --out data/ \\
        [--db-path PASCAL3D+_release1.1] [--voc-dir <VOC2012>]

    python -m multi_modal_regression_tpu_torch.cli prepare-detections \\
        --detector vk|r4cnn|maskrcnn|objectnet --det-source <outputs> \\
        --images-dir <JPEGImages> [--image-set val.txt] --out <set>

    python -m multi_modal_regression_tpu_torch.cli evaluate-detections \\
        --results <results .mat> --det-path <set> --annotations <root>

    python -m multi_modal_regression_tpu_torch.cli verify-parity \\
        --data-root <prepared> [--db-path <release>] [--render-root <tree>] \\
        [--det-path <set> --annotations <root>] [--device cuda|cpu]

`train` trains a preset on the device (the card unless `--device cpu`)
from the PNG trees under --data-root (<real-subdir>, <render-subdir> and
<test-subdir>, each <class>/*.png with the pose in the file name),
evaluates MedErr after every main epoch and writes checkpoints `last`,
`best` and `final` under <workdir>/checkpoints; `--resume` continues from
`last`; `--warm-start-*` grafts a source run's checkpoint into the new
model first (models/surgery: a classifier into a bin-delta model, an
oracle into a joint model), the two-stage pipelines. With `--packed-cache` every tree is first decoded once into a
uint8 cache (data/packed.py; `auto` puts it in `.packed/` beside the tree)
and the loaders gather from it; `pack` builds those caches and stops.
`evaluate` is the reference's snapshot-ensemble protocol: it fine-tunes a
checkpoint with the cyclical SGD, takes a test snapshot at each minimum of
the rate (<workdir>/results_<save-str>/num<k>.npz) and prints the
per-snapshot and the ensembled MedErr. `predict` runs the test set through
a checkpoint and writes <workdir>/results_<save-str>.npz; with
`--det-path` it runs a detector's crop set instead and writes
<workdir>/results_<save-str>_<set>.mat; with `--analysis` (a joint BD
preset) it runs the per-class analysis forward over the comma-separated
`--checkpoint` list and writes <workdir>/results_<save-str>_analysis.mat.
`dictionary` parses the pose of
every image of a tree from its file name and fits a kmeans or GMM pose
dictionary on the device. `prepare-data` writes a synthetic tree or walks
a PASCAL3D+ / ObjectNet3D release into the training trees (host code);
`prepare-detections` crops a detector's outputs into a crop set;
`evaluate-detections` scores a results .mat (AP / AVP / ARP);
`verify-parity` chains prepare-data, dictionary, train, the snapshot
ensemble and the detection metrics into one table (tools/parity.py). All
take the JAX package's arguments.

`--distributed` (train, evaluate, predict) joins a process group
(parallel/multihost.initialize: torchrun's variables, or
`--coordinator-address H:P --num-processes N --process-id I`), puts the
rank on its card (`--device cuda`, NCCL where each rank has a card of its
own, gloo where they share one) or the CPU (`--device cpu`, gloo), strides
every loader by rank, and trains data-parallel over the global batch;
rank 0 alone writes checkpoints, metrics, the snapshot and results files
and the tables, runs `--det-path` and `--analysis`, while `predict`
gathers every rank's test rows. `--compile-cache DIR|off` (every
subcommand that has it in the JAX package) sets where the CUDA kernel
library is built and kept (ops/_build.BUILD_DIR): DIR, or with `off` a
fresh temporary directory of this process; an unwritable DIR keeps the
default and says so.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from multi_modal_regression_tpu_torch import PASCAL3D_CLASSES


def _add_common_data_args(
    p: argparse.ArgumentParser, required_data_root: bool = True
) -> None:
    p.add_argument("--data-root", type=str, required=required_data_root,
                   default=None if required_data_root else ".")
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
                   help="pre-decoded uint8 crop cache (data/packed.py): "
                        "'auto' packs into .packed/ beside each tree on "
                        "first use and reuses it after, or give an "
                        "explicit cache root. Replaces per-image PNG "
                        "decodes with memmap gathers, for every protocol: "
                        "balanced/flat train trees, the filenames test "
                        "tree and the mat crop sets.")


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
                   help="backward-pass rematerialization (train/remat.py)")
    p.add_argument("--optimizer-dtype", type=str, default=None,
                   choices=("float32", "bfloat16"),
                   help="Adam first-moment storage (bfloat16 default; "
                        "float32 = the reference's torch.optim.Adam)")
    p.add_argument("--lr-scaling", type=str, default=None,
                   choices=("none", "linear", "sqrt"),
                   help="global-batch LR rule: scale init_lr by "
                        "(items-per-batch/8) [linear] or its sqrt")
    p.add_argument("--frozen-bn", action="store_true", default=None,
                   help="BatchNorm in eval mode during training (running "
                        "statistics, none updated); every trained weight "
                        "still trains")
    p.add_argument("--device-resize-from", type=int, default=None,
                   help="the loaders ship images at this size and the steps "
                        "resize them to --image-size on the device "
                        "(ops/augment.py)")
    p.add_argument("--checkpoint-async",
                   action=argparse.BooleanOptionalAction, default=None,
                   help="write checkpoints on a background thread "
                        "(default on; the copy to the host stays on the "
                        "caller's thread)")
    p.add_argument("--train-flip", action="store_true", default=None,
                   help="random horizontal flips in the train step, with the "
                        "(-az, el, -ct) pose")
    p.add_argument("--workdir", type=str, default=None)
    p.add_argument("--resume", action="store_true")
    _add_compile_cache_arg(p)


def _add_compile_cache_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--compile-cache", type=str, default=None,
                   help="where the CUDA kernel library is built and kept "
                        "(default build/torch_kernels/ in the checkout); "
                        "'off' builds into a temporary directory of this "
                        "process")


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

def _setup_compile_cache(args) -> None:
    """--compile-cache: DIR replaces ops/_build.BUILD_DIR, `off` builds
    into a temporary directory of this process (no library is kept for
    the next run), none keeps the default. A DIR that cannot be created
    or written keeps the default and prints why, as the JAX package's
    does; no kernel is skipped either way."""
    import tempfile

    from multi_modal_regression_tpu_torch.ops import _build

    choice = getattr(args, "compile_cache", None)
    if choice is None:
        return
    if choice == "off":
        _build.set_build_dir(tempfile.mkdtemp(prefix="mmr_kernels_"))
        return
    d = Path(choice)
    try:
        d.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryFile(dir=d):
            pass
    except OSError as e:  # an unwritable cache dir is never fatal
        print(f"compile cache disabled ({e}); building into {_build.BUILD_DIR}", flush=True)
        return
    _build.set_build_dir(d)


def _maybe_init_distributed(args) -> tuple[int, int]:
    """--distributed: join the process group (parallel/multihost) before
    anything is built, and put this rank on its device (args.device becomes
    'cuda:<i>' for a rank on the card). Returns (host_count, host_index)
    for the loaders' striding; (1, 0) without the flag."""
    if not getattr(args, "distributed", False):
        return 1, 0
    from multi_modal_regression_tpu_torch.parallel import multihost

    device = "cpu" if args.device == "cpu" else "cuda"
    count, index = multihost.initialize(
        coordinator_address=args.coordinator_address, num_processes=args.num_processes,
        process_id=args.process_id, device=device,
    )
    args.device = str(multihost.local_device())
    print(f"distributed: process {index}/{count} on {args.device}", flush=True)
    return count, index


def _overrides_from_args(args) -> dict:
    return {field: v for field in _OVERRIDE_FIELDS
            if (v := getattr(args, field, None)) is not None}


def _config_from_args(args):
    from multi_modal_regression_tpu_torch.models.backbones import VGG_CONFIGS
    from multi_modal_regression_tpu_torch.train.presets import get_config

    overrides = _overrides_from_args(args)
    if overrides.get("feature_network") in VGG_CONFIGS and "N0" not in overrides:
        # the port's heads are sized by N0, the trunk's feature width: a
        # VGG trunk's fc6 / fc7 give 4096 (the JAX heads infer it)
        overrides["N0"] = 4096
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


def _packed_cache_dir(args, load_size: int, subdir: str,
                      kind: str | None = None,
                      split: str | None = None) -> Path:
    """The cache directory of one tree under --packed-cache: the JAX
    package's names, so either package adopts the other's caches."""
    from multi_modal_regression_tpu_torch.data.packed import default_cache_dir

    tree = (
        Path(args.mat_root or (Path(args.data_root) / "original"))
        if kind == "mat"
        else Path(args.data_root) / subdir
    )
    if args.packed_cache == "auto":
        # caches live next to their tree, reused by pack/train/evaluate/
        # predict (data/packed.default_cache_dir)
        return default_cache_dir(tree, load_size, kind=kind, split=split)
    # explicit cache root: two datasets whose trees share a basename
    # (every prep writes 'train'/'original') must not fight over one
    # cache dir, so the name holds a digest of the resolved tree path
    import hashlib

    tag = hashlib.sha256(str(tree.resolve()).encode()).hexdigest()[:8]
    tail = "_".join(
        [tree.name, tag] + ([split] if split else []) + [f"{load_size}px"]
        + ([kind] if kind else [])
    )
    new = Path(args.packed_cache) / tail
    # a cache of the earlier layout without the digest is reused rather
    # than the whole tree decoded again (pack_index still checks it)
    legacy = Path(args.packed_cache) / "_".join(
        [subdir if kind != "mat" else tree.name]
        + ([split] if split else []) + [f"{load_size}px"]
        + ([kind] if kind else [])
    )
    if not (new / "meta.json").exists() and (legacy / "meta.json").exists():
        return legacy
    return new


def _make_test_loader(args, cfg, classes, load_size: int, host_count: int = 1,
                      host_index: int = 0):
    from multi_modal_regression_tpu_torch.data import (
        FlatTestIndex,
        MatCropIndex,
        MatCropLoader,
        TestLoader,
    )

    root = Path(args.data_root)
    packed = getattr(args, "packed_cache", None)
    hosts = dict(host_count=host_count, host_index=host_index)
    if getattr(args, "test_protocol", "filenames") == "mat":
        mat_root = args.mat_root or str(root / "original")
        # evaluate at the resolution the experiment trains at: the .mat
        # crops are whatever the prep wrote (224)
        index = MatCropIndex(mat_root, args.mat_split, classes=classes)
        if packed:
            from multi_modal_regression_tpu_torch.data import (
                PackedMatCropLoader,
                pack_mat_index,
            )

            pack = pack_mat_index(
                index,
                _packed_cache_dir(args, cfg.image_size, "original", kind="mat",
                                  split=args.mat_split),
                image_size=cfg.image_size, num_workers=args.num_workers,
                wait_for_builder=host_index > 0,
            )
            return PackedMatCropLoader(index, pack, batch_size=cfg.eval_batch, **hosts)
        return MatCropLoader(
            index, batch_size=cfg.eval_batch, image_size=cfg.image_size,
            num_workers=args.num_workers, **hosts,
        )
    index = FlatTestIndex(str(root / args.test_subdir), classes=classes)
    if packed:
        from multi_modal_regression_tpu_torch.data import PackedTestLoader, pack_index

        pack = pack_index(
            index, _packed_cache_dir(args, load_size, args.test_subdir),
            image_size=load_size, num_workers=args.num_workers,
            wait_for_builder=host_index > 0,
        )
        return PackedTestLoader(index, pack, batch_size=cfg.eval_batch, **hosts)
    return TestLoader(index, cfg.eval_batch, load_size, num_workers=args.num_workers,
                      **hosts)


def _make_loaders(args, cfg, host_count: int = 1, host_index: int = 0):
    """(real, render, test) loaders; render is None for the flat protocol
    and for --train-data real|render (the one loader drives the loop).
    host_count/host_index: every loader reads this rank's stride (the
    packed caches are built by rank 0; the others wait for them)."""
    from multi_modal_regression_tpu_torch.data import (
        BalancedLoader,
        ClassBalancedIndex,
        FlatLoader,
        FlatTestIndex,
        PackedBalancedLoader,
        PackedFlatLoader,
        pack_index,
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
    # with the on-device resize the loaders ship raw-size images
    load_size = cfg.device_resize_from or cfg.image_size
    root = Path(args.data_root)
    packed = getattr(args, "packed_cache", None)
    hosts = dict(host_count=host_count, host_index=host_index)

    def pack(index, subdir: str):
        return pack_index(
            index, _packed_cache_dir(args, load_size, subdir),
            image_size=load_size, num_workers=args.num_workers,
            wait_for_builder=host_index > 0,
        )

    if protocol == "flat":
        # single shuffled flat train loader over <root>/train, test over
        # <root>/test (learnObjectnetBDModel.py:50-51,74-75)
        train_index = FlatTestIndex(str(root / "train"), classes=classes)
        if packed:
            train = PackedFlatLoader(
                train_index, pack(train_index, "train"),
                batch_size=cfg.items_per_batch * 12, seed=cfg.seed, **hosts,
            )
        else:
            train = FlatLoader(
                train_index, batch_size=cfg.items_per_batch * 12, image_size=load_size,
                num_workers=args.num_workers, seed=cfg.seed, **hosts,
            )
        return train, None, _make_test_loader(args, cfg, classes, load_size, **hosts)
    # --train-data selects real/render/both (the ablationGBDAugmentation.py
    # --type protocol; 'both' is the standard two-loader training)
    which = getattr(args, "train_data", "both")

    def balanced(subdir: str, db_type: str):
        index = ClassBalancedIndex(str(root / subdir), db_type, classes=classes)
        if packed:
            return PackedBalancedLoader(
                index, pack(index, subdir), items_per_batch=cfg.items_per_batch,
                seed=cfg.seed, **hosts,
            )
        return BalancedLoader(
            index, cfg.items_per_batch, load_size,
            num_workers=args.num_workers, seed=cfg.seed, **hosts,
        )

    real = render = None
    if which in ("both", "real"):
        real = balanced(args.real_subdir, "real")
    if which in ("both", "render"):
        render = balanced(args.render_subdir, "render")
    if real is None:  # render-only: it drives the loop
        real, render = render, None
    return real, render, _make_test_loader(args, cfg, classes, load_size, **hosts)


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


# the fields a warm start's source config takes from the new run's
# (the JAX cli's _warm_start), dict_size among them
_WARM_START_FIELDS = ("feature_network", "feature_layer", "num_classes", "N0", "N1",
                      "N2", "image_size", "dict_size")


def _warm_start(trainer, args) -> None:
    """Two-stage chaining: graft a source run's checkpoint into this model.

    --warm-start-kind classifier: a classification model's trunk and bin
    heads into a bin-delta model (learnSimpleBDModel_rene.py:89-130);
    oracle: a BD or regression oracle into a joint model
    (learnJointCatPoseModel_*.py). The source is restored through a Trainer
    of --warm-start-preset, its config taking this run's widths."""
    from multi_modal_regression_tpu_torch.models.surgery import (
        graft_classifier_into_bd,
        graft_oracle_into_joint,
    )
    from multi_modal_regression_tpu_torch.train.presets import get_config
    from multi_modal_regression_tpu_torch.train.trainer import Trainer

    if not args.warm_start_preset:
        raise SystemExit("--warm-start-workdir needs --warm-start-preset, the source "
                         "run's preset")
    cfg = trainer.config
    src_cfg = get_config(args.warm_start_preset,
                         **{k: getattr(cfg, k) for k in _WARM_START_FIELDS})
    src = Trainer(src_cfg, dictionary=_load_dictionary_cached(args.dictionary),
                  workdir=args.warm_start_workdir, device=args.device)
    src.restore_checkpoint(args.warm_start_checkpoint)
    dst_sd, src_sd = trainer.model.state_dict(), src.model.state_dict()
    if args.warm_start_kind == "classifier":
        grafted = graft_classifier_into_bd(dst_sd, src_sd)
    else:
        grafted = graft_oracle_into_joint(dst_sd, src_sd, cfg.model_kind)
    trainer.model.load_state_dict(grafted)
    print(f"warm-started ({args.warm_start_kind}) from {args.warm_start_workdir}",
          flush=True)


def cmd_train(args) -> int:
    host_count, host_index = _maybe_init_distributed(args)
    _setup_compile_cache(args)
    from multi_modal_regression_tpu_torch.train.trainer import Trainer

    cfg = _config_from_args(args)
    workdir = args.workdir or f"runs/{args.save_str}"
    trainer = Trainer(
        cfg, dictionary=_load_dictionary_cached(args.dictionary), workdir=workdir,
        device=args.device,
    )
    real, render, test = _make_loaders(args, cfg, host_count, host_index)
    if args.resume:
        state = trainer.restore_checkpoint()
        print(f"resumed from step {state.step}", flush=True)
    else:
        state = trainer.init_state()
        if args.pretrained_backbone:
            _load_pretrained(trainer, args.pretrained_backbone)
        if args.warm_start_workdir:
            _warm_start(trainer, args)
    state = trainer.fit(state, real, render, test_loader=test)
    trainer.save_checkpoint(state, "final")
    med = trainer.evaluate(state, test)  # overlaps the background save
    trainer.wait_for_checkpoints()
    print(f"final {trainer.metric_label(med)}", flush=True)
    return 0


def cmd_pack(args) -> int:
    """Build the packed uint8 crop caches (data/packed.py) that a
    train/evaluate/predict run with these flags would use, then stop."""
    _setup_compile_cache(args)
    if not getattr(args, "packed_cache", None):
        args.packed_cache = "auto"
    cfg = _config_from_args(args)
    real, render, test = _make_loaders(args, cfg)
    for name, ld in (("train", real), ("render", render), ("test", test)):
        pack = getattr(ld, "pack", None)
        if pack is not None:
            n = sum(len(v) for v in pack.meta["classes"].values())
            print(f"packed {name}: {pack.cache_dir} ({n} images "
                  f"@ {pack.image_size}px)", flush=True)
    return 0


def cmd_evaluate(args) -> int:
    """The snapshot-ensemble protocol from a checkpoint (evaluate*.py); with
    --distributed the fine-tune is data-parallel and every test pass
    gathered, and rank 0 writes the snapshots."""
    host_count, host_index = _maybe_init_distributed(args)
    _setup_compile_cache(args)
    from multi_modal_regression_tpu_torch.train.evaluator import SnapshotEnsembleEvaluator
    from multi_modal_regression_tpu_torch.train.trainer import Trainer

    cfg = _config_from_args(args)
    workdir = args.workdir or f"runs/{args.save_str}"
    trainer = Trainer(
        cfg, dictionary=_load_dictionary_cached(args.dictionary), workdir=workdir,
        device=args.device,
    )
    real, render, test = _make_loaders(args, cfg, host_count, host_index)
    state = trainer.restore_checkpoint(args.checkpoint)
    ev = SnapshotEnsembleEvaluator(
        trainer,
        # one writer a job
        workdir=Path(workdir) / f"results_{args.save_str}" if host_index == 0 else None,
    )
    ev.run(state, real, render, test, num_epochs=args.eval_num_epochs)
    med, _ = ev.ensemble()
    per_snap = [round(s.med_err, 4) for s in ev.snapshots]
    print(f"snapshot MedErrs: {per_snap}", flush=True)
    print(f"ensembled MedErr: {med:.4f} deg", flush=True)
    return 0


def cmd_predict(args) -> int:
    """Inference from a checkpoint over the GT test crops (the
    evaluateJointModel.py protocol): <workdir>/results_<save-str>.npz and
    the per-class table; with --det-path over a detector's crop set (the
    evaluateModelDetectedBBoxes.py protocol): the results .mat; with
    --analysis the joint models' per-class analysis (evaluateJointModel.py)
    over one or more checkpoints: one analysis .mat. With --distributed the
    test pass runs each rank's stride and gathers them; the detection and
    analysis protocols run on rank 0 over the whole set, and rank 0 alone
    writes and prints."""
    host_count, host_index = _maybe_init_distributed(args)
    _setup_compile_cache(args)
    from multi_modal_regression_tpu_torch.metrics import (
        mean_class_accuracy,
        mean_class_median_error,
        per_class_report,
    )
    from multi_modal_regression_tpu_torch.train.trainer import Trainer

    if args.analysis and args.det_path:
        raise SystemExit(
            "--analysis and --det-path are mutually exclusive protocols "
            "(evaluateJointModel vs evaluateModelDetectedBBoxes); run two "
            "predict invocations"
        )
    cfg = _config_from_args(args)
    workdir = args.workdir or f"runs/{args.save_str}"
    dictionary = _load_dictionary_cached(args.dictionary)
    trainer = Trainer(cfg, dictionary=dictionary, workdir=workdir, device=args.device)
    if (args.analysis or args.det_path) and host_index != 0:
        # one results file over the whole set: rank 0 alone (its restore and
        # forwards are local, with the data-parallel mesh's replicated weights)
        return 0
    if args.analysis:
        return _predict_analysis(args, cfg, trainer, dictionary, workdir)
    state = trainer.restore_checkpoint(args.checkpoint)
    if args.det_path:
        from multi_modal_regression_tpu_torch.detection import (
            DetectionSetIndex,
            run_detection_inference,
            save_results_mat,
        )

        index = DetectionSetIndex(args.det_path)
        bboxes, ypred, labels, _scores = run_detection_inference(
            state.model, trainer.problem, index, batch_size=cfg.eval_batch,
            compute_dtype=trainer.compute_dtype,
        )
        det_name = Path(args.det_path).name
        out = Path(workdir) / f"results_{args.save_str}_{det_name}.mat"
        save_results_mat(out, bboxes, ypred, labels)
        n = sum(len(b) for b in labels)
        print(f"wrote {out} ({n} detections over {len(index)} images)", flush=True)
        return 0
    # every test protocol (filenames PNG tree, packed or not, or the
    # Pascal3dAll .mat crops), built as train and evaluate build it
    names = _classes_from_args(args)
    test = _make_test_loader(args, cfg, names, cfg.device_resize_from or cfg.image_size,
                             host_count, host_index)
    # every rank gets the whole set back (Trainer.predict gathers); one writes
    ytrue, ypred, labels = trainer.predict(state, test)
    if host_index != 0:
        return 0
    out = Path(workdir) / f"results_{args.save_str}.npz"
    np.savez(out, ytest=ytrue, yhat_test=ypred, test_labels=labels)
    if trainer.problem.metric == "category_accuracy":
        # class ids: the mean per-class accuracy, no pose table
        acc = mean_class_accuracy(labels, ypred, cfg.num_classes)
        print(f"wrote {out}; Acc {acc:.4f}", flush=True)
        return 0
    rep = "quaternion" if trainer.problem.ydata_type == "quaternion" else "axis_angle"
    med = mean_class_median_error(ytrue, ypred, labels, cfg.num_classes, representation=rep)
    if len(names) != cfg.num_classes:
        names = tuple(f"class{i}" for i in range(cfg.num_classes))
    table = per_class_report(ytrue, ypred, labels, names, representation=rep)
    for name, row in table.items():
        print(
            f"  {name:>14s}: MedErr {row['median_err_deg']:7.2f} deg  "
            f"Acc@30 {row['acc_30deg']:5.1f}%  (n={row['count']})",
            flush=True,
        )
    print(f"wrote {out}; MedErr {med:.4f}", flush=True)
    return 0


def _predict_analysis(args, cfg, trainer, dictionary, workdir) -> int:
    """evaluateJointModel[2].py: the same per-class analysis forward over up
    to four checkpoints, one combined results .mat."""
    from multi_modal_regression_tpu_torch.train.analysis import (
        analysis_report,
        parse_analysis_runs,
        run_joint_analysis,
        save_analysis_mat,
    )

    if not hasattr(trainer.model, "analysis"):
        raise SystemExit(
            f"--analysis needs a joint BD preset (model_kind joint_bd_*), not "
            f"{cfg.model_kind!r}"
        )
    runs = parse_analysis_runs(
        args.checkpoint.split(","),
        args.analysis_names.split(",") if args.analysis_names else None,
    )
    centers = getattr(dictionary, "cluster_centers", None)
    if centers is None:
        centers = dictionary.means
    test = _make_test_loader(args, cfg, _classes_from_args(args),
                             cfg.device_resize_from or cfg.image_size)
    results = {}
    for name, ckpt in runs:
        state = trainer.restore_checkpoint(ckpt)
        r = run_joint_analysis(trainer, state, test, centers)
        results[name] = r
        rep = analysis_report(r, cfg.num_classes)
        print(f"{name}: cat acc {rep['cat_acc']:.4f} | "
              f"MedErr oracle {rep['mederr_oracle']:.2f} deg "
              f"(Acc@30 {rep['acc30_oracle']:.1f}%) | "
              f"pred-cat {rep['mederr_predcat']:.2f} deg "
              f"(Acc@30 {rep['acc30_predcat']:.1f}%) | "
              f"{len(r['ytrue_cat'])} samples", flush=True)
    out = Path(workdir) / f"results_{args.save_str}_analysis.mat"
    save_analysis_mat(out, results)
    print(f"wrote {out}", flush=True)
    return 0


def cmd_dictionary(args) -> int:
    _setup_compile_cache(args)
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


def cmd_prepare_data(args) -> int:
    """A synthetic pose tree (the default), or a PASCAL3D+ / ObjectNet3D
    release walked into the training trees (setupData*.m; host code)."""
    if args.dataset == "pascal3d":
        from multi_modal_regression_tpu_torch.tools.ingest import prepare_pascal3d

        if not args.db_path:
            raise SystemExit("--db-path is required for --dataset pascal3d")
        voc = args.voc_dir or str(
            Path(args.db_path) / "PASCAL" / "VOCdevkit" / "VOC2012"
        )
        classes = (
            tuple(args.classes.split(","))
            if args.classes else _classes_from_args(args)
        )
        prepare_pascal3d(
            args.db_path, voc, args.out,
            classes=classes,
            kinds=tuple(args.kinds.split(",")),
            workers=args.workers,
        )
        print(f"wrote {args.out}", flush=True)
        return 0
    if args.dataset == "objectnet3d":
        from multi_modal_regression_tpu_torch.tools.ingest import prepare_objectnet3d

        if not args.db_path:
            raise SystemExit("--db-path is required for --dataset objectnet3d")
        prepare_objectnet3d(args.db_path, args.out, workers=args.workers)
        print(f"wrote {args.out}", flush=True)
        return 0

    from multi_modal_regression_tpu_torch.tools.synthetic import generate_pose_dataset

    synth_kwargs = {}
    if args.classes:  # default: the full PASCAL3D+ list
        synth_kwargs["classes"] = tuple(args.classes.split(","))
    for i, sub in enumerate((args.real_subdir, args.render_subdir, args.test_subdir)):
        root = generate_pose_dataset(
            Path(args.out) / sub,
            images_per_class=args.images_per_class,
            image_size=args.image_size,
            # deterministic per-subdir seed (hash() is process-randomized)
            seed=args.seed + 1000 * (i + 1),
            pattern=args.pattern,
            **synth_kwargs,
        )
        print(f"wrote {root}", flush=True)
    return 0


def cmd_prepare_detections(args) -> int:
    """Parse third-party detector outputs and crop them into the
    `dbinfo.mat + all/<img>.mat` layout `predict --det-path` consumes
    (the setupDataDetection_{vk,r4cnn,maskrcnn}.m pipelines, plus the
    setupDataDetected_objectnet3d.m Fast-RCNN script)."""
    from multi_modal_regression_tpu_torch.tools.ingest import (
        parse_maskrcnn_results,
        parse_r4cnn_detections,
        parse_vk_detections,
        prepare_detection_set,
        prepare_objectnet_detected,
        read_image_set,
    )

    classes = _classes_from_args(args)
    if args.detector == "objectnet":
        # per-class detections_<cls>.txt trees; no VOC image-set file:
        # the image list is the union of the detection files' rows
        n = prepare_objectnet_detected(
            args.det_source, args.images_dir, args.out, classes,
            size=args.image_size, workers=args.workers,
        )
        print(f"wrote {args.out} ({n} detections)", flush=True)
        return 0
    if args.image_set is None:
        raise SystemExit("--image-set is required for this detector")
    image_names = read_image_set(args.image_set)
    if args.detector == "vk":
        dets = parse_vk_detections(args.det_source, num_images=len(image_names))
    elif args.detector == "r4cnn":
        dets = parse_r4cnn_detections(
            args.det_source, classes=classes, num_images=len(image_names)
        )
    else:
        det_classes = classes
        if args.detector_classes:
            det_classes = tuple(args.detector_classes.split(","))
        dets = parse_maskrcnn_results(
            args.det_source, image_names, classes=det_classes
        )
    prepare_detection_set(
        args.images_dir, image_names, dets, args.out,
        size=args.image_size, workers=args.workers,
    )
    n = sum(len(b) for b, _ in dets)
    print(f"wrote {args.out} ({n} detections over {len(image_names)} images)",
          flush=True)
    return 0


def cmd_evaluate_detections(args) -> int:
    """AVP/ARP in one command (the computeAVP.m / computeARP.m stage):
    results .mat (from `predict --det-path`) + PASCAL3D+ Annotations tree
    -> per-class AP / AVP / ARP / MedErr table."""
    from multi_modal_regression_tpu_torch.detection import (
        DetectionSetIndex,
        build_voc_ground_truth,
        evaluate_detection_results,
        load_results_mat,
    )

    classes = _classes_from_args(args)
    index = DetectionSetIndex(args.det_path)
    bboxes, ypred, labels, scores = load_results_mat(args.results)
    if len(bboxes) != len(index):
        raise SystemExit(
            f"results file has {len(bboxes)} images, detection set has "
            f"{len(index)}"
        )
    annos = build_voc_ground_truth(args.annotations, index.image_names, classes)
    table = evaluate_detection_results(
        annos, bboxes, ypred, labels, classes, scores=scores,
        nbins=args.nbins,
    )
    header = f"{'class':>14s}  {'AP':>7s} {'AVP':>7s} {'ARP':>7s} " \
             f"{'MedErr':>8s} {'MedAzErr':>9s}"
    print(header, flush=True)
    for cls, row in table.items():
        print(
            f"{cls:>14s}  {row['ap']:7.4f} {row['avp']:7.4f} "
            f"{row['arp']:7.4f} {row['med_err_deg']:8.3f} "
            f"{row['med_az_err_deg']:9.3f}",
            flush=True,
        )
    if args.out:
        import json

        Path(args.out).write_text(json.dumps(table, indent=2))
        print(f"wrote {args.out}", flush=True)
    return 0


def cmd_verify_parity(args) -> int:
    """The quality-parity acceptance gate as ONE command: prepare-data ->
    dictionary -> train (--pretrained-backbone) -> snapshot-ensemble
    evaluate -> optional AVP/ARP, printing the MedErr / Acc@pi/6 table
    (tools/parity.py; reference chain setupDataFlipped_pascal3d.m ->
    learnGeodesicBDModel.py -> evaluateGeodesicBDModel.py -> computeAVP.m)."""
    _setup_compile_cache(args)
    from multi_modal_regression_tpu_torch.tools.parity import run_parity_gate

    overrides = _overrides_from_args(args)
    classes = (
        tuple(args.classes.split(",")) if args.classes
        else _classes_from_args(args)
    )
    table = run_parity_gate(
        workdir=args.workdir or "runs/parity",
        data_root=args.data_root,
        db_path=args.db_path,
        voc_dir=args.voc_dir,
        render_root=args.render_root,
        pretrained_backbone=args.pretrained_backbone,
        det_path=args.det_path,
        annotations=args.annotations,
        classes=classes,
        overrides=overrides,
        eval_num_epochs=args.eval_num_epochs,
        workers=args.num_workers,
        packed_cache=not args.no_packed_cache,
        device=args.device,
    )
    ev = table["stages"]["evaluate"]
    print(f"{'class':>14s}  {'MedErr':>8s}  {'Acc@pi/6':>8s}", flush=True)
    for cls, row in ev["per_class"].items():
        if cls == "mean":  # already reported by the ensembled line below
            continue
        print(
            f"{cls:>14s}  {row['med_err_deg']:8.3f}  "
            f"{row['acc_pi_6_pct']:7.2f}%",
            flush=True,
        )
    print(
        f"ensembled MedErr {ev['ensembled_med_err_deg']:.3f} deg  "
        f"Acc@pi/6 {ev['acc_pi_6_pct']:.2f}%",
        flush=True,
    )
    for d in table["deviations"]:
        print(f"DEVIATION: {d}", flush=True)
    return 0


def _add_device_arg(p: argparse.ArgumentParser, what: str) -> None:
    p.add_argument("--device", type=str, default="cuda",
                   help=f"where {what} runs: 'cuda' (the default) or 'cpu'")


def _add_distributed_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--distributed", action="store_true",
                   help="one process a rank (python -m torch.distributed.run, "
                        "or the flags below on every rank): data-parallel "
                        "over the process group, every loader strided by rank")
    p.add_argument("--coordinator-address", type=str, default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)


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
    p_train.add_argument("--warm-start-workdir", type=str, default=None,
                         help="source run workdir for two-stage chaining")
    p_train.add_argument("--warm-start-preset", type=str, default=None,
                         help="preset of the source run")
    p_train.add_argument("--warm-start-checkpoint", type=str, default="final")
    p_train.add_argument("--warm-start-kind", choices=("classifier", "oracle"),
                         default="oracle")
    _add_distributed_args(p_train)
    _add_common_data_args(p_train)
    _add_config_overrides(p_train)
    _add_device_arg(p_train, "training")
    p_train.set_defaults(fn=cmd_train)

    p_pack = sub.add_parser(
        "pack",
        help="build the packed uint8 crop caches that a train/evaluate/"
             "predict run with the same flags would use",
    )
    p_pack.add_argument("--preset", choices=sorted(PRESETS), required=True)
    p_pack.add_argument("--train-data", choices=("both", "real", "render"),
                        default="both")
    _add_common_data_args(p_pack)
    _add_config_overrides(p_pack)
    p_pack.set_defaults(fn=cmd_pack)

    p_eval = sub.add_parser("evaluate", help="snapshot-ensemble evaluation")
    p_eval.add_argument("--preset", choices=sorted(PRESETS), required=True)
    p_eval.add_argument("--dictionary", type=str, default=None)
    p_eval.add_argument("--checkpoint", type=str, default="last")
    p_eval.add_argument("--eval-num-epochs", type=int, default=None)
    _add_distributed_args(p_eval)
    _add_common_data_args(p_eval)
    _add_config_overrides(p_eval)
    _add_device_arg(p_eval, "the fine-tune and the test passes")
    p_eval.set_defaults(fn=cmd_evaluate)

    p_pred = sub.add_parser("predict", help="inference from a checkpoint")
    p_pred.add_argument("--preset", choices=sorted(PRESETS), required=True)
    p_pred.add_argument("--dictionary", type=str, default=None)
    p_pred.add_argument("--checkpoint", type=str, default="final")
    p_pred.add_argument("--det-path", type=str, default=None,
                        help="detector crop set (dbinfo.mat + all/*.mat)")
    p_pred.add_argument("--analysis", action="store_true",
                        help="joint-model analysis protocol "
                             "(evaluateJointModel.py): --checkpoint may list "
                             "up to 4 comma-separated checkpoints")
    p_pred.add_argument("--analysis-names", type=str, default=None,
                        help="comma-separated run names for the --analysis "
                             "checkpoints (default pose,cat,top1,wgt)")
    _add_common_data_args(p_pred, required_data_root=False)
    _add_distributed_args(p_pred)
    _add_config_overrides(p_pred)
    _add_device_arg(p_pred, "inference")
    p_pred.set_defaults(fn=cmd_predict)

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
    _add_compile_cache_arg(p_dict)
    p_dict.set_defaults(fn=cmd_dictionary)

    p_prep = sub.add_parser(
        "prepare-data",
        help="prepare a dataset: synthetic (default), or walk a real "
             "PASCAL3D+/ObjectNet3D release (setupData*.m)",
    )
    p_prep.add_argument("--dataset",
                        choices=("synthetic", "pascal3d", "objectnet3d"),
                        default="synthetic")
    p_prep.add_argument("--db-path", type=str, default=None,
                        help="release root (PASCAL3D+_release1.1 / "
                             "ObjectNet3D) for non-synthetic datasets")
    p_prep.add_argument("--voc-dir", type=str, default=None,
                        help="VOC2012 devkit dir (default "
                             "<db-path>/PASCAL/VOCdevkit/VOC2012)")
    p_prep.add_argument("--kinds", type=str,
                        default="flipped,original,augmented",
                        help="comma list of pascal3d output trees")
    p_prep.add_argument("--workers", type=int, default=8)
    p_prep.add_argument("--classes", type=str, default=None,
                        help="comma list of classes to ingest (default: "
                             "the 12 PASCAL3D+ classes / --dbinfo)")
    p_prep.add_argument("--dbinfo", type=str, default=None)
    p_prep.add_argument("--out", type=str, required=True)
    p_prep.add_argument("--real-subdir", type=str, default="augmented2")
    p_prep.add_argument("--render-subdir", type=str, default="renderforcnn")
    p_prep.add_argument("--test-subdir", type=str, default="test")
    p_prep.add_argument("--images-per-class", type=int, default=8)
    p_prep.add_argument("--image-size", type=int, default=64)
    p_prep.add_argument("--seed", type=int, default=0)
    p_prep.add_argument("--pattern", choices=("noise", "pose"), default="noise",
                        help="'pose' renders learnable viewpoint-dependent content")
    p_prep.set_defaults(fn=cmd_prepare_data)

    p_pdet = sub.add_parser(
        "prepare-detections",
        help="crop third-party detector outputs into a detection set "
             "(setupDataDetection_{vk,r4cnn,maskrcnn}.m)",
    )
    p_pdet.add_argument("--detector",
                        choices=("vk", "r4cnn", "maskrcnn", "objectnet"),
                        required=True)
    p_pdet.add_argument("--det-source", type=str, required=True,
                        help="vk: VOC2012_val_det.mat; r4cnn: dir of "
                             "per-class .mat files; maskrcnn: dir of "
                             "results_<cls>.txt files; objectnet: dir of "
                             "detections_<cls>.txt files (Fast-RCNN)")
    p_pdet.add_argument("--images-dir", type=str, required=True,
                        help="VOC JPEGImages / ObjectNet3D Images dir")
    p_pdet.add_argument("--image-set", type=str, default=None,
                        help="val.txt listing the test images (not used "
                             "for --detector objectnet)")
    p_pdet.add_argument("--out", type=str, required=True)
    p_pdet.add_argument("--image-size", type=int, default=224)
    p_pdet.add_argument("--workers", type=int, default=8)
    p_pdet.add_argument("--dbinfo", type=str, default=None)
    p_pdet.add_argument("--detector-classes", type=str, default=None,
                        help="comma list of the detector's own class "
                             "spellings (maskrcnn uses 'motorcycle')")
    p_pdet.set_defaults(fn=cmd_prepare_detections)

    p_edet = sub.add_parser(
        "evaluate-detections",
        help="AP/AVP/ARP table from a results .mat + annotations "
             "(computeAVP.m / computeARP.m)",
    )
    p_edet.add_argument("--results", type=str, required=True,
                        help="results .mat from `predict --det-path`")
    p_edet.add_argument("--det-path", type=str, required=True,
                        help="detection set dir (its dbinfo.mat lists the "
                             "image order of the results file)")
    p_edet.add_argument("--annotations", type=str, required=True,
                        help="PASCAL3D+ Annotations root "
                             "(<cls>_pascal/<image>.mat trees)")
    p_edet.add_argument("--nbins", type=int, default=4,
                        help="azimuth bins for AVP")
    p_edet.add_argument("--out", type=str, default=None,
                        help="optional JSON output path")
    p_edet.add_argument("--dbinfo", type=str, default=None)
    p_edet.set_defaults(fn=cmd_evaluate_detections)

    p_par = sub.add_parser(
        "verify-parity",
        help="the quality-parity gate as one command: prepare-data -> "
             "dictionary -> train -> snapshot-ensemble evaluate "
             "[-> AVP/ARP] (tools/parity.py)",
    )
    p_par.add_argument("--data-root", type=str, required=True,
                       help="prepared tree (train/test/augmented2/original);"
                            " ingested from --db-path if missing")
    p_par.add_argument("--db-path", type=str, default=None,
                       help="PASCAL3D+ release root (for ingestion)")
    p_par.add_argument("--voc-dir", type=str, default=None)
    p_par.add_argument("--render-root", type=str, default=None,
                       help="RenderForCNN-style render tree (dictionary "
                            "poses + render training data)")
    p_par.add_argument("--pretrained-backbone", type=str, default=None,
                       help="torchvision resnet50 .pth (quality parity "
                            "requires it)")
    p_par.add_argument("--det-path", type=str, default=None,
                       help="prepared detection set for the AVP/ARP stage")
    p_par.add_argument("--annotations", type=str, default=None,
                       help="PASCAL3D+ Annotations root (AVP/ARP stage)")
    p_par.add_argument("--eval-num-epochs", type=int, default=None)
    p_par.add_argument("--classes", type=str, default=None,
                       help="comma list (default: the 12 PASCAL3D+ classes)")
    p_par.add_argument("--dbinfo", type=str, default=None)
    p_par.add_argument("--num-workers", type=int, default=8)
    p_par.add_argument("--no-packed-cache", action="store_true",
                       help="disable the default packed uint8 crop cache "
                            "(.packed/ next to each tree, shared with "
                            "--packed-cache auto) and decode PNGs per epoch")
    _add_config_overrides(p_par)
    _add_device_arg(p_par, "each device stage")
    p_par.set_defaults(fn=cmd_verify_parity)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    finally:
        if getattr(args, "distributed", False):
            from multi_modal_regression_tpu_torch.parallel import multihost

            multihost.shutdown()


if __name__ == "__main__":
    raise SystemExit(main())
