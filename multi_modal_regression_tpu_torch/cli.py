"""Command line of the port (the JAX package's cli.py, as far as ported).

    python -m multi_modal_regression_tpu_torch.cli dictionary \\
        --data-root <render tree> --out kmeans_dictionary_axis_angle_200.npz \\
        [--type kmeans|gmm] [--size 200] [--seed 0] [--db-type render|real] \\
        [--dbinfo dbinfo.mat | --num-classes N] [--device cuda|cpu]

`dictionary` parses the pose of every image of the tree from its file name
and fits a kmeans or GMM pose dictionary on the device (the card unless
`--device cpu`), with the arguments of the JAX package's subcommand (its
`--compile-cache` has no counterpart here). The other subcommands arrive
with their slices (ROADMAP.md).
"""

from __future__ import annotations

import argparse

import numpy as np

from multi_modal_regression_tpu_torch import PASCAL3D_CLASSES


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


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="multi_modal_regression_tpu_torch.cli")
    sub = parser.add_subparsers(dest="command", required=True)

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
    p_dict.add_argument("--device", type=str, default="cuda",
                        help="where the fit runs: 'cuda' (the default) or 'cpu'")
    p_dict.set_defaults(fn=cmd_dictionary)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
