"""State-dict surgery for the two-stage pipelines (port of the JAX package's
models/surgery.py).

The reference chains checkpoints: a trained pose "oracle" is wrapped into a
joint model that re-uses its modules and adds a fresh category fc
(learnJointCatPoseModel_top1.py:93-106, learnJointCatPoseModel2_weighted.py:
93-107), and a classifier's trunk and bin heads seed a bin-delta model
(learnSimpleBDModel_rene.py:89-130). Here a graft copies the source
state_dict's tensors under one module prefix over the destination's under
another, replacing the destination's whole subtree as the JAX package
replaces a flax subtree; the new branches keep their fresh init. Plain
copies, so a grafted tensor is bit-equal to its source.
"""

from __future__ import annotations

from typing import Mapping

import torch

StateDict = Mapping[str, torch.Tensor]


def _subtree(sd: StateDict, prefix: str) -> dict[str, torch.Tensor]:
    """The entries under module `prefix`, keyed by the rest of their name."""
    head = prefix + "."
    return {k[len(head):]: v for k, v in sd.items() if k.startswith(head)}


def _graft(dst: StateDict, src: StateDict, mapping: Mapping[str, str]) -> dict:
    """dst with its subtree dst_prefix replaced by src's subtree src_prefix,
    for each (dst_prefix, src_prefix) of mapping that src holds."""
    out = dict(dst)
    for k_dst, k_src in mapping.items():
        sub = _subtree(src, k_src)
        if not sub:
            continue
        for k in [k for k in out if k.startswith(k_dst + ".")]:
            del out[k]
        out.update({f"{k_dst}.{k}": v.clone() for k, v in sub.items()})
    return out


def graft_classifier_into_bd(bd_state: StateDict, classifier_state: StateDict) -> dict:
    """Warm-start a OneBinDeltaModel from a trained pose-classification
    model: its trunk into `feature_model`, its per-class bin heads (the
    classifier's `pose_models` bank is a bin_3layer bank) into
    `bin_models`; the delta heads keep their fresh init."""
    return _graft(bd_state, classifier_state,
                  {"feature_model": "feature_model", "bin_models": "pose_models"})


def graft_oracle_into_joint(
    joint_state: StateDict, oracle_state: StateDict, model_kind: str
) -> dict:
    """Copy an oracle checkpoint's modules into a joint model's state_dict.

    model_kind 'joint_bd_v1' (and 'elhoseiny_like'): feature_model,
    bin_models, res_models; 'joint_reg_v3': feature_model, pose_models;
    'joint_bd_v2': the oracle's trunk split at layer3, its stages 1-3 into
    `feature_trunk` and its layer4 into `pose_stage` AND `category_stage`
    (the reference seeds the category layer4 from torchvision's,
    learnJointCatPoseModel2_weighted.py:90,105), plus the two head banks.
    The category fc keeps its fresh init.
    """
    if model_kind in ("joint_bd_v1", "elhoseiny_like"):
        mapping = {"feature_model": "feature_model", "bin_models": "bin_models",
                   "res_models": "res_models"}
    elif model_kind == "joint_reg_v3":
        mapping = {"feature_model": "feature_model", "pose_models": "pose_models"}
    elif model_kind == "joint_bd_v2":
        trunk = _subtree(oracle_state, "feature_model")
        split = {
            "feature_trunk": {k: v for k, v in trunk.items() if not k.startswith("layer4_")},
            "pose_stage": {k: v for k, v in trunk.items() if k.startswith("layer4_")},
        }
        split["category_stage"] = split["pose_stage"]
        src = {f"{m}.{k}": v for m, sub in split.items() for k, v in sub.items()}
        for bank in ("bin_models", "res_models"):
            src.update({f"{bank}.{k}": v for k, v in _subtree(oracle_state, bank).items()})
        return _graft(joint_state, src, {m: m for m in (*split, "bin_models", "res_models")})
    else:
        raise ValueError(f"unknown model_kind {model_kind!r}")
    return _graft(joint_state, oracle_state, mapping)
