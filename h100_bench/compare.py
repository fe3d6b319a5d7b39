"""The numbers that decide `correct`: what the timed path produced against
the plain reference (reference/), each held to a limit of its own
(limits/<cell>.json).

Training: each leaf's gap as a share of the reference's norm of that leaf
or of the median leaf, whichever is larger; by the worst leaf, the gap
between the program's and the reference's norms of the first step's
gradient (`grad_gap`), the norm of the difference of the two gradients
(`grad_diff_gap`, and of the median leaf: `grad_diff_median`), and the gap
between the norms of the parameters' change over the checked steps
(`change_gap`). A cell's limits file names the numbers it compares; the
others are reported beside them (`detail`). Leaves whose reference
gradient is under a thousandth of the median leaf's are nought to rounding
and left out. Every other leaf counts: the trunk, both banks, each BN. The training
traffic raises one bin of each bin head (traffic `bin_margin`), so that
no row's two best scores lie within rounding of each other and the
regression term decodes the same bin on both sides. Reported beside the
numbers: each step's loss and cross-entropy term, the leaf of each number
with its norms, and the quartiles of the first step's top-2 score
margins.

Serving: each sampled row's served pose is matched to the bin whose
reference pose lies nearest it; `pose_gap` is that distance (radians, in
axis-angle space) and `score_gap` how far that bin's reference score lies
below the reference's best. Both are the widest over the rows.
"""

from __future__ import annotations

import math
import statistics

import torch

NEGLIGIBLE = 1e-3  # a leaf's gradient under this share of the median leaf's


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def kept_leaves(ref_grad: dict) -> list[str]:
    med = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= NEGLIGIBLE * med]


def _shares(gaps: dict, ref: dict, leaves: list[str]) -> dict:
    """gaps[k] / max(ref[k], median ref norm) of each leaf (inf for nan)."""
    med = statistics.median(ref[k] for k in leaves)
    return {k: _finite(gaps[k] / max(ref[k], med, 1e-30)) for k in leaves}


def _worst(shares: dict) -> tuple[float, str]:
    k = max(shares, key=shares.get)
    return shares[k], k


def _median(shares: dict) -> tuple[float, str]:
    order = sorted(shares, key=shares.get)
    k = order[(len(order) - 1) // 2]
    return shares[k], k


def diff_norms(prog: dict, ref: dict, leaves: list[str]) -> dict:
    """Each leaf's norm of the program's tensor less the reference's (a
    leaf the program lacks: the reference's norm)."""
    out = {}
    for k in leaves:
        r = ref[k].double()
        p = prog.get(k)
        out[k] = float(torch.linalg.vector_norm(r if p is None else p.to(r.device).double() - r))
    return out


def step_gap(prog: list, ref: list) -> float:
    """Worst relative gap of a per-step value."""
    if len(prog) != len(ref):
        return math.inf
    return _finite(max(abs(p - r) / abs(r) for p, r in zip(prog, ref)))


def train_readings(prog: dict, ref: dict) -> tuple[dict, dict]:
    """(numbers, detail). prog, ref: {'loss', 'lc': [per step], 'grad':
    {leaf: step-1 gradient}, 'change': {leaf: norm}}; ref also 'margins'.
    detail, beside the numbers: the losses and their gap, each number with
    its leaf and the program's and the reference's norms there, the
    margins."""
    ref_norm, prog_norm = norms(ref["grad"]), norms(prog["grad"])
    leaves = kept_leaves(ref_norm)
    diff = _shares(diff_norms(prog["grad"], ref["grad"], leaves), ref_norm, leaves)
    picked = {
        "grad_gap": _worst(_shares({k: abs(prog_norm.get(k, 0.0) - ref_norm[k]) for k in leaves},
                                   ref_norm, leaves)),
        "grad_diff_gap": _worst(diff),
        "grad_diff_median": _median(diff),
        "change_gap": _worst(_shares({k: abs(prog["change"].get(k, 0.0) - ref["change"][k])
                                      for k in leaves}, ref["change"], leaves)),
    }
    detail = {"loss": [prog["loss"], ref["loss"]], "lc": [prog["lc"], ref["lc"]],
              "loss_gap": step_gap(prog["loss"], ref["loss"])}
    for key, (value, leaf) in picked.items():
        pair = ([prog["change"].get(leaf, 0.0), ref["change"][leaf]] if key == "change_gap"
                else [prog_norm.get(leaf, 0.0), ref_norm[leaf]])
        detail[f"{key}_leaf"] = [value, leaf, *pair]
    detail["top2_margin_quartiles"] = ref["margins"]
    return {k: v for k, (v, _) in picked.items()}, detail


def serve_numbers(rows: list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]]) -> dict:
    """rows: (served poses (B, 3), reference scores (B, K), reference
    candidate poses (B, K, 3)) of each sampled request."""
    score_gap = pose_gap = 0.0
    for poses, scores, cands in rows:
        poses = poses.to(cands.device, torch.float32)
        if not bool(torch.isfinite(poses).all()):
            return {"score_gap": math.inf, "pose_gap": math.inf}
        dist = torch.linalg.vector_norm(cands - poses[:, None, :], dim=-1)  # (B, K)
        d, k = dist.min(dim=-1)
        below = scores.max(dim=-1).values - scores.gather(1, k[:, None])[:, 0]
        score_gap = max(score_gap, float(below.max()))
        pose_gap = max(pose_gap, float(d.max()))
    return {"score_gap": score_gap, "pose_gap": pose_gap}
