"""Problems (port of the JAX package's train/problems.py): per-preset
target transforms, losses and decoders.

  simple          CE + MSE(residual), the warm-up balance form for the whole
                  run (learnSimpleBDModel.py:124-131)
  simple_rene     the _rene fine-tunes of fresh delta heads on a frozen,
  euclidean_rene  classifier-grafted oracle: the residual term alone (MSE of
                  the raw residual, or of the decoded pose) under the sigma
                  balance, no CE term (learnSimpleBDModel_rene.py:160-170,
                  learnEuclideanBDModel_rene.py:159-170)
  geodesic        warm-up CE + MSE(residual), then CE + geodesic loss on the
                  decoded pose (learnGeodesicBDModel.py:106-205), the north
                  star
  euclidean       main Lr = MSE on the decoded pose, with the warm-up
                  balance form in the main phase too
                  (learnEuclideanBDModel.py:176-183)
  laplacian       main Lr = L1 on the decoded pose (learnLaplacianBDModel.py:178)
  geodesic_quat   quaternion dictionary + quaternion geodesic; renormalized
                  test predictions (learnGeodesicBDModel_quaternion.py)
  relaxed_kmeans  RBF soft bins over a kmeans dictionary (width gamma), KL
                  in place of CE, fixed weights (ablationXBDModel.py)
  probabilistic   GMM posterior soft bins; warm-up KL + MSE on the soft
                  residual; main KL + the expected geodesic loss under the
                  softmax posterior (learnProbabilisticBDModel.py:124-129);
                  the multires variant takes per-cluster deltas
  probabilistic_quat[_multires]
                  the reference-dormant quaternion variants: RBF soft bins
                  over the quaternion dictionary, expected quaternion
                  geodesic (binDeltaLosses.py:149-166,197-208)
  riemannian      tangent residual targets; main loss composes
                  R_bin @ exp(delta) with a trace-angle geodesic
                  (learnRiemannianBDModel.py:186-233)
  log_euclidean   MSE vs the tangent residual at the PREDICTED bin ('m2',
                  learnLogEuclideanModel.py:103-134), every bin's residual
                  target made on the device; warm-up balance form throughout
  classification  CE only; prediction = dictionary atom at argmax
                  (learnClassificationModel.py)
  regression      no bins: warm-up MSE, then the geodesic loss on the raw
                  pose output (learnGeodesicRegressionModel.py:122-199);
                  regression_quat in quaternions

  objectnet_quat  the fixed 16-atom quaternion dictionary (no fitted
                  one): bins by the largest |<atom, q>|, the residual
                  q - atom in R^4; warm-up CE + MSE, main CE + quaternion
                  geodesic; renormalized test predictions
                  (learnObjectnetModel.py:60-66,108-112,213)

The joint problems are in train/joint_problems.py.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from multi_modal_regression_tpu_torch.data.targets import (
    gmm_soft_targets,
    hard_bin_targets,
    per_bin_tangent_residuals,
    rbf_soft_targets,
    tangent_residual_targets,
)
from multi_modal_regression_tpu_torch.geometry.quaternion import convert_dictionary
from multi_modal_regression_tpu_torch.geometry.so3 import exp_so3, log_so3
from multi_modal_regression_tpu_torch.losses.bin_delta import (
    decode_bin_delta,
    expected_regression,
)
from multi_modal_regression_tpu_torch.losses.primitives import (
    cross_entropy,
    geodesic_aa,
    geodesic_quat,
    geodesic_rotmat,
    kl_div_mean,
    l1,
    mse,
)
from multi_modal_regression_tpu_torch.models.heads import select_class

PORTED_PROBLEMS = (
    "simple", "simple_rene", "euclidean_rene", "geodesic", "euclidean", "laplacian", "geodesic_quat",
    "relaxed_kmeans", "probabilistic", "probabilistic_multires",
    "probabilistic_quat", "probabilistic_quat_multires", "riemannian",
    "log_euclidean", "classification", "regression", "regression_quat",
    "objectnet_quat",
)
# the problems that train without a fitted pose dictionary
DICTIONARY_FREE = ("regression", "regression_quat", "objectnet_quat")


@dataclasses.dataclass(frozen=True)
class Problem:
    """A training problem: target transform + (Lc, Lr) losses + decoder.

      targets(y)                 pose batch -> dict of target tensors
      warmup_losses(out, tg)     -> (lc, lr) for the warm-up phase
      main_losses(out, tg)       -> (lc, lr) for the main phase
      decode(out)                -> predicted poses (test protocol)
    `out` is the model output: (scores, residual), or one tensor for the
    classification and regression models. The balance modes are
    'warmup' | 'main' | 'sigma' | None (fixed weights Lc + alpha * Lr).
    `metric` is the headline evaluation: 'pose' (MedErr) or
    'category_accuracy' (mean per-class accuracy of decoded class ids).
    `graphable` is False where the targets wait on the host every step (the
    GMM posterior's Cholesky checks its result there), so that a CUDA graph
    cannot capture the train step (train/steps.graph_blocker).
    """

    name: str
    ydata_type: str
    targets: Callable
    warmup_losses: Callable
    main_losses: Callable
    decode: Callable
    warmup_balance: str | None = "warmup"
    main_balance: str | None = "main"
    metric: str = "pose"
    graphable: bool = True


def _first(out):
    """The scores or poses of a model output: the tensor itself, or the first
    of a tuple."""
    return out[0] if isinstance(out, tuple) else out


def _zero(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=like.dtype, device=like.device)


def _unit(q: torch.Tensor) -> torch.Tensor:
    """Quaternion test predictions renormalized, the norm floored at the
    reference's 1e-10 (learnGeodesicBDModel_quaternion.py:217-218)."""
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-10)


def objectnet_quaternion_dictionary() -> np.ndarray:
    """The fixed 16-atom quaternion dictionary of learnObjectnetModel.py:60-66,
    (16, 4) float32: the 4 unit quaternions e_i, then (e_i + e_j)/sqrt(2)
    for i < j, then (e_i - e_j)/sqrt(2) for i < j (the reference's order).
    The atoms come in +/- pairs across the double cover only up to sign, so
    |<atom, q>| often ties between two atoms near their bisector."""
    atoms = list(np.eye(4))
    s = 1.0 / np.sqrt(2.0)
    pairs = [(i, j) for i in range(4) for j in range(i + 1, 4)]
    for sign in (1.0, -1.0):
        for i, j in pairs:
            v = np.zeros(4)
            v[i], v[j] = s, sign * s
            atoms.append(v)
    return np.stack(atoms).astype(np.float32)


def make_problem(
    name: str,
    centers: np.ndarray | None = None,
    device: torch.device | str = "cuda",
    *,
    gmm_means: np.ndarray | None = None,
    gmm_covariances: np.ndarray | None = None,
    gmm_weights: np.ndarray | None = None,
    gamma: float = 10.0,
    multires: bool = False,
) -> Problem:
    """Build a Problem by name. `centers` is the (K, 3) axis-angle dictionary
    (converted to quaternions for the quaternion problems, quaternion.py:
    79-92; unused by the regression problems); the `gmm_*` arrays are the
    fitted mixture of the probabilistic problems; `gamma` is the RBF width
    of the soft-bin problems; `multires` selects per-cluster deltas for the
    probabilistic ones (also implied by a `_multires` name). The arrays are
    placed on `device` once (the card unless the caller asks for "cpu")."""
    from multi_modal_regression_tpu_torch.train.joint_problems import JOINT_PROBLEMS

    if name in JOINT_PROBLEMS:
        raise ValueError(
            f"{name!r} is a joint problem: train/joint_problems.make_joint_problem "
            "builds it (train.presets.build_problem routes it there)"
        )
    if name not in PORTED_PROBLEMS:
        raise ValueError(
            f"unknown problem {name!r}; the port has {list(PORTED_PROBLEMS)}"
        )
    is_multires = multires or name.endswith("multires")

    def on_device(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def soft_lc(scores, tg):
        return kl_div_mean(F.log_softmax(scores, dim=-1), tg["soft"])

    def soft_warmup(out, tg):
        # multires: every per-cluster delta regresses the shared soft residual
        scores, residual = out
        res = tg["res"][:, None, :] if is_multires else tg["res"]
        return soft_lc(scores, tg), mse(residual, res)

    def candidates(atoms, residual):
        # (B, K, D): the atoms plus the per-cluster or the shared delta
        return atoms[None, :, :] + (residual if is_multires else residual[:, None, :])

    def decode_soft(atoms, out):
        # argmax decode (the per-argmax-bin delta if multires): the
        # reference's LIVE test path; its softmax-expectation decode is
        # commented out (learnProbabilisticBDModel.py:168-181)
        scores, residual = out
        ind = torch.argmax(scores, dim=-1)
        if is_multires:
            residual = select_class(residual, ind)
        return atoms[ind] + residual

    def hard_warmup(out, tg):
        scores, residual = out
        return cross_entropy(scores, tg["bins"]), mse(residual, tg["res"])

    if name in ("simple", "geodesic", "euclidean", "laplacian", "geodesic_quat"):
        quat = name == "geodesic_quat"
        C = convert_dictionary(on_device(centers)) if quat else on_device(centers)
        reg = {"simple": None, "geodesic": geodesic_aa, "euclidean": mse,
               "laplacian": l1, "geodesic_quat": geodesic_quat}[name]

        def targets(y):
            bins, res = hard_bin_targets(y, C)
            return {"y": y, "bins": bins, "res": res}

        def main(out, tg):
            # the decode's argmax passes no gradient: Lr reaches the residual only
            scores, residual = out
            ypred = decode_bin_delta(scores, residual, C)
            return cross_entropy(scores, tg["bins"]), reg(ypred, tg["y"])

        def decode(out):
            q = decode_bin_delta(out[0], out[1], C)
            return _unit(q) if quat else q

        if name == "simple":
            # one phase, CE + MSE(residual) in the warm-up balance form
            return Problem(name, "axis_angle", targets, hard_warmup, hard_warmup, decode,
                           warmup_balance="warmup", main_balance="warmup")
        # learnEuclideanBDModel.py keeps the WARM-UP balance form in its main
        # phase (loss = Lc + 0.5*exp(-2s)*Lr + s, s' = 0.5*log(Lr), :178,183);
        # geodesic (:189) and laplacian (:179) switch to the main form
        return Problem(
            name, "quaternion" if quat else "axis_angle", targets, hard_warmup, main,
            decode, main_balance="warmup" if name == "euclidean" else "main",
        )

    if name in ("simple_rene", "euclidean_rene"):
        # the bin heads come from a trained classifier and stay frozen
        # (train_only=('res_models',) on the preset); the loss is the
        # residual term alone under the homoscedastic sigma balance
        C = on_device(centers)

        def targets(y):
            bins, res = hard_bin_targets(y, C)
            return {"y": y, "bins": bins, "res": res}

        def losses(out, tg):
            scores, residual = out
            if name == "simple_rene":
                return _zero(residual), mse(residual, tg["res"])
            return _zero(residual), mse(decode_bin_delta(scores, residual, C), tg["y"])

        return Problem(
            name, "axis_angle", targets, losses, losses,
            lambda out: decode_bin_delta(out[0], out[1], C),
            warmup_balance="sigma", main_balance="sigma",
        )

    if name == "relaxed_kmeans":
        C = on_device(centers)

        def targets(y):
            soft, res = rbf_soft_targets(y, C, gamma=gamma)
            return {"y": y, "soft": soft, "res": res}

        def main(out, tg):
            scores, residual = out
            ypred = decode_bin_delta(scores, residual, C)
            return soft_lc(scores, tg), geodesic_aa(ypred, tg["y"])

        # the relaxed ablation trains with FIXED weights (alpha), no
        # self-balance scalar anywhere (ablationXBDModel.py:63-170)
        return Problem(
            name, "axis_angle", targets, soft_warmup, main,
            lambda out: decode_bin_delta(out[0], out[1], C),
            warmup_balance=None, main_balance=None,
        )

    if name in ("probabilistic", "probabilistic_multires"):
        mu, cov, w = on_device(gmm_means), on_device(gmm_covariances), on_device(gmm_weights)

        def targets(y):
            resp, res = gmm_soft_targets(y, mu, cov, w)
            return {"y": y, "soft": resp, "res": res}

        def main(out, tg):
            scores, residual = out
            lr = expected_regression(
                scores, candidates(mu, residual), tg["y"],
                lambda p, t: geodesic_aa(p, t, reduce=False),
            )
            return soft_lc(scores, tg), lr

        return Problem(name, "axis_angle", targets, soft_warmup, main,
                       lambda out: decode_soft(mu, out), graphable=False)

    if name in ("probabilistic_quat", "probabilistic_quat_multires"):
        # the reference-dormant quaternion variants (RelaXedProbabilisticLossQ
        # / ...MultiresLossQ, binDeltaLosses.py:149-166,197-208): RBF soft
        # bins over quaternion distances with the soft-mean residual
        # (XPBDGeneratorQ, binDeltaGenerators.py:86-110), KL bin term and the
        # expected quaternion geodesic under the softmax posterior
        Cq = convert_dictionary(on_device(centers))

        def targets(y):
            soft, res = rbf_soft_targets(y, Cq, gamma=gamma)
            return {"y": y, "soft": soft, "res": res}

        def main(out, tg):
            scores, residual = out
            # the reference's argument order my_loss(ytrue, candidate)
            # (binDeltaLosses.py:163-164): geodesic_quat normalizes its FIRST
            # argument, the (unit) ground truth, so the candidates enter
            # un-normalized, |<cand, y>| clamped
            lr = expected_regression(
                scores, candidates(Cq, residual), tg["y"],
                lambda p, t: geodesic_quat(t, p, reduce=False),
            )
            return soft_lc(scores, tg), lr

        return Problem(name, "quaternion", targets, soft_warmup, main,
                       lambda out: _unit(decode_soft(Cq, out)))

    if name in ("riemannian", "log_euclidean"):
        C = on_device(centers)
        # the key rotations exp(centers), computed once on the host in
        # float64 as the reference's startup `rotations_dict` (numpy doubles,
        # learnRiemannianBDModel.py:61, learnLogEuclideanModel.py:58); kept
        # in float64 and taken in the dtype of the rotations they meet
        key_R = exp_so3(torch.as_tensor(np.asarray(centers, np.float64))).to(device)

        def keys_at(ind, like):
            return key_R.to(like.dtype)[ind]

        def decode(out):
            scores, residual = out
            R = exp_so3(residual)
            return log_so3(keys_at(torch.argmax(scores, dim=-1), R) @ R)

        if name == "riemannian":
            def targets(y):
                bins, res, R = tangent_residual_targets(y, C, key_R)
                return {"y": y, "bins": bins, "res": res, "R": R}

            def main(out, tg):
                scores, residual = out
                R = exp_so3(residual)
                R_pred = keys_at(torch.argmax(scores, dim=-1), R) @ R
                return cross_entropy(scores, tg["bins"]), geodesic_rotmat(R_pred, tg["R"])

            return Problem(name, "axis_angle", targets, hard_warmup, main, decode)

        def targets(y):
            bins, _ = hard_bin_targets(y, C)
            return {"y": y, "bins": bins, "res_per_bin": per_bin_tangent_residuals(y, key_R)}

        def losses(out, tg):
            scores, residual = out
            res_true = select_class(tg["res_per_bin"], torch.argmax(scores, dim=-1))
            return cross_entropy(scores, tg["bins"]), mse(residual, res_true)

        # a single-phase script with the warm-up balance form for its whole
        # run: Lc + 0.5*exp(-2s)*Lr + s, s = 0.5*log(Lr)
        # (learnLogEuclideanModel.py:135,140)
        return Problem(name, "axis_angle", targets, losses, losses, decode,
                       warmup_balance="warmup", main_balance="warmup")

    if name == "objectnet_quat":
        # `centers` is not read: the dictionary is the fixed one
        Cq = on_device(objectnet_quaternion_dictionary())

        def targets(y):
            bins = torch.argmax(torch.abs(y @ Cq.to(y.dtype).T), dim=-1)
            return {"y": y, "bins": bins, "res": y - Cq.to(y.dtype)[bins]}

        def main(out, tg):
            scores, residual = out
            ypred = decode_bin_delta(scores, residual, Cq)
            return cross_entropy(scores, tg["bins"]), geodesic_quat(ypred, tg["y"])

        return Problem(
            name, "quaternion", targets, hard_warmup, main,
            lambda out: _unit(decode_bin_delta(out[0], out[1], Cq)),
            warmup_balance=None, main_balance=None,
        )

    if name == "classification":
        C = on_device(centers)

        def targets(y):
            bins, _ = hard_bin_targets(y, C)
            return {"y": y, "bins": bins}

        def losses(out, tg):
            scores = _first(out)
            return cross_entropy(scores, tg["bins"]), _zero(scores)

        return Problem(
            name, "axis_angle", targets, losses, losses,
            lambda out: C[torch.argmax(_first(out), dim=-1)],
            warmup_balance=None, main_balance=None,
        )

    # regression, regression_quat: no bins, no dictionary
    quat = name == "regression_quat"
    reg = geodesic_quat if quat else geodesic_aa

    def warmup(out, tg):
        y = _first(out)
        return _zero(y), mse(y, tg["y"])

    def main(out, tg):
        y = _first(out)
        return _zero(y), reg(y, tg["y"])

    return Problem(
        name, "quaternion" if quat else "axis_angle", lambda y: {"y": y}, warmup, main,
        _first, warmup_balance=None, main_balance=None,
    )
