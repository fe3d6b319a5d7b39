"""Per-epoch learning-rate factors (port of the JAX package's
train/schedules.py; the cyclical SGD of the snapshot-ensemble evaluation
arrives with the evaluator, ROADMAP.md).

`Trainer.fit` multiplies the base rate by `epoch_lr_factor(kind, e + 1)`
before main epoch e, the reference scripts' scheduler.step()-before-
training() pattern; warm-up passes run at factor(0) = 1.
"""

from __future__ import annotations


def objectnet_epoch_lr_factor(epoch: int) -> float:
    """The ObjectNet per-epoch LambdaLR factor: 10^-(ep//10) / (1 + ep%10)
    (learnObjectnetBDModel.py:87, learnObjectnetModel.py:134; stepped at
    :190/:238).

    torch semantics: LambdaLR construction applies lambda(0)=1, so the
    warm-up pass (training_init, before the epoch loop) runs at init_lr;
    scheduler.step() then precedes training() inside the loop, so MAIN
    epoch e (0-based) runs at init_lr * lambda(e + 1): 1/2, 1/3, ...,
    1/10, then a 10x drop each decade."""
    ep = epoch
    return (10.0 ** -(ep // 10)) / (1.0 + ep % 10)


def step_epoch_lr_factor(epoch: int) -> float:
    """StepLR(step_size=1, gamma=0.1): after k scheduler.step() calls the
    rate is init_lr * 0.1^k. Eleven reference scripts construct this AND
    actively step it before each training() epoch: the regression family
    (learnGeodesicRegressionModel.py:114,234 and the quaternion/independent/
    Elhoseiny variants), the classifiers (learnClassificationModel.py:94,167
    and _new), learnIndependentBDModel.py:115,255,
    learnRenderedBDModel.py:115,234, and learnProbabilisticBDModel.py:97,204.
    Warm-up (before the loop) runs at 0.1^0 = 1; main epoch e at 0.1^(e+1)."""
    return 0.1 ** epoch


def inv_epoch_lr_factor(epoch: int) -> float:
    """The joint/categorization family's LambdaLR `my_schedule(ep) =
    1/(1+ep)` (learnJointCatPoseModel2_top1.py:142-148 and the six other
    joint variants, learnCatGivenPoseModel.py:127,204,
    learnCategorizationModel.py:69,118). Same call pattern: main epoch e
    runs at init_lr / (e + 2); any pre-loop pass at lambda(0) = 1."""
    return 1.0 / (1.0 + epoch)


EPOCH_LR_FACTORS = {
    "objectnet": objectnet_epoch_lr_factor,
    "step": step_epoch_lr_factor,
    "inv": inv_epoch_lr_factor,
}


def epoch_lr_factor(kind: str, epoch: int) -> float:
    """Dispatch on cfg.epoch_lr_decay. `epoch` follows torch's post-step
    count: Trainer.fit passes (main_epoch + 1) because every stepping
    script calls scheduler.step() BEFORE training() inside its loop."""
    if kind not in EPOCH_LR_FACTORS:
        raise ValueError(
            f"unknown epoch_lr_decay {kind!r}; available: {sorted(EPOCH_LR_FACTORS)}"
        )
    return EPOCH_LR_FACTORS[kind](epoch)
