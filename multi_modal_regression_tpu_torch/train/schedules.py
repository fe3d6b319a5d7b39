"""Learning-rate schedules (port of the JAX package's train/schedules.py).

`Trainer.fit` multiplies the base rate by `epoch_lr_factor(kind, e + 1)`
before main epoch e, the reference scripts' scheduler.step()-before-
training() pattern; warm-up passes run at factor(0) = 1.

`cyclical_triangular` is the reference's mySGD cyclical rate
(helperFunctions.py:62-120): a triangle wave between alpha1 (cycle
endpoints) and alpha2 (cycle midpoint) with period c steps, used by the
snapshot-ensemble evaluation (train/evaluator.py), which takes a results
snapshot at each minimum of the rate (evaluateGeodesicBDModel.py:141-145).
`cyclical_sgd` is the optimizer that applies it.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch


def cyclical_triangular(
    c: int, alpha1: float = 1e-6, alpha2: float = 1e-8
) -> Callable[[int], np.float32]:
    """rate(step): t = ((step mod c) + 1)/c; linear alpha1 -> alpha2 on the
    first half-cycle, alpha2 -> alpha1 on the second
    (helperFunctions.py:112-118; their state['step'] is 1-based, so t uses
    (step-1) mod c + 1: counting from 0 gives the same sequence).

    The rate is formed in float32, operation by operation, as the JAX
    schedule forms it from its int32 step count, so the two agree bit for
    bit."""
    f = np.float32
    a1, a2, cf = f(alpha1), f(alpha2), f(c)

    def schedule(step: int) -> np.float32:
        t = (f(step % c) + f(1.0)) / cf
        if t <= f(0.5):
            return (f(1.0) - f(2.0) * t) * a1 + f(2.0) * t * a2
        return f(2.0) * (f(1.0) - t) * a2 + (f(2.0) * t - f(1.0)) * a1

    return schedule


def is_snapshot_step(step: int, c: int) -> bool:
    """True at the minimum of the rate in each cycle: the reference
    snapshots when `count % c == c/2` with a 1-based count
    (evaluateGeodesicBDModel.py:141)."""
    return (step + 1) % c == c // 2


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


class CyclicalSGD(torch.optim.Optimizer):
    """SGD at the cyclical triangular rate (the reference's mySGD; the JAX
    package's optax chain of trace, scale_by_schedule and scale(-1)).

    Step k, counted from 0 in this optimizer's own state (empty when it is
    made), applies p -= rate(k) * u per parameter with a gradient, where
    u = g without momentum, and with it the trace t = g + momentum * t
    (t starting at 0; optax.trace). rate(k) is `cyclical_triangular`'s
    float32 value, cast to the parameter's dtype; the product and the
    subtraction are two roundings, as optax applies them.
    """

    def __init__(self, params: Iterable, c: int, alpha1: float = 1e-6,
                 alpha2: float = 1e-8, momentum: float = 0.0):
        super().__init__(params, dict(momentum=momentum))
        self.rate = cyclical_triangular(c, alpha1, alpha2)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("CyclicalSGD.step takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            states = [self.state[p] for p in params]
            for st in states:
                st.setdefault("count", 0)
            count = states[0]["count"]
            if any(st["count"] != count for st in states):
                raise RuntimeError(
                    "CyclicalSGD: parameters of one group at different steps"
                )
            rate = float(self.rate(count))
            grads = [p.grad for p in params]
            if group["momentum"]:
                for st, g in zip(states, grads):
                    if "trace" not in st:
                        st["trace"] = torch.zeros_like(g)
                traces = [st["trace"] for st in states]
                torch._foreach_mul_(traces, group["momentum"])
                torch._foreach_add_(traces, grads)
                grads = traces
            torch._foreach_sub_(params, torch._foreach_mul(grads, rate))
            for st in states:
                st["count"] = count + 1


def cyclical_sgd(
    params: Iterable, c: int, alpha1: float = 1e-6, alpha2: float = 1e-8,
    momentum: float = 0.0,
) -> CyclicalSGD:
    """SGD with the cyclical triangular rate over `params` (the mySGD
    optimizer): see CyclicalSGD."""
    return CyclicalSGD(params, c, alpha1, alpha2, momentum)
