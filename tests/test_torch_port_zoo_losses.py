"""The PyTorch port's loss zoo vs the JAX package, on CPU, in float64 (the
JAX side under a scoped jax_enable_x64): the new loss primitives, the
composed bin-delta losses, the SO(3) tangent targets, the output
nonlinearities of the pose heads, and the 12 problems the single-model pose
zoo adds, phase by phase (targets, losses, decode, and the gradients with
respect to the model outputs). Dictionaries and mixtures stay float32 on
both sides, as both packages hold them, and are promoted. Each test states
its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_regression_tpu.data import targets as jax_targets
from multi_modal_regression_tpu.geometry import quaternion as jax_quat
from multi_modal_regression_tpu.geometry.so3 import exp_so3 as jax_exp_so3
from multi_modal_regression_tpu.losses import bin_delta as jax_bin_delta
from multi_modal_regression_tpu.losses import primitives as jax_primitives
from multi_modal_regression_tpu.models.heads import (
    apply_output_nonlinearity as jax_nonlinearity,
)
from multi_modal_regression_tpu.train.problems import make_problem as jax_make_problem
from multi_modal_regression_tpu_torch.data import targets
from multi_modal_regression_tpu_torch.geometry.so3 import exp_so3
from multi_modal_regression_tpu_torch.losses import bin_delta, primitives
from multi_modal_regression_tpu_torch.models.heads import apply_output_nonlinearity
from multi_modal_regression_tpu_torch.train.problems import make_problem

from test_torch_port_ops import one_torch_thread  # noqa: F401
from test_torch_port_softbins import _gmm_arrays
from test_torch_port_train import _poses, x64  # noqa: F401

B, K = 12, 8
RTOL = 1e-9  # float64 against float64
ATOL = 1e-12


def _centers() -> np.ndarray:
    return (0.7 * np.random.default_rng(0).standard_normal((K, 3))).astype(np.float32)


def _quats(rng, n) -> np.ndarray:
    return np.array(jax_quat.quat_from_axis_angle(jnp.asarray(_poses(rng, n).astype(np.float64))))


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def _grads_match(port_fn, jax_fn, args, argnums, rtol=RTOL, atol=ATOL):
    """Value and d/d(args[argnums]) of a scalar function, port vs JAX."""
    targs = [torch.tensor(a, requires_grad=i in argnums) if isinstance(a, np.ndarray)
             and a.dtype == np.float64 else (torch.from_numpy(a) if isinstance(a, np.ndarray)
                                             else a)
             for i, a in enumerate(args)]
    value = port_fn(*targs)
    value.backward()
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    want, jgrads = jax.jit(jax.value_and_grad(jax_fn, argnums))(*jargs)
    _close(value, want, rtol, atol, "value")
    for i, g in zip(argnums, jgrads):
        got = targs[i].grad  # None: the function does not read the argument
        _close(torch.zeros_like(targs[i]) if got is None else got, g, rtol, atol, f"grad {i}")


# --- primitives ------------------------------------------------------------------------


@pytest.mark.parametrize("reduce", [True, False])
def test_new_primitives_match_jax(x64, reduce):
    """l1, geodesic_quat (an identity pair, q against -q) and geodesic_rotmat
    (a pair at the same rotation, the clamp's edge): values within 1e-9
    relative, and the gradients of the reduced forms. l1's pairs differ in
    every element: at a difference of exactly 0 torch takes the subgradient
    0 of |x| and JAX 1."""
    rng = np.random.default_rng(1)
    a, b = _poses(rng, B).astype(np.float64), _poses(rng, B).astype(np.float64)
    b[0] = 0.1
    qa, qb = _quats(rng, B), _quats(rng, B)
    qb[1] = -qa[1]
    qa_raw = 1.3 * qa  # the prediction enters unnormalized
    Ra, Rb = (np.array(jax_exp_so3(jnp.asarray(x))) for x in (a, b))
    Rb[2] = Ra[2]
    if not reduce:
        _close(primitives.geodesic_quat(torch.from_numpy(qa_raw), torch.from_numpy(qb), reduce=False),
               jax_primitives.geodesic_quat(jnp.asarray(qa_raw), jnp.asarray(qb), reduce=False))
        _close(primitives.geodesic_rotmat(torch.from_numpy(Ra), torch.from_numpy(Rb), reduce=False),
               jax_primitives.geodesic_rotmat(jnp.asarray(Ra), jnp.asarray(Rb), reduce=False))
        return
    _grads_match(primitives.l1, jax_primitives.l1, (a, b), (0,))
    _grads_match(primitives.geodesic_quat, jax_primitives.geodesic_quat, (qa_raw, qb), (0,))
    _grads_match(primitives.geodesic_rotmat, jax_primitives.geodesic_rotmat, (Ra, Rb), (0,))


# --- the composed bin-delta losses ---------------------------------------------------


def _loss_inputs(rng, ndim=3):
    scores = rng.standard_normal((B, K))
    residual = 0.2 * rng.standard_normal((B, ndim))
    residuals = 0.2 * rng.standard_normal((B, K, ndim))
    bins = rng.integers(0, K, B)
    soft = np.exp(rng.standard_normal((B, K)))
    soft[0, :3] = 0.0  # zero targets: 0 * log 0 := 0
    soft /= soft.sum(1, keepdims=True)
    y = _poses(rng, B).astype(np.float64)
    return scores, residual, residuals, bins, soft, y


LOSSES = {
    "simple_loss": lambda m, s, r, rs, b, so, y, C, R, kR, pb: m.simple_loss(s, r, b, y, 0.7),
    "bd_loss_mse": lambda m, s, r, rs, b, so, y, C, R, kR, pb: m.bd_loss(s, r, b, y, C, 0.7),
    "bd_loss_l1": lambda m, s, r, rs, b, so, y, C, R, kR, pb: m.bd_loss(
        s, r, b, y, C, 0.7, (primitives if m is bin_delta else jax_primitives).l1),
    "bd_loss_geodesic": lambda m, s, r, rs, b, so, y, C, R, kR, pb: m.bd_loss(
        s, r, b, y, C, 0.7, (primitives if m is bin_delta else jax_primitives).geodesic_aa),
    "relaxed_simple_loss": lambda m, s, r, rs, b, so, y, C, R, kR, pb: m.relaxed_simple_loss(
        s, r, so, y, 0.7),
    "relaxed_bd_loss": lambda m, s, r, rs, b, so, y, C, R, kR, pb: m.relaxed_bd_loss(
        s, r, so, y, C, 0.7),
    "probabilistic_loss_hard": lambda m, s, r, rs, b, so, y, C, R, kR, pb: m.probabilistic_loss(
        s, r, b, y, C, 0.7),
    "probabilistic_loss_soft": lambda m, s, r, rs, b, so, y, C, R, kR, pb: m.probabilistic_loss(
        s, r, so, y, C, 0.7, soft_bins=True),
    "probabilistic_multires_loss_hard": lambda m, s, r, rs, b, so, y, C, R, kR, pb:
        m.probabilistic_multires_loss(s, rs, b, y, C, 0.7),
    "probabilistic_multires_loss_soft": lambda m, s, r, rs, b, so, y, C, R, kR, pb:
        m.probabilistic_multires_loss(s, rs, so, y, C, 0.7, soft_bins=True),
    "riemannian_loss": lambda m, s, r, rs, b, so, y, C, R, kR, pb: m.riemannian_loss(
        s, r, b, R, kR, 0.7),
    "per_bin_residual_loss": lambda m, s, r, rs, b, so, y, C, R, kR, pb:
        m.per_bin_residual_loss(s, r, b, pb, 0.7),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_composed_bin_delta_losses_match_jax(x64, name):
    """Each composed loss at alpha 0.7: the value and its gradient with
    respect to (scores, residual or per-cluster residuals) within 1e-9
    relative; float32 centers promoted on both sides."""
    rng = np.random.default_rng(2)
    scores, residual, residuals, bins, soft, y = _loss_inputs(rng)
    C = _centers()
    R = np.array(jax_exp_so3(jnp.asarray(y)))
    kR = np.array(jax_exp_so3(jnp.asarray(C.astype(np.float64))))
    pb = 0.3 * rng.standard_normal((B, K, 3))
    fn = LOSSES[name]

    def port(s, r, rs):
        t = {k: torch.from_numpy(v) for k, v in
             dict(b=bins, so=soft, y=y, C=C, R=R, kR=kR, pb=pb).items()}
        return fn(bin_delta, s, r, rs, **t)

    def ref(s, r, rs):
        return fn(jax_bin_delta, s, r, rs, jnp.asarray(bins), jnp.asarray(soft), jnp.asarray(y),
                  jnp.asarray(C), jnp.asarray(R), jnp.asarray(kR), jnp.asarray(pb))

    _grads_match(port, ref, (scores, residual, residuals), (0, 1, 2))


def test_riemannian_loss_gradient_is_finite_at_a_zero_residual(x64):
    """A residual row of exactly 0 trains: the port's gradient there is 0,
    the derivative of exp_so3's identity branch, where the JAX package's
    exp_so3 gives 0 * inf = NaN; the other rows' gradients within 1e-9
    relative of JAX's."""
    rng = np.random.default_rng(3)
    scores, residual, _, bins, _, y = _loss_inputs(rng)
    residual[0] = 0.0
    C = _centers()
    R = np.array(jax_exp_so3(jnp.asarray(y)))
    kR = np.array(jax_exp_so3(jnp.asarray(C.astype(np.float64))))
    r = torch.tensor(residual, requires_grad=True)
    bin_delta.riemannian_loss(torch.from_numpy(scores), r, torch.from_numpy(bins),
                              torch.from_numpy(R), torch.from_numpy(kR)).backward()
    want = jax.grad(jax_bin_delta.riemannian_loss, 1)(
        jnp.asarray(scores), jnp.asarray(residual), jnp.asarray(bins), jnp.asarray(R),
        jnp.asarray(kR))
    assert torch.isfinite(r.grad).all() and torch.equal(r.grad[0], torch.zeros(3, dtype=torch.float64))
    assert np.isnan(np.asarray(want)[0]).all()
    _close(r.grad[1:], np.asarray(want)[1:])
    v = torch.zeros(2, 3, dtype=torch.float64, requires_grad=True)
    exp_so3(v).sum().backward()
    assert torch.equal(v.grad, torch.zeros_like(v))


# --- tangent targets --------------------------------------------------------------------


def test_tangent_targets_match_jax(x64):
    """tangent_residual_targets (bins equal, residuals and R within 1e-9
    relative) and per_bin_tangent_residuals (B, K, 3) against JAX, with
    float64 key rotations; a pose equal to an atom has residual 0."""
    rng = np.random.default_rng(4)
    C = _centers()
    y = _poses(rng, B).astype(np.float64)
    y[3] = C[5]
    kR = np.array(jax_exp_so3(jnp.asarray(C.astype(np.float64))))
    bins, res, R = targets.tangent_residual_targets(
        torch.from_numpy(y), torch.from_numpy(C), torch.from_numpy(kR))
    jbins, jres, jR = jax_targets.tangent_residual_targets(
        jnp.asarray(y), jnp.asarray(C), jnp.asarray(kR))
    np.testing.assert_array_equal(bins.numpy(), np.asarray(jbins))
    _close(res, jres)
    _close(R, jR)
    assert int(bins[3]) == 5 and float(res[3].abs().max()) < 1e-6
    per = targets.per_bin_tangent_residuals(torch.from_numpy(y), torch.from_numpy(kR))
    assert per.shape == (B, K, 3)
    _close(per, jax_targets.per_bin_tangent_residuals(jnp.asarray(y), jnp.asarray(kR)))


# --- the output nonlinearities ---------------------------------------------------------


@pytest.mark.parametrize("kind", ["none", "tanh", "pi_tanh", "my_proj", "quat"])
def test_output_nonlinearities_match_jax(x64, kind):
    """Rows at |y| = 0, inside the EPS ball, at pi and above pi (my_proj
    folds the angle by fmod), and large ones (quat of a saturated tanh):
    values and the gradient of a weighted sum within 1e-9 relative;
    unknown kinds raise."""
    rng = np.random.default_rng(5)
    ndim = 4 if kind == "quat" else 3
    y = rng.standard_normal((16, ndim))
    y[1] = 0.0
    y[2] = 3e-7
    y[3] *= np.pi / np.linalg.norm(y[3])
    y[4] *= 2.5 * np.pi / np.linalg.norm(y[4])
    y[5] *= 40.0
    w = rng.standard_normal((16, ndim))
    got = apply_output_nonlinearity(torch.from_numpy(y), kind)
    _close(got, jax_nonlinearity(jnp.asarray(y), kind))
    _grads_match(
        lambda t: (apply_output_nonlinearity(t, kind) * torch.from_numpy(w)).sum(),
        lambda t: (jax_nonlinearity(t, kind) * jnp.asarray(w)).sum(), (y,), (0,),
    )
    if kind == "my_proj":
        norms = np.linalg.norm(got.numpy(), axis=1)
        assert norms[1] == 0.0 and norms.max() < np.pi
    with pytest.raises(ValueError, match="nonlinearity"):
        apply_output_nonlinearity(torch.from_numpy(y), "relu")


# --- the 12 problems, phase by phase -----------------------------------------------------

NEW_PROBLEMS = (
    "simple", "euclidean", "laplacian", "geodesic_quat", "probabilistic_multires",
    "probabilistic_quat", "probabilistic_quat_multires", "riemannian", "log_euclidean",
    "classification", "regression", "regression_quat",
)


# problems whose targets come from float32 constants that each library makes
# in float32 from the same float32 arrays: the quaternion dictionary
# (cos/sin of the atoms) and the GMM posteriors (Cholesky and log-determinant
# of the mixture, which the JAX function takes in float32 and the port in
# the poses' float64). The two roundings differ by float32 ulps (measured
# 6e-8 absolute), which float64 carries into every output.
F32_CONSTANTS = ("geodesic_quat", "probabilistic_multires", "probabilistic_quat",
                 "probabilistic_quat_multires")


def _problem_kw(name):
    if name == "probabilistic_multires":
        means, covs, w = _gmm_arrays()
        return _centers(), dict(gmm_means=means, gmm_covariances=covs, gmm_weights=w)
    return (None if name.startswith("regression") else _centers()), {}


def _outputs(name, rng):
    """The model output the problem sees: (scores, residual) with per-cluster
    residuals for the multires problems, or one tensor."""
    ndim = 4 if "quat" in name else 3
    scores = rng.standard_normal((B, K))
    if name == "classification":
        return scores
    if name.startswith("regression"):
        y = rng.standard_normal((B, ndim))
        return y / np.linalg.norm(y, axis=1, keepdims=True) if ndim == 4 else y
    shape = (B, K, ndim) if name.endswith("multires") else (B, ndim)
    return scores, 0.2 * rng.standard_normal(shape)


@pytest.mark.parametrize("phase", ["warmup", "main"])
@pytest.mark.parametrize("name", NEW_PROBLEMS)
def test_zoo_problems_match_jax(x64, name, phase):
    """Targets (integer bins equal), the phase's (lc, lr), the decode and
    d(lc + lr)/d(outputs) within 1e-9 relative (atol 1e-12) of the JAX
    problem's, and the same representation and balance modes; float64
    poses, float32 dictionaries and mixtures on both sides. The problems of
    F32_CONSTANTS within 1e-6 relative, atol 1e-7 (see there)."""
    rng = np.random.default_rng(6)
    tol = dict(rtol=1e-6, atol=1e-7) if name in F32_CONSTANTS else {}
    centers, kw = _problem_kw(name)
    port = make_problem(name, centers, "cpu", **kw)
    ref = jax_make_problem(name, centers, **kw)
    assert (port.ydata_type, port.warmup_balance, port.main_balance) == (
        ref.ydata_type, ref.warmup_balance, ref.main_balance)
    y = _quats(rng, B) if port.ydata_type == "quaternion" else _poses(rng, B).astype(np.float64)
    tg, jtg = port.targets(torch.from_numpy(y)), jax.jit(ref.targets)(jnp.asarray(y))
    assert sorted(tg) == sorted(jtg)
    for k in tg:
        if tg[k].dtype == torch.int64:
            np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jtg[k]), err_msg=k)
        else:
            _close(tg[k], jtg[k], msg=k, **tol)
    out = _outputs(name, rng)
    single = not isinstance(out, tuple)
    outs = (out,) if single else out
    touts = [torch.tensor(o, requires_grad=True) for o in outs]
    port_out = touts[0] if single else tuple(touts)
    jouts = tuple(jnp.asarray(o) for o in outs)
    jlosses_fn = getattr(ref, f"{phase}_losses")
    losses = getattr(port, f"{phase}_losses")(port_out, tg)
    jout = jouts[0] if single else jouts
    want, jdecode = jax.jit(lambda o, t: (jlosses_fn(o, t), ref.decode(o)))(jout, jtg)
    for g, w, what in zip(losses, want, ("lc", "lr")):
        _close(g, w, msg=what, **tol)
    with torch.no_grad():
        _close(port.decode(port_out), jdecode, msg="decode", **tol)
    total = sum(losses)
    if not total.requires_grad:  # nothing to differentiate (e.g. warm-up lc and lr at 0)
        return
    total.backward()
    jgrads = jax.jit(jax.grad(
        lambda *o: sum(jlosses_fn(o[0] if single else o, jtg)), tuple(range(len(jouts)))
    ))(*jouts)
    for t, g in zip(touts, jgrads):
        _close(t.grad, g, msg="grad", **tol)
