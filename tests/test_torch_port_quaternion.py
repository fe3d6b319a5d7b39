"""The PyTorch port's geometry/quaternion.py and quaternion pose targets vs
the JAX package, on CPU, in float64 (the JAX side under a scoped
jax_enable_x64): every function within 1e-12, including the identity
branch (skew norm <= eps) and rotations near pi."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_regression_tpu.data.targets import euler_to_pose as jax_euler_to_pose
from multi_modal_regression_tpu.geometry import quaternion as jq
from multi_modal_regression_tpu.geometry.so3 import exp_so3 as jax_exp_so3
from multi_modal_regression_tpu_torch.data.targets import euler_to_pose
from multi_modal_regression_tpu_torch.geometry import quaternion as q

from test_torch_port_ops import one_torch_thread  # noqa: F401
from test_torch_port_train import x64  # noqa: F401

TOL = 1e-12


def _axis_angles(rng, n: int) -> np.ndarray:
    """Random axis-angle vectors with an identity row, a row inside the eps
    ball, and rows at and near pi."""
    v = rng.standard_normal((n, 3))
    v = v / np.linalg.norm(v, axis=1, keepdims=True)
    angles = rng.uniform(0, np.pi, n)
    angles[:5] = [0.0, 3e-7, np.pi, np.pi - 1e-9, np.pi - 1e-4]
    return v * angles[:, None]


def _close(got: torch.Tensor, want) -> None:
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_quat_from_axis_angle_matches_jax(x64):
    v = _axis_angles(np.random.default_rng(0), 64)
    _close(q.quat_from_axis_angle(torch.from_numpy(v)), jq.quat_from_axis_angle(jnp.asarray(v)))
    assert torch.equal(q.quat_from_axis_angle(torch.zeros(1, 3, dtype=torch.float64)),
                       torch.tensor([[1.0, 0.0, 0.0, 0.0]], dtype=torch.float64))


def test_quat_from_rotation_matches_jax(x64):
    """Rotation matrices from exp_so3 of the axis-angles, an identity and a
    rotation whose skew part is under eps (both take the identity branch),
    and rotations at pi (skew part 0 as well: the reference's identity)."""
    v = _axis_angles(np.random.default_rng(1), 64)
    R = np.array(jax_exp_so3(jnp.asarray(v)))
    _close(q.quat_from_rotation(torch.from_numpy(R)), jq.quat_from_rotation(jnp.asarray(R)))
    got = q.quat_from_rotation(torch.from_numpy(R[:3]))
    assert torch.equal(got[:2], torch.tensor([[1.0, 0, 0, 0]] * 2, dtype=torch.float64))


def test_axis_angle_from_quat_matches_jax(x64):
    v = _axis_angles(np.random.default_rng(2), 64)
    qs = np.array(jq.quat_from_axis_angle(jnp.asarray(v)))
    _close(q.axis_angle_from_quat(torch.from_numpy(qs)), jq.axis_angle_from_quat(jnp.asarray(qs)))
    # round trip away from the eps ball and pi
    back = q.axis_angle_from_quat(q.quat_from_axis_angle(torch.from_numpy(v[5:])))
    np.testing.assert_allclose(back.numpy(), v[5:], atol=1e-10)


@pytest.mark.parametrize("eps", [None, 1e-6], ids=["metric", "loss"])
def test_quat_geodesic_angle_matches_jax(x64, eps):
    """Both clip conventions, with q against -q (angle 0) and unnormalized
    inputs whose dot leaves [-1, 1]."""
    rng = np.random.default_rng(3)
    a = np.array(jq.quat_from_axis_angle(jnp.asarray(_axis_angles(rng, 64))))
    b = np.array(jq.quat_from_axis_angle(jnp.asarray(_axis_angles(rng, 64))))
    b[:4] = -a[:4]
    b[4] = 1.01 * a[4]
    _close(q.quat_geodesic_angle(torch.from_numpy(a), torch.from_numpy(b), eps),
           jq.quat_geodesic_angle(jnp.asarray(a), jnp.asarray(b), eps))


def test_convert_dictionary_matches_jax(x64):
    c = _axis_angles(np.random.default_rng(4), 200)
    got = q.convert_dictionary(torch.from_numpy(c))
    _close(got, jq.convert_dictionary(jnp.asarray(c)))
    np.testing.assert_allclose(torch.linalg.vector_norm(got, dim=-1).numpy(), 1.0, atol=TOL)


@pytest.mark.parametrize("ydata_type", ["axis_angle", "quaternion"])
def test_euler_to_pose_matches_jax(x64, ydata_type):
    """Euler angles in degrees (with the zero pose, whose quaternion is the
    identity) to poses, within 1e-12; an unknown kind raises."""
    rng = np.random.default_rng(5)
    e = np.stack([rng.uniform(-180, 180, 64), rng.uniform(-60, 80, 64),
                  rng.uniform(-45, 45, 64)], axis=1)
    e[0] = 0.0
    got = euler_to_pose(torch.from_numpy(e), ydata_type)
    assert got.shape == (64, 4 if ydata_type == "quaternion" else 3)
    _close(got, jax_euler_to_pose(jnp.asarray(e), ydata_type))
    with pytest.raises(ValueError, match="ydata_type"):
        euler_to_pose(torch.from_numpy(e), "rotmat")
