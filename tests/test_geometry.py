import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereo_vo.core import geometry as geo


def random_quats(rng, n, unit=True):
    q = rng.normal(size=(n, 4))
    if unit:
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return jnp.asarray(q, jnp.float32)


def test_quat_mul_identity(rng):
    q = random_quats(rng, 8)
    e = jnp.broadcast_to(geo.quat_identity(), q.shape)
    np.testing.assert_allclose(geo.quat_mul(e, q), q, atol=1e-6)
    np.testing.assert_allclose(geo.quat_mul(q, e), q, atol=1e-6)


def test_quat_mul_conj_gives_norm(rng):
    q = random_quats(rng, 8, unit=False)
    prod = geo.quat_mul(q, geo.quat_conj(q))
    n2 = jnp.sum(q * q, axis=-1)
    np.testing.assert_allclose(prod[:, 0], n2, rtol=1e-5)
    np.testing.assert_allclose(prod[:, 1:], 0.0, atol=1e-4)


def test_rot_apply_matches_matrix(rng):
    q = random_quats(rng, 16)
    p = jnp.asarray(rng.normal(size=(16, 3)), jnp.float32)
    via_mat = jnp.einsum("nij,nj->ni", geo.quat_to_rotmat(q), p)
    np.testing.assert_allclose(geo.rot_apply(q, p), via_mat, atol=1e-5)


def test_rot_apply_nonunit_invariance(rng):
    """The reference residual divides by |q|^2 so scaling q must not change R
    (reprojection_factor.cpp:24-33)."""
    q = random_quats(rng, 8)
    p = jnp.asarray(rng.normal(size=(8, 3)), jnp.float32)
    np.testing.assert_allclose(
        geo.rot_apply(q * 3.7, p), geo.rot_apply(q, p), rtol=1e-4, atol=1e-5
    )


def test_rotmat_quat_roundtrip(rng):
    q = random_quats(rng, 64)
    q = q * jnp.where(q[:, 0:1] < 0, -1.0, 1.0)
    q2 = geo.rotmat_to_quat(geo.quat_to_rotmat(q))
    np.testing.assert_allclose(q2, q, atol=1e-5)


def test_rotmat_to_quat_singular_cases():
    # 180-degree rotations exercise every branch of Shepperd's method.
    for axis in range(3):
        m = -np.eye(3)
        m[axis, axis] = 1.0
        q = geo.rotmat_to_quat(jnp.asarray(m, jnp.float32))
        m2 = geo.quat_to_rotmat(q)
        np.testing.assert_allclose(m2, m, atol=1e-5)


def test_quat_exp_small_angle():
    d = jnp.array([1e-10, 0.0, 0.0], jnp.float32)
    q = geo.quat_exp(d)
    np.testing.assert_allclose(q, [1.0, 1e-10, 0, 0], atol=1e-8)
    np.testing.assert_allclose(jnp.linalg.norm(q), 1.0, atol=1e-7)


def test_quat_retract_composes_rotation(rng):
    q = random_quats(rng, 4)
    d = jnp.asarray(rng.normal(size=(4, 3)) * 0.3, jnp.float32)
    p = jnp.asarray(rng.normal(size=(4, 3)), jnp.float32)
    lhs = geo.rot_apply(geo.quat_retract(q, d), p)
    rhs = geo.rot_apply(geo.quat_exp(d), geo.rot_apply(q, p))
    np.testing.assert_allclose(lhs, rhs, atol=1e-5)


def test_quat_lift_jacobian_vs_autodiff(rng):
    q = random_quats(rng, 8)

    def plus(d, qq):
        return geo.quat_retract(qq, d)

    jac = jax.vmap(lambda qq: jax.jacfwd(plus)(jnp.zeros(3, jnp.float32), qq))(q)
    np.testing.assert_allclose(geo.quat_lift_jacobian(q), jac, atol=1e-5)


def test_axis_angle_roundtrip(rng):
    r = jnp.asarray(rng.normal(size=(16, 3)), jnp.float32)
    r2 = geo.quat_to_axis_angle(geo.axis_angle_to_quat(r))
    np.testing.assert_allclose(r2, r, atol=1e-4)


def test_axis_angle_matches_cv2_rodrigues(rng):
    cv2 = pytest.importorskip("cv2")
    for _ in range(5):
        rvec = rng.normal(size=3)
        m_cv, _ = cv2.Rodrigues(rvec)
        m_ours = geo.quat_to_rotmat(geo.axis_angle_to_quat(jnp.asarray(rvec, jnp.float32)))
        np.testing.assert_allclose(m_ours, m_cv, atol=1e-5)


def test_pose_inverse_matches_reference_convention(rng):
    """Publication inversion: q' = conj(q), t' = R(q')(-t) (vo_node.cpp:149-150)."""
    q = random_quats(rng, 8)
    t = jnp.asarray(rng.normal(size=(8, 3)), jnp.float32)
    pose = geo.make_pose(q, t)
    inv = geo.pose_inverse(pose)
    # pose_apply(inv, pose_apply(pose, p)) == p
    p = jnp.asarray(rng.normal(size=(8, 3)), jnp.float32)
    np.testing.assert_allclose(geo.pose_apply(inv, geo.pose_apply(pose, p)), p, atol=1e-4)


def test_pose_matrix_consistency(rng):
    q = random_quats(rng, 4)
    t = jnp.asarray(rng.normal(size=(4, 3)), jnp.float32)
    pose = geo.make_pose(q, t)
    p = jnp.asarray(rng.normal(size=(4, 3)), jnp.float32)
    ph = jnp.concatenate([p, jnp.ones((4, 1), jnp.float32)], axis=-1)
    via_mat = jnp.einsum("nij,nj->ni", geo.pose_to_matrix(pose), ph)[:, :3]
    np.testing.assert_allclose(geo.pose_apply(pose, p), via_mat, atol=1e-5)
    # camera_to_world is the matrix of the inverse (image_processor.cpp:130-134)
    c2w = geo.camera_to_world_matrix(pose)
    np.testing.assert_allclose(
        jnp.einsum("nij,njk->nik", geo.pose_to_matrix(pose), c2w),
        jnp.broadcast_to(jnp.eye(4), (4, 4, 4)),
        atol=1e-4,
    )
