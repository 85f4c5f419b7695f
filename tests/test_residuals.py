import jax
import jax.numpy as jnp
import numpy as np

from stereo_vo.backend.residuals import (
    reprojection_jacobians,
    reprojection_residual,
)
from stereo_vo.core.camera import CameraInfo
from stereo_vo.core import geometry as geo

CAM = CameraInfo(focal=718.856, cx=607.19, cy=185.22, baseline=0.537)


def _random_problem(rng, n, unit=False):
    q = rng.normal(size=(n, 4))
    if unit:
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
    else:
        q *= 0.7  # deliberately non-unit: the residual must be scale-invariant
    # small rotations + camera ~2m behind looking at points in front
    q = 0.2 * q + np.array([1.0, 0, 0, 0])
    t = rng.normal(size=(n, 3)) * 0.5
    p = rng.normal(size=(n, 3)) * 2.0 + np.array([0, 0, 10.0])
    pose = jnp.asarray(np.concatenate([q, t], axis=-1), jnp.float32)
    point = jnp.asarray(p, jnp.float32)
    obs = CAM.project(geo.pose_apply(pose, point)) + jnp.asarray(
        rng.normal(size=(n, 2)), jnp.float32
    )
    return pose, point, obs


def test_residual_zero_at_exact_projection(rng):
    pose, point, _ = _random_problem(rng, 8)
    obs = CAM.project(geo.pose_apply(pose, point))
    r = reprojection_residual(pose, point, obs, CAM)
    np.testing.assert_allclose(r, 0.0, atol=1e-2)  # f32 at ~700px scale


def test_residual_nonunit_quaternion_invariance(rng):
    """|q|^2 normalization inside the residual (reprojection_factor.cpp:33)."""
    pose, point, obs = _random_problem(rng, 8)
    scaled = pose.at[:, 0:4].multiply(2.5)
    np.testing.assert_allclose(
        reprojection_residual(scaled, point, obs, CAM),
        reprojection_residual(pose, point, obs, CAM),
        rtol=1e-4,
        atol=1e-2,
    )


def test_jacobians_match_autodiff(rng):
    """Analytic 2x7 / 2x3 Jacobians == jacfwd of the residual — the same
    derivative the reference's MATLAB closed forms express
    (reprojection_factor.cpp:59-84)."""
    with jax.enable_x64(True):
        pose, point, obs = _random_problem(rng, 16)
        pose = pose.astype(jnp.float64)
        point = point.astype(jnp.float64)
        obs = obs.astype(jnp.float64)

        r, jp, jl = reprojection_jacobians(pose, point, obs, CAM)
        r_ref = reprojection_residual(pose, point, obs, CAM)
        np.testing.assert_allclose(r, r_ref, rtol=1e-12)

        jp_ad = jax.vmap(
            lambda po, pt, ob: jax.jacfwd(
                lambda x: reprojection_residual(x, pt, ob, CAM)
            )(po)
        )(pose, point, obs)
        jl_ad = jax.vmap(
            lambda po, pt, ob: jax.jacfwd(
                lambda x: reprojection_residual(po, x, ob, CAM)
            )(pt)
        )(pose, point, obs)
        np.testing.assert_allclose(jp, jp_ad, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(jl, jl_ad, rtol=1e-9, atol=1e-9)


def test_jacobians_match_finite_differences(rng):
    with jax.enable_x64(True):
        pose, point, obs = _random_problem(rng, 4)
        pose = pose.astype(jnp.float64)
        point = point.astype(jnp.float64)
        obs = obs.astype(jnp.float64)
        _, jp, jl = reprojection_jacobians(pose, point, obs, CAM)

        eps = 1e-6
        jp_fd = np.zeros_like(jp)
        for k in range(7):
            dp = jnp.zeros(7, jnp.float64).at[k].set(eps)
            rp = reprojection_residual(pose + dp, point, obs, CAM)
            rm = reprojection_residual(pose - dp, point, obs, CAM)
            jp_fd[:, :, k] = (rp - rm) / (2 * eps)
        np.testing.assert_allclose(jp, jp_fd, rtol=1e-4, atol=1e-4)

        jl_fd = np.zeros_like(jl)
        for k in range(3):
            dp = jnp.zeros(3, jnp.float64).at[k].set(eps)
            rp = reprojection_residual(pose, point + dp, obs, CAM)
            rm = reprojection_residual(pose, point - dp, obs, CAM)
            jl_fd[:, :, k] = (rp - rm) / (2 * eps)
        np.testing.assert_allclose(jl, jl_fd, rtol=1e-4, atol=1e-4)


def test_translation_jacobian_structure(rng):
    """dr/dt2 for r_x and dr/dt1 for r_y are exactly zero, and dr/dt1 for r_x
    is f/gamma_z — structural facts visible in the reference closed forms
    (reprojection_factor.cpp:72-75, zero entries [5] and [11])."""
    pose, point, obs = _random_problem(rng, 8)
    _, jp, _ = reprojection_jacobians(pose, point, obs, CAM)
    np.testing.assert_allclose(jp[:, 0, 5], 0.0, atol=1e-6)
    np.testing.assert_allclose(jp[:, 1, 4], 0.0, atol=1e-6)
    g = geo.pose_apply(pose, point)
    np.testing.assert_allclose(jp[:, 0, 4], CAM.focal / g[:, 2], rtol=1e-4)
    np.testing.assert_allclose(jp[:, 1, 5], CAM.focal / g[:, 2], rtol=1e-4)
