"""Reprojection residual and analytic Jacobians.

The cost function of the reference backend (``reprojection_factor.cpp:10-88``):

    gamma = R(q) p / |q|^2 + t          # world point into camera frame,
                                        # valid for NON-unit quaternions
    r     = K_{2x3} * gamma / gamma_z - obs

with ``q`` w-first, pose = T_cw, and ``K = [[f, 0, cx], [0, f, cy]]``.

The reference ships closed-form Jacobians generated by MATLAB symbolic
differentiation (``reprojection_factor.cpp:59-84``). Here the same 2x7 (pose)
and 2x3 (landmark) Jacobians are derived analytically via the chain rule in a
compact form; tests verify them against ``jax.jacfwd`` of the residual — which
is exactly the derivative the MATLAB forms express — and against finite
differences (SURVEY.md §4 "Unit").

Everything is written batched over an arbitrary leading observation axis so the
whole window's residual block evaluates as one fused XLA computation (the
reference evaluates per-observation callbacks inside Ceres).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from stereo_vo.core.camera import CameraInfo
from stereo_vo.core.geometry import pose_q, pose_t, rot_apply


def _gamma(pose: jnp.ndarray, point: jnp.ndarray) -> jnp.ndarray:
    """Camera-frame point ``R(q) p / |q|^2 + t`` for ``[..., 7]`` poses."""
    return rot_apply(pose_q(pose), point) + pose_t(pose)


def reprojection_residual(
    pose: jnp.ndarray,
    point: jnp.ndarray,
    obs: jnp.ndarray,
    cam: CameraInfo,
) -> jnp.ndarray:
    """``[..., 2]`` residual ``K gamma / gamma_z - obs`` (reprojection_factor.cpp:38)."""
    g = _gamma(pose, point)
    z = g[..., 2:3]
    uv = g[..., 0:2] / z
    k = jnp.array([cam.cx, cam.cy], dtype=uv.dtype)
    return uv * jnp.asarray(cam.focal, uv.dtype) + k - obs


def reprojection_jacobians(
    pose: jnp.ndarray,
    point: jnp.ndarray,
    obs: jnp.ndarray,
    cam: CameraInfo,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Residual + analytic Jacobians.

    Returns ``(r [..., 2], J_pose [..., 2, 7], J_point [..., 2, 3])`` — the same
    blocks as the reference's ``SizedCostFunction<2, 7, 3>::Evaluate``
    (``reprojection_factor.hpp:7``, ``.cpp:59-84``).
    """
    dtype = pose.dtype
    q = pose_q(pose)
    w = q[..., 0:1]
    v = q[..., 1:4]
    t = pose_t(pose)
    n2 = jnp.sum(q * q, axis=-1, keepdims=True)

    # Unnormalized rotated point u = R_un(q) p ; gamma = u / n2 + t.
    vdotp = jnp.sum(v * point, axis=-1, keepdims=True)
    vdotv = jnp.sum(v * v, axis=-1, keepdims=True)
    vxp = jnp.cross(v, point)
    u = 2.0 * vdotp * v + (w * w - vdotv) * point + 2.0 * w * vxp
    g = u / n2 + t

    gx, gy, gz = g[..., 0], g[..., 1], g[..., 2]
    inv_z = 1.0 / gz
    f = jnp.asarray(cam.focal, dtype)

    # dr/dgamma  [..., 2, 3]
    zero = jnp.zeros_like(gx)
    dr_dg = jnp.stack(
        [
            f * inv_z, zero, -f * gx * inv_z * inv_z,
            zero, f * inv_z, -f * gy * inv_z * inv_z,
        ],
        axis=-1,
    ).reshape(g.shape[:-1] + (2, 3))

    # d(R_un p)/dq  [..., 3, 4]:
    #   d/dw = 2 (w p + v x p)
    #   d/dv = 2 ( v p^T + (v.p) I - p v^T - w skew(p) )
    du_dw = 2.0 * (w * point + vxp)  # [..., 3]
    eye3 = jnp.eye(3, dtype=dtype)
    vpT = v[..., :, None] * point[..., None, :]
    pvT = point[..., :, None] * v[..., None, :]
    px, py, pz = point[..., 0], point[..., 1], point[..., 2]
    skew_p = jnp.stack(
        [zero, -pz, py,
         pz, zero, -px,
         -py, px, zero],
        axis=-1,
    ).reshape(point.shape[:-1] + (3, 3))
    du_dv = 2.0 * (vpT + vdotp[..., None] * eye3 - pvT - w[..., None] * skew_p)
    du_dq = jnp.concatenate([du_dw[..., :, None], du_dv], axis=-1)  # [..., 3, 4]

    # dgamma/dq = du_dq / n2 - 2 u q^T / n2^2  (quotient rule for the 1/|q|^2)
    dg_dq = du_dq / n2[..., None] - (
        2.0 * u[..., :, None] * q[..., None, :] / (n2 * n2)[..., None]
    )

    # dgamma/dp = R(q)/|q|^2 : build from the same primitives.
    rmat = (
        2.0 * (v[..., :, None] * v[..., None, :])
        + (w * w - vdotv)[..., None] * eye3
        + 2.0
        * w[..., None]
        * jnp.stack(
            [zero, -v[..., 2], v[..., 1],
             v[..., 2], zero, -v[..., 0],
             -v[..., 1], v[..., 0], zero],
            axis=-1,
        ).reshape(point.shape[:-1] + (3, 3))
    ) / n2[..., None]

    # 2x3 @ 3xK chain products as broadcast-sums: per-observation matrices
    # are far below any matrix unit's tile size, so a batched dot pads; the
    # elementwise form fuses with the surrounding jacobian arithmetic
    j_q = jnp.sum(dr_dg[..., :, :, None] * dg_dq[..., None, :, :], axis=-2)
    j_t = dr_dg                                            # dgamma/dt = I
    j_pose = jnp.concatenate([j_q, j_t], axis=-1)          # [..., 2, 7]
    j_point = jnp.sum(dr_dg[..., :, :, None] * rmat[..., None, :, :], axis=-2)

    uvz = jnp.stack([gx, gy], axis=-1) * inv_z[..., None]
    r = uvz * f + jnp.array([cam.cx, cam.cy], dtype=dtype) - obs
    return r, j_pose, j_point
