"""Quaternion / SE(3) geometry in the reference's conventions.

Conventions (parity with the reference C++ — see SURVEY.md §0):

- Quaternions are **w-first** ``[w, x, y, z]`` Hamilton quaternions
  (reference ``bundle_adjuster.cpp:63-66``).
- A pose is a 7-vector ``[qw qx qy qz, tx ty tz]`` storing the transform of the
  **world frame with respect to the camera frame** (T_cw): ``x_cam = R(q) @ x_world + t``
  (reference ``bundle_adjuster.hpp:16-24``, ``reprojection_factor.cpp:15-16``).
- ``rot_apply`` is valid for **non-unit** quaternions: it uses
  ``R(q) p = (v v^T + (skew(v) + w I)^2) p / |q|^2``, exactly the form used by the
  reference cost function (``reprojection_factor.cpp:24-33``), so that the
  optimizer may wander off the unit sphere without changing the encoded rotation.
- Publication of a pose inverts it: ``q_wc = conj(q_cw)``,
  ``t_wc = R(q_wc) @ (-t_cw)`` (reference ``vo_node.cpp:149-150``).

All functions are shape-polymorphic over leading batch dims where noted and are
dtype-generic (float32 on the device, float64 under ``jax.experimental.enable_x64`` for
verification tests).
"""

from __future__ import annotations

import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Quaternion primitives
# ---------------------------------------------------------------------------

def quat_identity(dtype=jnp.float32) -> jnp.ndarray:
    return jnp.array([1.0, 0.0, 0.0, 0.0], dtype=dtype)


def quat_conj(q: jnp.ndarray) -> jnp.ndarray:
    """Conjugate of ``[..., 4]`` w-first quaternions."""
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_mul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Hamilton product ``a ⊗ b`` of ``[..., 4]`` w-first quaternions."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_normalize(q: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    n = jnp.linalg.norm(q, axis=-1, keepdims=True)
    return q / jnp.maximum(n, eps)


def rot_apply(q: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Rotate ``[..., 3]`` vectors by ``[..., 4]`` (possibly non-unit) quaternions.

    Implements ``R(q) p / |q|^2`` with
    ``R = 2 v v^T + (w^2 - v.v) I + 2 w skew(v)`` — algebraically identical to the
    reference's ``(v v^T + (skew(v)+wI)^2)`` form (``reprojection_factor.cpp:24-33``).
    """
    w = q[..., 0:1]
    v = q[..., 1:4]
    n2 = jnp.sum(q * q, axis=-1, keepdims=True)
    vp = jnp.cross(v, p)
    vdotp = jnp.sum(v * p, axis=-1, keepdims=True)
    vdotv = jnp.sum(v * v, axis=-1, keepdims=True)
    rp = 2.0 * vdotp * v + (w * w - vdotv) * p + 2.0 * w * vp
    return rp / n2


def quat_to_rotmat(q: jnp.ndarray) -> jnp.ndarray:
    """``[..., 4]`` quaternion -> ``[..., 3, 3]`` rotation matrix (normalizing)."""
    q = quat_normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = jnp.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        axis=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def rotmat_to_quat(m: jnp.ndarray) -> jnp.ndarray:
    """``[..., 3, 3]`` rotation matrix -> unit w-first quaternion.

    Branch-free (Shepperd's method computed over all four candidates and the
    numerically-best one selected) so it is safe under ``vmap``/``jit``.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidate 4*q*q_k parameterizations; pick the one with largest pivot.
    qw = jnp.stack([1 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    qx = jnp.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1)
    qy = jnp.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21], axis=-1)
    qz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22], axis=-1)

    pivots = jnp.stack([1 + tr, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22,
                        1 - m00 - m11 + m22], axis=-1)
    best = jnp.argmax(pivots, axis=-1)
    cands = jnp.stack([qw, qx, qy, qz], axis=-2)  # [..., 4(cand), 4(comp)]
    q = jnp.take_along_axis(cands, best[..., None, None], axis=-2)[..., 0, :]
    q = quat_normalize(q)
    # Canonical sign: w >= 0.
    return q * jnp.where(q[..., 0:1] < 0, -1.0, 1.0)


# ---------------------------------------------------------------------------
# Tangent-space retraction (manifold parameterization for the optimizer)
# ---------------------------------------------------------------------------

def quat_exp(delta: jnp.ndarray) -> jnp.ndarray:
    """Exponential map ``R^3 -> S^3``: ``[cos|δ|, sinc|δ| · δ]`` (w-first).

    Same chart as Ceres' ``QuaternionParameterization::Plus``
    (reference solver config ``bundle_adjuster.cpp:19-20``).
    """
    n2 = jnp.sum(delta * delta, axis=-1, keepdims=True)
    n = jnp.sqrt(n2)
    small = n < 1e-8
    # Taylor: cos(n) ~ 1 - n^2/2 ; sinc(n) ~ 1 - n^2/6
    w = jnp.where(small, 1.0 - n2 / 2.0, jnp.cos(n))
    s = jnp.where(small, 1.0 - n2 / 6.0, jnp.sin(jnp.maximum(n, 1e-20)) / jnp.maximum(n, 1e-20))
    return jnp.concatenate([w, s * delta], axis=-1)


def quat_retract(q: jnp.ndarray, delta: jnp.ndarray) -> jnp.ndarray:
    """``q ⊞ δ = exp(δ) ⊗ q`` for ``[..., 4]`` quats and ``[..., 3]`` tangents."""
    return quat_mul(quat_exp(delta), q)


def quat_lift_jacobian(q: jnp.ndarray) -> jnp.ndarray:
    """``d(exp(δ) ⊗ q)/dδ`` at ``δ = 0`` — the ``[..., 4, 3]`` lift matrix.

    For the left-multiplicative chart: rows ``[[-v^T], [w I - skew(v)]]``.
    Used to fold the 2x7 ambient reprojection Jacobian down to the 2x6 tangent
    Jacobian inside the Schur solver.
    """
    w = q[..., 0]
    x, y, z = q[..., 1], q[..., 2], q[..., 3]
    zero = jnp.zeros_like(w)
    j = jnp.stack(
        [
            -x, -y, -z,
            w, z, -y,
            -z, w, x,
            y, -x, w,
        ],
        axis=-1,
    )
    del zero
    return j.reshape(q.shape[:-1] + (4, 3))


# ---------------------------------------------------------------------------
# Axis-angle (Rodrigues) — used by PnP, mirroring cv::Rodrigues
# (reference image_processor.cpp:84-92)
# ---------------------------------------------------------------------------

def axis_angle_to_quat(rvec: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues vector ``[..., 3]`` -> w-first quaternion (``exp(rvec/2)``)."""
    return quat_exp(rvec / 2.0)


def quat_to_axis_angle(q: jnp.ndarray) -> jnp.ndarray:
    q = quat_normalize(q)
    q = q * jnp.where(q[..., 0:1] < 0, -1.0, 1.0)
    w = jnp.clip(q[..., 0:1], -1.0, 1.0)
    v = q[..., 1:4]
    vn = jnp.linalg.norm(v, axis=-1, keepdims=True)
    angle = 2.0 * jnp.arctan2(vn, w)
    axis = v / jnp.maximum(vn, 1e-12)
    return jnp.where(vn < 1e-12, 2.0 * v, angle * axis)


# ---------------------------------------------------------------------------
# SE(3) poses as 7-vectors [qw qx qy qz, tx ty tz] encoding T_cw
# ---------------------------------------------------------------------------

def pose_identity(dtype=jnp.float32) -> jnp.ndarray:
    return jnp.array([1.0, 0, 0, 0, 0, 0, 0], dtype=dtype)


def make_pose(q: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    return jnp.concatenate([q, t], axis=-1)


def pose_q(pose: jnp.ndarray) -> jnp.ndarray:
    return pose[..., 0:4]


def pose_t(pose: jnp.ndarray) -> jnp.ndarray:
    return pose[..., 4:7]


def pose_apply(pose: jnp.ndarray, p_world: jnp.ndarray) -> jnp.ndarray:
    """``x_cam = R(q) p + t`` for a T_cw pose (non-unit-safe rotation)."""
    return rot_apply(pose_q(pose), p_world) + pose_t(pose)


def pose_inverse(pose: jnp.ndarray) -> jnp.ndarray:
    """Invert T_cw -> T_wc exactly as published by the reference
    (``vo_node.cpp:149-150``): ``q' = conj(q)``, ``t' = R(q') (-t)``."""
    qc = quat_conj(pose_q(pose))
    tw = rot_apply(qc, -pose_t(pose))
    return make_pose(qc, tw)


def pose_retract(pose: jnp.ndarray, delta6: jnp.ndarray) -> jnp.ndarray:
    """Retraction on SE(3) as quaternion-manifold ⊗ Euclidean translation.

    ``delta6 = [δθ(3), δt(3)]`` — matches the reference's
    ``ProductParameterization(Quaternion, Identity(3))`` (``bundle_adjuster.cpp:19-20``).
    """
    q = quat_retract(pose_q(pose), delta6[..., 0:3])
    t = pose_t(pose) + delta6[..., 3:6]
    return make_pose(q, t)


def pose_to_matrix(pose: jnp.ndarray) -> jnp.ndarray:
    """T_cw pose -> ``[..., 4, 4]`` homogeneous matrix."""
    r = quat_to_rotmat(pose_q(pose))
    t = pose_t(pose)[..., None]
    top = jnp.concatenate([r, t], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=pose.dtype), pose.shape[:-1] + (4,)
    )[..., None, :]
    return jnp.concatenate([top, bottom], axis=-2)


def camera_to_world_matrix(pose: jnp.ndarray) -> jnp.ndarray:
    """T_cw pose -> ``[..., 4, 4]`` camera-to-world matrix ``[R^T, -R^T t]``.

    The matrix the reference feeds to triangulation (``image_processor.cpp:130-134``).
    """
    return pose_to_matrix(pose_inverse(pose))
