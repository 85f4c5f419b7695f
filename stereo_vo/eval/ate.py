"""Trajectory evaluation: ATE / RPE.

The benchmark-harness replacement for the reference's eyeball-in-rviz
validation (SURVEY.md §4, C11): absolute trajectory error after Umeyama
SE(3)/Sim(3) alignment, and relative pose error over fixed frame deltas —
the standard KITTI/TUM metrics.

Operates on ``[N, 7]`` T_cw pose arrays (the framework convention) or on
``[N, 3]`` position arrays directly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _positions_from_tcw(poses: np.ndarray) -> np.ndarray:
    """T_cw pose vectors -> camera centers in world frame: c = -R^T t."""
    import jax.numpy as jnp

    from stereo_vo.core import geometry as geo

    p = jnp.asarray(poses)
    inv = geo.pose_inverse(p)
    return np.asarray(inv[..., 4:7])


def umeyama_align(
    est: np.ndarray, gt: np.ndarray, with_scale: bool = False
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity/rigid alignment est -> gt (Umeyama 1991).

    Returns ``(R, t, s)`` with ``aligned = s * (R @ est.T).T + t``.
    """
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    xe = est - mu_e
    xg = gt - mu_g
    cov = xg.T @ xe / len(est)
    u, d, vt = np.linalg.svd(cov)
    s_mat = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_mat[2, 2] = -1
    r = u @ s_mat @ vt
    if with_scale:
        var_e = (xe ** 2).sum() / len(est)
        s = float(np.trace(np.diag(d) @ s_mat) / var_e) if var_e > 0 else 1.0
    else:
        s = 1.0
    t = mu_g - s * r @ mu_e
    return r, t, s


def absolute_trajectory_error(
    est: np.ndarray,
    gt: np.ndarray,
    align: bool = True,
    with_scale: bool = False,
) -> dict:
    """ATE statistics between two trajectories.

    ``est``/``gt`` are ``[N, 7]`` T_cw poses or ``[N, 3]`` positions. Returns a
    dict with rmse/mean/median/max in meters.
    """
    if est.shape[-1] == 7:
        est = _positions_from_tcw(est)
    if gt.shape[-1] == 7:
        gt = _positions_from_tcw(gt)
    n = min(len(est), len(gt))
    est, gt = est[:n], gt[:n]
    if align and n >= 3:
        r, t, s = umeyama_align(est, gt, with_scale)
        est = s * (r @ est.T).T + t
    err = np.linalg.norm(est - gt, axis=1)
    return {
        "rmse": float(np.sqrt((err ** 2).mean())),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "max": float(err.max()),
        "n": int(n),
    }


def relative_pose_error(
    est: np.ndarray, gt: np.ndarray, delta: int = 1
) -> dict:
    """Translational RPE over frame pairs ``(i, i+delta)`` (drift per step)."""
    if est.shape[-1] == 7:
        est = _positions_from_tcw(est)
    if gt.shape[-1] == 7:
        gt = _positions_from_tcw(gt)
    n = min(len(est), len(gt))
    if n <= delta:
        return {"rmse": 0.0, "mean": 0.0, "n": 0}
    de = est[delta:n] - est[: n - delta]
    dg = gt[delta:n] - gt[: n - delta]
    err = np.linalg.norm(de - dg, axis=1)
    return {"rmse": float(np.sqrt((err ** 2).mean())), "mean": float(err.mean()),
            "n": int(len(err))}
