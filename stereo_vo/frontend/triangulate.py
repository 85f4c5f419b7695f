"""Stereo triangulation of detected features.

The device-native version of ``ImageProcessor::triangulate_stereo``
(``image_processor.cpp:165-208``): disparity looked up at truncated integer
feature coordinates, features kept iff ``disp > 0``, back-projected through the
Q reprojection matrix and transformed by the camera-to-world matrix. Instead of
dynamically-sized output vectors, returns fixed-shape arrays + validity mask.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from stereo_vo.core.camera import CameraInfo
from stereo_vo.core.geometry import camera_to_world_matrix
from stereo_vo.ops.stereo_bm import disparity_at


def triangulate_features(
    disparity: jnp.ndarray,
    xy: jnp.ndarray,
    valid: jnp.ndarray,
    cam: CameraInfo,
    pose_cw: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Returns ``(points_world [F, 3], valid [F])``.

    ``pose_cw`` is the T_cw 7-vector of the camera the features live in; the
    reference passes the equivalent ``[R^T, -R^T t]`` matrix
    (``image_processor.cpp:130-142``).
    """
    disp = disparity_at(disparity, xy)
    return triangulate_from_disparities(disp, xy, valid, cam, pose_cw)


def triangulate_from_disparities(
    disp: jnp.ndarray,
    xy: jnp.ndarray,
    valid: jnp.ndarray,
    cam: CameraInfo,
    pose_cw: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Same as :func:`triangulate_features` but from per-feature disparities
    (the sparse ``stereo_bm_at`` path — the engine never needs the dense map)."""
    ok = valid & (disp > 0)
    safe_disp = jnp.where(ok, disp, 1.0)
    p_cam = cam.back_project(xy, safe_disp)             # [F, 3]
    c2w = camera_to_world_matrix(pose_cw)               # [4, 4]
    p_world = p_cam @ c2w[:3, :3].T + c2w[:3, 3]
    return jnp.where(ok[:, None], p_world, 0.0), ok
