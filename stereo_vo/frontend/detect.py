"""Detection wrapper + spatial dedup against tracked features.

``detect_features`` adapts the Shi-Tomasi kernel to the pipeline's fixed
feature capacity; ``dedup_new_features`` is the vectorized version of the
reference's O(N*M) loop discarding detections within ``min_distance`` of a
tracked inlier (``image_processor.cpp:113-128``).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from stereo_vo.core.config import FrontendConfig
from stereo_vo.ops.shi_tomasi import detect_corners


def detect_features(
    img: jnp.ndarray, cfg: FrontendConfig, resp: jnp.ndarray = None
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Detect up to ``cfg.max_detect`` corners; returns ``(xy [D, 2], valid [D])``.

    ``resp``: optional precomputed Shi-Tomasi response (the engine shares the
    every-frame gate's structure tensor with this keyframe-branch call)."""
    xy, _, valid = detect_corners(
        img,
        max_corners=cfg.max_detect,
        quality_level=cfg.quality_level,
        min_distance=cfg.min_distance,
        block_size=cfg.detect_block_size,
        resp=resp,
    )
    return xy, valid


def dedup_new_features(
    new_xy: jnp.ndarray,
    new_valid: jnp.ndarray,
    tracked_xy: jnp.ndarray,
    tracked_valid: jnp.ndarray,
    min_distance: float,
) -> jnp.ndarray:
    """Drop new detections within ``min_distance`` of any valid tracked feature.

    Returns the updated validity mask for ``new_xy``.
    """
    d2 = jnp.sum(
        (new_xy[:, None, :] - tracked_xy[None, :, :]) ** 2, axis=-1
    )  # [D, F]
    close = (d2 < min_distance * min_distance) & tracked_valid[None, :]
    return new_valid & ~jnp.any(close, axis=1)
