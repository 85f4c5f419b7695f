"""Gaussian image pyramids (cv::pyrDown-compatible)."""

from __future__ import annotations

from typing import List

import jax.numpy as jnp

from stereo_vo.ops.filters import sep_filter

_G5 = [1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16]


def pyr_down(img: jnp.ndarray) -> jnp.ndarray:
    """5x5 Gaussian blur then even-index decimation (OpenCV pyrDown).

    Decimation via pad + reshape (no strided slice).
    """
    blurred = sep_filter(img, _G5, _G5, mode="reflect")
    h, w = blurred.shape[-2:]
    ho, wo = (h + 1) // 2, (w + 1) // 2
    pad = [(0, 0)] * (blurred.ndim - 2) + [(0, 2 * ho - h), (0, 2 * wo - w)]
    p = jnp.pad(blurred, pad)
    p = p.reshape(p.shape[:-2] + (ho, 2, wo, 2))
    return p[..., :, 0, :, 0]


def build_pyramid(img: jnp.ndarray, max_level: int) -> List[jnp.ndarray]:
    """Levels ``0..max_level`` (level 0 is the input), float32."""
    levels = [img.astype(jnp.float32)]
    for _ in range(max_level):
        levels.append(pyr_down(levels[-1]))
    return levels
