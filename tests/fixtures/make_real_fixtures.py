#!/usr/bin/env python
"""Generate the checked-in real-imagery stereo fixtures.

Renders a short KITTI-resolution (376x1241) stereo sequence whose background
texture is a real photograph — the public-domain Grace Hopper portrait shipped
with matplotlib (a US government work) — through the geometrically exact
synthetic renderer. The frames therefore have *natural image statistics*
(real gradients, textures, lighting structure) with exact ground-truth poses
and disparities, which is what the real-image readiness tests need: they
exercise the native PNG decoder, detection, LK and StereoBM on photographic
content, not band-limited noise (reference validation loop:
``/root/reference/README.md:6-8``, ``src/kitti_node.cpp:56-76``).

Run from the repo root: ``python tests/fixtures/make_real_fixtures.py``.
Deterministic: re-running reproduces the committed PNGs bit-for-bit.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

N_FRAMES = 5
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "real")


def load_photo() -> np.ndarray:
    from stereo_vo.data.synthetic import load_sample_photo

    photo = load_sample_photo()
    assert photo is not None, "matplotlib sample data missing"
    return photo


def main():
    from stereo_vo.core.config import load_config
    from stereo_vo.data.synthetic import SyntheticStereoSequence

    cfg = load_config("kitti00")
    world = SyntheticStereoSequence(
        cam=cfg.camera, n_frames=N_FRAMES, shape=(376, 1241), n_points=1500,
        seed=7, speed=0.9, yaw_rate=0.004, texture=load_photo(),
    )

    from PIL import Image

    for sub in ("image_0", "image_1"):
        os.makedirs(os.path.join(OUT, sub), exist_ok=True)
    rows = []
    for i, fr in enumerate(world):
        Image.fromarray(fr.left).save(
            os.path.join(OUT, "image_0", f"{i:06d}.png"), compress_level=2)
        Image.fromarray(fr.right).save(
            os.path.join(OUT, "image_1", f"{i:06d}.png"), compress_level=2)
        # KITTI GT format: 3x4 row-major T_wc
        from stereo_vo.core import geometry as geo
        import jax.numpy as jnp

        t_wc = np.asarray(geo.pose_to_matrix(geo.pose_inverse(jnp.asarray(fr.gt_pose))))
        rows.append(" ".join(f"{v:.9e}" for v in t_wc[:3].reshape(-1)))
    with open(os.path.join(OUT, "real.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")
    print(f"wrote {N_FRAMES} stereo pairs + poses to {OUT}")


if __name__ == "__main__":
    main()
