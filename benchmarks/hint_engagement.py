#!/usr/bin/env python
"""Measure how often the flow-hinted short-pyramid LK path engages.

Streams frames one at a time (state on host between steps) and reads
``tracker.pred_err`` — the gate for the next frame's hinted pass
(frontend/track.py). Engagement fraction bounds the achievable average LK
cost: a hinted pass runs 2 pyramid levels instead of 4.

Usage: python benchmarks/hint_engagement.py [--frames 96]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--photo", action="store_true")
    args = ap.parse_args()

    from stereo_vo.utils.cache import setup_compilation_cache

    setup_compilation_cache()

    import jax.numpy as jnp
    import numpy as np

    from stereo_vo.core.config import load_config
    from stereo_vo.data.synthetic import SyntheticStereoSequence
    from stereo_vo.engine.step import VOEngine

    cfg = load_config("kitti00")
    tex = None
    if args.photo:
        sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tests", "fixtures"))
        from make_real_fixtures import load_photo

        tex = load_photo()
    world = SyntheticStereoSequence(
        cam=cfg.camera, n_frames=args.frames + 1, shape=(376, 1241),
        n_points=4000, seed=0, speed=0.8, yaw_rate=0.003, texture=tex,
    )
    frames = list(world)
    engine = VOEngine(cfg, frames[0].left.shape)
    state = engine.init_state()
    state, _ = engine.bootstrap(
        state, jnp.asarray(frames[0].left), jnp.asarray(frames[0].right)
    )

    thresh = cfg.frontend.lk_hint_pred_err_px
    engaged = []   # whether THIS step ran hinted (gate from prev step's state)
    kf = []
    perr_prev = float(np.asarray(state.tracker.pred_err))
    for f in frames[1:]:
        engaged.append(perr_prev < thresh)
        state, out = engine.step(
            state, jnp.asarray(f.left), jnp.asarray(f.right)
        )
        perr_prev = float(np.asarray(state.tracker.pred_err))
        kf.append(bool(np.asarray(out.is_keyframe)))

    engaged = np.array(engaged)
    kf = np.array(kf)
    n = len(engaged)
    print(f"frames={n} keyframes={kf.sum()} ({kf.mean():.1%})")
    print(f"hinted: {engaged.mean():.1%} overall | "
          f"{engaged[kf].mean() if kf.any() else float('nan'):.1%} on keyframes | "
          f"{engaged[~kf].mean() if (~kf).any() else float('nan'):.1%} on cruise")
    # where does the full pyramid run? after which events?
    full_idx = np.nonzero(~engaged)[0]
    after_kf = sum(1 for i in full_idx if i > 0 and kf[i - 1])
    print(f"full-pyramid frames: {len(full_idx)}; "
          f"{after_kf} immediately follow a keyframe")


if __name__ == "__main__":
    main()
