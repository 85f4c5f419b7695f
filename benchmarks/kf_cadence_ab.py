#!/usr/bin/env python
"""A/B the keyframe cadence + fps impact of a config override on the bench world.

Diagnosis tool for couplings the stage probes can't see: a tracking change
that shifts feature survival moves the keyframe gate (parallax/lost,
image_processor.cpp:63-65), and keyframe-branch work (PnP + BM + BA) can
dwarf any per-frame LK saving. Prints kf count, fps, ATE for each arm on
identical frames.

Usage: python benchmarks/kf_cadence_ab.py --frames 129 \
           --ab frontend.lk_hint_pred_err_px=0
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from accuracy_sweep import deep_merge, parse_override  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=129)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--photo", action="store_true")
    ap.add_argument("--ab", action="append", default=[])
    ap.add_argument("--base", action="append", default=[])
    args = ap.parse_args()

    from stereo_vo.utils.cache import setup_compilation_cache

    setup_compilation_cache()

    import numpy as np

    from stereo_vo.core.config import load_config
    from stereo_vo.data.synthetic import SyntheticStereoSequence
    from stereo_vo.engine.driver import run_vo
    from stereo_vo.eval.ate import absolute_trajectory_error

    base_over: dict = {}
    for s in args.base:
        base_over = deep_merge(base_over, parse_override(s))
    ab_over = dict(base_over)
    for s in args.ab:
        ab_over = deep_merge(ab_over, parse_override(s))

    cfg_a = load_config("kitti00", overrides=base_over or None)
    cfg_b = load_config("kitti00", overrides=ab_over) if args.ab else None

    tex = None
    if args.photo:
        sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tests", "fixtures"))
        from make_real_fixtures import load_photo

        tex = load_photo()

    # frame count -> bootstrap + whole chunks (bench.py convention)
    n_frames = 1 + max(2, round((args.frames - 1) / args.chunk)) * args.chunk

    for seed in range(args.seeds):
        world = SyntheticStereoSequence(
            cam=cfg_a.camera, n_frames=n_frames, shape=(376, 1241),
            n_points=4000, seed=seed, speed=0.8, yaw_rate=0.003, texture=tex,
        )
        frames = list(world)
        gt = world.gt_poses

        def run_arm(tag, cfg):
            run = run_vo(iter(frames), cfg, chunk_size=args.chunk,
                         preload_device=True)
            g = gt[: len(run.poses)]
            ate = absolute_trajectory_error(run.poses, g)["rmse"]
            kf = sum(1 for s_ in run.frame_stats if s_["is_keyframe"])
            print(json.dumps({
                "seed": seed, "arm": tag, "fps": round(run.frames_per_sec, 1),
                "keyframes": kf, "kf_ratio": round(kf / len(run.poses), 3),
                "ate_all_m": round(float(ate), 3),
                "mean_tracked": round(float(np.mean(
                    [s_["num_tracked"] for s_ in run.frame_stats])), 1),
            }), flush=True)

        run_arm("A", cfg_a)
        if cfg_b is not None:
            run_arm("B", cfg_b)


if __name__ == "__main__":
    main()
