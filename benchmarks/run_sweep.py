#!/usr/bin/env python
"""Benchmark sweep over KITTI sequences (BASELINE.md measurement plan).

    python benchmarks/run_sweep.py --kitti-root /data/kitti            # real data
    python benchmarks/run_sweep.py --synthetic --frames 97             # no dataset

Per sequence: frames/s (chunked replay, device-preloaded), keyframe count,
ATE (aligned + raw) vs ground truth, and optionally the OpenCV full-pipeline
twin's ATE/fps on the same frames (--twin). Results append to
``benchmarks/results.jsonl`` and print as a table.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# invoked as `python benchmarks/run_sweep.py`, sys.path gets benchmarks/,
# not the repo root where the package lives
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

KITTI_SEQUENCES = ["00", "03", "08", "09", "10", "13"]
SEQ_CONFIG = {"00": "kitti00", "03": "kitti03", "08": "kitti08",
              "09": "kitti09", "10": "kitti10", "13": "kitti13"}


def run_one(cfg, frames, gt, chunk, twin=False):
    from stereo_vo.engine.driver import run_vo
    from stereo_vo.eval.ate import absolute_trajectory_error

    run = run_vo(iter(frames), cfg, chunk_size=chunk, preload_device=True)
    kf = np.array([s["is_keyframe"] for s in run.frame_stats])
    row = {
        "frames": len(run.poses),
        "keyframes": int(kf.sum()),
        "frames_per_sec": round(run.frames_per_sec, 2),
    }
    if gt is not None and kf.sum() >= 3:
        gt_arr = np.asarray(gt)[: len(run.poses)]
        row["ate_kf_raw_m"] = round(
            absolute_trajectory_error(run.poses[kf], gt_arr[kf], align=False)["rmse"], 3
        )
        row["ate_kf_aligned_m"] = round(
            absolute_trajectory_error(run.poses[kf], gt_arr[kf], align=True)["rmse"], 3
        )
    if twin:
        from stereo_vo.eval.cv_twin import run_cv_twin

        poses_cv, stats_cv, dt = run_cv_twin(frames, cfg.camera, cfg.frontend)
        kf_cv = np.array([s["is_keyframe"] for s in stats_cv])
        # trajectory twin: in-domain minEig=1e-4 (OpenCV default) — its ATE is
        # the parity signal; fps baselines come from bench.measure_cpu_twin,
        # which keeps the reference-exact arguments (see eval/cv_twin.py)
        row["twin_policy"] = "trajectory(minEig=1e-4); fps not the baseline"
        row["twin_fps"] = round(len(frames) / dt, 2)
        if gt is not None and kf_cv.sum() >= 3:
            gt_arr = np.asarray(gt)[: len(poses_cv)]
            row["twin_ate_kf_raw_m"] = round(
                absolute_trajectory_error(poses_cv[kf_cv], gt_arr[kf_cv], align=False)[
                    "rmse"
                ], 3,
            )
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kitti-root", default=None)
    ap.add_argument("--sequences", nargs="*", default=KITTI_SEQUENCES)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--frames", type=int, default=None, help="cap frames per sequence")
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--twin", action="store_true", help="also run the OpenCV twin")
    ap.add_argument("--platform", default="auto")
    ap.add_argument("--out", default=os.path.join(os.path.dirname(__file__), "results.jsonl"))
    args = ap.parse_args()

    if args.platform != "auto":
        import jax

        jax.config.update("jax_platforms", args.platform)
    from stereo_vo.utils.cache import setup_compilation_cache

    setup_compilation_cache()

    from stereo_vo.core.config import load_config

    rows = []
    if args.synthetic or not args.kitti_root:
        from stereo_vo.data.synthetic import SyntheticStereoSequence

        n = args.frames or 97
        n = 1 + max(1, round((n - 1) / args.chunk)) * args.chunk
        for seed in range(3):
            cfg = load_config("kitti00")
            world = SyntheticStereoSequence(
                cam=cfg.camera, n_frames=n, shape=(376, 1241), n_points=4000,
                seed=seed, speed=0.8, yaw_rate=0.003,
            )
            frames = list(world)
            row = {"sequence": f"synthetic-{seed}"}
            row.update(run_one(cfg, frames, world.gt_poses, args.chunk, args.twin))
            rows.append(row)
            print(json.dumps(row), flush=True)
    else:
        from stereo_vo.data.kitti import KittiSequence

        for seq in args.sequences:
            cfg = load_config(SEQ_CONFIG.get(seq, "kitti00"))
            ds = KittiSequence(args.kitti_root, seq)
            n = len(ds) if args.frames is None else min(len(ds), args.frames)
            n = 1 + max(1, (n - 1) // args.chunk) * args.chunk
            frames = [ds[i] for i in range(min(n, len(ds)))]
            row = {"sequence": seq}
            row.update(run_one(cfg, frames, ds.gt_poses, args.chunk, args.twin))
            rows.append(row)
            print(json.dumps(row), flush=True)

    with open(args.out, "a") as f:
        stamp = time.strftime("%Y-%m-%d %H:%M:%S")
        for row in rows:
            f.write(json.dumps({"ts": stamp, **row}) + "\n")

    # summary table
    if rows:
        keys = [k for k in rows[0] if k != "sequence"]
        print("\n| sequence | " + " | ".join(keys) + " |")
        print("|" + "---|" * (len(keys) + 1))
        for row in rows:
            print("| " + row["sequence"] + " | "
                  + " | ".join(str(row.get(k, "-")) for k in keys) + " |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
