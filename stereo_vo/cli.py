"""Command-line entry point (the ``roslaunch``/``rosrun`` replacement, C1/C9).

    svo run --config kitti00 --kitti-root /data/kitti --sequence 00 --out out/
    svo run --config kitti00 --synthetic 100 --out out/
    svo eval --est out/trajectory_kitti.txt --gt poses/00.txt
    svo configs
"""

from __future__ import annotations

import argparse
import json
import sys


def _apply_platform(platform: str) -> None:
    """Select or check the JAX platform before any computation.

    ``cpu`` restricts JAX to the CPU (in a fresh process). ``gpu`` keeps every
    backend JAX has up (callers may hold CPU arrays too) and fails unless the
    default device is a GPU. ``auto`` takes whatever JAX picks.
    """
    if platform == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")
    elif platform == "gpu":
        from stereo_vo.utils.device import NoGPUError, require_gpu

        try:
            require_gpu()
        except NoGPUError as e:
            raise SystemExit(f"error: --platform gpu: {e}")


def _cmd_run(args) -> int:
    _apply_platform(args.platform)
    from stereo_vo.utils.cache import setup_compilation_cache

    setup_compilation_cache()
    from stereo_vo.core.config import load_config
    from stereo_vo.engine import run_vo

    cfg = load_config(args.config)

    if args.synthetic:
        from stereo_vo.data.synthetic import kitti_like_sequence

        # KITTI-sized synthetic frames under the selected camera's intrinsics
        stream = kitti_like_sequence(
            cfg.camera, args.synthetic, shape=args.synthetic_shape,
            n_points=args.synthetic_points, seed=args.seed,
        )
    else:
        if not args.kitti_root:
            print("error: --kitti-root or --synthetic required", file=sys.stderr)
            return 2
        from stereo_vo.data.kitti import kitti_replay

        stream = kitti_replay(
            args.kitti_root, args.sequence, rate_hz=cfg.frame_rate,
            max_frames=args.max_frames,
        )

    run = run_vo(
        stream,
        cfg,
        out_dir=args.out,
        max_frames=args.max_frames,
        checkpoint_every=args.checkpoint_every,
        resume_from=args.resume,
        chunk_size=args.chunk_size,
        save_track_images=args.save_track_images,
        save_world_points=args.save_world_points,
        progress=not args.quiet,
    )

    summary = {
        "frames": len(run.poses),
        "frames_per_sec": round(run.frames_per_sec, 3),
        "keyframes": sum(1 for s in run.frame_stats if s["is_keyframe"]),
        "ate": run.ate,
    }
    print(json.dumps(summary))

    if args.out and args.plot:
        from stereo_vo.eval.trajectory import poses_to_positions
        from stereo_vo.eval.viz import plot_trajectory

        import os

        plot_trajectory(
            poses_to_positions(run.poses),
            poses_to_positions(run.gt_poses) if run.gt_poses is not None else None,
            out_path=os.path.join(args.out, "trajectory.png"),
        )
    return 0


def _cmd_eval(args) -> int:
    import numpy as np

    from stereo_vo.eval.ate import absolute_trajectory_error, relative_pose_error
    from stereo_vo.eval.trajectory import load_kitti_trajectory, load_tum_trajectory

    def load(path):
        probe = open(path).readline().split()
        return load_kitti_trajectory(path) if len(probe) == 12 else load_tum_trajectory(path)

    est = load(args.est)
    gt = load(args.gt)
    out = {
        "ate": absolute_trajectory_error(est, gt, align=not args.no_align),
        "rpe_1": relative_pose_error(est, gt, delta=1),
    }
    print(json.dumps(out))
    return 0


def _cmd_configs(_args) -> int:
    from stereo_vo.core.config import available_configs

    print("\n".join(sorted(available_configs())))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="svo", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="replay a sequence through the VO pipeline")
    pr.add_argument("--config", required=True, help="camera config name or path")
    pr.add_argument("--platform", default="auto", choices=["auto", "cpu", "gpu"],
                    help="JAX platform (auto = whatever the environment provides)")
    pr.add_argument("--kitti-root", default=None)
    pr.add_argument("--sequence", default="00")
    pr.add_argument("--synthetic", type=int, default=0, metavar="N",
                    help="use an N-frame synthetic world instead of a dataset")
    pr.add_argument("--synthetic-shape", type=int, nargs=2, default=(376, 1241))
    pr.add_argument("--synthetic-points", type=int, default=4000)
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--out", default=None)
    pr.add_argument("--max-frames", type=int, default=None)
    pr.add_argument("--checkpoint-every", type=int, default=0)
    pr.add_argument("--chunk-size", type=int, default=0,
                    help="offline fast path: frames per device program (0 = streaming)")
    pr.add_argument("--save-track-images", type=int, default=0, metavar="N",
                    help="write a feature-track debug image every N frames")
    pr.add_argument("--save-world-points", action="store_true",
                    help="dump the live landmark table per keyframe "
                         "(the reference's /vo/features debug output)")
    pr.add_argument("--resume", default=None, help="checkpoint file to resume from")
    pr.add_argument("--plot", action="store_true")
    pr.add_argument("--quiet", action="store_true")
    pr.set_defaults(fn=_cmd_run)

    pe = sub.add_parser("eval", help="ATE/RPE between two trajectory files")
    pe.add_argument("--est", required=True)
    pe.add_argument("--gt", required=True)
    pe.add_argument("--no-align", action="store_true")
    pe.set_defaults(fn=_cmd_eval)

    pc = sub.add_parser("configs", help="list bundled camera configs")
    pc.set_defaults(fn=_cmd_configs)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
