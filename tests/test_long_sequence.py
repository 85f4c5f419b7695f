"""Long-horizon drift vs the OpenCV twin on natural-texture imagery.

The reference's validation story is replaying full KITTI sequences and judging
the trajectory (``/root/reference/src/kitti_node.cpp:46-76``). No KITTI data
exists in this environment, so this is the stand-in: a photo-textured
KITTI-resolution sequence long enough to cycle the 5-keyframe window dozens of
times (~60+ keyframes over 160 frames), with our full pipeline and the OpenCV
full-pipeline twin (``stereo_vo/eval/cv_twin.py``) replaying *identical
frames* and judged by ATE against exact ground truth.

Generated in-test (no repo bloat) from the same machinery as the checked-in
5-frame fixtures (``tests/fixtures/make_real_fixtures.py``).

Single-sequence keyframe cascades amplify sub-pixel differences (NOTES.md:
single-run ATE swings ~2x across equal-quality builds), so the gate is the
mean ratio over two seeds with a generous per-seed cap.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "fixtures"))

N_FRAMES = 161
SEEDS = (11, 23)


def _make_frames(cfg, seed):
    from make_real_fixtures import load_photo

    from stereo_vo.data.synthetic import SyntheticStereoSequence

    world = SyntheticStereoSequence(
        cam=cfg.camera, n_frames=N_FRAMES, shape=(376, 1241), n_points=3000,
        seed=seed, speed=0.9, yaw_rate=0.004, texture=load_photo(),
    )
    return world, list(world)


def test_long_sequence_drift_vs_twin():
    pytest.importorskip("cv2")
    from stereo_vo.core.config import load_config
    from stereo_vo.engine.driver import run_vo
    from stereo_vo.eval.ate import absolute_trajectory_error
    from stereo_vo.eval.cv_twin import run_cv_twin

    cfg = load_config("kitti00")
    ratios = []
    for seed in SEEDS:
        world, frames = _make_frames(cfg, seed)
        run = run_vo(iter(frames), cfg, chunk_size=32)
        gt = world.gt_poses[: len(run.poses)]
        ours = absolute_trajectory_error(run.poses, gt)["rmse"]

        kf = sum(1 for s in run.frame_stats if s["is_keyframe"])
        assert kf >= 30, f"window never cycled: {kf} keyframes in {N_FRAMES}"
        assert all(np.isfinite(np.asarray(run.poses)).reshape(-1))

        tp, _, _ = run_cv_twin(iter(frames), cfg.camera, cfg.frontend)
        twin = absolute_trajectory_error(tp[: len(gt)], gt[: len(tp)])["rmse"]
        ratios.append(ours / twin)
        # generous per-seed cap — catches collapse, tolerates cascade noise
        assert ratios[-1] <= 1.5, (
            f"seed {seed}: drift {ours:.2f} m vs twin {twin:.2f} m "
            f"(ratio {ratios[-1]:.2f})"
        )

    mean_ratio = float(np.mean(ratios))
    assert mean_ratio <= 1.1, (
        f"long-horizon drift {mean_ratio:.2f}x the OpenCV twin "
        f"(per-seed: {[round(r, 3) for r in ratios]})"
    )
