"""End-to-end integration: full VO loop on the synthetic world
(SURVEY.md §4 "Integration" / §7.5 minimum slice)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest

from stereo_vo.core.camera import CameraInfo
from stereo_vo.core.config import BackendConfig, FrontendConfig, PipelineConfig
from stereo_vo.data.synthetic import SyntheticStereoSequence
from stereo_vo.engine import run_vo
from stereo_vo.engine.step import VOEngine
from stereo_vo.eval.ate import absolute_trajectory_error

CAM = CameraInfo(focal=400.0, cx=160.0, cy=120.0, baseline=0.5)


def small_config(**overrides):
    return PipelineConfig(
        camera=CAM,
        frontend=FrontendConfig(min_distance=12.0, parallax_thresh=10.0),
        backend=BackendConfig(
            feature_capacity=384, landmark_capacity=1024, max_lm_iters=8
        ),
        **overrides,
    )


@pytest.fixture(scope="module")
def world():
    return SyntheticStereoSequence(
        cam=CAM, n_frames=25, shape=(240, 320), n_points=500, seed=11,
        speed=0.35, yaw_rate=0.004, point_depth=(5.0, 18.0),
    )


def _kf_mask(run):
    return np.array([s["is_keyframe"] for s in run.frame_stats])


@pytest.fixture(scope="module")
def vo_run(world, tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("vo_out"))
    run = run_vo(world, small_config(), out_dir=out_dir, progress=False)
    return run, out_dir


def test_pipeline_tracks_trajectory(vo_run, world):
    run, _ = vo_run
    assert len(run.poses) == len(world)
    assert run.ate is not None
    # The published pose advances only on keyframes (the reference re-publishes
    # the last keyframe pose between them, vo_node.cpp:146-148) — evaluate at
    # keyframes against GT at those frames. ~8.4 m travelled.
    kf = _kf_mask(run)
    ate_kf = absolute_trajectory_error(run.poses[kf], world.gt_poses[kf], align=False)
    assert ate_kf["rmse"] < 0.5, f"keyframe ATE {ate_kf}"


def test_keyframes_and_tracking_health(vo_run):
    run, _ = vo_run
    kf = [s for s in run.frame_stats if s["is_keyframe"]]
    assert len(kf) >= 3  # gates actually fire over 25 frames
    assert all(s["pnp_ok"] for s in run.frame_stats)
    mid = run.frame_stats[len(run.frame_stats) // 2]
    assert mid["num_tracked"] > 20
    # BA reduces cost on keyframes where it runs
    for s in kf[1:]:
        if s["ba_iterations"] > 0:
            assert s["ba_final_cost"] <= s["ba_initial_cost"] + 1e-3


def test_outputs_written(vo_run):
    run, out_dir = vo_run
    assert os.path.exists(os.path.join(out_dir, "trajectory_kitti.txt"))
    assert os.path.exists(os.path.join(out_dir, "trajectory_tum.txt"))
    lines = open(os.path.join(out_dir, "metrics.jsonl")).read().strip().splitlines()
    assert len(lines) == len(run.poses)


def test_unaligned_drift_is_bounded(vo_run, world):
    """Scale comes from stereo, so even *unaligned* full-trajectory ATE —
    including the keyframe-hold lag between keyframes — stays bounded."""
    run, _ = vo_run
    ate_raw = absolute_trajectory_error(run.poses, world.gt_poses, align=False)
    assert ate_raw["rmse"] < 1.5, ate_raw


def test_checkpoint_resume_bitwise(world, tmp_path):
    """Resume from a mid-run checkpoint must reproduce the straight run's
    remaining trajectory (state pytree is complete)."""
    cfg = small_config()
    frames = list(world)[:12]

    out_a = str(tmp_path / "a")
    run_a = run_vo(iter(frames), cfg, out_dir=out_a, checkpoint_every=6)

    from stereo_vo.engine.checkpoint import load_state

    engine = VOEngine(cfg, frames[0].left.shape)
    state, next_idx = load_state(os.path.join(out_a, "checkpoint.npz"), engine)
    assert next_idx in (6, 12)

    # resume from the checkpoint over the tail frames
    run_b = run_vo(
        iter(frames), cfg, resume_from=os.path.join(out_a, "checkpoint.npz")
    )
    tail_a = run_a.poses[next_idx:]
    np.testing.assert_allclose(run_b.poses, tail_a, atol=1e-5)


def test_blank_images_degrade_gracefully(tmp_path):
    """Frames with nothing to detect must not crash or move the pose."""
    cfg = small_config()
    from stereo_vo.data.stream import StereoFrame

    blank = np.full((240, 320), 77, np.uint8)
    frames = [
        StereoFrame(left=blank, right=blank, stamp=i / 11.0, index=i)
        for i in range(3)
    ]
    run = run_vo(iter(frames), cfg)
    assert len(run.poses) == 3
    np.testing.assert_allclose(run.poses[-1], [1, 0, 0, 0, 0, 0, 0], atol=1e-6)
    assert all(not s["is_keyframe"] for s in run.frame_stats)


def test_chunked_replay_matches_streaming(world):
    """Offline chunked replay (lax.scan) must produce the same trajectory as
    per-frame streaming calls."""
    cfg = small_config()
    frames = list(world)[:13]
    run_stream = run_vo(iter(frames), cfg)
    run_chunk = run_vo(iter(frames), cfg, chunk_size=4)
    assert len(run_chunk.poses) == len(run_stream.poses)
    np.testing.assert_allclose(run_chunk.poses, run_stream.poses, atol=1e-5)
    kf_a = [s["is_keyframe"] for s in run_stream.frame_stats]
    kf_b = [s["is_keyframe"] for s in run_chunk.frame_stats]
    assert kf_a == kf_b


def test_preload_survives_late_bootstrap(world):
    """Device-preloaded replay must hit HBM for every chunk even when
    bootstrap happens late (dark lead-in frames: the reference just retries
    detection on the next frame, image_processor.cpp:23-25). Round 3 keyed
    preloaded chunks on the first-frame index, so a late bootstrap silently
    re-uploaded every chunk from the host (VERDICT r3 item 8)."""
    from stereo_vo.data.stream import StereoFrame

    cfg = small_config()
    good = list(world)[:17]
    dark = [
        StereoFrame(
            left=np.zeros((240, 320), np.uint8),
            right=np.zeros((240, 320), np.uint8),
            stamp=i / 11.0, index=i,
        )
        for i in range(3)
    ]
    frames = dark + [
        dataclasses.replace(f, index=i + 3, stamp=(i + 3) / 11.0)
        for i, f in enumerate(good)
    ]
    run = run_vo(iter(frames), cfg, chunk_size=4, preload_device=True)
    assert run.preload_misses == 0
    assert len(run.poses) == len(frames)
    # first keyframe is the late bootstrap, not frame 0
    kf = _kf_mask(run)
    assert not kf[:3].any() and kf[3]
    assert np.isfinite(run.poses).all()
    # trajectory identical to the non-preloaded chunked run on the same frames
    run_ref = run_vo(iter(frames), cfg, chunk_size=4)
    np.testing.assert_allclose(run.poses, run_ref.poses, atol=1e-5)
