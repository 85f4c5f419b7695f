"""benchmarks/run_sweep.py actually runs (VERDICT r3 item 5).

The sweep is the tool that will produce the real-KITTI parity table the day a
dataset exists (reference validation loop, ``src/kitti_node.cpp:46-76``);
until round 4 its only evidence of working was that it parses. This drives
``run_one`` — the full per-sequence measurement (chunked replay + ATE + the
OpenCV twin) — on a small synthetic world.
"""

import importlib.util
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_run_sweep():
    spec = importlib.util.spec_from_file_location(
        "run_sweep", os.path.join(ROOT, "benchmarks", "run_sweep.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_run_one_synthetic_world():
    from stereo_vo.core.camera import CameraInfo
    from stereo_vo.core.config import (
        BackendConfig,
        FrontendConfig,
        PipelineConfig,
    )
    from stereo_vo.data.synthetic import SyntheticStereoSequence

    rs = _load_run_sweep()
    cam = CameraInfo(focal=400.0, cx=160.0, cy=120.0, baseline=0.5)
    cfg = PipelineConfig(
        camera=cam,
        frontend=FrontendConfig(min_distance=12.0, parallax_thresh=10.0),
        backend=BackendConfig(
            feature_capacity=384, landmark_capacity=1024, max_lm_iters=8
        ),
    )
    world = SyntheticStereoSequence(
        cam=cam, n_frames=17, shape=(240, 320), n_points=500, seed=11,
        speed=0.35, yaw_rate=0.004, point_depth=(5.0, 18.0),
    )
    frames = list(world)
    row = rs.run_one(cfg, frames, world.gt_poses, chunk=8, twin=True)
    assert row["frames"] == 17
    assert row["keyframes"] >= 2
    assert row["frames_per_sec"] > 0
    assert np.isfinite(row["ate_kf_aligned_m"]) and row["ate_kf_aligned_m"] < 2.0
    # twin leg ran on the same frames
    assert row["twin_fps"] > 0
    assert "twin_ate_kf_raw_m" in row
