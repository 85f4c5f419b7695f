import numpy as np
import pytest

from stereo_vo.core.camera import CameraInfo
from stereo_vo.core.config import FrontendConfig
from stereo_vo.data.synthetic import SyntheticStereoSequence
from stereo_vo.eval.ate import absolute_trajectory_error
from stereo_vo.utils import StageTimer


def test_cv_twin_tracks_synthetic():
    cv2 = pytest.importorskip("cv2")
    from stereo_vo.eval.cv_twin import run_cv_twin

    cam = CameraInfo(focal=400.0, cx=160.0, cy=120.0, baseline=0.5)
    world = SyntheticStereoSequence(
        cam=cam, n_frames=20, shape=(240, 320), n_points=500, seed=11,
        speed=0.35, yaw_rate=0.004, point_depth=(5.0, 18.0),
    )
    poses, stats, dt = run_cv_twin(list(world), cam,
                                   FrontendConfig(min_distance=12.0,
                                                  parallax_thresh=10.0))
    kf = np.array([s["is_keyframe"] for s in stats])
    assert kf.sum() >= 3
    ate = absolute_trajectory_error(poses[kf], world.gt_poses[kf], align=False)
    assert ate["rmse"] < 0.5, ate


def test_stage_timer():
    t = StageTimer()
    with t.stage("a"):
        pass
    with t.stage("a"):
        pass
    with t.stage("b"):
        pass
    s = t.summary()
    assert s["a"]["count"] == 2 and s["b"]["count"] == 1
