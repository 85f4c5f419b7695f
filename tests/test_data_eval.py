import os

import numpy as np
import pytest

from stereo_vo.core.camera import CameraInfo
from stereo_vo.data.kitti import KittiSequence, kitti_replay, parse_kitti_poses
from stereo_vo.data.stream import drop_gate, StereoFrame
from stereo_vo.data.synthetic import SyntheticStereoSequence
from stereo_vo.eval.ate import absolute_trajectory_error, relative_pose_error, umeyama_align
from stereo_vo.eval.trajectory import (
    load_kitti_trajectory,
    load_tum_trajectory,
    poses_to_positions,
    write_kitti_trajectory,
    write_tum_trajectory,
)

CAM = CameraInfo(focal=300.0, cx=160.0, cy=120.0, baseline=0.3)


@pytest.fixture(scope="module")
def world():
    return SyntheticStereoSequence(cam=CAM, n_frames=8, shape=(240, 320), n_points=200, seed=3)


def test_synthetic_renders_consistent_stereo(world):
    left, right = world.render(0)
    assert left.shape == (240, 320) and left.dtype == np.uint8
    u, v, disp, vis = world.projections(0)
    # pick a well-inside visible landmark and check the right image contains the
    # same patch shifted by its disparity
    ok = vis & (u > 40) & (u < 280) & (v > 40) & (v < 200) & (disp > 2)
    k = np.nonzero(ok)[0][0]
    iu, iv = int(round(u[k])), int(round(v[k]))
    patch_l = left[iv - 4 : iv + 5, iu - 4 : iu + 5].astype(np.float32)
    iur = int(round(u[k] - disp[k]))
    patch_r = right[iv - 4 : iv + 5, iur - 4 : iur + 5].astype(np.float32)
    # sub-pixel shift means not identical; correlation must still be high
    pl = patch_l - patch_l.mean()
    pr = patch_r - patch_r.mean()
    corr = (pl * pr).sum() / np.sqrt((pl ** 2).sum() * (pr ** 2).sum() + 1e-9)
    assert corr > 0.7


def test_synthetic_gt_projection_matches_camera_model(world):
    """projections() must agree with the framework camera/pose math."""
    import jax.numpy as jnp

    from stereo_vo.core import geometry as geo

    i = 3
    u, v, disp, vis = world.projections(i)
    pose = jnp.asarray(world.gt_poses[i])
    p_cam = geo.pose_apply(pose[None], jnp.asarray(world.points))
    uv = np.asarray(CAM.project(p_cam))
    np.testing.assert_allclose(uv[vis, 0], u[vis], atol=1e-2)
    np.testing.assert_allclose(uv[vis, 1], v[vis], atol=1e-2)


def test_synthetic_iteration(world):
    frames = list(world)
    assert len(frames) == 8
    assert frames[4].gt_pose is not None
    assert frames[4].stamp > frames[3].stamp


def test_drop_gate():
    frames = [StereoFrame(None, None, stamp=t, index=i) for i, t in
              enumerate([0.0, 0.01, 0.06, 0.08, 0.12])]
    kept = [f.stamp for f in drop_gate(frames, 0.05)]
    assert kept == [0.0, 0.06, 0.12]


@pytest.fixture(scope="module")
def fake_kitti(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("kitti")
    seq = root / "sequences" / "07"
    (seq / "image_0").mkdir(parents=True)
    (seq / "image_1").mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(5):
        img = rng.integers(0, 255, size=(60, 80), dtype=np.uint8)
        cv2.imwrite(str(seq / "image_0" / f"{i:06d}.png"), img)
        cv2.imwrite(str(seq / "image_1" / f"{i:06d}.png"), img)
    (root / "poses").mkdir()
    rows = []
    for i in range(5):
        m = np.hstack([np.eye(3), np.array([[0.1 * i], [0], [1.0 * i]])])
        rows.append(m.reshape(-1))
    np.savetxt(root / "poses" / "07.txt", np.stack(rows))
    return str(root)


def test_kitti_loader(fake_kitti):
    seq = KittiSequence(fake_kitti, "07")
    assert len(seq) == 5
    fr = seq[2]
    assert fr.left.shape == (60, 80)
    assert fr.gt_pose is not None
    # GT row i has camera at [0.1 i, 0, i]; T_cw translation = -R^T t = -t here
    np.testing.assert_allclose(fr.gt_pose[4:], [-0.2, 0, -2.0], atol=1e-6)


def test_kitti_replay_prefetch(fake_kitti):
    frames = list(kitti_replay(fake_kitti, "07", prefetch=2, max_frames=4))
    assert [f.index for f in frames] == [0, 1, 2, 3]


def test_umeyama_recovers_transform(rng):
    pts = rng.normal(size=(50, 3))
    import jax.numpy as jnp

    from stereo_vo.core import geometry as geo

    q = geo.quat_normalize(jnp.asarray(rng.normal(size=4), jnp.float32))
    r_true = np.asarray(geo.quat_to_rotmat(q))
    t_true = np.array([1.0, -2.0, 0.5])
    s_true = 1.7
    moved = s_true * (r_true @ pts.T).T + t_true
    r, t, s = umeyama_align(pts, moved, with_scale=True)
    np.testing.assert_allclose(r, r_true, atol=1e-6)
    np.testing.assert_allclose(t, t_true, atol=1e-6)
    assert s == pytest.approx(s_true, abs=1e-6)


def test_ate_zero_for_identical(world):
    ate = absolute_trajectory_error(world.gt_poses, world.gt_poses)
    assert ate["rmse"] < 1e-5
    rpe = relative_pose_error(world.gt_poses, world.gt_poses)
    assert rpe["rmse"] < 1e-5


def test_ate_detects_offset(world):
    pos = poses_to_positions(world.gt_poses)
    shifted = pos + np.array([0, 1.0, 0])
    ate_aligned = absolute_trajectory_error(shifted, pos, align=True)
    assert ate_aligned["rmse"] < 1e-5  # rigid offset removed by alignment
    ate_raw = absolute_trajectory_error(shifted, pos, align=False)
    assert ate_raw["rmse"] == pytest.approx(1.0, abs=1e-6)


def test_trajectory_roundtrip(tmp_path, world):
    poses = world.gt_poses
    kpath = str(tmp_path / "traj_kitti.txt")
    write_kitti_trajectory(kpath, poses)
    back = load_kitti_trajectory(kpath)
    np.testing.assert_allclose(
        poses_to_positions(back), poses_to_positions(poses), atol=1e-5
    )
    tpath = str(tmp_path / "traj_tum.txt")
    write_tum_trajectory(tpath, poses)
    back2 = load_tum_trajectory(tpath)
    np.testing.assert_allclose(
        poses_to_positions(back2), poses_to_positions(poses), atol=1e-5
    )
