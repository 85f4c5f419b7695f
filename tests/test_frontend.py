import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereo_vo.core.camera import CameraInfo
from stereo_vo.core.config import FrontendConfig
from stereo_vo.core import geometry as geo
from stereo_vo.data.synthetic import SyntheticStereoSequence
from stereo_vo.frontend.detect import dedup_new_features, detect_features
from stereo_vo.frontend.pnp import pnp_ransac
from stereo_vo.frontend.track import TrackerState, track_step, tracker_init
from stereo_vo.frontend.triangulate import triangulate_features
from stereo_vo.ops.pyramid import build_pyramid
from stereo_vo.ops.stereo_bm import stereo_bm_disparity

CAM = CameraInfo(focal=300.0, cx=160.0, cy=120.0, baseline=0.3)
CFG = FrontendConfig()


def _random_pose(rng, scale_rot=0.2, scale_t=1.0):
    q = geo.quat_exp(jnp.asarray(rng.normal(size=3) * scale_rot, jnp.float32))
    t = jnp.asarray(rng.normal(size=3) * scale_t, jnp.float32)
    return geo.make_pose(q, t)


def _pnp_problem(rng, f_cap=128, n=80, noise=0.0, outlier_frac=0.0):
    pose_gt = _random_pose(rng, 0.1, 0.3)
    p3 = np.concatenate(
        [rng.uniform(-5, 5, (n, 2)), rng.uniform(8, 25, (n, 1))], axis=1
    ).astype(np.float32)
    # points are in front of a camera near identity; move them to world frame
    p3_world = np.asarray(geo.pose_apply(geo.pose_inverse(pose_gt)[None], jnp.asarray(p3)))
    uv = np.array(CAM.project(jnp.asarray(p3)))
    uv += rng.normal(size=uv.shape).astype(np.float32) * noise
    n_out = int(n * outlier_frac)
    if n_out:
        idx = rng.choice(n, n_out, replace=False)
        uv[idx] += rng.uniform(30, 80, size=(n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    p3_pad = np.zeros((f_cap, 3), np.float32)
    uv_pad = np.zeros((f_cap, 2), np.float32)
    p3_pad[:n] = p3_world
    uv_pad[:n] = uv
    valid = np.zeros(f_cap, bool)
    valid[:n] = True
    return pose_gt, jnp.asarray(p3_pad), jnp.asarray(uv_pad), jnp.asarray(valid)


def _pose_err(pose, pose_gt):
    t_err = float(jnp.linalg.norm(pose[4:] - pose_gt[4:]))
    q = geo.quat_normalize(pose[:4])
    qg = geo.quat_normalize(pose_gt[:4])
    ang = float(
        2 * np.arccos(np.clip(abs(float(jnp.sum(q * qg))), 0, 1))
    )
    return t_err, ang


class TestPnP:
    def test_exact_correspondences(self, rng):
        pose_gt, p3, uv, valid = _pnp_problem(rng)
        res = jax.jit(
            lambda a, b, c, d, e: pnp_ransac(a, b, c, CAM, d, e, CFG)
        )(p3, uv, valid, geo.pose_identity(), jnp.array(0, jnp.uint32))
        t_err, ang = _pose_err(res.pose, pose_gt)
        assert bool(res.ok)
        assert t_err < 1e-2 and ang < 1e-3
        assert int(res.num_inliers) >= 78

    def test_with_outliers(self, rng):
        pose_gt, p3, uv, valid = _pnp_problem(rng, noise=0.3, outlier_frac=0.3)
        res = pnp_ransac(p3, uv, valid, CAM, geo.pose_identity(),
                         jnp.array(7, jnp.uint32), CFG)
        t_err, ang = _pose_err(res.pose, pose_gt)
        assert bool(res.ok)
        assert t_err < 0.05 and ang < 0.01
        # outliers rejected
        assert int(res.num_inliers) <= 60

    def test_warm_start_dominates_when_good(self, rng):
        """With the previous pose exact, hypothesis 0 already wins (the
        reference's useExtrinsicGuess warm start)."""
        pose_gt, p3, uv, valid = _pnp_problem(rng, noise=0.2)
        res = pnp_ransac(p3, uv, valid, CAM, pose_gt, jnp.array(3, jnp.uint32), CFG)
        t_err, ang = _pose_err(res.pose, pose_gt)
        assert t_err < 0.02 and ang < 0.005

    def test_matches_opencv(self, rng):
        cv2 = pytest.importorskip("cv2")
        pose_gt, p3, uv, valid = _pnp_problem(rng, noise=0.3, outlier_frac=0.2)
        res = pnp_ransac(p3, uv, valid, CAM, geo.pose_identity(),
                         jnp.array(11, jnp.uint32), CFG)
        n = int(np.sum(np.asarray(valid)))
        k = np.array([[300.0, 0, 160], [0, 300, 120], [0, 0, 1]])
        ok_cv, rvec, tvec, inl = cv2.solvePnPRansac(
            np.asarray(p3[:n], np.float64),
            np.asarray(uv[:n], np.float64).reshape(-1, 1, 2),
            k, np.zeros(4), iterationsCount=100, reprojectionError=8.0,
            confidence=0.99,
        )
        assert ok_cv
        q_cv = geo.axis_angle_to_quat(jnp.asarray(rvec.ravel(), jnp.float32))
        pose_cv = geo.make_pose(q_cv, jnp.asarray(tvec.ravel(), jnp.float32))
        t_cv, a_cv = _pose_err(pose_cv, pose_gt)
        t_us, a_us = _pose_err(res.pose, pose_gt)
        # both near GT; ours within 2x of OpenCV's error (plus small floor)
        assert t_us < max(2 * t_cv, 0.03)
        assert a_us < max(2 * a_cv, 0.01)

    def test_deterministic(self, rng):
        _, p3, uv, valid = _pnp_problem(rng, noise=0.5, outlier_frac=0.2)
        r1 = pnp_ransac(p3, uv, valid, CAM, geo.pose_identity(), jnp.array(5, jnp.uint32), CFG)
        r2 = pnp_ransac(p3, uv, valid, CAM, geo.pose_identity(), jnp.array(5, jnp.uint32), CFG)
        np.testing.assert_array_equal(np.asarray(r1.pose), np.asarray(r2.pose))

    def test_degenerate_too_few_points(self, rng):
        p3 = jnp.zeros((64, 3))
        uv = jnp.zeros((64, 2))
        valid = jnp.zeros(64, bool).at[:3].set(True)
        res = pnp_ransac(p3, uv, valid, CAM, geo.pose_identity(), jnp.array(1, jnp.uint32), CFG)
        assert not bool(res.ok)
        assert bool(jnp.all(jnp.isfinite(res.pose)))


class TestTriangulate:
    def test_ground_truth_geometry(self):
        world = SyntheticStereoSequence(cam=CAM, n_frames=2, shape=(240, 320),
                                        n_points=150, seed=5)
        left, right = world.render(0)
        disp = stereo_bm_disparity(jnp.asarray(left), jnp.asarray(right))
        u, v, d_gt, vis = world.projections(0)
        # only points with adequate stereo conditioning (disparity >= 3 px;
        # depth error scales as z^2/(f b) so far points are legitimately noisy)
        sel = vis & (u > 70) & (u < 310) & (v > 12) & (v < 228) & (d_gt >= 4.5)
        f_cap = 256
        xy = np.zeros((f_cap, 2), np.float32)
        n = sel.sum()
        xy[:n] = np.stack([u[sel], v[sel]], 1)
        valid = np.arange(f_cap) < n
        pose0 = jnp.asarray(world.gt_poses[0])
        p3, ok = triangulate_features(
            disp, jnp.asarray(xy), jnp.asarray(valid), CAM, pose0
        )
        p3, ok = np.asarray(p3), np.asarray(ok)
        assert ok.sum() > 0.5 * n
        gt_pts = world.points[sel]
        err = np.linalg.norm(p3[:n][ok[:n]] - gt_pts[ok[:n]], axis=1)
        # depth error scales with z^2/(f b) * disp_err; median sub-30cm is
        # consistent with ~0.3 px disparity noise at these depths
        assert np.median(err) < 0.5

    def test_invalid_disparity_masked(self):
        disp = jnp.full((50, 50), -1.0)
        xy = jnp.asarray([[25.0, 25.0]])
        p3, ok = triangulate_features(disp, xy, jnp.asarray([True]), CAM,
                                      geo.pose_identity())
        assert not bool(ok[0])


class TestTracker:
    def test_track_and_stats(self, rng):
        world = SyntheticStereoSequence(cam=CAM, n_frames=3, shape=(240, 320),
                                        n_points=150, seed=5)
        l0, _ = world.render(0)
        l1, _ = world.render(1)
        u0, v0, _, vis0 = world.projections(0)
        sel = vis0 & (u0 > 30) & (u0 < 290) & (v0 > 30) & (v0 < 210)
        f_cap = 128
        n = min(int(sel.sum()), f_cap)
        xy = np.zeros((f_cap, 2), np.float32)
        xy[:n] = np.stack([u0[sel], v0[sel]], 1)[:n]
        valid = np.arange(f_cap) < n
        p0 = build_pyramid(jnp.asarray(l0, jnp.float32), 3)
        p1 = build_pyramid(jnp.asarray(l1, jnp.float32), 3)
        st = tracker_init(p0, jnp.asarray(xy), jnp.arange(f_cap, dtype=jnp.int32),
                          jnp.asarray(valid))
        st2, stats = track_step(st, p1, CFG)
        assert int(stats.num_tracked) > 0.5 * n
        assert float(stats.percent_lost) < 0.5
        assert 0.0 < float(stats.av_parallax) < 20.0
        # identity track: same image -> ~zero parallax, nothing lost
        st3, stats3 = track_step(st, p0, CFG)
        assert float(stats3.av_parallax) < 0.1
        assert float(stats3.percent_lost) < 0.2

    def test_flow_hint_parity_and_safety(self, rng):
        """Flow-hinted short-pyramid tracking (config.lk_hint_pred_err_px):
        (a) with accurate hints the 2-level hinted pass matches the full
        pyramid; (b) the full-pyramid pass measures prediction error so the
        gate engages on the NEXT frame; (c) garbage hints on large motion
        kill features and reset the gate to the full pyramid."""
        from stereo_vo.frontend.track import _NO_FLOW

        # 30 px shift of a textured rendered frame: far beyond a 2-level
        # unhinted capture, trivial with a correct hint, exact ground truth
        world = SyntheticStereoSequence(cam=CAM, n_frames=1, shape=(240, 320),
                                        n_points=150, seed=5)
        img0, _ = world.render(0)
        shift = 30
        img1 = np.roll(img0, shift, axis=1)
        p0 = build_pyramid(jnp.asarray(img0, jnp.float32), 3)
        p1 = build_pyramid(jnp.asarray(img1, jnp.float32), 3)
        u0, v0, _, vis0 = world.projections(0)
        sel = vis0 & (u0 > 40) & (u0 < 260) & (v0 > 40) & (v0 < 200)
        f_cap = 64
        n = min(int(sel.sum()), f_cap)
        xy = np.zeros((f_cap, 2), np.float32)
        xy[:n] = np.stack([u0[sel], v0[sel]], 1)[:n]
        valid = np.arange(f_cap) < n
        ids = jnp.arange(f_cap, dtype=jnp.int32)
        st = tracker_init(p0, jnp.asarray(xy), ids, jnp.asarray(valid))

        # (b) full pyramid (pred_err sentinel forces it); afterwards the
        # state carries per-feature flow and a small prediction error is
        # only available once flows exist — simulate the steady state by
        # injecting the true flow as the previous step's flow
        st_full, stats_full = track_step(st, p1, CFG)
        assert int(stats_full.num_tracked) >= 0.8 * n

        true_flow = jnp.tile(jnp.asarray([[float(shift), 0.0]]), (f_cap, 1))
        st_hinted_in = st._replace(
            flow_xy=true_flow,
            flow_valid=jnp.asarray(valid),
            pred_err=jnp.float32(1.0),   # engages the hinted branch
        )
        st_hint, stats_hint = track_step(st_hinted_in, p1, CFG)
        both = np.asarray(st_full.feat_valid) & np.asarray(st_hint.feat_valid)
        assert both.sum() >= 0.8 * int(stats_full.num_tracked)
        np.testing.assert_allclose(
            np.asarray(st_hint.feat_xy)[both], np.asarray(st_full.feat_xy)[both],
            atol=0.05,
        )
        # accurate prediction -> small measured error: the gate stays engaged
        assert float(st_hint.pred_err) < 2.0
        # flow snapshot updated for the next step
        flows = np.asarray(st_hint.flow_xy)[both]
        np.testing.assert_allclose(flows[:, 0], shift, atol=0.5)

        # fresh features (no own flow) borrow a tracked neighbor's hint
        st_fresh_in = st._replace(
            flow_xy=true_flow.at[: n // 2].set(0.0),
            flow_valid=jnp.asarray(valid).at[: n // 2].set(False),
            pred_err=jnp.float32(1.0),
        )
        st_fresh, stats_fresh = track_step(st_fresh_in, p1, CFG)
        assert int(stats_fresh.num_tracked) >= 0.8 * int(stats_full.num_tracked)

        # (c) garbage hints (zero flow) on a 70 px motion — beyond the hinted
        # 2-level region bound (~52 px): features die and the gate resets so
        # the NEXT frame takes the full pyramid (which tracks 70 px fine)
        img2 = np.roll(img0, 70, axis=1)
        p2 = build_pyramid(jnp.asarray(img2, jnp.float32), 3)
        st_bad_in = st._replace(
            flow_xy=jnp.zeros_like(true_flow),
            flow_valid=jnp.asarray(valid),
            pred_err=jnp.float32(1.0),
        )
        st_bad, stats_bad = track_step(st_bad_in, p2, CFG)
        assert int(stats_bad.num_tracked) < 0.5 * int(stats_full.num_tracked)
        assert float(st_bad.pred_err) == _NO_FLOW
        st_ok, stats_ok = track_step(st, p2, CFG)
        # (edge features legitimately exit the 320-px frame under a 70 px
        # shift; the full pyramid still tracks what remains visible)
        assert int(stats_ok.num_tracked) > int(stats_bad.num_tracked)
        assert int(stats_ok.num_tracked) >= 0.5 * n

    def test_live_slot_compaction_exact(self, rng):
        """config.lk_compact_slots: tracking the gathered live set in a
        smaller batch is exact — per-feature LK results are independent of
        batch position — and a frame with more live features than slots
        falls back to the full-width path (no feature is ever dropped)."""
        import dataclasses

        world = SyntheticStereoSequence(cam=CAM, n_frames=2, shape=(240, 320),
                                        n_points=260, seed=7)
        l0, _ = world.render(0)
        l1, _ = world.render(1)
        u0, v0, _, vis0 = world.projections(0)
        sel = vis0 & (u0 > 30) & (u0 < 290) & (v0 > 30) & (v0 < 210)
        f_cap = 256
        pts = np.stack([u0[sel], v0[sel]], 1)
        # replicate with deterministic jitter so the overflow case really
        # exceeds the compaction width (the crop keeps only ~44 world points)
        jit = np.random.RandomState(0).uniform(-4, 4, (5, len(pts), 2))
        pts = np.concatenate([pts + j for j in jit]).astype(np.float32)
        pts = pts.clip([31, 31], [289, 209])
        p0 = build_pyramid(jnp.asarray(l0, jnp.float32), 3)
        p1 = build_pyramid(jnp.asarray(l1, jnp.float32), 3)
        cfg_on = dataclasses.replace(CFG, lk_compact_slots=64)
        cfg_off = dataclasses.replace(CFG, lk_compact_slots=0)

        def run(n_valid, cfg):
            xy = np.zeros((f_cap, 2), np.float32)
            n = min(len(pts), n_valid)
            xy[:n] = pts[:n]
            # interleave invalid slots among valid ones so compaction's
            # gather actually reorders (valid slots are NOT a prefix);
            # deterministic so both configs see the identical layout
            perm = np.random.RandomState(n_valid).permutation(f_cap)
            valid = (np.arange(f_cap) < n)[np.argsort(perm)]
            xy = xy[np.argsort(perm)]
            st = tracker_init(p0, jnp.asarray(xy),
                              jnp.arange(f_cap, dtype=jnp.int32),
                              jnp.asarray(valid))
            return track_step(st, p1, cfg)

        # engaged: 40 live <= 64 slots
        st_c, stats_c = run(40, cfg_on)
        st_f, stats_f = run(40, cfg_off)
        assert int(stats_c.num_tracked) == int(stats_f.num_tracked) > 20
        np.testing.assert_array_equal(
            np.asarray(st_c.feat_valid), np.asarray(st_f.feat_valid))
        keep = np.asarray(st_f.feat_valid)
        np.testing.assert_allclose(
            np.asarray(st_c.feat_xy)[keep], np.asarray(st_f.feat_xy)[keep],
            atol=1e-5,
        )
        np.testing.assert_allclose(
            float(st_c.pred_err), float(st_f.pred_err), atol=1e-4)

        # overflow: 200 live > 64 slots -> full-width branch, still all kept
        st_c2, stats_c2 = run(200, cfg_on)
        st_f2, stats_f2 = run(200, cfg_off)
        assert int(stats_c2.num_tracked) == int(stats_f2.num_tracked) > 100
        keep2 = np.asarray(st_f2.feat_valid)
        np.testing.assert_allclose(
            np.asarray(st_c2.feat_xy)[keep2],
            np.asarray(st_f2.feat_xy)[keep2], atol=1e-5,
        )

    def test_fb_gate_kills_occluded(self, rng):
        """A feature whose patch vanishes in the next image fails round-trip."""
        img0 = np.asarray(
            np.random.default_rng(0).integers(0, 255, (100, 100)), np.uint8
        )
        img1 = img0.copy()
        img1[40:60, 40:60] = 0  # destroy a patch
        p0 = build_pyramid(jnp.asarray(img0, jnp.float32), 2)
        p1 = build_pyramid(jnp.asarray(img1, jnp.float32), 2)
        xy = jnp.asarray([[50.0, 50.0], [20.0, 20.0]], jnp.float32)
        st = tracker_init(p0, xy, jnp.arange(2, dtype=jnp.int32), jnp.ones(2, bool))
        _, stats = track_step(st, p1, CFG)
        assert int(stats.num_tracked) <= 1


class TestDetectDedup:
    def test_dedup(self):
        new_xy = jnp.asarray([[10.0, 10.0], [50.0, 50.0], [90.0, 90.0]])
        new_valid = jnp.ones(3, bool)
        tracked = jnp.asarray([[12.0, 11.0], [200.0, 200.0]])
        tval = jnp.ones(2, bool)
        out = dedup_new_features(new_xy, new_valid, tracked, tval, 30.0)
        assert not bool(out[0])  # within 30px of tracked
        assert bool(out[1]) and bool(out[2])

    def test_dedup_ignores_invalid_tracked(self):
        new_xy = jnp.asarray([[10.0, 10.0]])
        tracked = jnp.asarray([[12.0, 11.0]])
        out = dedup_new_features(new_xy, jnp.ones(1, bool), tracked,
                                 jnp.zeros(1, bool), 30.0)
        assert bool(out[0])

    def test_detect_wrapper(self):
        world = SyntheticStereoSequence(cam=CAM, n_frames=1, shape=(240, 320),
                                        n_points=100, seed=2)
        l0, _ = world.render(0)
        xy, valid = detect_features(jnp.asarray(l0), FrontendConfig(min_distance=10.0))
        assert xy.shape == (300, 2)
        assert int(jnp.sum(valid)) > 20
