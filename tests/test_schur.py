import jax
import jax.numpy as jnp
import numpy as np

from stereo_vo.backend.schur import bundle_adjust, lm_step, _masked_system
from stereo_vo.backend.window import WindowState, empty_window
from stereo_vo.core.camera import CameraInfo
from stereo_vo.core.config import BackendConfig
from stereo_vo.core import geometry as geo

CAM = CameraInfo(focal=500.0, cx=320.0, cy=240.0, baseline=0.5)


def make_problem(rng, w=4, n_lm=40, f_cap=64, l_cap=64, noise_px=0.0):
    """Synthetic BA problem: camera moving in +x, landmarks ahead, full visibility."""
    cfg = BackendConfig(
        window_size=w, max_features=f_cap, feature_capacity=f_cap,
        landmark_capacity=l_cap, max_lm_iters=20,
    )
    lm_gt = np.concatenate(
        [
            rng.uniform(-5, 5, size=(n_lm, 1)),
            rng.uniform(-3, 3, size=(n_lm, 1)),
            rng.uniform(8, 25, size=(n_lm, 1)),
        ],
        axis=1,
    )
    poses_gt = []
    for i in range(w):
        # T_cw: camera at x = 0.3 i with slight rotation
        aa = np.array([0.01, 0.02, 0.005]) * i
        q = geo.axis_angle_to_quat(jnp.asarray(aa, jnp.float64))
        t_wc = np.array([0.3 * i, 0.01 * i, 0.05 * i])
        # T_cw = inverse of (R_wc, t_wc): q_cw = conj(q_wc), t_cw = -R_cw t_wc
        q_cw = geo.quat_conj(q)
        t_cw = -np.asarray(geo.rot_apply(q_cw, jnp.asarray(t_wc)))
        poses_gt.append(np.concatenate([np.asarray(q_cw), t_cw]))
    poses_gt = np.stack(poses_gt)

    obs = np.zeros((w, f_cap, 2), np.float64)
    obs_lm = np.zeros((w, f_cap), np.int32)
    obs_valid = np.zeros((w, f_cap), bool)
    for i in range(w):
        p_cam = np.asarray(
            geo.pose_apply(jnp.asarray(poses_gt[i])[None], jnp.asarray(lm_gt))
        )
        uv = np.asarray(CAM.project(jnp.asarray(p_cam)))
        obs[i, :n_lm] = uv + rng.normal(size=(n_lm, 2)) * noise_px
        obs_lm[i, :n_lm] = np.arange(n_lm)
        obs_valid[i, :n_lm] = True

    lm_pos = np.zeros((l_cap, 3))
    lm_pos[:n_lm] = lm_gt
    window = WindowState(
        poses=jnp.asarray(poses_gt, jnp.float32),
        pose_valid=jnp.ones(w, bool),
        obs_uv=jnp.asarray(obs, jnp.float32),
        obs_lm=jnp.asarray(obs_lm),
        obs_valid=jnp.asarray(obs_valid),
        lm_pos=jnp.asarray(lm_pos, jnp.float32),
        lm_refcount=jnp.asarray(
            np.where(np.arange(l_cap) < n_lm, w, 0), jnp.int32
        ),
        lm_valid=jnp.asarray(np.arange(l_cap) < n_lm),
        lm_prior=jnp.asarray(lm_pos, jnp.float32),
        lm_prior_w=jnp.zeros(l_cap, jnp.float32),
        num_kf=jnp.array(w, jnp.int32),
    )
    return cfg, window, poses_gt, lm_gt


def perturb(window, rng, pose_scale=0.02, lm_scale=0.1):
    """Perturb all poses except the gauge pose (index 0) and all landmarks."""
    w = window.window_size
    dp = rng.normal(size=(w, 6)) * pose_scale
    dp[0] = 0
    poses = geo.pose_retract(window.poses, jnp.asarray(dp, jnp.float32))
    dl = rng.normal(size=window.lm_pos.shape) * lm_scale
    lm = window.lm_pos + jnp.asarray(dl, jnp.float32) * window.lm_valid[:, None]
    return window._replace(poses=poses, lm_pos=lm)


def test_converges_to_ground_truth(rng):
    cfg, window_gt, poses_gt, lm_gt = make_problem(rng)
    window = perturb(window_gt, rng)
    solved, stats = jax.jit(
        lambda win: bundle_adjust(win, CAM, cfg), static_argnames=()
    )(window)
    assert float(stats.final_cost) < 1e-3 * float(stats.initial_cost)
    # gauge pose fixed at index 0 -> solution matches GT, not just up to gauge
    np.testing.assert_allclose(
        np.asarray(solved.poses[:, 4:]), poses_gt[:, 4:], atol=5e-3
    )
    # quaternions up to sign/normalization
    for i in range(window_gt.window_size):
        q = np.asarray(geo.quat_normalize(solved.poses[i, :4]))
        qg = poses_gt[i, :4]
        assert min(np.abs(q - qg).max(), np.abs(q + qg).max()) < 2e-3
    # landmark depth accuracy is limited by the f32 residual floor (~0.05 px at
    # 25 m depth); 10 cm at these depths is below that floor
    lm_err = np.abs(np.asarray(solved.lm_pos) - np.vstack([lm_gt, np.zeros((24, 3))]))
    assert lm_err[np.asarray(window_gt.lm_valid)].max() < 0.1


def test_noisy_problem_reduces_cost_monotonically(rng):
    cfg, window_gt, *_ = make_problem(rng, noise_px=0.5)
    window = perturb(window_gt, rng)
    solved, stats = bundle_adjust(window, CAM, cfg)
    assert float(stats.final_cost) < float(stats.initial_cost)
    assert int(stats.iterations) >= 1
    # With only the oldest pose fixed, overall scale is a weakly-constrained
    # gauge mode (same freedom Ceres has in the reference's monocular-residual
    # BA) — compare translations up to a fitted scale.
    t_sol = np.asarray(solved.poses[:, 4:])
    t_gt = np.asarray(window_gt.poses[:, 4:])
    scale = float(np.sum(t_sol * t_gt) / max(np.sum(t_sol * t_sol), 1e-12))
    np.testing.assert_allclose(scale * t_sol, t_gt, atol=5e-2)


def test_schur_step_equals_dense_normal_equations(rng):
    """The Schur-eliminated camera system must produce the same step as directly
    solving the full (6W + 3L) damped normal equations (SURVEY.md §7 hard part 6)."""
    with jax.enable_x64(True):
        cfg, window_gt, *_ = make_problem(rng, w=3, n_lm=12, f_cap=16, l_cap=16)
        window = perturb(window_gt, rng)
        window = jax.tree.map(
            lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32 else x, window
        )
        lam = 1e-3
        poses, lm_pos = window.poses, window.lm_pos

        cand_poses, cand_lm = lm_step(poses, lm_pos, lam, window, CAM, cfg)

        # Dense reference solve in numpy (same Huber-IRLS weighting: sqrt(w) is
        # folded into r/jp/jl by _masked_system, so the dense normal equations
        # built from them are the robustified ones)
        r, jp, jl, mask = _masked_system(
            poses, lm_pos, window, CAM, cfg.min_depth, cfg.huber_delta_px
        )
        w, f = mask.shape
        n_lm = 12
        npose, nlm = w * 6, n_lm * 3
        big_j = np.zeros((w * f * 2, npose + nlm))
        big_r = np.zeros(w * f * 2)
        k = 0
        for i in range(w):
            for j in range(f):
                if not bool(mask[i, j]):
                    continue
                big_j[2 * k : 2 * k + 2, 6 * i : 6 * i + 6] = np.asarray(jp[i, j])
                l_id = int(window.obs_lm[i, j])
                big_j[2 * k : 2 * k + 2, npose + 3 * l_id : npose + 3 * l_id + 3] = (
                    np.asarray(jl[i, j])
                )
                big_r[2 * k : 2 * k + 2] = np.asarray(r[i, j])
                k += 1
        big_j = big_j[: 2 * k]
        big_r = big_r[: 2 * k]
        h = big_j.T @ big_j
        h_damped = h + lam * np.clip(np.diag(h), 1e-8, None) * np.eye(h.shape[0])
        g = -big_j.T @ big_r
        # gauge: remove pose-0 columns
        keep = np.ones(npose + nlm, bool)
        keep[:6] = False
        delta = np.zeros(npose + nlm)
        delta[keep] = np.linalg.solve(h_damped[np.ix_(keep, keep)], g[keep])

        dp_dense = delta[:npose].reshape(w, 6)
        dl_dense = delta[npose:].reshape(n_lm, 3)

        exp_poses = np.asarray(geo.pose_retract(poses, jnp.asarray(dp_dense)))
        # tolerance floor: lm_step's closed-form 3x3 inverse regularizes V with
        # an absolute 1e-6 ridge the dense reference doesn't have; with Huber
        # weights shrinking V on the perturbed problem that ridge is ~1e-5
        # relative — not a formulation difference
        np.testing.assert_allclose(np.asarray(cand_poses), exp_poses, rtol=1e-4, atol=1e-8)
        np.testing.assert_allclose(
            np.asarray(cand_lm[:n_lm]), np.asarray(lm_pos[:n_lm]) + dl_dense,
            rtol=1e-4, atol=1e-8,
        )


def test_landmark_compaction_matches_full(rng):
    """config.ba_compact_landmarks: solving the gathered live-landmark
    problem equals the full-capacity solve (poses, landmarks, stats), with
    live slots scattered across the table; overflow falls back."""
    import dataclasses

    # noise gives the solve a real cost floor: at ~zero final cost the
    # accept/reject decisions sit at machine epsilon, where the compacted
    # path's different f32 summation order can flip a marginal iteration
    cfg, window_gt, _, _ = make_problem(rng, w=4, n_lm=40, l_cap=128,
                                        noise_px=0.3)
    window = perturb(window_gt, rng)
    # scatter the live landmarks around the table (recycled ids are not a
    # prefix in production): apply a permutation to the lm axis + remap obs
    perm = np.random.RandomState(3).permutation(128)
    inv = np.argsort(perm)
    window = window._replace(
        lm_pos=window.lm_pos[perm],
        lm_refcount=window.lm_refcount[perm],
        lm_valid=window.lm_valid[perm],
        lm_prior=window.lm_prior[perm],
        lm_prior_w=window.lm_prior_w[perm],
        obs_lm=jnp.asarray(inv)[window.obs_lm],
    )
    cfg_on = dataclasses.replace(cfg, ba_compact_landmarks=64)
    cfg_off = dataclasses.replace(cfg, ba_compact_landmarks=0)
    solved_c, stats_c = bundle_adjust(window, CAM, cfg_on)
    solved_f, stats_f = bundle_adjust(window, CAM, cfg_off)
    # f32 summation-order differences accumulate over the LM iterations;
    # tolerances are far below any physically meaningful difference
    assert abs(int(stats_c.iterations) - int(stats_f.iterations)) <= 1
    np.testing.assert_allclose(
        float(stats_c.final_cost), float(stats_f.final_cost), rtol=1e-3)
    np.testing.assert_allclose(
        np.asarray(solved_c.poses), np.asarray(solved_f.poses), atol=1e-3)
    live = np.asarray(window.lm_valid)
    np.testing.assert_allclose(
        np.asarray(solved_c.lm_pos)[live], np.asarray(solved_f.lm_pos)[live],
        atol=1e-2,
    )
    # dead slots keep their original values
    np.testing.assert_array_equal(
        np.asarray(solved_c.lm_pos)[~live], np.asarray(window.lm_pos)[~live])

    # overflow: 40 live > 32 slots -> full-capacity branch (same math; the
    # cond wrapper changes XLA fusion choices, hence the f32-level tolerance)
    cfg_small = dataclasses.replace(cfg, ba_compact_landmarks=32)
    solved_o, stats_o = bundle_adjust(window, CAM, cfg_small)
    np.testing.assert_allclose(
        np.asarray(solved_o.poses), np.asarray(solved_f.poses), atol=1e-3)


def test_invalid_window_is_noop():
    cfg = BackendConfig(window_size=3, max_features=8, feature_capacity=8,
                        landmark_capacity=16, max_lm_iters=3)
    window = empty_window(cfg)
    solved, stats = bundle_adjust(window, CAM, cfg)
    assert float(stats.initial_cost) == 0.0
    assert float(stats.final_cost) == 0.0
    assert bool(jnp.all(jnp.isfinite(solved.poses)))
    assert bool(jnp.all(jnp.isfinite(solved.lm_pos)))


def _big_lm_problem(w, lcap, noise=0.5, seed=0):
    """Realistic-scale landmark-major problem with known ground truth."""
    import numpy as np
    import jax.numpy as jnp
    from stereo_vo.backend.schur import LandmarkMajorProblem
    from stereo_vo.core.camera import CameraInfo

    cam = CameraInfo(focal=718.856, cx=607.19, cy=185.22, baseline=0.537)
    rng = np.random.default_rng(seed)
    lm = np.concatenate(
        [rng.uniform(-20, 20, (lcap, 2)), rng.uniform(5, 60, (lcap, 1))], axis=1
    ).astype(np.float32)
    poses = np.tile(np.array([1, 0, 0, 0, 0, 0, 0], np.float32), (w, 1))
    poses[:, 4] = -0.5 * np.arange(w)
    obs = np.zeros((lcap, w, 2), np.float32)
    for wi in range(w):
        p = lm + np.array([poses[wi, 4], 0, 0])
        obs[:, wi, 0] = cam.focal * p[:, 0] / p[:, 2] + cam.cx
        obs[:, wi, 1] = cam.focal * p[:, 1] / p[:, 2] + cam.cy
    obs += rng.normal(size=obs.shape).astype(np.float32) * noise
    prob = LandmarkMajorProblem(
        poses=jnp.asarray(
            poses + np.concatenate(
                [np.zeros((w, 4)), rng.normal(size=(w, 3)) * 0.05], axis=1
            ).astype(np.float32)
        ),
        pose_valid=jnp.ones(w, bool),
        lm_pos=jnp.asarray(lm + rng.normal(size=lm.shape).astype(np.float32) * 0.1),
        lm_valid=jnp.ones(lcap, bool),
        obs_uv=jnp.asarray(obs),
        obs_valid=jnp.ones((lcap, w), bool),
        lm_prior=jnp.asarray(lm),
        # production anchors monocular BA's free scale mode with stereo
        # priors (backend.window); without them GT recovery is gauge-deficient
        lm_prior_w=jnp.full(lcap, 0.5, jnp.float32),
    )
    return prob, cam, poses, lm


def test_big_window_converges_to_ground_truth():
    """32x16384 must not just run — it must recover the trajectory (VERDICT r1
    weak #5). At 0.5 px observation noise the pose error floor is ~mm."""
    from stereo_vo.backend.schur import lm_loop

    w, lcap = 32, 16384
    prob, cam, poses_gt, lm_gt = _big_lm_problem(w, lcap)
    cfg = BackendConfig(window_size=w, landmark_capacity=lcap, max_lm_iters=10)
    poses, lm_pos, c0, c1, accepted, _, _ = jax.jit(
        lambda p: lm_loop(p, cam, cfg, None)
    )(prob)
    poses, lm_pos = np.asarray(poses), np.asarray(lm_pos)
    assert float(c1) < float(c0)
    # convergence to the chi^2 noise floor: E[cost] ~= N_obs * sigma^2 at the
    # ML optimum (sigma = 0.5 px, both residual dims)
    n_obs = w * lcap
    assert float(c1) <= 1.15 * n_obs * 0.5 ** 2, f"cost {float(c1):.0f} above noise floor"
    # pose/landmark error vs GT bounded by the statistical floor of this
    # geometry (depth-direction sigma ~ z^2 sigma_px / (f * span) ~ 4 cm)
    terr = np.linalg.norm(poses[:, 4:7] - poses_gt[:, 4:7], axis=1)
    assert terr.max() < 0.1, f"max translation error {terr.max():.4f} m"
    lerr = np.linalg.norm(lm_pos - lm_gt, axis=1)
    assert np.median(lerr) < 0.1, f"median landmark error {np.median(lerr):.3f} m"


def test_condition_probe_and_precision_islands():
    from stereo_vo.backend.schur import lm_loop, reduced_camera_condition

    w, lcap = 8, 1024
    prob, cam, poses_gt, _ = _big_lm_problem(w, lcap)
    cfg = BackendConfig(window_size=w, landmark_capacity=lcap, max_lm_iters=8)
    cond = float(reduced_camera_condition(prob, cam, cfg, lam=1e-4))
    assert np.isfinite(cond) and cond > 1.0

    def run(**kw):
        c = BackendConfig(window_size=w, landmark_capacity=lcap, max_lm_iters=8, **kw)
        poses, *_ = jax.jit(lambda p: lm_loop(p, cam, c, None))(prob)
        return np.linalg.norm(np.asarray(poses)[:, 4:7] - poses_gt[:, 4:7], axis=1).max()

    base = run(reduced_solve_refine=0)
    refined = run(reduced_solve_refine=1)
    # refinement must not hurt (it usually helps on ill-conditioned systems),
    # and the solve must stay at this geometry's statistical floor (~0.1 m for
    # 8 poses x 1024 landmarks at 0.5 px noise)
    assert refined <= base * 1.5
    assert refined < 0.3


def test_narrow_build_path_matches_fused(rng, monkeypatch):
    """The large-shape narrow-einsum normal-equation build (used when
    L*W > _FUSED_GRAM_MAX_OBS, where the fused [L,W,10,10] Gram would
    materialize hundreds of MB) must produce the identical system."""
    import stereo_vo.backend.schur as schur_mod
    from stereo_vo.backend.schur import (
        _build_system, window_to_landmark_major,
    )

    cfg, window_gt, *_ = make_problem(rng, noise_px=0.5)
    window = perturb(window_gt, rng)
    prob = window_to_landmark_major(window)

    fused = _build_system(prob.poses, prob.lm_pos, prob, CAM, cfg, None)
    monkeypatch.setattr(schur_mod, "_FUSED_GRAM_MAX_OBS", 0)
    narrow = _build_system(prob.poses, prob.lm_pos, prob, CAM, cfg, None)

    for name, a, b in zip(fused._fields, fused, narrow):
        a, b = np.asarray(a), np.asarray(b)
        # absolute tolerance scaled to the field's magnitude: the two
        # contraction orders differ by f32 cancellation noise on near-zero
        # entries of O(1e4) blocks
        atol = 1e-5 * max(np.abs(a).max(), 1.0)
        np.testing.assert_allclose(
            a, b, rtol=1e-5, atol=atol, err_msg=f"field {name}",
        )
