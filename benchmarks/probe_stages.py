#!/usr/bin/env python
"""Scan-amortized per-stage device timings.

Each stage is wrapped in a `lax.scan` of K iterations inside ONE jit call with
a single final fetch, so per-call dispatch and fetch amortize away and the
number approximates device time per invocation. Scan-amortized cold probes
overstate in-situ cost for stages whose inputs stay cached across the scan.

Usage: python benchmarks/probe_stages.py [--k 64] [--stages lk,ba,...]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timed(fn, *args, reps=3):
    """Median wall time of fn(*args) fully fetched, over reps."""
    import numpy as np

    out = fn(*args)
    for leaf in __import__("jax").tree_util.tree_leaves(out):
        np.asarray(leaf)  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        for leaf in __import__("jax").tree_util.tree_leaves(out):
            np.asarray(leaf)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def probe_stage_timings(k=64, stages="lk,lk_hint,ba,detect,bm,pnp,pyramid",
                        cfg=None):
    """Scan-amortized ms/invocation for each pipeline stage; returns a dict.

    Importable (bench.py embeds the result in BENCH details so throughput
    claims carry auditable per-stage receipts); ``main`` wraps it for CLI use.
    """
    stages = set(stages.split(",")) if isinstance(stages, str) else set(stages)

    from stereo_vo.utils.cache import setup_compilation_cache

    setup_compilation_cache()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from stereo_vo.core.config import load_config
    from stereo_vo.data.synthetic import SyntheticStereoSequence

    if cfg is None:
        cfg = load_config("kitti00")
    fe = cfg.frontend
    world = SyntheticStereoSequence(
        cam=cfg.camera, n_frames=4, shape=(376, 1241), n_points=4000,
        seed=0, speed=0.8, yaw_rate=0.003,
    )
    frames = list(world)
    img0 = jnp.asarray(frames[0].left, jnp.float32)
    img1 = jnp.asarray(frames[1].left, jnp.float32)
    right1 = jnp.asarray(frames[1].right, jnp.float32)

    def scan_ms(body, init_xs):
        """Time `lax.scan(body, 0, xs)` with K steps; return ms per step."""
        f = jax.jit(lambda xs: jax.lax.scan(body, 0.0, xs)[0])
        dt = timed(f, init_xs)
        return dt * 1e3 / k

    results = {}

    # ---- pyramid build ----------------------------------------------------
    if "pyramid" in stages:
        from stereo_vo.ops.pyramid import build_pyramid

        def body(c, x):
            pyr = build_pyramid(img1 + x, fe.lk_max_level)
            return c + sum(jnp.sum(p[:1, :1]) for p in pyr), None

        results["pyramid_build"] = scan_ms(body, jnp.arange(k, dtype=jnp.float32) * 1e-6)

    # ---- LK fwd/bwd: full pyramid vs hinted short pyramid ------------------
    from stereo_vo.ops.pyramid import build_pyramid
    from stereo_vo.ops.lk import lk_track_fwdbwd
    from stereo_vo.frontend.detect import detect_features

    pyr0 = tuple(build_pyramid(img0, fe.lk_max_level))
    pyr1 = tuple(build_pyramid(img1, fe.lk_max_level))
    det_xy, det_valid = detect_features(img0, fe)
    f_cap = cfg.backend.feature_capacity
    pts = jnp.zeros((f_cap, 2), jnp.float32).at[: det_xy.shape[0]].set(det_xy)
    val = jnp.zeros((f_cap,), bool).at[: det_valid.shape[0]].set(det_valid)
    n_act = int(jax.device_get(jnp.sum(val.astype(jnp.int32))))

    lk_kwargs = dict(window=fe.lk_window, max_iters=fe.lk_iters, eps=fe.lk_eps,
                     min_eig_threshold=fe.lk_min_eig, bwd_levels=fe.lk_bwd_levels)

    if "lk" in stages:
        def body(c, x):
            out = lk_track_fwdbwd(pyr0, pyr1, pts + x, val, **lk_kwargs)
            return c + jnp.sum(out[0]) * 1e-9, None

        results[f"lk_full_{n_act}feat"] = scan_ms(
            body, jnp.zeros((k, 1, 2), jnp.float32).at[:, 0, 0].set(
                jnp.arange(k, dtype=jnp.float32) * 1e-4)
        )

    if "lk_hint" in stages:
        hint = jnp.zeros((f_cap, 2), jnp.float32)

        def body(c, x):
            out = lk_track_fwdbwd(
                list(pyr0)[: fe.lk_hint_levels], list(pyr1)[: fe.lk_hint_levels],
                pts + x, val, init_flow=hint, bwd_from_original=True, **lk_kwargs
            )
            return c + jnp.sum(out[0]) * 1e-9, None

        results[f"lk_hint{fe.lk_hint_levels}_{n_act}feat"] = scan_ms(
            body, jnp.zeros((k, 1, 2), jnp.float32).at[:, 0, 0].set(
                jnp.arange(k, dtype=jnp.float32) * 1e-4)
        )

    # ---- LK at the PRODUCTION width (live-slot compaction engaged): the
    # tracker gathers the live set into a lk_compact_slots-wide batch, so the
    # in-situ per-frame LK cost is this probe, not the full-capacity ones
    kc = getattr(fe, "lk_compact_slots", 0)
    if "lk_hint" in stages and 0 < kc < f_cap:
        pts_c = pts[:kc]
        val_c = val[:kc]
        n_act_c = int(jax.device_get(jnp.sum(val_c.astype(jnp.int32))))
        hint_c = jnp.zeros((kc, 2), jnp.float32)

        def body(c, x):
            out = lk_track_fwdbwd(
                list(pyr0)[: fe.lk_hint_levels], list(pyr1)[: fe.lk_hint_levels],
                pts_c + x, val_c, init_flow=hint_c, bwd_from_original=True,
                **lk_kwargs
            )
            return c + jnp.sum(out[0]) * 1e-9, None

        results[f"lk_hint{fe.lk_hint_levels}_{kc}slots_{n_act_c}live"] = scan_ms(
            body, jnp.zeros((k, 1, 2), jnp.float32).at[:, 0, 0].set(
                jnp.arange(k, dtype=jnp.float32) * 1e-4)
        )

    # ---- BA: production-shaped lm_loop (W x Lcap, warm + cold inits) ------
    if "ba" in stages:
        from stereo_vo.backend.schur import LandmarkMajorProblem, lm_loop
        from stereo_vo.core.camera import CameraInfo

        be = cfg.backend
        cam = cfg.camera
        w, lcap = be.window_size, be.landmark_capacity
        rng = np.random.default_rng(0)
        # production sparsity: ~max_features live landmarks, each seen by <=W poses
        n_live = be.max_features * 2
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
        obs += rng.normal(size=obs.shape).astype(np.float32) * 0.5
        obs_valid = np.zeros((lcap, w), bool)
        obs_valid[:n_live] = True
        lm_valid = np.zeros(lcap, bool)
        lm_valid[:n_live] = True
        prob = LandmarkMajorProblem(
            poses=jnp.asarray(poses + np.concatenate(
                [np.zeros((w, 4)), rng.normal(size=(w, 3)) * 0.02], axis=1
            ).astype(np.float32)),
            pose_valid=jnp.ones(w, bool),
            lm_pos=jnp.asarray(lm),
            lm_valid=jnp.asarray(lm_valid),
            obs_uv=jnp.asarray(obs),
            obs_valid=jnp.asarray(obs_valid),
            lm_prior=jnp.asarray(lm),
            lm_prior_w=jnp.full(lcap, 1.0, jnp.float32),
        )

        def body(c, x):
            p = prob._replace(lm_pos=prob.lm_pos + x)
            out = lm_loop(p, cam, be, None)
            return c + out[3] * 1e-9, None

        # cold init: the full accept/reject trajectory from a perturbed start
        results["ba_solve_cold"] = scan_ms(
            body, jnp.arange(k, dtype=jnp.float32)[:, None, None] * 1e-6
        )

        # production path: live-landmark compaction gathers the valid set
        # into a ba_compact_landmarks-row problem (bench replay: 116-291
        # live), so the in-situ keyframe BA cost is this shape
        lc = getattr(be, "ba_compact_landmarks", 0)
        if 0 < lc < lcap:
            n_live_c = min(n_live, 300)
            tr = lambda a, n: a[:n]
            prob_c = LandmarkMajorProblem(
                poses=prob.poses,
                pose_valid=prob.pose_valid,
                lm_pos=tr(prob.lm_pos, lc),
                lm_valid=jnp.asarray(np.arange(lc) < n_live_c),
                obs_uv=tr(prob.obs_uv, lc),
                obs_valid=jnp.asarray(
                    np.broadcast_to(np.arange(lc)[:, None] < n_live_c, (lc, w))
                ),
                lm_prior=tr(prob.lm_prior, lc),
                lm_prior_w=tr(prob.lm_prior_w, lc),
            )

            def body_c(c, x):
                p = prob_c._replace(lm_pos=prob_c.lm_pos + x)
                out = lm_loop(p, cam, be, None)
                return c + out[3] * 1e-9, None

            results[f"ba_solve_cold_c{lc}x{n_live_c}live"] = scan_ms(
                body_c, jnp.arange(k, dtype=jnp.float32)[:, None, None] * 1e-6
            )

    # ---- detection (full NMS, keyframe branch) -----------------------------
    if "detect" in stages:
        def body(c, x):
            xy, ok = detect_features(img1 + x, fe)
            return c + jnp.sum(xy) * 1e-9, None

        results["detect_full_nms"] = scan_ms(body, jnp.arange(k, dtype=jnp.float32) * 1e-6)

    # ---- sparse StereoBM ----------------------------------------------------
    if "bm" in stages:
        from stereo_vo.ops.stereo_bm import stereo_bm_at

        cat_xy = jnp.concatenate([pts, pts], axis=0)
        cat_ok = jnp.concatenate([val, val], axis=0)

        def body(c, x):
            d = stereo_bm_at(
                img1 + x, right1, cat_xy, cat_ok,
                num_disparities=fe.bm_num_disparities, block_size=fe.bm_block_size,
                prefilter_cap=fe.bm_prefilter_cap,
                texture_threshold=fe.bm_texture_threshold,
                uniqueness_ratio=fe.bm_uniqueness_ratio,
            )
            return c + jnp.sum(d) * 1e-9, None

        results[f"stereo_bm_{2 * f_cap}pts"] = scan_ms(
            body, jnp.arange(k, dtype=jnp.float32) * 1e-6
        )

        # production path: live-slot compaction engaged (the keyframe branch
        # feeds ~240 valid of max_detect+feature_capacity slots)
        kb = getattr(fe, "bm_compact_slots", 0)
        if kb > 0:
            n_bm_valid = min(n_act, kb - 32)
            cat_ok_c = jnp.zeros_like(cat_ok).at[:n_bm_valid].set(
                val[:n_bm_valid]
            )

            def body_c(c, x):
                d = stereo_bm_at(
                    img1 + x, right1, cat_xy, cat_ok_c,
                    num_disparities=fe.bm_num_disparities,
                    block_size=fe.bm_block_size,
                    prefilter_cap=fe.bm_prefilter_cap,
                    texture_threshold=fe.bm_texture_threshold,
                    uniqueness_ratio=fe.bm_uniqueness_ratio,
                    compact_slots=kb,
                )
                return c + jnp.sum(d) * 1e-9, None

            results[f"stereo_bm_c{kb}slots"] = scan_ms(
                body_c, jnp.arange(k, dtype=jnp.float32) * 1e-6
            )

    # ---- PnP-RANSAC ---------------------------------------------------------
    if "pnp" in stages:
        from stereo_vo.frontend.pnp import pnp_ransac

        rng = np.random.default_rng(1)
        wpts = np.concatenate(
            [rng.uniform(-10, 10, (f_cap, 2)), rng.uniform(5, 50, (f_cap, 1))],
            axis=1,
        ).astype(np.float32)
        uv = (wpts[:, :2] / wpts[:, 2:]) * cfg.camera.focal + np.array(
            [cfg.camera.cx, cfg.camera.cy]
        )
        uv += rng.normal(size=uv.shape) * 0.5
        wpts_j = jnp.asarray(wpts)
        uv_j = jnp.asarray(uv.astype(np.float32))
        vmask = jnp.ones((f_cap,), bool)
        from stereo_vo.core import geometry as geo

        warm = geo.pose_identity()

        def body(c, x):
            res = pnp_ransac(wpts_j, uv_j + x, vmask, cfg.camera, warm,
                             x[0, 0].astype(jnp.uint32), fe)
            return c + jnp.sum(res.pose) * 1e-9, None

        results["pnp_ransac"] = scan_ms(
            body, jnp.zeros((k, 1, 2), jnp.float32).at[:, 0, 0].set(
                jnp.arange(k, dtype=jnp.float32))
        )

    return {name: round(ms, 3) for name, ms in results.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=64, help="scan length per probe")
    ap.add_argument("--stages", default="lk,lk_hint,ba,detect,bm,pnp,pyramid")
    args = ap.parse_args()
    results = probe_stage_timings(k=args.k, stages=args.stages)
    print("stage timings (ms/invocation, scan-amortized x%d):" % args.k)
    for name, ms in results.items():
        print(f"  {name:28s} {ms:8.3f}")


if __name__ == "__main__":
    main()
