"""The per-frame VO step: one compiled XLA program per frame.

This is where the device boundary sits (SURVEY.md §3): everything the reference does across ``ImageProcessor::process``
(``image_processor.cpp:18-163``) and ``BundleAdjuster::bundle_adjust``
(``bundle_adjuster.cpp:137-157``) — detection, tracking, the keyframe gate,
PnP, triangulation, window update and the Schur-LM solve — runs as a single
jitted function of the ``VOState`` pytree. The only host<->device traffic per
frame: two grayscale images in, pose + scalar stats out.

Control-flow mapping (reference -> XLA):
- "fewer than 4 detections -> return"  (``image_processor.cpp:23-25``)
  -> outer ``lax.cond`` skipping the whole frame;
- keyframe gate "parallax <= 20 && lost < 0.4 -> return"
  (``image_processor.cpp:63-65``) -> ``lax.cond`` around the keyframe branch
  (both branches compiled once, one executed);
- PnP degraded mode: the reference ignores ``solvePnPRansac`` failure
  (SURVEY.md §5 "Failure detection"); here a failed PnP skips keyframe
  creation and keeps tracking — a deliberate robustness fix, surfaced in the
  per-frame ``StepOutput.pnp_ok`` flag.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from stereo_vo.backend.schur import BASolveStats, bundle_adjust
from stereo_vo.backend.window import (
    WindowState,
    add_keyframe,
    empty_window,
    get_world_points,
    newest_pose,
)
from stereo_vo.core.config import PipelineConfig
from stereo_vo.core import geometry as geo
from stereo_vo.frontend.detect import dedup_new_features, detect_features
from stereo_vo.frontend.pnp import pnp_ransac
from stereo_vo.frontend.track import TrackerState, TrackStats, track_step, tracker_init
from stereo_vo.frontend.triangulate import triangulate_from_disparities
from stereo_vo.ops.pyramid import build_pyramid
from stereo_vo.ops.stereo_bm import stereo_bm_at


class VOState(NamedTuple):
    tracker: TrackerState
    window: WindowState
    pnp_pose: jnp.ndarray      # [7] PnP warm start (reference rvec/tvec members)
    cur_pose: jnp.ndarray      # [7] latest published T_cw (BA-optimized)
    frame_idx: jnp.ndarray     # [] int32
    initialized: jnp.ndarray   # [] bool


class StepOutput(NamedTuple):
    pose_cw: jnp.ndarray       # [7] published pose (T_cw)
    pose_wc: jnp.ndarray       # [7] inverted for the path (vo_node.cpp:149-150)
    is_keyframe: jnp.ndarray
    pnp_ok: jnp.ndarray
    num_detected: jnp.ndarray
    num_tracked: jnp.ndarray
    num_inliers: jnp.ndarray
    num_new_landmarks: jnp.ndarray
    av_parallax: jnp.ndarray
    percent_lost: jnp.ndarray
    ba_initial_cost: jnp.ndarray
    ba_final_cost: jnp.ndarray
    ba_iterations: jnp.ndarray
    hinted: jnp.ndarray        # this step ran the flow-hinted short-pyramid LK
    # tracker snapshot for the /feature_tracking debug drawing
    track_from: jnp.ndarray    # [F, 2]
    track_to: jnp.ndarray      # [F, 2]
    track_valid: jnp.ndarray   # [F]

    @property
    def summary(self) -> jnp.ndarray:
        """All per-frame scalars packed into one [18] float32 vector so the
        host fetches a single buffer per frame (each separate fetch is a
        device round-trip — expensive on remote-attached accelerators)."""
        scalars = jnp.stack(
            [
                self.is_keyframe.astype(jnp.float32),
                self.pnp_ok.astype(jnp.float32),
                self.num_detected.astype(jnp.float32),
                self.num_tracked.astype(jnp.float32),
                self.num_inliers.astype(jnp.float32),
                self.num_new_landmarks.astype(jnp.float32),
                self.av_parallax,
                self.percent_lost,
                self.ba_initial_cost,
                self.ba_final_cost,
                self.ba_iterations.astype(jnp.float32),
                self.hinted.astype(jnp.float32),
            ]
        )
        return jnp.concatenate([self.pose_cw, scalars])

SUMMARY_KEYS = (
    "is_keyframe", "pnp_ok", "num_detected", "num_tracked", "num_inliers",
    "num_new_landmarks", "av_parallax", "percent_lost", "ba_initial_cost",
    "ba_final_cost", "ba_iterations", "hinted",
)


def parse_summary(vec) -> dict:
    """Host-side: unpack a summary vector into the metrics row dict."""
    import numpy as np

    vec = np.asarray(vec)
    pose = vec[:7]
    s = vec[7:]
    row = {}
    for i, k in enumerate(SUMMARY_KEYS):
        v = float(s[i])
        if k in ("is_keyframe", "pnp_ok", "hinted"):
            row[k] = bool(v)
        elif k.startswith("num_") or k == "ba_iterations":
            row[k] = int(v)
        else:
            row[k] = v
    return pose, row


def _pad_to(arr: jnp.ndarray, n: int) -> jnp.ndarray:
    if arr.shape[0] >= n:
        return arr[:n]
    return jnp.zeros((n,) + arr.shape[1:], arr.dtype).at[: arr.shape[0]].set(arr)


def _empty_pnp(prev_pose, f_dim):
    from stereo_vo.frontend.pnp import PnPResult

    return PnPResult(
        pose=prev_pose,
        inliers=jnp.zeros((f_dim,), bool),
        num_inliers=jnp.array(0, jnp.int32),
        ok=jnp.array(False),
    )


class VOEngine:
    """Factory for the jitted bootstrap/step functions, closed over config.

    Image shape is static: one engine per camera geometry (the reference's
    process-wide camera matrix, ``vo_node.cpp:104-108``).
    """

    def __init__(self, config: PipelineConfig, image_shape: Tuple[int, int]):
        self.config = config
        self.image_shape = tuple(image_shape)
        self.step = jax.jit(self._step)
        self.bootstrap = jax.jit(self._bootstrap)
        self.replay_chunk = jax.jit(self._replay_chunk)

    def _replay_chunk(self, state: "VOState", lefts, rights):
        """Process a whole chunk of frames in one device program (lax.scan).

        The offline-replay fast path: amortizes per-call dispatch/transfer
        latency (which dominates on remote-attached devices) over many frames.
        Returns ``(state, poses [K, 7], summaries [K, 18])``.

        The per-frame image preprocessing that does not depend on the carried
        state — pyramid levels and the detection-gate peak count — is hoisted
        OUT of the scan and computed for the whole chunk as batched ops: a
        [K, H, W] convolution keeps the VPU busier than K serial [H, W] ones
        inside the sequential scan, and XLA can schedule the entire batch
        without the scan's carry dependency.
        """
        from stereo_vo.ops.shi_tomasi import count_quality_peaks, min_eig_response

        cfg = self.config
        lefts_f = lefts.astype(jnp.float32)
        pyrs = build_pyramid(lefts_f, cfg.frontend.lk_max_level)  # [K, h, w] each
        resps = min_eig_response(lefts_f, cfg.frontend.detect_block_size)
        n_peaks = count_quality_peaks(
            lefts_f, cfg.frontend.quality_level, cfg.frontend.detect_block_size,
            resp=resps,
        )                                                          # [K]

        def body(st, xs):
            left, right, peaks, resp = xs[0], xs[1], xs[2], xs[3]
            pyr = tuple(xs[4:])
            st, out = self._step(st, left, right, precomp=(pyr, peaks, resp))
            return st, (out.pose_cw, out.summary)

        state, (poses, summaries) = jax.lax.scan(
            body, state, (lefts, rights, n_peaks, resps, *pyrs)
        )
        return state, poses, summaries

    # ------------------------------------------------------------------
    def init_state(self) -> VOState:
        cfg = self.config
        h, w = self.image_shape
        f_cap = cfg.backend.feature_capacity
        pyr_shapes = []
        hh, ww = h, w
        for _ in range(cfg.frontend.lk_max_level + 1):
            pyr_shapes.append((hh, ww))
            hh, ww = (hh + 1) // 2, (ww + 1) // 2
        tracker = TrackerState(
            pyramid=tuple(jnp.zeros(s, jnp.float32) for s in pyr_shapes),
            feat_xy=jnp.zeros((f_cap, 2), jnp.float32),
            feat_ids=jnp.zeros((f_cap,), jnp.int32),
            feat_valid=jnp.zeros((f_cap,), bool),
            init_xy=jnp.zeros((f_cap, 2), jnp.float32),
            init_count=jnp.array(0, jnp.int32),
            flow_xy=jnp.zeros((f_cap, 2), jnp.float32),
            flow_valid=jnp.zeros((f_cap,), bool),
            pred_err=jnp.array(1e9, jnp.float32),
        )
        return VOState(
            tracker=tracker,
            window=empty_window(cfg.backend),
            pnp_pose=geo.pose_identity(),
            cur_pose=geo.pose_identity(),
            frame_idx=jnp.array(0, jnp.int32),
            initialized=jnp.array(False),
        )

    # ------------------------------------------------------------------
    def _bootstrap(self, state: VOState, left, right) -> Tuple[VOState, StepOutput]:
        """First-keyframe path (``image_processor.cpp:30-58``): triangulate the
        detections at the identity pose and seed tracker + window."""
        cfg = self.config
        f_cap = cfg.backend.feature_capacity
        left_f = left.astype(jnp.float32)
        det_xy, det_valid = detect_features(left_f, cfg.frontend)
        n_det = jnp.sum(det_valid.astype(jnp.int32))

        def do_init(state):
            disp_n = stereo_bm_at(
                left_f, right.astype(jnp.float32), det_xy, det_valid,
                num_disparities=cfg.frontend.bm_num_disparities,
                block_size=cfg.frontend.bm_block_size,
                prefilter_cap=cfg.frontend.bm_prefilter_cap,
                texture_threshold=cfg.frontend.bm_texture_threshold,
                uniqueness_ratio=cfg.frontend.bm_uniqueness_ratio,
            )
            identity = geo.pose_identity()
            p3, tri_valid = triangulate_from_disparities(
                disp_n, det_xy, det_valid, cfg.camera, identity)
            sigma_d = cfg.backend.stereo_prior_sigma_px
            if sigma_d > 0:
                fb = cfg.camera.focal * cfg.camera.baseline
                w_new = (fb / (jnp.maximum(p3[:, 2], 1.0) ** 2 * sigma_d)) ** 2
                w_new = jnp.where(tri_valid, w_new, 0.0)
            else:
                w_new = jnp.zeros(p3.shape[0], jnp.float32)
            new_uv = _pad_to(det_xy, f_cap)
            new_p3 = _pad_to(p3, f_cap)
            new_valid = _pad_to(tri_valid, f_cap)
            no_uv = jnp.zeros((f_cap, 2), jnp.float32)
            no_lm = jnp.zeros((f_cap,), jnp.int32)
            no_valid = jnp.zeros((f_cap,), bool)
            window, ids, ids_valid = add_keyframe(
                state.window, cfg.backend, identity,
                no_uv, no_lm, no_valid, new_uv, new_p3, new_valid,
                _pad_to(w_new, f_cap),
            )
            pyr = build_pyramid(left_f, cfg.frontend.lk_max_level)
            tracker = tracker_init(tuple(pyr), new_uv, ids, ids_valid)
            return state._replace(
                tracker=tracker,
                window=window,
                initialized=jnp.array(True),
                pnp_pose=identity,
                cur_pose=identity,
            )

        enough = n_det >= cfg.frontend.min_detected
        new_state = jax.lax.cond(enough, do_init, lambda s: s, state)
        new_state = new_state._replace(frame_idx=state.frame_idx + 1)
        zero = jnp.array(0, jnp.int32)
        zf = jnp.array(0.0, jnp.float32)
        out = StepOutput(
            pose_cw=new_state.cur_pose,
            pose_wc=geo.pose_inverse(new_state.cur_pose),
            is_keyframe=enough,
            pnp_ok=jnp.array(True),
            num_detected=n_det,
            num_tracked=zero,
            num_inliers=zero,
            num_new_landmarks=jnp.sum(new_state.tracker.feat_valid.astype(jnp.int32)),
            av_parallax=zf,
            percent_lost=zf,
            ba_initial_cost=zf,
            ba_final_cost=zf,
            ba_iterations=zero,
            hinted=jnp.array(False),
            track_from=new_state.tracker.init_xy,
            track_to=new_state.tracker.feat_xy,
            track_valid=new_state.tracker.feat_valid,
        )
        return new_state, out

    # ------------------------------------------------------------------
    def _keyframe_work(self, left_f, right_f, pose, inliers, args, resp=None):
        """Keyframe-branch body (``image_processor.cpp:95-162`` + BA).

        ``args`` is the small-state tuple; returns ``(new_args, (ba_c0, ba_c1,
        ba_iters, n_new_landmarks))``.
        """
        cfg = self.config
        f_cap = cfg.backend.feature_capacity
        (window, pnp_pose, cur_pose, feat_xy, feat_ids, feat_valid,
         flow_xy, flow_valid) = args
        # resp: the gate's structure-tensor response, shared so the keyframe
        # branch skips rebuilding it (~1/3 of detection)
        det_xy, det_valid = detect_features(left_f, cfg.frontend, resp=resp)
        # keyframe observations = PnP inliers only (image_processor.cpp:95-108)
        inlier_valid = feat_valid & inliers
        # dedup new detections vs inlier tracked (image_processor.cpp:113-128)
        new_valid = dedup_new_features(
            det_xy, det_valid, feat_xy, inlier_valid,
            cfg.frontend.min_distance,
        )
        # sparse BM: disparity only where it's consumed — the new detections
        # (image_processor.cpp:191-207) AND the tracked inliers (our stereo-
        # prior refresh, see add_keyframe) in one call, instead of the dense
        # [D,H,W] SAD volume over every pixel
        n_det = det_xy.shape[0]
        cat_xy = jnp.concatenate([det_xy, feat_xy], axis=0)
        cat_ok = jnp.concatenate([new_valid, inlier_valid], axis=0)
        disp_cat = stereo_bm_at(
            left_f, right_f, cat_xy, cat_ok,
            num_disparities=cfg.frontend.bm_num_disparities,
            block_size=cfg.frontend.bm_block_size,
            prefilter_cap=cfg.frontend.bm_prefilter_cap,
            texture_threshold=cfg.frontend.bm_texture_threshold,
            uniqueness_ratio=cfg.frontend.bm_uniqueness_ratio,
            compact_slots=getattr(cfg.frontend, "bm_compact_slots", 0),
        )
        disp_new, disp_trk = disp_cat[:n_det], disp_cat[n_det:]
        p3_new, tri_valid = triangulate_from_disparities(
            disp_new, det_xy, new_valid, cfg.camera, pose
        )

        # stereo depth-noise prior weight: sigma_z = z^2 sigma_d / (f b)
        sigma_d = cfg.backend.stereo_prior_sigma_px
        fb = cfg.camera.focal * cfg.camera.baseline

        def prior_weight(p3, ok):
            z = geo.pose_apply(pose[None, :], p3)[:, 2]
            if sigma_d <= 0:
                return jnp.zeros_like(z)
            w = (fb / (jnp.maximum(z, 1.0) ** 2 * sigma_d)) ** 2
            return jnp.where(ok, w, 0.0)

        w_new = prior_weight(p3_new, tri_valid)

        # tracked-landmark prior refresh: this keyframe's stereo depth at each
        # tracked inlier, gated against its existing prior (a grossly
        # inconsistent match is a block-matching outlier, not evidence)
        p3_trk, trk_ok = triangulate_from_disparities(
            disp_trk, feat_xy, inlier_valid, cfg.camera, pose
        )
        prior_old = window.lm_prior[feat_ids]
        w_old = window.lm_prior_w[feat_ids]
        dist = jnp.linalg.norm(p3_trk - prior_old, axis=-1)
        z_trk = geo.pose_apply(pose[None, :], p3_trk)[:, 2]
        consistent = (w_old <= 0) | (dist < 0.25 * jnp.maximum(z_trk, 1.0))
        w_trk = jnp.where(consistent, prior_weight(p3_trk, trk_ok), 0.0)
        if not cfg.backend.stereo_prior_refresh:
            w_trk = jnp.zeros_like(w_trk)

        window, new_ids, new_ids_valid = add_keyframe(
            window, cfg.backend, pose,
            feat_xy, feat_ids, inlier_valid,
            _pad_to(det_xy, f_cap), _pad_to(p3_new, f_cap),
            _pad_to(tri_valid, f_cap), _pad_to(w_new, f_cap),
            tracked_prior_pos=p3_trk, tracked_prior_w=w_trk,
        )
        window, ba_stats = bundle_adjust(window, cfg.camera, cfg.backend)
        opt_pose = newest_pose(window)

        # tracker re-init slots: inlier tracked + new features
        # (image_processor.cpp:146-162). Flow hints ride along under the same
        # slot permutation (fresh detections have none; they borrow a
        # neighbor's at the next track_step, frontend/track._flow_hint).
        cat_xy = jnp.concatenate([feat_xy, _pad_to(det_xy, f_cap)], axis=0)
        cat_ids = jnp.concatenate([feat_ids, new_ids], axis=0)
        cat_valid = jnp.concatenate([inlier_valid, new_ids_valid], axis=0)
        cat_flow = jnp.concatenate(
            [flow_xy, jnp.zeros((f_cap, 2), flow_xy.dtype)], axis=0
        )
        cat_flow_valid = jnp.concatenate(
            [flow_valid & inlier_valid, jnp.zeros((f_cap,), bool)], axis=0
        )
        order = jnp.argsort(jnp.logical_not(cat_valid), stable=True)
        n_newlm = jnp.sum(new_ids_valid.astype(jnp.int32))
        return (
            window, pose, opt_pose,
            cat_xy[order][:f_cap], cat_ids[order][:f_cap],
            cat_valid[order][:f_cap],
            cat_flow[order][:f_cap], cat_flow_valid[order][:f_cap],
        ), (ba_stats.initial_cost, ba_stats.final_cost, ba_stats.iterations,
            n_newlm)

    # ------------------------------------------------------------------
    def _step(self, state: VOState, left, right, precomp=None
              ) -> Tuple[VOState, StepOutput]:
        """One frame. Control-flow layout is deliberate: the heavy
        arrays (image pyramids) are computed unconditionally and selected with
        cheap elementwise ``where``s, so only *small* state (window, landmark
        tables, feature slots) ever crosses a ``lax.cond`` boundary — each cond
        materializes copies of everything it carries, which dominated frame
        time in the naive nested-cond formulation.

        ``precomp = (pyramid_tuple, n_peaks)`` supplies the state-independent
        per-frame preprocessing when the caller batched it across a chunk
        (``_replay_chunk``); ``None`` (the streaming path) computes it here."""
        cfg = self.config
        f_cap = cfg.backend.feature_capacity
        left_f = left.astype(jnp.float32)
        right_f = right.astype(jnp.float32)

        # cheap every-frame bail (peak count); the full min-distance NMS is
        # deferred to the keyframe branch where its output is actually used
        from stereo_vo.ops.shi_tomasi import count_quality_peaks

        if precomp is None:
            from stereo_vo.ops.shi_tomasi import min_eig_response

            resp = min_eig_response(left_f, cfg.frontend.detect_block_size)
            n_peaks = count_quality_peaks(
                left_f, cfg.frontend.quality_level,
                cfg.frontend.detect_block_size, resp=resp,
            )
            pyr = tuple(build_pyramid(left_f, cfg.frontend.lk_max_level))
        else:
            pyr, n_peaks, resp = tuple(precomp[0]), precomp[1], precomp[2]
        n_det = jnp.minimum(n_peaks, cfg.frontend.max_detect)
        has_det = n_peaks >= cfg.frontend.min_detected

        # Track unconditionally; if the frame is skipped (under 4 detections,
        # image_processor.cpp:23-25) the tracker update is discarded below.
        tracked, stats = track_step(state.tracker, pyr, cfg.frontend)

        accept = has_det & (
            (stats.av_parallax > cfg.frontend.parallax_thresh)
            | (stats.percent_lost >= cfg.frontend.lost_thresh)
        )

        # PnP runs only on accepted frames (image_processor.cpp:71-80); its
        # inputs/outputs are small arrays, so this cond is cheap to carry.
        def run_pnp(_):
            world_pts = get_world_points(state.window, tracked.feat_ids)
            return pnp_ransac(
                world_pts, tracked.feat_xy, tracked.feat_valid,
                cfg.camera, state.pnp_pose,
                state.frame_idx.astype(jnp.uint32), cfg.frontend,
            )

        def skip_pnp(_):
            return _empty_pnp(state.pnp_pose, tracked.feat_valid.shape[0])

        res = jax.lax.cond(accept, run_pnp, skip_pnp, None)
        do_keyframe = accept & res.ok

        # ---- keyframe branch over SMALL state only -----------------------
        small = (
            state.window, state.pnp_pose, state.cur_pose,
            tracked.feat_xy, tracked.feat_ids, tracked.feat_valid,
            tracked.flow_xy, tracked.flow_valid,
        )

        def keyframe(args):
            return self._keyframe_work(left_f, right_f, res.pose, res.inliers,
                                       args, resp=resp)

        def non_keyframe(args):
            zf = jnp.array(0.0, jnp.float32)
            return args, (zf, zf, jnp.array(0, jnp.int32), jnp.array(0, jnp.int32))

        (window, pnp_pose, cur_pose, slot_xy, slot_ids, slot_valid,
         slot_flow, slot_flow_valid), (
            ba_c0, ba_c1, ba_iters, n_newlm
        ) = jax.lax.cond(do_keyframe, keyframe, non_keyframe, small)
        was_kf = do_keyframe

        # ---- reassemble tracker state with elementwise selects ------------
        # pyramid: new one unless the frame was skipped entirely
        new_pyramid = tuple(
            jnp.where(has_det, new_l, old_l)
            for new_l, old_l in zip(pyr, state.tracker.pyramid)
        )
        def sel(kf_val, track_val, old_val):
            return jnp.where(was_kf, kf_val, jnp.where(has_det, track_val, old_val))

        tr = state.tracker
        new_tracker = TrackerState(
            pyramid=new_pyramid,
            feat_xy=sel(slot_xy, tracked.feat_xy, tr.feat_xy),
            feat_ids=sel(slot_ids, tracked.feat_ids, tr.feat_ids),
            feat_valid=sel(slot_valid, tracked.feat_valid, tr.feat_valid),
            init_xy=sel(slot_xy, tr.init_xy, tr.init_xy),
            init_count=sel(
                jnp.sum(slot_valid.astype(jnp.int32)), tr.init_count, tr.init_count
            ),
            # flow belongs to the frame pair, so keyframe re-init keeps it
            # (slot-permuted through _keyframe_work)
            flow_xy=sel(slot_flow, tracked.flow_xy, tr.flow_xy),
            flow_valid=sel(slot_flow_valid, tracked.flow_valid, tr.flow_valid),
            pred_err=jnp.where(has_det, tracked.pred_err, tr.pred_err),
        )

        new_state = VOState(
            tracker=new_tracker,
            window=window,
            pnp_pose=pnp_pose,
            cur_pose=cur_pose,
            frame_idx=state.frame_idx + 1,
            initialized=state.initialized,
        )

        zero = jnp.array(0, jnp.int32)
        out = StepOutput(
            pose_cw=cur_pose,
            pose_wc=geo.pose_inverse(cur_pose),
            is_keyframe=was_kf,
            pnp_ok=jnp.where(accept, res.ok, jnp.array(True)),
            num_detected=n_det,
            num_tracked=jnp.where(has_det, stats.num_tracked, zero),
            num_inliers=jnp.where(accept, res.num_inliers, zero),
            num_new_landmarks=n_newlm,
            av_parallax=jnp.where(has_det, stats.av_parallax, 0.0),
            percent_lost=jnp.where(has_det, stats.percent_lost, 0.0),
            ba_initial_cost=ba_c0,
            ba_final_cost=ba_c1,
            ba_iterations=ba_iters,
            hinted=has_det & stats.hinted,
            track_from=tr.init_xy,
            track_to=jnp.where(has_det, tracked.feat_xy, tr.feat_xy),
            track_valid=jnp.where(was_kf, tracked.feat_valid & res.inliers,
                                  jnp.where(has_det, tracked.feat_valid, tr.feat_valid)),
        )
        return new_state, out
