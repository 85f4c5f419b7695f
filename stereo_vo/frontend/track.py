"""Feature-tracker state machine.

The device re-design of ``FeatureTracker`` (``feature_tracker.cpp:3-91``): the
dynamic feature vectors and the id->initial-position map become fixed-capacity
masked arrays in a pytree, and both LK passes (forward + backward verification)
are batched device calls.

Semantics parity (``feature_tracker.cpp:18-67``):
- tracks from the *last* image to the current one every call, accumulating
  positions; parallax is measured against the feature's position at ``init``
  (the keyframe image);
- forward-backward gate: round trip must land within ``fb_thresh`` (2 px);
- tracks with parallax > ``max_parallax`` (200 px) are dropped;
- ``percent_lost = 1 - kept / init_count``.

Deliberate fix of reference quirk #2 (SURVEY.md §2): average parallax divides
by the number of *kept* features, not attempted ones (the reference divides by
attempted, biasing its keyframe gate low as features drop). Quirk #1 (the
out-of-bounds ``feature_ids`` read) has no analog here — ids ride along in the
same masked array.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from stereo_vo.core.config import FrontendConfig
from stereo_vo.ops.lk import lk_track_fwdbwd, lk_track_pyramid

# sentinel for "no flow estimate yet" — always takes the full pyramid
_NO_FLOW = 1e9


class TrackerState(NamedTuple):
    pyramid: Tuple[jnp.ndarray, ...]  # last image pyramid (level 0..L)
    feat_xy: jnp.ndarray              # [F, 2] current positions
    feat_ids: jnp.ndarray             # [F] landmark ids
    feat_valid: jnp.ndarray           # [F]
    init_xy: jnp.ndarray              # [F, 2] positions at keyframe init
    init_count: jnp.ndarray           # [] int32 — feature count at init
    # per-feature flow of the previous step (the warm-start hint for
    # config.lk_hint_pred_err_px) and its validity
    flow_xy: jnp.ndarray              # [F, 2]
    flow_valid: jnp.ndarray           # [F]
    # [] float32 — largest |actual - predicted| flow over kept features of
    # the previous step: the gate for hinted short-pyramid tracking.
    # _NO_FLOW forces a full-pyramid pass.
    pred_err: jnp.ndarray


def _flow_hint(feat_xy, flow_xy, flow_valid):
    """Per-feature predicted flow: own previous flow, else the nearest
    tracked neighbor's (flow fields are locally smooth; fresh detections
    appear next to tracked structure). Zero when nothing is valid."""
    d2 = jnp.sum((feat_xy[:, None, :] - feat_xy[None, :, :]) ** 2, axis=-1)
    d2 = jnp.where(flow_valid[None, :], d2, jnp.float32(1e12))
    nn = jnp.argmin(d2, axis=1)
    nn_flow = jnp.take(flow_xy, nn, axis=0)
    hint = jnp.where(flow_valid[:, None], flow_xy, nn_flow)
    return jnp.where(jnp.any(flow_valid), hint, jnp.zeros_like(hint))


class TrackStats(NamedTuple):
    av_parallax: jnp.ndarray   # [] float
    percent_lost: jnp.ndarray  # [] float
    num_tracked: jnp.ndarray   # [] int32
    # [] bool — whether THIS step ran the flow-hinted short-pyramid LK path
    # (the throughput mechanism's engagement signal, surfaced per-frame so
    # replays report engagement % with zero extra measurement)
    hinted: jnp.ndarray


def tracker_init(
    pyramid: Tuple[jnp.ndarray, ...],
    xy: jnp.ndarray,
    ids: jnp.ndarray,
    valid: jnp.ndarray,
    flow_xy: Optional[jnp.ndarray] = None,
    flow_valid: Optional[jnp.ndarray] = None,
    pred_err: Optional[jnp.ndarray] = None,
) -> TrackerState:
    """Snapshot the feature set on a new keyframe (``FeatureTracker::init``).

    ``flow_xy``/``flow_valid``/``pred_err`` carry the previous step's flow
    estimates across the re-init (flow is a property of the frame pair, not
    the feature set); None means no estimate — the next step runs the full
    pyramid."""
    if flow_xy is None:
        flow_xy = jnp.zeros_like(xy)
    if flow_valid is None:
        flow_valid = jnp.zeros(xy.shape[0], bool)
    if pred_err is None:
        pred_err = jnp.array(_NO_FLOW, jnp.float32)
    return TrackerState(
        pyramid=tuple(pyramid),
        feat_xy=xy,
        feat_ids=ids,
        feat_valid=valid,
        init_xy=xy,
        init_count=jnp.sum(valid.astype(jnp.int32)),
        flow_xy=flow_xy,
        flow_valid=flow_valid,
        pred_err=pred_err,
    )


def track_step(
    state: TrackerState,
    new_pyramid: Tuple[jnp.ndarray, ...],
    cfg: FrontendConfig,
    flow_back: bool = True,
) -> Tuple[TrackerState, TrackStats]:
    """One tracking update (``FeatureTracker::track_features``)."""
    prev_pyr = list(state.pyramid)
    new_pyr = list(new_pyramid)
    kwargs = dict(
        window=cfg.lk_window, max_iters=cfg.lk_iters, eps=cfg.lk_eps,
        min_eig_threshold=cfg.lk_min_eig,
    )
    hint_thresh = getattr(cfg, "lk_hint_pred_err_px", 0.0)
    hint_levels = getattr(cfg, "lk_hint_levels", 2)
    use_hint_path = (
        flow_back and hint_thresh > 0 and 0 < hint_levels < len(prev_pyr)
    )
    hint = None
    if flow_back:
        kwargs["bwd_levels"] = getattr(cfg, "lk_bwd_levels", 0)
        if use_hint_path:
            # flow-hinted cruise tracking (config.lk_hint_pred_err_px): when
            # the previous step's flow prediction was accurate, warm-start at
            # pts + hint and run only the finest levels — the pyramid absorbs
            # the prediction error, not the absolute motion. lax.cond
            # executes ONE branch per frame.
            hint = _flow_hint(state.feat_xy, state.flow_xy, state.flow_valid)

        def run_lk(pts, val, hint_vec):
            """Width-generic fused fwd/bwd LK (hinted short pyramid when the
            prediction-error gate is open)."""
            if not use_hint_path:
                return lk_track_fwdbwd(prev_pyr, new_pyr, pts, val, **kwargs)

            def full(_):
                return lk_track_fwdbwd(prev_pyr, new_pyr, pts, val, **kwargs)

            def hinted(_):
                return lk_track_fwdbwd(
                    prev_pyr[:hint_levels], new_pyr[:hint_levels],
                    pts, val, init_flow=hint_vec,
                    bwd_from_original=True, **kwargs
                )

            return jax.lax.cond(state.pred_err < hint_thresh, hinted, full, None)

        # Live-slot compaction (config.lk_compact_slots): every LK cost —
        # region extraction, selector matmuls, the GN loop — scales with batch
        # width, and the live count sits far below capacity between
        # keyframes. Gather the valid slots (stable valid-first order) into
        # a fixed smaller batch, track there, scatter back. Per-feature
        # results are batch-position-independent, so this is exact; a frame
        # with more live features than slots takes the full-width branch.
        f = state.feat_xy.shape[0]
        k = getattr(cfg, "lk_compact_slots", 0)
        k = (k // 32) * 32
        if 0 < k < f:
            def compacted(_):
                idx = jnp.argsort(
                    jnp.logical_not(state.feat_valid), stable=True
                )[:k]
                hint_c = None if hint is None else jnp.take(hint, idx, axis=0)
                f_xy, f_ok, b_xy, b_ok = run_lk(
                    jnp.take(state.feat_xy, idx, axis=0),
                    jnp.take(state.feat_valid, idx, axis=0),
                    hint_c,
                )
                no = jnp.zeros((f,), bool)
                return (
                    state.feat_xy.at[idx].set(f_xy),
                    no.at[idx].set(f_ok),
                    state.feat_xy.at[idx].set(b_xy),
                    no.at[idx].set(b_ok),
                )

            def full_width(_):
                return run_lk(state.feat_xy, state.feat_valid, hint)

            live = jnp.sum(state.feat_valid.astype(jnp.int32))
            fwd_xy, fwd_ok, bwd_xy, bwd_ok = jax.lax.cond(
                live <= k, compacted, full_width, None
            )
        else:
            fwd_xy, fwd_ok, bwd_xy, bwd_ok = run_lk(
                state.feat_xy, state.feat_valid, hint
            )
        roundtrip = jnp.linalg.norm(state.feat_xy - bwd_xy, axis=1)
        ok = fwd_ok & bwd_ok & (roundtrip < cfg.fb_thresh)
    else:
        fwd_xy, fwd_ok = lk_track_pyramid(
            prev_pyr, new_pyr, state.feat_xy, state.feat_valid, **kwargs
        )
        ok = fwd_ok

    parallax = jnp.linalg.norm(fwd_xy - state.init_xy, axis=1)
    ok = ok & (parallax <= cfg.max_parallax)

    kept = jnp.sum(ok.astype(jnp.int32))
    av_parallax = jnp.sum(jnp.where(ok, parallax, 0.0)) / jnp.maximum(kept, 1)
    percent_lost = 1.0 - kept.astype(jnp.float32) / jnp.maximum(
        state.init_count, 1
    ).astype(jnp.float32)

    # per-feature flow + prediction-error gate for the next step. The error
    # is measured against the hint in BOTH branches (in the full branch:
    # what the hint WOULD have predicted), so the gate can engage after a
    # full-pyramid frame. The statistic is the p90 over kept features, not
    # the max: a couple of jittery features must not force the full pyramid
    # (they fail the hinted pass's region/round-trip gates and are dropped —
    # the same fate the fb gate deals unpredictable features anyway).
    # Distrust the estimate entirely (full pyramid next frame) when this
    # step kept nothing or killed >30% of its features — the mass-casualty
    # signature of motion out-running a hinted short pyramid, well above the
    # 10-20% routine attrition of fresh weak detections after a keyframe.
    step_flow = fwd_xy - state.feat_xy
    if use_hint_path:
        perr = jnp.linalg.norm(step_flow - hint, axis=1)
        desc = -jnp.sort(-jnp.where(ok, perr, -jnp.inf))     # kept errs, desc
        k90 = (kept.astype(jnp.float32) * 0.1).astype(jnp.int32)
        pred_err_now = jax.lax.dynamic_index_in_dim(
            desc, jnp.minimum(k90, perr.shape[0] - 1), keepdims=False
        )
        # loss among EXPERIENCED features only (those carrying a flow
        # estimate): fresh detections routinely die in droves right after a
        # keyframe re-init (weak corners failing the round-trip gate), and
        # counting that attrition as hint failure forced a full-pyramid
        # restart on ~half of keyframe steps. A hinted pass failing features
        # that tracked fine last frame is the actual runaway-motion signal.
        experienced = state.feat_valid & state.flow_valid
        n_prev = jnp.sum(experienced.astype(jnp.int32))
        kept_exp = jnp.sum((ok & experienced).astype(jnp.int32))
        step_loss = 1.0 - kept_exp.astype(jnp.float32) / jnp.maximum(n_prev, 1)
        pred_err = jnp.where(
            (kept == 0) | (step_loss > 0.30), jnp.float32(_NO_FLOW),
            pred_err_now,
        )
    else:
        pred_err = jnp.float32(_NO_FLOW)

    new_state = state._replace(
        pyramid=tuple(new_pyramid),
        feat_xy=jnp.where(ok[:, None], fwd_xy, state.feat_xy),
        feat_valid=ok,
        flow_xy=jnp.where(ok[:, None], step_flow, 0.0),
        flow_valid=ok,
        pred_err=pred_err,
    )
    hinted = (
        state.pred_err < hint_thresh if use_hint_path else jnp.array(False)
    )
    return new_state, TrackStats(
        av_parallax=av_parallax, percent_lost=percent_lost, num_tracked=kept,
        hinted=hinted,
    )
