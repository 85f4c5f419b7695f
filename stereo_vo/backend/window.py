"""Sliding-window bundle-adjustment state.

Device-side re-design of the reference backend's dynamic data model
(``bundle_adjuster.hpp:22-75,134-149``): the C++ heap of ``PoseVariable``s,
refcounted ``Feature`` pointers and an ``avail_ids`` free-list becomes one
fixed-shape pytree of masked arrays, so every mutation (add keyframe, evict,
recycle ids) is a compiled scatter/gather with **no host round-trips**:

- ``poses``       ``[W, 7]``    T_cw per keyframe, chronological (oldest at 0)
- ``obs_uv/lm``   ``[W, F, 2] / [W, F]`` per-keyframe observations -> landmark ids
- ``lm_pos``      ``[L, 3]``    landmark table (the ``features`` vector + free-list)
- ``lm_refcount`` ``[L]``       windowed observation count (``Feature::refcount``)

Deliberate fixes to reference quirks (SURVEY.md §2 "Behavioral quirks"):
- quirk #3: a new landmark's refcount starts at exactly 1 (the reference
  double-increments at ``bundle_adjuster.cpp:113,116`` so slots leak forever);
  here eviction really frees slots and ids recycle (lowest index first, the
  deterministic analog of the ``avail_ids`` stack).
- quirk #4: the ``max_features`` cap truncates features, 3d points and ids
  coherently (the reference zero-fills ids at ``bundle_adjuster.cpp:89,115``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from stereo_vo.core.config import BackendConfig


class WindowState(NamedTuple):
    poses: jnp.ndarray        # [W, 7] float
    pose_valid: jnp.ndarray   # [W] bool
    obs_uv: jnp.ndarray       # [W, F, 2] float
    obs_lm: jnp.ndarray       # [W, F] int32
    obs_valid: jnp.ndarray    # [W, F] bool
    lm_pos: jnp.ndarray       # [L, 3] float
    lm_refcount: jnp.ndarray  # [L] int32
    lm_valid: jnp.ndarray     # [L] bool
    # Stereo-triangulation prior per landmark: position at creation and an
    # isotropic inverse variance derived from the stereo depth-noise model.
    # The reference discards the stereo measurement after initialization,
    # leaving its monocular-factor BA with a free scale mode that drifts; the
    # prior anchors it (deliberate accuracy fix, weight configurable).
    lm_prior: jnp.ndarray     # [L, 3] float
    lm_prior_w: jnp.ndarray   # [L] float (1/sigma^2; 0 = no prior)
    num_kf: jnp.ndarray       # [] int32, total keyframes ever added
    # [] float — LM damping λ carried across solves (warm start): consecutive
    # window problems share all but one keyframe, so the damping regime that
    # worked last solve is the right opening bid, skipping the reject ramp
    # that a fixed init_damping pays each keyframe. None = no carried λ
    # (cfg.init_damping used; the field stays None for hand-built windows).
    ba_lam: jnp.ndarray = None

    @property
    def window_size(self) -> int:
        return self.poses.shape[0]

    @property
    def feature_capacity(self) -> int:
        return self.obs_uv.shape[1]

    @property
    def landmark_capacity(self) -> int:
        return self.lm_pos.shape[0]


def empty_window(cfg: BackendConfig, dtype=jnp.float32) -> WindowState:
    w, f, l = cfg.window_size, cfg.feature_capacity, cfg.landmark_capacity
    return WindowState(
        poses=jnp.tile(jnp.array([1.0, 0, 0, 0, 0, 0, 0], dtype), (w, 1)),
        pose_valid=jnp.zeros((w,), bool),
        obs_uv=jnp.zeros((w, f, 2), dtype),
        obs_lm=jnp.zeros((w, f), jnp.int32),
        obs_valid=jnp.zeros((w, f), bool),
        lm_pos=jnp.zeros((l, 3), dtype),
        lm_refcount=jnp.zeros((l,), jnp.int32),
        lm_valid=jnp.zeros((l,), bool),
        lm_prior=jnp.zeros((l, 3), dtype),
        lm_prior_w=jnp.zeros((l,), dtype),
        num_kf=jnp.array(0, jnp.int32),
        ba_lam=jnp.array(cfg.init_damping, dtype),
    )


def _compact(valid: jnp.ndarray, *arrays: jnp.ndarray):
    """Stable-pack valid entries to the front along axis 0.

    Returns the packed validity mask and each packed array; invalid tail
    entries are gathered from arbitrary (masked-off) slots.
    """
    order = jnp.argsort(jnp.logical_not(valid), stable=True)
    return (valid[order],) + tuple(a[order] for a in arrays)


def add_keyframe(
    state: WindowState,
    cfg: BackendConfig,
    pose: jnp.ndarray,
    tracked_uv: jnp.ndarray,
    tracked_lm: jnp.ndarray,
    tracked_valid: jnp.ndarray,
    new_uv: jnp.ndarray,
    new_p3: jnp.ndarray,
    new_valid: jnp.ndarray,
    new_prior_w: jnp.ndarray = None,
    tracked_prior_pos: jnp.ndarray = None,
    tracked_prior_w: jnp.ndarray = None,
) -> Tuple[WindowState, jnp.ndarray, jnp.ndarray]:
    """Add a keyframe; evict the oldest pose if the window overflows.

    Mirrors ``BundleAdjuster::add_keyframe`` + ``remove_oldest_pose``
    (``bundle_adjuster.cpp:41-135``): tracked observations re-reference live
    landmarks; new features claim recycled landmark ids; the per-keyframe
    observation count is capped at ``cfg.max_features`` by truncating new
    features (``bundle_adjuster.cpp:85-90``).

    All inputs are fixed-capacity ``[F, ...]`` arrays with validity masks.
    Returns ``(new_state, new_ids [F], new_ids_valid [F])`` — the landmark ids
    assigned to the new features (for tracker re-init, ``image_processor.cpp:156-162``).
    """
    f_cap = state.feature_capacity

    # --- cap new features: max_new = max_features - num_tracked (coherently).
    num_tracked = jnp.sum(tracked_valid.astype(jnp.int32))
    max_new = jnp.maximum(cfg.max_features - num_tracked, 0)
    new_rank = jnp.cumsum(new_valid.astype(jnp.int32)) - 1  # rank among valid
    new_valid = new_valid & (new_rank < max_new)

    # --- allocate landmark ids for new features: lowest free slots first
    # (deterministic analog of the avail_ids stack, bundle_adjuster.cpp:98-107).
    # Allocation is clamped to the number of currently-free slots (allocation
    # runs before this keyframe's eviction, so the count is conservative);
    # without the clamp, overflow ranks would index into *live* slots and
    # silently clobber landmarks still referenced by window observations.
    num_free = state.landmark_capacity - jnp.sum(state.lm_valid.astype(jnp.int32))
    new_valid = new_valid & (new_rank < num_free)
    free_order = jnp.argsort(state.lm_valid, stable=True)  # invalid slots first
    new_ids = free_order[jnp.clip(new_rank, 0, state.landmark_capacity - 1)]
    new_ids = jnp.where(new_valid, new_ids, 0)
    # Scatter target: invalid entries go to an out-of-bounds dump index so XLA
    # drops them (a masked write to slot 0 would race with the real write).
    scat_ids = jnp.where(new_valid, new_ids, state.landmark_capacity)

    # --- write new landmarks (refcount = exactly 1: quirk #3 fixed).
    lm_pos = state.lm_pos.at[scat_ids].set(new_p3, mode="drop")
    lm_refcount = state.lm_refcount.at[scat_ids].add(1, mode="drop")
    lm_valid = state.lm_valid.at[scat_ids].set(True, mode="drop")
    if new_prior_w is None:
        new_prior_w = jnp.zeros(new_valid.shape, state.lm_prior_w.dtype)
    lm_prior = state.lm_prior
    lm_prior_w = state.lm_prior_w

    # --- stereo-prior refresh for TRACKED landmarks (beyond the reference,
    # which only triangulates features at birth, image_processor.cpp:137-142):
    # every keyframe's block-matching depth at a tracked inlier is an
    # independent stereo measurement of its landmark, fused into the prior as
    # an information filter (weights are inverse variances), so the scale
    # anchor tightens with every observation instead of freezing at birth.
    if tracked_prior_w is not None:
        tw = jnp.where(tracked_valid, tracked_prior_w, 0.0)
        t_scat = jnp.where(tw > 0, tracked_lm, state.landmark_capacity)
        num = lm_prior * lm_prior_w[:, None]
        num = num.at[t_scat].add(tw[:, None] * tracked_prior_pos, mode="drop")
        lm_prior_w = lm_prior_w.at[t_scat].add(tw, mode="drop")
        lm_prior = jnp.where(
            (lm_prior_w > 0)[:, None],
            num / jnp.maximum(lm_prior_w, 1e-20)[:, None],
            lm_prior,
        )

    lm_prior = lm_prior.at[scat_ids].set(new_p3, mode="drop")
    lm_prior_w = lm_prior_w.at[scat_ids].set(new_prior_w, mode="drop")

    # --- tracked features: bump refcounts (bundle_adjuster.cpp:77).
    lm_refcount = lm_refcount.at[jnp.where(tracked_valid, tracked_lm, 0)].add(
        jnp.where(tracked_valid, 1, 0)
    )

    # --- build this keyframe's packed observation row: tracked first, then new.
    cat_uv = jnp.concatenate([tracked_uv, new_uv], axis=0)
    cat_lm = jnp.concatenate([tracked_lm, new_ids], axis=0)
    cat_valid = jnp.concatenate([tracked_valid, new_valid], axis=0)
    row_valid, row_uv, row_lm = _compact(cat_valid, cat_uv, cat_lm)
    row_valid, row_uv, row_lm = row_valid[:f_cap], row_uv[:f_cap], row_lm[:f_cap]
    row_valid = row_valid & (jnp.cumsum(row_valid.astype(jnp.int32)) <= cfg.max_features)

    # --- insert into the window (chronological layout, oldest at index 0).
    window_full = state.num_kf >= state.window_size

    def insert_not_full(st):
        idx = state.num_kf
        return st._replace(
            poses=st.poses.at[idx].set(pose),
            pose_valid=st.pose_valid.at[idx].set(True),
            obs_uv=st.obs_uv.at[idx].set(row_uv),
            obs_lm=st.obs_lm.at[idx].set(row_lm),
            obs_valid=st.obs_valid.at[idx].set(row_valid),
        )

    def insert_full(st):
        # Evict oldest (index 0): decrement its landmarks' refcounts; free
        # zero-ref landmarks (remove_oldest_pose, bundle_adjuster.cpp:41-58).
        ev_lm = jnp.where(st.obs_valid[0], st.obs_lm[0], 0)
        rc = st.lm_refcount.at[ev_lm].add(jnp.where(st.obs_valid[0], -1, 0))
        valid = st.lm_valid & (rc > 0)
        rc = jnp.maximum(rc, 0)
        last = state.window_size - 1
        return st._replace(
            poses=jnp.roll(st.poses, -1, axis=0).at[last].set(pose),
            pose_valid=st.pose_valid,
            obs_uv=jnp.roll(st.obs_uv, -1, axis=0).at[last].set(row_uv),
            obs_lm=jnp.roll(st.obs_lm, -1, axis=0).at[last].set(row_lm),
            obs_valid=jnp.roll(st.obs_valid, -1, axis=0).at[last].set(row_valid),
            lm_refcount=rc,
            lm_valid=valid,
        )

    mid = state._replace(lm_pos=lm_pos, lm_refcount=lm_refcount, lm_valid=lm_valid,
                         lm_prior=lm_prior, lm_prior_w=lm_prior_w)
    out = jax.lax.cond(window_full, insert_full, insert_not_full, mid)
    out = out._replace(num_kf=state.num_kf + 1)
    return out, new_ids, new_valid


def newest_pose(state: WindowState) -> jnp.ndarray:
    """The most recent keyframe's T_cw (the only pose the reference publishes,
    ``bundle_adjuster.cpp:146-153``)."""
    idx = jnp.clip(state.num_kf - 1, 0, state.window_size - 1)
    return state.poses[idx]


def get_world_points(state: WindowState, ids: jnp.ndarray) -> jnp.ndarray:
    """Landmark id -> 3d position lookup (``bundle_adjuster.cpp:159-163``)."""
    return state.lm_pos[ids]
