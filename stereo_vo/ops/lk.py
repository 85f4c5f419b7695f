"""Batched pyramidal Lucas-Kanade optical flow.

Replaces ``cv::calcOpticalFlowPyrLK(..., Size(21,21), 3, {30 iters, eps 0.01},
0, 1e-2)`` (reference ``feature_tracker.cpp:23-26``) with a fixed-capacity
batched device op: all N features advance together through the pyramid
(coarse -> fine), each level running a whole-batch Gauss-Newton iteration loop
with per-feature convergence masking and a whole-batch early exit.

Layout:
- Each feature extracts one ``R x R`` **region** around its start point once
  per level (a vmapped ``dynamic_slice``, see ``extract_regions``), and every
  iteration samples its 21x21 window from that region with two batched
  matmuls against **bilinear "soft one-hot" selector matrices**:

      patch[n] = RowSel[n] @ region[n] @ ColSel[n]^T

  where ``RowSel[n] [21, R]`` carries ``(1-fy, fy)`` at rows ``iy, iy+1``.
  The iteration loop touches no gathers.
- The region bounds per-level refinement to ``±slack`` pixels (the pyramid
  handles large motion; a feature pushed beyond its region fails the level,
  which OpenCV's forward-backward users would reject anyway).

Algorithm parity with OpenCV:
- spatial gradients via Scharr/32 on the template (previous) image per level;
- 21x21 window, bilinear sub-pixel sampling of template and target patches;
- per-feature 2x2 normal matrix G; failure if ``min_eig(G)/win_area`` is below
  ``min_eig_threshold`` at level 0 (status false);
- iteration stops when the update norm drops below ``eps`` or at ``max_iters``;
- a feature whose tracked position leaves the image is marked lost.
"""

from __future__ import annotations

from typing import List, Tuple

import jax
import jax.numpy as jnp

from stereo_vo.ops.filters import scharr_x, scharr_y

# Per-level refinement slack in pixels: region = window + 2*slack.
# The top pyramid level absorbs the full (scaled) inter-frame motion, so it
# gets a larger budget; lower levels only refine the upsampled estimate.
LK_SLACK = 10
LK_SLACK_TOP = 26

# Gauss-Newton iterations executed per while-loop step. The loop's compute is
# tiny (one sampled patch + a 2x2 solve per feature) while every while-loop
# trip pays a fixed sequencing cost (its predicate is evaluated between
# trips), so unrolling cuts the trip count. Convergence masking is per
# sub-iteration, so results are unchanged — converged features' extra
# sub-steps are masked no-ops. Env-overridable (read at trace time).
LK_UNROLL = 3


def _lk_unroll() -> int:
    import os

    # clamp to >=1: 0 would make the unrolled body a no-op that never
    # increments the while counter — a compiled infinite loop on device.
    # NOTE: read at TRACE time; set before the engine's jitted functions
    # first trace (an in-process change after tracing is ignored by the jit
    # cache — restart the process or use a fresh engine for A/B probes).
    return max(1, int(os.environ.get("STEREO_VO_LK_UNROLL", LK_UNROLL)))


def _pad_edge(img: jnp.ndarray, m: int) -> jnp.ndarray:
    pad = [(0, 0)] * (img.ndim - 2) + [(m, m), (m, m)]
    return jnp.pad(img, pad, mode="edge")


def extract_regions(stack: jnp.ndarray, origins: jnp.ndarray, ry: int, rx: int):
    """Per-feature region extraction: ``stack [C, Hp, Wp]`` + integer
    ``origins [N, 2]`` (x, y) -> ``[N, C, RY, RX]``.

    Done once per level — the only gather in LK. Origins must lie in
    ``[0, dim - size]`` (callers clip them); ``dynamic_slice`` would clamp
    anything outside, silently shifting the region."""
    c = stack.shape[0]
    return jax.vmap(
        lambda oy, ox: jax.lax.dynamic_slice(stack, (0, oy, ox), (c, ry, rx))
    )(origins[:, 1], origins[:, 0])


def _sample_template(regions: jnp.ndarray, pos: jnp.ndarray, win: int):
    """Sample the template window AND its Scharr gradients from a 1-channel
    region stack ``[N, 1, RY, RX]`` at window top-left ``pos`` (region coords).

    Key identity: all template samples lie on one uniformly-shifted integer
    lattice, and bilinear interpolation is linear and shift-invariant there,
    so discrete convolution commutes with the sampling — Scharr of the sampled
    (win+2)^2 patch equals bilinear sampling of the full-image Scharr. This
    replaces per-level 3-channel gradient-region extraction (+ full-region
    Scharr + channel stacking, together the largest memory traffic in LK)
    with one 1-channel sample and a tiny per-patch filter.

    Returns ``(t_patch, gx, gy)`` each ``[N, win, win]``.

    ``pos - 1`` is in-bounds by construction (callers pad with
    ``m = half + slack + 2`` and size regions at ``win + 2 + 2*slack + 9``
    rounded up to 8); an out-of-range index would select zero weight rows,
    zeroing the patch and failing the feature via the min-eig gate rather
    than silently sampling at a shifted offset."""
    wt = win + 2
    patch = _sample(regions, pos - 1.0, wt)[:, 0]  # [N, win+2, win+2]
    gx = scharr_x(patch)[..., 1:-1, 1:-1]
    gy = scharr_y(patch)[..., 1:-1, 1:-1]
    return patch[..., 1:-1, 1:-1], gx, gy


def _soft_selector(idx: jnp.ndarray, frac: jnp.ndarray, win: int, r_size: int):
    """Bilinear selector matrices ``[N, win, R]``: row i has weight ``1-frac``
    at column ``idx + i`` and ``frac`` at ``idx + i + 1``."""
    i = jax.lax.broadcasted_iota(jnp.int32, (win, r_size), 0)
    j = jax.lax.broadcasted_iota(jnp.int32, (win, r_size), 1)
    d = (j - i)[None, :, :]                      # [1, win, R]
    idx = idx[:, None, None]
    frac = frac[:, None, None]
    return jnp.where(d == idx, 1.0 - frac, 0.0) + jnp.where(d == idx + 1, frac, 0.0)


# Matmul precision of the two sampling einsums, read at trace time. HIGHEST
# keeps full f32; DEFAULT would let the GPU run them in TF32. On an H100,
# TF32 missed the parity bound against the f32 CPU reference (p99 0.076 px
# over 411 tracked features, bound 0.05 px) for a 15 % shorter LK call; see
# benchmarks/lk_precision_ab.py. chip_smoke.py (phase c) checks the bound.
SAMPLE_PRECISION = jax.lax.Precision.HIGHEST


def _sample(regions: jnp.ndarray, pos: jnp.ndarray, win: int):
    """Sample ``[N, C, win, win]`` windows from ``[N, C, RY, RX]`` regions at
    continuous region coordinates ``pos [N, 2]`` (x, y of window top-left)."""
    ry, rx = regions.shape[-2], regions.shape[-1]
    x0 = jnp.floor(pos[:, 0])
    y0 = jnp.floor(pos[:, 1])
    fx = pos[:, 0] - x0
    fy = pos[:, 1] - y0
    rowsel = _soft_selector(y0.astype(jnp.int32), fy, win, ry)  # [N, w, RY]
    colsel = _soft_selector(x0.astype(jnp.int32), fx, win, rx)  # [N, w, RX]
    tmp = jnp.einsum("nar,ncrs->ncas", rowsel, regions,
                     preferred_element_type=jnp.float32,
                     precision=SAMPLE_PRECISION)
    return jnp.einsum("ncas,nbs->ncab", tmp, colsel,
                      preferred_element_type=jnp.float32,
                      precision=SAMPLE_PRECISION)


def _center_regions(prev_reg: jnp.ndarray, next_reg: jnp.ndarray):
    """Subtract each feature's prev-region mean from BOTH images' regions.

    The GN update divides tiny patch DIFFERENCES of large pixel values, so
    low-precision matmul operands hurt it most at large magnitudes. Shifting
    both regions by the same per-feature constant leaves di = J - T and the
    Scharr gradients mathematically unchanged but shrinks operand magnitude
    from ~128 (DC) to the local contrast (~±30), cutting the rounding of
    reduced-precision sampling ~4x. Regions are 1-channel [N, 1, R, R]."""
    c = jnp.mean(prev_reg[:, 0], axis=(-2, -1))[:, None, None, None]
    return prev_reg - c, next_reg - c


def _lk_level(
    prev_img, next_img, img_shape, pts_prev, guess, active, half: int,
    slack: int, max_iters: int, eps: float, min_eig_threshold: float,
    is_level0: bool,
):
    """One pyramid level of LK for all features (region + matmul sampling)."""
    h, w = img_shape
    win = 2 * half + 1
    # square region, 8-aligned size: (window + gradient ring) + slack each side
    # + bilinear margin + up to 7 px alignment residual per axis. The 8-px
    # alignment of sizes and origins is kept only because the sampling
    # positions, and hence trajectories, depend on it.
    rx = ry = ((win + 2 + 2 * slack + 9) + 7) // 8 * 8
    m = half + slack + 2                 # image pad (incl. gradient ring)

    prev_p = _pad_edge(prev_img[None], m)
    next_p = _pad_edge(next_img[None], m)
    hp, wp = prev_p.shape[-2:]

    # Region origin (padded coords): centered on the *template* point for prev,
    # on the initial guess for next, aligned down to a multiple of 8 (see the
    # region size above).
    def origins(centers):
        ox = jnp.floor(centers[:, 0]).astype(jnp.int32) - half - slack + m
        ox = jnp.clip((ox // 8) * 8, 0, wp - rx)
        oy = jnp.floor(centers[:, 1]).astype(jnp.int32) - half - slack + m
        oy = jnp.clip((oy // 8) * 8, 0, hp - ry)
        return jnp.stack([ox, oy], axis=1)

    prev_org = origins(pts_prev)
    next_org = origins(guess)
    prev_reg = extract_regions(prev_p, prev_org, ry, rx)    # [N, 1, RY, RX]
    next_reg = extract_regions(next_p, next_org, ry, rx)    # [N, 1, RY, RX]
    prev_reg, next_reg = _center_regions(prev_reg, next_reg)

    # Continuous region coordinates of a window top-left for image point p:
    # (p - half) + m - origin.
    tpl_pos = pts_prev - half + m - prev_org.astype(pts_prev.dtype)
    guess, solvable, in_region = _gn_pass(
        prev_reg, next_reg, tpl_pos, guess, active, half,
        max_iters, eps, min_eig_threshold, next_org, m,
    )

    # OpenCV only kills a feature when its point leaves the image; our region
    # bound additionally fails features that ran off their slack window.
    inside = (
        (guess[:, 0] >= 0) & (guess[:, 0] <= w - 1)
        & (guess[:, 1] >= 0) & (guess[:, 1] <= h - 1)
    ) & in_region(guess)
    if is_level0:
        ok = solvable & inside
    else:
        ok = active  # higher levels don't kill features, they just stop helping
    return guess, ok


def lk_track_pyramid(
    prev_pyr: List[jnp.ndarray],
    next_pyr: List[jnp.ndarray],
    pts: jnp.ndarray,
    valid: jnp.ndarray,
    window: int = 21,
    max_iters: int = 30,
    eps: float = 0.01,
    min_eig_threshold: float = 1e-2,
    slack: int = LK_SLACK,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Track ``pts [N, 2]`` from ``prev_pyr`` to ``next_pyr``.

    Returns ``(tracked [N, 2], status [N] bool)``. Invalid input slots stay
    invalid. Pyramids are lists level0..levelL of float32 images (level 0 full
    resolution); gradients are computed internally per level.
    """
    half = window // 2
    n_levels = len(prev_pyr)
    scale_top = float(2 ** (n_levels - 1))
    guess = pts / scale_top
    ok = valid
    for lvl in range(n_levels - 1, -1, -1):
        lvl_slack = LK_SLACK_TOP if lvl == n_levels - 1 else slack
        prev_img = prev_pyr[lvl]
        next_img = next_pyr[lvl]
        pts_l = pts / float(2 ** lvl)
        guess, ok = _lk_level(
            prev_img, next_img, prev_img.shape, pts_l, guess, ok, half, lvl_slack,
            max_iters, eps, min_eig_threshold, is_level0=(lvl == 0),
        )
        if lvl > 0:
            guess = guess * 2.0
    return guess, ok & valid


# ---------------------------------------------------------------------------
# Fused forward + backward tracking (the frontend's hot path).
#
# Per level, only TWO region extractions happen (prev + gradients at the
# feature points; next + gradients at the forward entry guesses) and both
# passes sample from them: forward templates from the prev regions and
# J-patches from the next regions; the backward pass reuses the *same* regions
# with roles swapped (its start points — the forward endpoints — lie within
# the next regions because per-level movement is bounded by the slack, and its
# targets approach the prev regions' centers). Region extraction is the only
# gather in LK, and this halves it.
# ---------------------------------------------------------------------------


# Straggler compaction: after this many iterations the (few) features that
# haven't converged — typically patches whose appearance scales between
# frames, which pure-translation LK circles around — continue in a compacted
# batch of this many slots. Every GN iteration re-reads the whole region set,
# so shrinking the live batch makes the long convergence tail cheaper without
# changing any feature's iteration sequence. Must be a multiple of LK_UNROLL.
# With 3, on low-occupancy frames (<=128 live features — the common cruise
# regime) the whole live set compacts after one unrolled step.
LK_COMPACT_AFTER = 3
LK_COMPACT_K = 128


def _lk_compact_after() -> int:
    import os

    # trace-time read — see _lk_unroll's note on the jit cache
    return int(os.environ.get("STEREO_VO_LK_COMPACT_AFTER", LK_COMPACT_AFTER))


def _gn_loop(regions_j, tpl3, invs, solvable, org_f, guess, prev_step,
             converged, it0, half, m, max_iters, eps):
    """Masked whole-batch GN iteration from ``it0`` until ``max_iters`` or all
    converged. Shapes follow the inputs, so it runs full-size or compacted."""
    win = 2 * half + 1
    ry, rx = regions_j.shape[-2], regions_j.shape[-1]
    t_patch, gx_p, gy_p = tpl3
    inv11, inv12, inv22 = invs

    def in_region(g):
        pos = g - half + m - org_f
        return (
            (pos[:, 0] >= 0) & (pos[:, 0] <= rx - win - 1)
            & (pos[:, 1] >= 0) & (pos[:, 1] <= ry - win - 1)
        )

    def body(state):
        guess, converged, prev_step, it = state
        pos = jnp.clip(guess - half + m - org_f, 0.0, None)
        pos = jnp.minimum(pos, jnp.array([rx - win - 1, ry - win - 1], pos.dtype))
        j_patch = _sample(regions_j, pos, win)[:, 0]
        di = j_patch - t_patch
        bx = jnp.sum(di * gx_p, axis=(1, 2))
        by = jnp.sum(di * gy_p, axis=(1, 2))
        step = jnp.stack(
            [-(inv11 * bx + inv12 * by), -(inv12 * bx + inv22 * by)], axis=-1
        )
        # OpenCV's oscillation break (see _lk_level.body)
        osc = (it > 0) & (jnp.sum(step * prev_step, axis=-1) < -0.01)
        step = jnp.where(osc[:, None], 0.5 * step, step)
        # `it < max_iters` keeps the exact iteration cap under unrolling
        upd = solvable & ~converged & (it < max_iters)
        new_guess = jnp.where(upd[:, None], guess + step, guess)
        small = jnp.sum(step * step, axis=-1) < eps * eps
        return (new_guess, converged | small | osc | ~in_region(new_guess) | ~solvable,
                jnp.where(upd[:, None], step, prev_step), it + 1)

    def body_unrolled(state):
        for _ in range(_lk_unroll()):
            state = body(state)
        return state

    def cond(state):
        _, converged, _, it = state
        return (it < max_iters) & ~jnp.all(converged)

    return jax.lax.while_loop(
        cond, body_unrolled, (guess, converged, prev_step, it0)
    )


def _gn_iterate(tpl, regions_j, guess, active, half,
                max_iters, eps, min_eig_threshold, region_org_j, m):
    """Shared Gauss-Newton loop: precomputed template triple ``tpl``
    (patch, gx, gy), iterate guess over 1-channel ``regions_j`` (image
    coords). Runs a full-batch phase, then continues the non-converged
    stragglers in a compacted batch (see LK_COMPACT_AFTER)."""
    win = 2 * half + 1
    n = guess.shape[0]
    ry, rx = regions_j.shape[-2], regions_j.shape[-1]
    win_area = float(win * win)

    t_patch, gx_p, gy_p = tpl

    g11 = jnp.sum(gx_p * gx_p, axis=(1, 2))
    g12 = jnp.sum(gx_p * gy_p, axis=(1, 2))
    g22 = jnp.sum(gy_p * gy_p, axis=(1, 2))
    tr = g11 + g22
    det = g11 * g22 - g12 * g12
    min_eig = (tr - jnp.sqrt(jnp.maximum(tr * tr - 4 * det, 0.0))) * 0.5
    eig_ok = (min_eig / win_area) >= min_eig_threshold
    det_ok = det > 1e-12
    solvable = eig_ok & det_ok & active

    safe_det = jnp.where(det_ok, det, 1.0)
    inv11 = jnp.where(det_ok, g22 / safe_det, 0.0)
    inv12 = jnp.where(det_ok, -g12 / safe_det, 0.0)
    inv22 = jnp.where(det_ok, g11 / safe_det, 0.0)

    org = region_org_j.astype(guess.dtype)

    def in_region(g):
        pos = g - half + m - org
        return (
            (pos[:, 0] >= 0) & (pos[:, 0] <= rx - win - 1)
            & (pos[:, 1] >= 0) & (pos[:, 1] <= ry - win - 1)
        )

    k = LK_COMPACT_K
    compact_after = _lk_compact_after()
    phase1_end = compact_after if (max_iters > compact_after and n > k) \
        else max_iters
    guess, converged, prev_step, it = _gn_loop(
        regions_j, tpl, (inv11, inv12, inv22), solvable, org,
        guess, jnp.zeros_like(guess), ~solvable, 0, half, m, phase1_end, eps,
    )
    if phase1_end >= max_iters:
        return guess, solvable, in_region

    pending = ~converged

    def compact_continue(args):
        guess, converged, prev_step = args
        # stable rank: pending features first; an exact row gather
        idx = jnp.argsort(jnp.logical_not(pending), stable=True)[:k]
        take = lambda a: jnp.take(a, idx, axis=0)
        g_c, conv_c, ps_c, _ = _gn_loop(
            take(regions_j), (take(t_patch), take(gx_p), take(gy_p)),
            (take(inv11), take(inv12), take(inv22)), take(solvable),
            take(org), take(guess), take(prev_step), take(converged),
            phase1_end, half, m, max_iters, eps,
        )
        # scatter back: non-gathered slots were already converged; gathered
        # already-converged slots write back their unchanged values
        return guess.at[idx].set(g_c), converged.at[idx].set(conv_c), \
            prev_step.at[idx].set(ps_c)

    def full_continue(args):
        guess, converged, prev_step = args
        g, c, p, _ = _gn_loop(
            regions_j, tpl, (inv11, inv12, inv22), solvable, org,
            guess, prev_step, converged, phase1_end, half, m, max_iters, eps,
        )
        return g, c, p

    # overflow fallback: more stragglers than compacted slots (rare) — finish
    # at full batch size so no feature is silently truncated
    guess, converged, prev_step = jax.lax.cond(
        jnp.sum(pending) <= k, compact_continue, full_continue,
        (guess, converged, prev_step),
    )
    return guess, solvable, in_region


def _gn_pass(tpl_reg, it_reg, tpl_pos, guess, active, half,
             max_iters, eps, min_eig_threshold, it_org, m):
    """One template-sample + GN-iterate level pass; returns
    ``(guess', solvable, in_region)``."""
    win = 2 * half + 1
    tpl = _sample_template(tpl_reg, tpl_pos, win)
    return _gn_iterate(tpl, it_reg, guess, active, half,
                       max_iters, eps, min_eig_threshold, it_org, m)


def lk_track_fwdbwd(
    prev_pyr: List[jnp.ndarray],
    next_pyr: List[jnp.ndarray],
    pts: jnp.ndarray,
    valid: jnp.ndarray,
    window: int = 21,
    max_iters: int = 30,
    eps: float = 0.01,
    min_eig_threshold: float = 1e-2,
    slack: int = LK_SLACK,
    slack_top: int = LK_SLACK_TOP,
    bwd_levels: int = 0,
    init_flow=None,
    bwd_from_original: bool = False,
):
    """Forward track + backward verification in one fused pass.

    Returns ``(tracked [N, 2], fwd_ok [N], back [N, 2], bwd_ok [N])`` — the
    backward result is the round-trip endpoint for the 2 px gate
    (``feature_tracker.cpp:31-47``).

    ``bwd_levels`` limits the backward verification to the finest L pyramid
    levels (0 / >=n_levels = all of them: OpenCV's exact coarse-to-fine
    semantics, initialized at the forward endpoint). A truncated backward
    pass initializes at the forward endpoint scaled to its top level and
    saves the coarsest level passes; level passes are the dominant LK cost.
    NOTE: verifying at level 0 ONLY measured as too permissive — features
    whose appearance scales between frames round-trip within the gate yet
    carry poor positions, degrading trajectory accuracy — so keep >= 2.

    ``init_flow [N, 2]`` warm-starts the forward search at ``pts +
    init_flow`` (predicted flow from the previous frame): with a good
    prediction the pyramid only needs to absorb the PREDICTION ERROR, not
    the absolute motion, so callers can drop coarse levels entirely on
    cruise frames. OpenCV's semantics (init at ``pts``) is ``init_flow=None``;
    a converged run reaches the same fixed point either way, and the
    round-trip gate still verifies every track. ``bwd_from_original`` forces
    the truncated backward semantics (init at the ORIGINAL point) even when
    ``bwd_levels >= n_levels`` — required with short hinted pyramids, where
    walking the full motion backward from the endpoint would exceed the
    top level's convergence basin.
    """
    half = window // 2
    n_levels = len(prev_pyr)
    win = 2 * half + 1
    if bwd_levels <= 0:
        bwd_levels = n_levels

    # ---------- forward pass, caching regions per level
    scale_top = float(2 ** (n_levels - 1))
    guess = (pts if init_flow is None else pts + init_flow) / scale_top
    ok = valid
    cache = []
    for lvl in range(n_levels - 1, -1, -1):
        lvl_slack = slack_top if lvl == n_levels - 1 else slack
        m = half + lvl_slack + 2
        rx = ry = ((win + 2 + 2 * lvl_slack + 9) + 7) // 8 * 8
        prev_img = prev_pyr[lvl]
        next_img = next_pyr[lvl]
        h, w = prev_img.shape
        prev_p = _pad_edge(prev_img[None], m)
        next_p = _pad_edge(next_img[None], m)
        hp, wp = prev_p.shape[-2:]

        def origins(centers):
            ox = jnp.floor(centers[:, 0]).astype(jnp.int32) - half - lvl_slack + m
            ox = jnp.clip((ox // 8) * 8, 0, wp - rx)
            oy = jnp.floor(centers[:, 1]).astype(jnp.int32) - half - lvl_slack + m
            oy = jnp.clip((oy // 8) * 8, 0, hp - ry)
            return jnp.stack([ox, oy], axis=1)

        pts_l = pts / float(2 ** lvl)
        prev_org = origins(pts_l)
        next_org = origins(guess)
        # 1-channel regions: forward templates differentiate the sampled prev
        # patch, backward templates the sampled next patch (roles swap) — see
        # _sample_template for why in-patch Scharr is exact
        prev_reg = extract_regions(prev_p, prev_org, ry, rx)
        next_reg = extract_regions(next_p, next_org, ry, rx)
        prev_reg, next_reg = _center_regions(prev_reg, next_reg)
        if lvl < bwd_levels:
            cache.append((lvl, prev_reg, next_reg, prev_org, next_org, (h, w), m))

        tpl_pos = pts_l - half + m - prev_org.astype(pts.dtype)
        guess, solvable, in_region = _gn_pass(
            prev_reg, next_reg, tpl_pos, guess, ok, half,
            max_iters, eps, min_eig_threshold, next_org, m,
        )
        if lvl == 0:
            inside = (
                (guess[:, 0] >= 0) & (guess[:, 0] <= w - 1)
                & (guess[:, 1] >= 0) & (guess[:, 1] <= h - 1)
            ) & in_region(guess)
            fwd_ok = solvable & inside & valid
        if lvl > 0:
            guess = guess * 2.0
    tracked = guess

    # ---------- backward pass over the cached regions (roles swapped).
    # Full depth initializes at the forward endpoint (OpenCV semantics); a
    # truncated pass instead initializes at the ORIGINAL point scaled to its
    # top level — the round-trip answer the 2 px gate tests for — because
    # without the coarse levels the backward flow cannot walk a large motion
    # within the per-level slack. The remaining coarse level(s) still verify
    # appearance-consistency before level 0 confirms the position.
    bguess = (
        tracked if (bwd_levels >= n_levels and not bwd_from_original) else pts
    ) / float(2 ** (bwd_levels - 1))
    bok = fwd_ok
    for (lvl, prev_reg, next_reg, prev_org, next_org, (h, w), m) in cache:
        tracked_l = tracked / float(2 ** lvl)
        # backward template: next image at the forward endpoint (inside the
        # next region as long as the per-level motion stayed within slack;
        # an endpoint that ran out samples a zeroed patch and fails min-eig)
        tpl_pos = tracked_l - half + m - next_org.astype(pts.dtype)
        bguess, bsolv, b_in_region = _gn_pass(
            next_reg, prev_reg, tpl_pos, bguess, bok, half,
            max_iters, eps, min_eig_threshold, prev_org, m,
        )
        if lvl == 0:
            binside = (
                (bguess[:, 0] >= 0) & (bguess[:, 0] <= w - 1)
                & (bguess[:, 1] >= 0) & (bguess[:, 1] <= h - 1)
            ) & b_in_region(bguess)
            bwd_ok = bsolv & binside & fwd_ok
        if lvl > 0:
            bguess = bguess * 2.0

    return tracked, fwd_ok, bguess, bwd_ok
