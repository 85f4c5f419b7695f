"""Block-matching stereo disparity (cv::StereoBM equivalent).

Replaces ``StereoBM::create(48, 21)`` + ``compute`` (reference
``image_processor.cpp:173-176``) with a vectorized device kernel that keeps
OpenCV's validity semantics so the same landmarks get triangulated:

- XSobel prefilter clipped to ``[0, 2*prefilter_cap]`` (OpenCV default cap 31);
- 21x21 SAD block match over ``num_disparities`` candidates (cumsum box sums,
  vectorized over the disparity axis);
- texture threshold: windows with too little |XSobel| energy are invalid;
- uniqueness ratio: best SAD must beat every candidate outside ``d ± 1`` by
  ``(1 + ratio/100)`` or the pixel is invalid;
- sub-pixel refinement by parabola fit around the best disparity;
- invalid pixels return -1.0 (the reference keeps features with ``disp > 0``,
  ``image_processor.cpp:194``).

The left image border of width ``num_disparities + radius`` cannot see a full
search range and is handled by masking impossible shifts.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from stereo_vo.ops.filters import box_filter, box_sum_tree, sobel_x


def _xsobel_prefilter(img: jnp.ndarray, cap: int) -> jnp.ndarray:
    s = sobel_x(img.astype(jnp.float32), mode="reflect")
    return jnp.clip(s + cap, 0.0, 2.0 * cap)


def stereo_bm_disparity(
    left: jnp.ndarray,
    right: jnp.ndarray,
    num_disparities: int = 48,
    block_size: int = 21,
    prefilter_cap: int = 31,
    texture_threshold: int = 10,
    uniqueness_ratio: int = 15,
) -> jnp.ndarray:
    """Dense float32 disparity of the left image; invalid pixels = -1.0."""
    h, w = left.shape
    radius = block_size // 2
    cap = float(prefilter_cap)

    lpre = _xsobel_prefilter(left, prefilter_cap)
    rpre = _xsobel_prefilter(right, prefilter_cap)

    # SAD cost volume [D, H, W]: right shifted by d, |diff| box-summed. The
    # shift is a *static* slice of a left-padded image per (unrolled) d and
    # the 21x21 box is a log-tree of shifted adds (box_sum_tree), so XLA fuses
    # each d's diff+tree chain into a few elementwise passes.
    xs = jnp.arange(w)
    r_padded = jnp.pad(rpre, ((0, 0), (num_disparities, 0)))

    def cost_for_d(d):
        shifted = jax.lax.slice(
            r_padded, (0, num_disparities - d), (h, num_disparities - d + w)
        )
        diff = jnp.abs(lpre - shifted)
        # columns x < d have no right-image counterpart -> huge diff
        diff = jnp.where(xs[None, :] >= d, diff, 1e6)
        return box_sum_tree(diff, radius)

    costs = jnp.stack([cost_for_d(d) for d in range(num_disparities)])  # [D, H, W]

    best_d = jnp.argmin(costs, axis=0)                          # [H, W]
    best_c = jnp.min(costs, axis=0)

    # uniqueness: any candidate outside best±1 with cost <= best*(1+ratio/100)?
    ds = jnp.arange(num_disparities)[:, None, None]
    near = jnp.abs(ds - best_d[None]) <= 1
    masked = jnp.where(near, jnp.inf, costs)
    second = jnp.min(masked, axis=0)
    unique_ok = second * 100.0 >= best_c * (100.0 + uniqueness_ratio)

    # texture: window energy of |prefiltered - cap|
    tex = box_filter(jnp.abs(lpre - cap), radius)
    tex_ok = tex >= texture_threshold

    # border: need full window + full search range
    ys = jnp.arange(h)[:, None]
    inside = (
        (ys >= radius)
        & (ys < h - radius)
        & (xs[None, :] >= num_disparities + radius - 1)
        & (xs[None, :] < w - radius)
    )

    # sub-pixel parabola around the minimum. Neighbor costs are extracted with
    # one-hot masked reductions over the disparity axis (exact: one term of
    # each sum is nonzero).
    d0 = jnp.clip(best_d, 1, num_disparities - 2)
    d0b = d0[None]
    c_m = jnp.sum(jnp.where(ds == d0b - 1, costs, 0.0), axis=0)
    c_0 = jnp.sum(jnp.where(ds == d0b, costs, 0.0), axis=0)
    c_p = jnp.sum(jnp.where(ds == d0b + 1, costs, 0.0), axis=0)
    denom = jnp.maximum(c_m + c_p - 2.0 * c_0, 1e-9)
    delta = jnp.clip((c_m - c_p) / (2.0 * denom), -0.5, 0.5)
    disp = jnp.where(best_d == d0, best_d + delta, best_d.astype(jnp.float32))

    valid = inside & unique_ok & tex_ok & (best_c < 1e5)
    return jnp.where(valid, disp, -1.0).astype(jnp.float32)


def stereo_bm_at(
    left: jnp.ndarray,
    right: jnp.ndarray,
    xy: jnp.ndarray,
    valid: jnp.ndarray,
    num_disparities: int = 48,
    block_size: int = 21,
    prefilter_cap: int = 31,
    texture_threshold: int = 10,
    uniqueness_ratio: int = 15,
    compact_slots: int = 0,
) -> jnp.ndarray:
    """StereoBM disparity evaluated ONLY at feature pixels — bit-equal to
    ``disparity_at(stereo_bm_disparity(left, right), xy)``.

    The pipeline consumes disparity at <=748 feature pixels per keyframe
    (``image_processor.cpp:193``), while the dense [D, H, W] SAD volume
    covers every pixel. BM is pixelwise given the (cheap, global) XSobel
    prefilter, so evaluating the 48-candidate SAD, uniqueness, texture and
    sub-pixel logic on per-feature 21x21 windows is exact and ~30x less work.
    Exactness notes: prefiltered values are small integers (<= 2*cap), so the
    one-hot window-selection matmuls are exact even in TF32 (a 10-bit
    mantissa holds integers to 2048) and the f32 SAD sums are exact; argmin
    tie-breaks (first minimum) match the dense ``jnp.argmin`` over
    ascending d.

    ``compact_slots`` (floored to a multiple of 32): when >0 and fewer than
    that many
    inputs are valid, gather the valid slots into a batch of exactly that
    width, match there, and scatter back (-1 elsewhere) — per-feature
    results are batch-position independent, so this is exact; more valid
    inputs than slots falls back to the full-width path. The production
    caller feeds ~240 valid of 748 slots (new detections + tracked inliers
    padded to capacity), so BM cost follows the live set, not the padding.

    Returns ``[N]`` float32 disparity, -1 where invalid.
    """
    n_in = xy.shape[0]
    k = (compact_slots // 32) * 32
    if 0 < k < n_in:
        kw = dict(
            num_disparities=num_disparities, block_size=block_size,
            prefilter_cap=prefilter_cap, texture_threshold=texture_threshold,
            uniqueness_ratio=uniqueness_ratio,
        )

        def compacted(_):
            idx = jnp.argsort(jnp.logical_not(valid), stable=True)[:k]
            disp_c = _stereo_bm_at_full(
                left, right, jnp.take(xy, idx, axis=0),
                jnp.take(valid, idx, axis=0), **kw,
            )
            return jnp.full((n_in,), -1.0, jnp.float32).at[idx].set(disp_c)

        def full(_):
            return _stereo_bm_at_full(left, right, xy, valid, **kw)

        live = jnp.sum(valid.astype(jnp.int32))
        return jax.lax.cond(live <= k, compacted, full, None)
    return _stereo_bm_at_full(
        left, right, xy, valid,
        num_disparities=num_disparities, block_size=block_size,
        prefilter_cap=prefilter_cap, texture_threshold=texture_threshold,
        uniqueness_ratio=uniqueness_ratio,
    )


def _stereo_bm_at_full(
    left: jnp.ndarray,
    right: jnp.ndarray,
    xy: jnp.ndarray,
    valid: jnp.ndarray,
    num_disparities: int = 48,
    block_size: int = 21,
    prefilter_cap: int = 31,
    texture_threshold: int = 10,
    uniqueness_ratio: int = 15,
) -> jnp.ndarray:
    """Full-width per-feature BM (see ``stereo_bm_at``)."""
    from stereo_vo.ops.lk import _pad_edge, _soft_selector, extract_regions

    h, w = left.shape
    n = xy.shape[0]
    radius = block_size // 2
    d_max = num_disparities
    cap = float(prefilter_cap)
    win = block_size
    band = num_disparities + block_size - 1

    lpre = _xsobel_prefilter(left, prefilter_cap)
    rpre = _xsobel_prefilter(right, prefilter_cap)

    # truncated-int lookup coordinates (disparity_at semantics)
    xi = jnp.clip(xy[:, 0].astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(xy[:, 1].astype(jnp.int32), 0, h - 1)

    # Tight per-side regions: the left window needs only win+align rows/cols
    # and the right side a short, wide search band (32x32 + 32x80). Origins
    # align down to 8 px and sizes carry that slack; the selection below is
    # exact either way, so the alignment only sets how much data moves.
    m = d_max + radius + 8
    ry = (win + 7 + 7) // 8 * 8                     # rows: win + 8-align slack
    rx_l = ry                                       # left cols: same budget
    rx_r = (band + 7 + 7) // 8 * 8                  # right cols: band + slack

    lp = _pad_edge(lpre[None], m)
    rp = _pad_edge(rpre[None], m)
    hp, wp = lp.shape[-2:]
    oy = jnp.clip(((yi - radius + m) // 8) * 8, 0, hp - ry)
    ox_l = jnp.clip(((xi - radius + m) // 8) * 8, 0, wp - rx_l)
    ox_r = jnp.clip(((xi - (d_max - 1) - radius + m) // 8) * 8, 0, wp - rx_r)
    lreg = extract_regions(lp, jnp.stack([ox_l, oy], axis=1), ry, rx_l)
    rreg = extract_regions(rp, jnp.stack([ox_r, oy], axis=1), ry, rx_r)

    def take_window(reg, row0, col0, wy, wx):
        """Integer-offset [wy, wx] window per feature; exact at any matmul
        precision (one-hot weights, integer operands <= 2*cap)."""
        size_y, size_x = reg.shape[-2], reg.shape[-1]
        zeros = jnp.zeros_like(row0, jnp.float32)
        rowsel = _soft_selector(row0, zeros, wy, size_y)
        colsel = _soft_selector(col0, zeros, wx, size_x)
        tmp = jnp.einsum("nar,nrs->nas", rowsel, reg[:, 0],
                         preferred_element_type=jnp.float32)
        return jnp.einsum("nas,nbs->nab", tmp, colsel,
                          preferred_element_type=jnp.float32)

    py = yi + m - oy      # feature row in region coords
    px_l = xi + m - ox_l
    px_r = xi + m - ox_r
    lwin = take_window(lreg, py - radius, px_l - radius, win, win)
    rband = take_window(rreg, py - radius, px_r - (d_max - 1) - radius, win, band)

    # SAD per disparity: right window for d sits at band offset (d_max-1) - d
    sads = jnp.stack(
        [
            jnp.sum(
                jnp.abs(
                    lwin
                    - jax.lax.slice(
                        rband, (0, 0, d_max - 1 - d), (n, win, d_max - 1 - d + win)
                    )
                ),
                axis=(1, 2),
            )
            for d in range(num_disparities)
        ]
    )                                                   # [D, N]

    best_d = jnp.argmin(sads, axis=0)                   # [N]
    best_c = jnp.min(sads, axis=0)
    ds = jnp.arange(num_disparities)[:, None]
    near = jnp.abs(ds - best_d[None]) <= 1
    second = jnp.min(jnp.where(near, jnp.inf, sads), axis=0)
    unique_ok = second * 100.0 >= best_c * (100.0 + uniqueness_ratio)
    tex = jnp.sum(jnp.abs(lwin - cap), axis=(1, 2))
    tex_ok = tex >= texture_threshold
    inside = (
        (yi >= radius)
        & (yi < h - radius)
        & (xi >= num_disparities + radius - 1)
        & (xi < w - radius)
    )
    d0 = jnp.clip(best_d, 1, num_disparities - 2)
    c_m = jnp.sum(jnp.where(ds == d0[None] - 1, sads, 0.0), axis=0)
    c_0 = jnp.sum(jnp.where(ds == d0[None], sads, 0.0), axis=0)
    c_p = jnp.sum(jnp.where(ds == d0[None] + 1, sads, 0.0), axis=0)
    denom = jnp.maximum(c_m + c_p - 2.0 * c_0, 1e-9)
    delta = jnp.clip((c_m - c_p) / (2.0 * denom), -0.5, 0.5)
    disp = jnp.where(best_d == d0, best_d + delta, best_d.astype(jnp.float32))
    ok = inside & unique_ok & tex_ok & valid
    return jnp.where(ok, disp, -1.0).astype(jnp.float32)


def disparity_at(
    disparity: jnp.ndarray, xy: jnp.ndarray
) -> jnp.ndarray:
    """Disparity sampled at truncated-int feature coordinates — the exact
    lookup the reference does (``image_processor.cpp:193``:
    ``disparity.at<float>(it->y, it->x)`` with implicit float->int truncation)."""
    h, w = disparity.shape
    xi = jnp.clip(xy[..., 0].astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(xy[..., 1].astype(jnp.int32), 0, h - 1)
    return disparity[yi, xi]
