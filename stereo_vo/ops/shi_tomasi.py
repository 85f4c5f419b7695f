"""Shi-Tomasi corner detection (goodFeaturesToTrack equivalent).

Replaces ``cv::goodFeaturesToTrack(image, 300, 0.1, 30)``
(reference ``image_processor.cpp:22``, constants ``vo_node.cpp:33-34``) with a
fully vectorized, fixed-output-shape device op:

1. min-eigenvalue corner response: Sobel gradients, 3x3 box-summed structure
   tensor, ``lambda_min = ((a+c) - sqrt((a-c)^2 + 4 b^2)) / 2``;
2. quality gate at ``quality_level * max(response)``;
3. min-distance enforcement as a sliding-window max filter: a corner survives
   iff it is the strongest response within ``min_distance`` — a deliberate,
   data-parallel re-design of OpenCV's sequential greedy suppression (the
   surviving set is pairwise >= min_distance apart like the reference's, but
   chains of mutually-suppressed corners resolve slightly more conservatively);
4. top-``max_corners`` by response into a fixed ``[K, 2]`` slot array + mask.

Everything is one jittable function of static shapes — no host round-trips.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from stereo_vo.ops.filters import box_filter, max_filter, sobel_x, sobel_y


def min_eig_response(img: jnp.ndarray, block_size: int = 3) -> jnp.ndarray:
    """Per-pixel Shi-Tomasi response (cv::cornerMinEigenVal, relative scale).

    Absolute scaling differs from OpenCV by a constant factor; the detector
    only uses the response relative to its global max, so the constant cancels
    (quality gate is ``quality * max``).
    """
    img = img.astype(jnp.float32)
    ix = sobel_x(img)
    iy = sobel_y(img)
    r = block_size // 2
    a = box_filter(ix * ix, r)
    b = box_filter(ix * iy, r)
    c = box_filter(iy * iy, r)
    return ((a + c) - jnp.sqrt((a - c) ** 2 + 4.0 * b * b)) * 0.5


def count_quality_peaks(
    img: jnp.ndarray, quality_level: float = 0.1, block_size: int = 3,
    border: int = 3, resp: jnp.ndarray = None,
) -> jnp.ndarray:
    """Number of 3x3-local-max responses above the quality threshold.

    The cheap every-frame stand-in for the reference's "fewer than 4
    detections -> skip frame" bail (image_processor.cpp:23-25): min-distance
    NMS only ever *reduces* the count, and a frame with >= 4 quality peaks but
    < 4 NMS survivors is pathological, so full (expensive) suppression can be
    deferred to keyframe processing.

    ``resp`` (optional): precomputed ``min_eig_response`` — the engine computes
    it once per frame and shares it with the keyframe branch's full detection.
    """
    h, w = img.shape[-2:]
    if resp is None:
        resp = min_eig_response(img, block_size)
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    inside = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    resp = jnp.where(inside, resp, 0.0)
    # batch-friendly: per-image threshold/count over the trailing image dims
    # (leading dims ride through — the chunked replay precomputes the gate for
    # a whole chunk in one batched pass, see VOEngine._replay_chunk)
    thresh = jnp.max(resp, axis=(-2, -1), keepdims=True) * quality_level
    localmax3 = max_filter(resp, 1)
    is_peak = (resp >= localmax3) & (resp >= thresh) & (resp > 0)
    return jnp.sum(is_peak.astype(jnp.int32), axis=(-2, -1))


def detect_corners(
    img: jnp.ndarray,
    max_corners: int = 300,
    quality_level: float = 0.1,
    min_distance: float = 30.0,
    block_size: int = 3,
    border: int = 3,
    nms: str = "greedy",
    candidates: int = 1024,
    resp: jnp.ndarray = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Detect corners; returns ``(xy [K, 2] float32, response [K], valid [K])``.

    ``resp``: optional precomputed ``min_eig_response`` (shared with the
    every-frame gate — the structure-tensor build is ~1/3 of detection).

    ``border`` pixels at the image edge are excluded, mirroring OpenCV's
    implicit exclusion of the derivative border.

    ``nms``:
    - ``"greedy"`` (default): exact goodFeaturesToTrack semantics — candidates
      in descending response order, each accepted corner suppressing weaker
      ones within ``min_distance``. Runs as a fixed-length device loop over
      the top-``candidates`` pool (vector ops per step, ~1 ms for 1024).
    - ``"maxpool"``: windowed-max suppression (a survivor must be the maximum
      within ``min_distance``) — fully parallel and slightly stricter (chains
      of mutually-suppressed corners resolve conservatively), yielding ~60-80%
      of the greedy corner count.
    """
    h, w = img.shape
    if resp is None:
        resp = min_eig_response(img, block_size)

    # exclude the border band
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    inside = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    resp = jnp.where(inside, resp, 0.0)

    maxval = jnp.max(resp)
    thresh = maxval * quality_level

    flat_idx = (ys * w + xs).astype(jnp.float32)

    def window_peaks(value, mask, radius):
        """True where the pixel is the maximum of ``value`` within ``radius``
        among ``mask`` pixels; exact index tie-break, no bias term.

        Exactness: two window-maximal pixels within ``radius`` of each other
        necessarily have *equal* values (each lies in the other's window), so
        breaking ties among them by lowest flat index never demotes a strictly
        stronger corner. Chains of equal-valued maxima resolve conservatively
        (only the lowest-index representative survives), same as before.
        """
        v = jnp.where(mask, value, -jnp.inf)
        is_max = mask & (v >= max_filter(v, radius))
        neg_idx = jnp.where(is_max, -flat_idx, -jnp.inf)
        return is_max & (neg_idx >= max_filter(neg_idx, radius))

    # 3x3 local-maximum + quality gate (cv2's dilate-compare step)
    is_peak = window_peaks(resp, (resp >= thresh) & (resp > 0) & inside, 1)

    radius = max(int(min_distance), 1)
    if nms == "maxpool":
        is_corner = window_peaks(resp, is_peak, radius)
        flat = jnp.where(is_corner, resp, -1.0).reshape(-1)
        vals, idx = jax.lax.top_k(flat, max_corners)
        valid = vals > 0
        xy = jnp.stack(
            [(idx % w).astype(jnp.float32), (idx // w).astype(jnp.float32)], axis=-1
        )
        return xy, vals, valid

    # greedy: descending-response sweep over the candidate pool. Pre-thin with
    # a small windowed max (radius ~ min_distance/4) so the fixed-size pool is
    # spatially representative instead of clustered in the most-textured area;
    # at this radius the removed candidates are ones the sweep would suppress.
    thin_r = max(radius // 4, 1)
    is_peak = window_peaks(resp, is_peak, thin_r)
    masked = jnp.where(is_peak, resp, -1.0)

    # Exact 64x sort reduction before top_k: thinning guarantees surviving
    # peaks are > thin_r apart in Chebyshev distance, so with tile size
    # t <= thin_r + 1 each non-overlapping t x t tile holds at most ONE peak —
    # compacting to the per-tile max (value + flat index) loses nothing, and
    # the top_k sort runs over H*W/t^2 elements instead of H*W.
    t = thin_r + 1
    hp_, wp_ = -h % t, -w % t
    padded = jnp.pad(masked, ((0, hp_), (0, wp_)), constant_values=-1.0)
    pidx = jnp.pad(
        flat_idx, ((0, hp_), (0, wp_)), constant_values=0.0
    )
    th_, tw_ = padded.shape[0] // t, padded.shape[1] // t
    tiles = padded.reshape(th_, t, tw_, t).transpose(0, 2, 1, 3).reshape(th_, tw_, t * t)
    tidx = pidx.reshape(th_, t, tw_, t).transpose(0, 2, 1, 3).reshape(th_, tw_, t * t)
    arg = jnp.argmax(tiles, axis=-1)
    tile_val = jnp.take_along_axis(tiles, arg[..., None], axis=-1)[..., 0]
    tile_idx = jnp.take_along_axis(tidx, arg[..., None], axis=-1)[..., 0]

    cvals, csel = jax.lax.top_k(tile_val.reshape(-1), min(candidates, th_ * tw_))
    cidx = tile_idx.reshape(-1)[csel].astype(jnp.int32)
    if candidates > th_ * tw_:  # keep the static [candidates] shape
        pad_n = candidates - th_ * tw_
        cvals = jnp.concatenate([cvals, jnp.full((pad_n,), -1.0, cvals.dtype)])
        cidx = jnp.concatenate([cidx, jnp.zeros((pad_n,), cidx.dtype)])
    cxy = jnp.stack(
        [(cidx % w).astype(jnp.float32), (cidx // w).astype(jnp.float32)], axis=-1
    )
    cvalid = cvals > 0
    r2 = float(min_distance) * float(min_distance)

    # Parallel greedy: simulate the sequential descending-response sweep as a
    # fixed-point over "conflict with an earlier candidate" rounds. Candidate i
    # is accepted the moment every earlier conflicting candidate is decided
    # (killed), and killed the moment an earlier conflicting candidate is
    # accepted — exactly the state candidate i observes at its turn of the
    # sequential sweep, so the accepted set is identical. Rounds needed = the
    # longest suppression chain (single digits in practice) instead of one
    # sequential step per candidate; each round is one [C, C] mat-vec.
    d2 = jnp.sum((cxy[:, None, :] - cxy[None, :, :]) ** 2, axis=-1)
    earlier = (
        jax.lax.broadcasted_iota(jnp.int32, (candidates, candidates), 0)
        < jax.lax.broadcasted_iota(jnp.int32, (candidates, candidates), 1)
    )
    # conflicts[j, i]: earlier candidate j suppresses i if accepted
    conflicts = ((d2 < r2) & earlier & cvalid[:, None] & cvalid[None, :]).astype(
        jnp.float32
    )

    def round_(state):
        accepted, killed, _ = state
        pending = cvalid & ~accepted & ~killed
        blocked = (pending.astype(jnp.float32) @ conflicts) > 0.0
        by_acc = (accepted.astype(jnp.float32) @ conflicts) > 0.0
        new_killed = killed | (pending & by_acc)
        new_accepted = accepted | (pending & ~by_acc & ~blocked)
        still = cvalid & ~new_accepted & ~new_killed
        return new_accepted, new_killed, jnp.any(still)

    def round_cond(state):
        return state[2]

    accepted, _, _ = jax.lax.while_loop(
        round_cond,
        round_,
        (jnp.zeros(candidates, bool), jnp.zeros(candidates, bool), jnp.any(cvalid)),
    )
    # cap at max_corners: the capped sequential sweep accepts exactly the first
    # max_corners of the uncapped accepted sequence (later acceptances only
    # ever suppress candidates that would rank past the cap themselves)
    rank = jnp.cumsum(accepted.astype(jnp.int32))
    accepted = accepted & (rank <= max_corners)

    # pack accepted (already in descending-response order) into the output
    order = jnp.argsort(jnp.logical_not(accepted), stable=True)
    sel = order[:max_corners]
    valid = accepted[sel]
    return cxy[sel], jnp.where(valid, cvals[sel], -1.0), valid
