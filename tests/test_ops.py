"""Kernel parity tests vs OpenCV (SURVEY.md §4 "Kernel" row).

The kernels are re-derived, not ported, so parity is tolerance-based: same
corners, same disparities within the fixed-point quantum, sub-pixel-identical
flow on unambiguous data.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from stereo_vo.core.camera import CameraInfo
from stereo_vo.data.synthetic import SyntheticStereoSequence
from stereo_vo.ops.filters import box_filter, max_filter, sep_filter, sobel_x
from stereo_vo.ops.lk import lk_track_pyramid
from stereo_vo.ops.pyramid import build_pyramid, pyr_down
from stereo_vo.ops.shi_tomasi import detect_corners, min_eig_response
from stereo_vo.ops.stereo_bm import disparity_at, stereo_bm_disparity

CAM = CameraInfo(focal=300.0, cx=160.0, cy=120.0, baseline=0.3)


@pytest.fixture(scope="module")
def world():
    return SyntheticStereoSequence(cam=CAM, n_frames=4, shape=(240, 320), n_points=200, seed=3)


@pytest.fixture(scope="module")
def images(world):
    l0, r0 = world.render(0)
    l1, _ = world.render(1)
    return l0, r0, l1


# ---------------------------------------------------------------- filters
def test_box_filter_matches_cv2(rng):
    img = rng.normal(size=(64, 80)).astype(np.float32)
    ours = np.asarray(box_filter(jnp.asarray(img), 10))
    ref = cv2.boxFilter(img, -1, (21, 21), normalize=False, borderType=cv2.BORDER_REFLECT101)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-3)


def test_sobel_matches_cv2(rng):
    img = rng.normal(size=(64, 80)).astype(np.float32)
    ours = np.asarray(sobel_x(jnp.asarray(img)))
    ref = cv2.Sobel(img, cv2.CV_32F, 1, 0, ksize=3, borderType=cv2.BORDER_REFLECT101)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)


def test_max_filter_is_sliding_max(rng):
    img = rng.normal(size=(40, 50)).astype(np.float32)
    for r in (1, 3, 7, 15):
        ours = np.asarray(max_filter(jnp.asarray(img), r))
        ref = cv2.dilate(img, np.ones((2 * r + 1, 2 * r + 1), np.uint8))
        # interior only (border semantics differ: we use -inf outside)
        np.testing.assert_allclose(ours[r:-r, r:-r], ref[r:-r, r:-r], atol=1e-6)


def test_pyr_down_matches_cv2(rng):
    img = rng.integers(0, 255, size=(64, 80)).astype(np.uint8)
    ours = np.asarray(pyr_down(jnp.asarray(img, jnp.float32)))
    ref = cv2.pyrDown(img).astype(np.float32)
    # interior agreement (border modes differ by one column convention)
    assert np.abs(ours[2:-2, 2:-2] - ref[2:-2, 2:-2]).max() < 1.0


# ---------------------------------------------------------------- detection
def test_min_eig_response_correlates(images):
    l0, *_ = images
    ours = np.asarray(min_eig_response(jnp.asarray(l0)))
    ref = cv2.cornerMinEigenVal(l0, 3, 3)
    c = np.corrcoef(ours[5:-5, 5:-5].ravel(), ref[5:-5, 5:-5].ravel())[0, 1]
    assert c > 0.999


def test_detect_corners_subset_of_cv2(images):
    """Every corner we emit is (within 1px of) a cv2 goodFeaturesToTrack corner;
    our stricter windowed NMS may emit fewer (documented deviation)."""
    l0, *_ = images
    xy, _, valid = jax.jit(lambda im: detect_corners(im, 300, 0.1, 10.0))(jnp.asarray(l0))
    ours = np.asarray(xy)[np.asarray(valid)]
    ref = cv2.goodFeaturesToTrack(l0, 300, 0.1, 10).reshape(-1, 2)
    d = np.min(np.linalg.norm(ours[:, None] - ref[None], axis=2), axis=1)
    assert np.median(d) < 1.0
    assert len(ours) > 0.6 * len(ref)


def test_detect_corners_respects_min_distance(images):
    l0, *_ = images
    xy, _, valid = detect_corners(jnp.asarray(l0), 300, 0.1, 10.0)
    pts = np.asarray(xy)[np.asarray(valid)]
    dist = np.linalg.norm(pts[:, None] - pts[None], axis=2)
    np.fill_diagonal(dist, np.inf)
    assert dist.min() >= 10.0


def test_detect_caps_at_max_corners(images):
    l0, *_ = images
    xy, _, valid = detect_corners(jnp.asarray(l0), 20, 0.01, 3.0)
    assert int(np.sum(np.asarray(valid))) <= 20


# ---------------------------------------------------------------- stereo
def test_stereo_bm_matches_cv2(images):
    l0, r0, _ = images
    ours = np.asarray(jax.jit(stereo_bm_disparity)(jnp.asarray(l0), jnp.asarray(r0)))
    bm = cv2.StereoBM.create(48, 21)
    ref = bm.compute(l0, r0).astype(np.float32) / 16.0
    both = (ours > 0) & (ref > 0)
    # validity sets overlap strongly
    assert both.sum() > 0.9 * (ref > 0).sum()
    diff = np.abs(ours[both] - ref[both])
    assert np.median(diff) <= 0.0625 + 1e-6  # cv2's 1/16 px quantization
    assert np.mean(diff < 1.0) > 0.9


def test_stereo_bm_ground_truth(world, images):
    l0, r0, _ = images
    disp = stereo_bm_disparity(jnp.asarray(l0), jnp.asarray(r0))
    u, v, d_gt, vis = world.projections(0)
    sel = vis & (u > 70) & (u < 310) & (v > 11) & (v < 229)
    sampled = np.asarray(disparity_at(disp, jnp.asarray(np.stack([u[sel], v[sel]], 1))))
    ok = sampled > 0
    assert ok.mean() > 0.6
    assert np.median(np.abs(sampled[ok] - d_gt[sel][ok])) < 0.5


def test_stereo_bm_at_matches_dense_and_compacts(world, images):
    """``stereo_bm_at`` == dense disparity sampled at feature pixels, with
    and without live-slot compaction (gather/scatter is exact; overflow
    falls back to full width)."""
    from stereo_vo.ops.stereo_bm import stereo_bm_at

    l0, r0, _ = images
    lj, rj = jnp.asarray(l0), jnp.asarray(r0)
    dense = stereo_bm_disparity(lj, rj)
    u, v, _, vis = world.projections(0)
    sel = vis & (u > 70) & (u < 310) & (v > 11) & (v < 229)
    pts = np.stack([u[sel], v[sel]], 1).astype(np.float32)
    n_cap = 128
    xy = np.zeros((n_cap, 2), np.float32)
    n = min(len(pts), n_cap)
    xy[:n] = pts[:n]
    # scatter the valid slots around so compaction actually reorders
    perm = np.random.RandomState(1).permutation(n_cap)
    valid = (np.arange(n_cap) < n)[np.argsort(perm)]
    xy = xy[np.argsort(perm)]

    ref = np.asarray(disparity_at(dense, jnp.asarray(xy)))
    ref = np.where(valid, ref, -1.0)

    full = np.asarray(stereo_bm_at(lj, rj, jnp.asarray(xy), jnp.asarray(valid)))
    np.testing.assert_allclose(full[valid], ref[valid], atol=1e-4)
    assert np.all(full[~valid] == -1.0)

    # compaction engaged (n valid <= 64 after trimming) and exact
    valid_small = valid.copy()
    valid_small[np.cumsum(valid) > 40] = False
    comp = np.asarray(stereo_bm_at(
        lj, rj, jnp.asarray(xy), jnp.asarray(valid_small), compact_slots=64))
    base = np.asarray(stereo_bm_at(
        lj, rj, jnp.asarray(xy), jnp.asarray(valid_small)))
    np.testing.assert_allclose(comp, base, atol=1e-5)
    assert np.all(comp[~valid_small] == -1.0)

    # overflow: more valid than slots -> full-width fallback, same answer
    comp_of = np.asarray(stereo_bm_at(
        lj, rj, jnp.asarray(xy), jnp.asarray(valid), compact_slots=32))
    np.testing.assert_allclose(comp_of, full, atol=1e-5)


# ---------------------------------------------------------------- LK
def test_lk_exact_on_pure_translation(rng):
    img0 = cv2.GaussianBlur(
        rng.integers(0, 255, (240, 320)).astype(np.uint8), (0, 0), 1.2
    )
    dx, dy = 3.3, -2.7
    img1 = cv2.warpAffine(img0, np.float32([[1, 0, dx], [0, 1, dy]]), (320, 240))
    pts = (
        np.stack(np.meshgrid(np.arange(40, 280, 20), np.arange(40, 200, 20)), -1)
        .reshape(-1, 2)
        .astype(np.float32)
    )
    pp = build_pyramid(jnp.asarray(img0, jnp.float32), 3)
    np_ = build_pyramid(jnp.asarray(img1, jnp.float32), 3)
    tr, st = jax.jit(lk_track_pyramid)(pp, np_, jnp.asarray(pts), jnp.ones(len(pts), bool))
    tr, st = np.asarray(tr), np.asarray(st)
    assert st.mean() > 0.9
    flow = tr[st] - pts[st]
    np.testing.assert_allclose(np.median(flow, axis=0), [dx, dy], atol=0.02)

    cvtr, cvst, _ = cv2.calcOpticalFlowPyrLK(
        img0, img1, pts.reshape(-1, 1, 2), None, winSize=(21, 21), maxLevel=3
    )
    cvtr = cvtr.reshape(-1, 2)
    b = st & cvst.ravel().astype(bool)
    agreement = np.linalg.norm(tr[b] - cvtr[b], axis=1)
    assert np.median(agreement) < 0.01


def test_lk_large_motion_uses_pyramid(rng):
    img0 = cv2.GaussianBlur(
        rng.integers(0, 255, (240, 320)).astype(np.uint8), (0, 0), 1.5
    )
    dx, dy = 24.0, -13.0
    img1 = cv2.warpAffine(img0, np.float32([[1, 0, dx], [0, 1, dy]]), (320, 240))
    pts = (
        np.stack(np.meshgrid(np.arange(60, 240, 24), np.arange(60, 180, 24)), -1)
        .reshape(-1, 2)
        .astype(np.float32)
    )
    pp = build_pyramid(jnp.asarray(img0, jnp.float32), 3)
    np_ = build_pyramid(jnp.asarray(img1, jnp.float32), 3)
    tr, st = lk_track_pyramid(pp, np_, jnp.asarray(pts), jnp.ones(len(pts), bool))
    tr, st = np.asarray(tr), np.asarray(st)
    flow = tr[st] - pts[st]
    assert st.mean() > 0.6
    np.testing.assert_allclose(np.median(flow, axis=0), [dx, dy], atol=0.1)


def test_lk_invalid_slots_stay_invalid(rng):
    img = rng.integers(0, 255, (100, 100)).astype(np.uint8)
    pp = build_pyramid(jnp.asarray(img, jnp.float32), 2)
    pts = jnp.zeros((8, 2), jnp.float32) + 50.0
    valid = jnp.asarray([True, False] * 4)
    _, st = lk_track_pyramid(pp, pp, pts, valid)
    assert not bool(st[1]) and not bool(st[3])
    assert bool(st[0])


def test_lk_tracks_synthetic_world(world, images):
    l0, _, l1 = images
    u0, v0, _, vis0 = world.projections(0)
    u1, v1, _, vis1 = world.projections(1)
    sel = vis0 & vis1 & (u0 > 30) & (u0 < 290) & (v0 > 30) & (v0 < 210)
    pts = np.stack([u0[sel], v0[sel]], 1).astype(np.float32)
    gt1 = np.stack([u1[sel], v1[sel]], 1)
    pp = build_pyramid(jnp.asarray(l0, jnp.float32), 3)
    np_ = build_pyramid(jnp.asarray(l1, jnp.float32), 3)
    tr, st = lk_track_pyramid(pp, np_, jnp.asarray(pts), jnp.ones(len(pts), bool))
    tr, st = np.asarray(tr), np.asarray(st)
    err = np.linalg.norm(tr - gt1, axis=1)
    good = st & (err < 2.0)
    # majority tracked to sub-2px of ground truth; fwd-bwd gating in the
    # frontend handles the ambiguous-texture failures
    assert good.sum() > 0.6 * len(pts)
    assert np.median(err[st]) < 1.5
