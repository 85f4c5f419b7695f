"""Exactness of the pipeline's gathers: region extraction, LK straggler
compaction and the flow-hint neighbour lookup. Each is a pure copy, so each
must equal plain NumPy indexing bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest

from stereo_vo.core.camera import CameraInfo
from stereo_vo.data.synthetic import SyntheticStereoSequence
from stereo_vo.frontend.track import _flow_hint
from stereo_vo.ops.lk import LK_COMPACT_K, extract_regions, lk_track_fwdbwd
from stereo_vo.ops.pyramid import build_pyramid


@pytest.mark.parametrize(
    "hp,wp,ry,rx,n",
    [
        (120, 200, 56, 56, 64),    # square LK fine-level region
        (150, 260, 88, 88, 40),    # square LK top-level region
        (100, 300, 32, 80, 96),    # StereoBM's short-wide right band
        (64, 64, 32, 32, 10),      # region covering half the image
    ],
)
def test_extract_regions_matches_numpy(rng, hp, wp, ry, rx, n):
    """Unaligned origins, both clip edges and rectangles copy exactly."""
    stack = rng.uniform(0, 255, (1, hp, wp)).astype(np.float32)
    ox = rng.integers(0, wp - rx + 1, n)
    oy = rng.integers(0, hp - ry + 1, n)
    ox[:3] = (0, wp - rx, 7)
    oy[:3] = (hp - ry, 0, 5)
    origins = np.stack([ox, oy], 1).astype(np.int32)
    got = np.asarray(extract_regions(jnp.asarray(stack), jnp.asarray(origins), ry, rx))
    want = np.stack([stack[:, y:y + ry, x:x + rx] for x, y in origins])
    assert got.shape == (n, 1, ry, rx)
    np.testing.assert_array_equal(got, want)


def test_lk_straggler_compaction_is_exact(monkeypatch):
    """Continuing the unconverged features in a compacted batch gives the
    same bits as keeping the full batch to the end."""
    cam = CameraInfo(focal=300.0, cx=160.0, cy=120.0, baseline=0.3)
    world = SyntheticStereoSequence(cam=cam, n_frames=2, shape=(240, 320),
                                    n_points=300, seed=11)
    l0, _ = world.render(0)
    l1, _ = world.render(1)
    u, v, _, vis = world.projections(0)
    sel = vis & (u > 15) & (u < 305) & (v > 15) & (v < 225)
    n = 192
    assert n > LK_COMPACT_K                   # so compaction engages
    pts = np.stack([u[sel], v[sel]], 1)
    jitter = np.random.RandomState(1).uniform(-3, 3, (n, 2))
    xy = (pts[np.arange(n) % len(pts)] + jitter).astype(np.float32)
    valid = np.ones(n, bool)
    valid[::7] = False
    p0 = build_pyramid(jnp.asarray(l0, jnp.float32), 3)
    p1 = build_pyramid(jnp.asarray(l1, jnp.float32), 3)
    args = (p0, p1, jnp.asarray(xy), jnp.asarray(valid))
    compacted = lk_track_fwdbwd(*args, bwd_levels=2)
    # compacting after the last iteration keeps the full batch to the end
    monkeypatch.setenv("STEREO_VO_LK_COMPACT_AFTER", "30")
    full = lk_track_fwdbwd(*args, bwd_levels=2)
    assert int(np.sum(np.asarray(compacted[1]))) > n // 2
    for a, b in zip(compacted, full):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_flow_hint_is_an_exact_gather(rng):
    """Own flow where valid, else the nearest flow-carrying feature's flow,
    copied exactly (no matmul rounding); zero when no flow is valid."""
    f = 96
    xy = rng.uniform(0, 300, (f, 2)).astype(np.float32)
    flow = rng.normal(0, 20, (f, 2)).astype(np.float32) + 1e-3
    fvalid = rng.uniform(size=f) < 0.4
    got = np.asarray(_flow_hint(jnp.asarray(xy), jnp.asarray(flow), jnp.asarray(fvalid)))
    d2 = np.sum((xy[:, None] - xy[None]) ** 2, axis=-1)
    d2 = np.where(fvalid[None], d2, 1e12)
    want = np.where(fvalid[:, None], flow, flow[np.argmin(d2, axis=1)])
    np.testing.assert_array_equal(got, want)
    none = np.asarray(_flow_hint(jnp.asarray(xy), jnp.asarray(flow),
                                 jnp.zeros(f, bool)))
    np.testing.assert_array_equal(none, np.zeros_like(flow))
