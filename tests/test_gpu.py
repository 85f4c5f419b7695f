"""On-card checks (``pytest -m gpu``): what the CPU tier cannot see.

Each test takes the ``gpu_device`` fixture, which skips it on a host without
a GPU. ``chip_smoke.py`` runs the same checks at production widths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereo_vo.core.camera import CameraInfo
from stereo_vo.data.synthetic import SyntheticStereoSequence
from stereo_vo.ops.lk import extract_regions, lk_track_fwdbwd
from stereo_vo.ops.pyramid import build_pyramid
from stereo_vo.ops.stereo_bm import disparity_at, stereo_bm_at, stereo_bm_disparity

pytestmark = pytest.mark.gpu

CAM = CameraInfo(focal=300.0, cx=160.0, cy=120.0, baseline=0.3)


@pytest.fixture(scope="module")
def world():
    return SyntheticStereoSequence(cam=CAM, n_frames=2, shape=(240, 320),
                                   n_points=300, seed=11)


def test_extract_regions_on_card(gpu_device, rng):
    stack = rng.uniform(0, 255, (1, 300, 500)).astype(np.float32)
    origins = np.stack([rng.integers(0, 500 - 80 + 1, 160),
                        rng.integers(0, 300 - 32 + 1, 160)], 1).astype(np.int32)
    got = extract_regions(*jax.device_put((stack, origins), gpu_device), 32, 80)
    want = np.stack([stack[:, y:y + 32, x:x + 80] for x, y in origins])
    np.testing.assert_array_equal(np.asarray(got), want)


def test_lk_compaction_bitwise_on_card(gpu_device, world, monkeypatch):
    l0, _ = world.render(0)
    l1, _ = world.render(1)
    u, v, _, vis = world.projections(0)
    sel = vis & (u > 15) & (u < 305) & (v > 15) & (v < 225)
    pts = np.stack([u[sel], v[sel]], 1)
    xy = (pts[np.arange(192) % len(pts)]
          + np.random.RandomState(1).uniform(-3, 3, (192, 2))).astype(np.float32)
    args = jax.device_put(
        (build_pyramid(jnp.asarray(l0, jnp.float32), 3),
         build_pyramid(jnp.asarray(l1, jnp.float32), 3), xy, np.ones(192, bool)),
        gpu_device,
    )
    compacted = lk_track_fwdbwd(*args, bwd_levels=2)
    monkeypatch.setenv("STEREO_VO_LK_COMPACT_AFTER", "30")  # full batch throughout
    full = lk_track_fwdbwd(*args, bwd_levels=2)
    for a, b in zip(compacted, full):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_sparse_stereo_bm_on_card(gpu_device, world):
    left, right = (jnp.asarray(x, jnp.float32) for x in world.render(0))
    rng = np.random.default_rng(0)
    xy = np.stack([rng.uniform(0, 319, 400), rng.uniform(0, 239, 400)], 1)
    valid = rng.uniform(size=400) < 0.5
    left, right, xy_d, valid_d = jax.device_put(
        (left, right, xy.astype(np.float32), valid), gpu_device)
    got = np.asarray(stereo_bm_at(left, right, xy_d, valid_d, compact_slots=256))
    want = np.where(valid, np.asarray(disparity_at(stereo_bm_disparity(left, right),
                                                   xy_d)), -1.0)
    np.testing.assert_array_equal(got >= 0, want >= 0)
    np.testing.assert_allclose(got, want, atol=1e-4)
