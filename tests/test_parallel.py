"""Distributed BA tests on a virtual 8-device CPU mesh (SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereo_vo.backend.schur import bundle_adjust
from stereo_vo.core.camera import CameraInfo
from stereo_vo.parallel import make_mesh, sharded_bundle_adjust, window_to_landmark_major

from tests.test_schur import make_problem, perturb

CAM = CameraInfo(focal=500.0, cx=320.0, cy=240.0, baseline=0.5)


def test_eight_devices_available():
    assert len(jax.devices()) >= 8  # conftest forces the virtual topology


def test_landmark_major_roundtrip(rng):
    cfg, window, *_ = make_problem(rng, w=3, n_lm=20, f_cap=32, l_cap=32)
    prob = window_to_landmark_major(window)
    # every valid pose-major obs appears exactly once in landmark-major
    assert int(jnp.sum(prob.obs_valid)) == int(jnp.sum(window.obs_valid))
    for w in range(3):
        for f in range(32):
            if bool(window.obs_valid[w, f]):
                l = int(window.obs_lm[w, f])
                assert bool(prob.obs_valid[l, w])
                np.testing.assert_allclose(prob.obs_uv[l, w], window.obs_uv[w, f])


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sharded_equals_single_device(rng, n_shards):
    """Sharded Schur BA == single-device BA (SURVEY.md §7 hard part 6)."""
    cfg, window_gt, *_ = make_problem(rng, w=4, n_lm=40, f_cap=64, l_cap=64)
    window = perturb(window_gt, rng)

    solved_single, stats = bundle_adjust(window, CAM, cfg)

    mesh = make_mesh((n_shards,), ("lm",), jax.devices()[:n_shards])
    solved_sharded, c0, c1 = sharded_bundle_adjust(window, CAM, cfg, mesh)

    np.testing.assert_allclose(c0, stats.initial_cost, rtol=1e-5)
    # identical damping schedule -> same accepted steps -> same solution
    np.testing.assert_allclose(
        np.asarray(solved_sharded.poses), np.asarray(solved_single.poses),
        rtol=1e-4, atol=1e-5,
    )
    lm_valid = np.asarray(window.lm_valid)
    np.testing.assert_allclose(
        np.asarray(solved_sharded.lm_pos)[lm_valid],
        np.asarray(solved_single.lm_pos)[lm_valid],
        rtol=1e-3, atol=1e-4,
    )
    np.testing.assert_allclose(c1, stats.final_cost, rtol=1e-3, atol=1e-6)


def test_sharded_converges_to_gt(rng):
    cfg, window_gt, poses_gt, _ = make_problem(rng)
    window = perturb(window_gt, rng)
    mesh = make_mesh((8,), ("lm",))
    solved, c0, c1 = sharded_bundle_adjust(window, CAM, cfg, mesh)
    assert float(c1) < 1e-3 * float(c0)
    np.testing.assert_allclose(
        np.asarray(solved.poses[:, 4:]), poses_gt[:, 4:], atol=5e-3
    )


def test_indivisible_capacity_raises(rng):
    cfg, window, *_ = make_problem(rng, w=3, n_lm=10, f_cap=16, l_cap=18)
    mesh = make_mesh((4,), ("lm",), jax.devices()[:4])
    with pytest.raises(ValueError, match="not divisible"):
        sharded_bundle_adjust(window, CAM, cfg, mesh)


def test_dp_sharded_batch(rng):
    """dp x lm batched solves equal per-window single-device solves."""
    from stereo_vo.backend.schur import window_to_landmark_major
    from stereo_vo.parallel.sharded_ba import dp_sharded_bundle_adjust

    cfg, w0, *_ = make_problem(rng, w=3, n_lm=16, f_cap=32, l_cap=32)
    _, w1, *_ = make_problem(rng, w=3, n_lm=16, f_cap=32, l_cap=32)
    wins = [perturb(w0, rng), perturb(w1, rng)]

    import jax.numpy as jnp

    probs = [window_to_landmark_major(w) for w in wins]
    batch = jax.tree.map(lambda *xs: jnp.stack(xs), *probs)
    mesh = make_mesh((2, 4), ("dp", "lm"))
    poses_b, lm_b, c0_b, c1_b = dp_sharded_bundle_adjust(batch, CAM, cfg, mesh)

    for i, win in enumerate(wins):
        solved, stats = bundle_adjust(win, CAM, cfg)
        np.testing.assert_allclose(
            np.asarray(poses_b[i]), np.asarray(solved.poses), rtol=1e-4, atol=1e-5
        )
        np.testing.assert_allclose(c1_b[i], stats.final_cost, rtol=1e-3, atol=1e-6)


def test_multihost_helpers_single_process():
    """Single-host behavior of the multi-host bootstrap + data plane."""
    from stereo_vo.parallel.distributed import initialize_multihost, shard_for_host

    idx, cnt = initialize_multihost()  # no coordinator configured -> no-op
    assert idx == 0 and cnt == 1
    assert shard_for_host(list(range(7))) == list(range(7))
    # explicit multi-process split: disjoint cover, near-even sizes
    items = list(range(11))
    parts = [shard_for_host(items, i, 3) for i in range(3)]
    assert sum(parts, []) == items
    assert [len(p) for p in parts] == [4, 4, 3]


def test_host_local_problem_to_global_single_process():
    import numpy as np
    import jax

    from stereo_vo.parallel.distributed import host_local_problem_to_global
    from stereo_vo.parallel.mesh import make_mesh

    mesh = make_mesh((2,), ("dp",), devices=jax.devices()[:2])
    local = {"a": np.arange(8, dtype=np.float32).reshape(2, 4)}
    glob = host_local_problem_to_global(local, mesh)
    np.testing.assert_array_equal(np.asarray(glob["a"]), local["a"])
