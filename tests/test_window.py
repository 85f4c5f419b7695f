import dataclasses

import jax.numpy as jnp
import numpy as np

from stereo_vo.backend.window import (
    add_keyframe,
    empty_window,
    get_world_points,
    newest_pose,
)
from stereo_vo.core.config import BackendConfig

CFG = BackendConfig(window_size=3, max_features=8, feature_capacity=16, landmark_capacity=32)


def _pose(i):
    return jnp.array([1.0, 0, 0, 0, float(i), 0, 0], jnp.float32)


def _padded(arr, cap, dim=None):
    arr = np.asarray(arr, np.float32)
    n = arr.shape[0]
    shape = (cap,) + arr.shape[1:] if dim is None else (cap, dim)
    out = np.zeros(shape, np.float32)
    out[:n] = arr
    valid = np.zeros(cap, bool)
    valid[:n] = True
    return jnp.asarray(out), jnp.asarray(valid)


def _no_tracked(cap):
    return (jnp.zeros((cap, 2), jnp.float32), jnp.zeros(cap, jnp.int32),
            jnp.zeros(cap, bool))


def test_bootstrap_keyframe():
    st = empty_window(CFG)
    new_uv, nv = _padded([[1, 2], [3, 4], [5, 6]], 16)
    new_p3, _ = _padded([[0, 0, 5], [1, 0, 6], [0, 1, 7]], 16)
    tuv, tlm, tval = _no_tracked(16)
    st, ids, ids_valid = add_keyframe(st, CFG, _pose(0), tuv, tlm, tval, new_uv, new_p3, nv)
    assert int(st.num_kf) == 1
    assert int(jnp.sum(st.lm_valid)) == 3
    # lowest-index-first id assignment
    np.testing.assert_array_equal(np.asarray(ids[:3]), [0, 1, 2])
    np.testing.assert_array_equal(np.asarray(st.lm_refcount[:3]), [1, 1, 1])
    np.testing.assert_allclose(get_world_points(st, ids[:3]), new_p3[:3])
    assert int(jnp.sum(st.obs_valid[0])) == 3


def test_tracked_refcount_and_eviction():
    st = empty_window(CFG)
    tuv, tlm, tval = _no_tracked(16)

    # kf0: 4 new landmarks
    new_uv, nv = _padded([[i, i] for i in range(4)], 16)
    new_p3, _ = _padded([[i, 0, 5] for i in range(4)], 16)
    st, ids0, _ = add_keyframe(st, CFG, _pose(0), tuv, tlm, tval, new_uv, new_p3, nv)

    # kf1..kf3: keep tracking landmarks 0,1 and add one new each
    for k in range(1, 4):
        t_uv, t_val = _padded([[k, 0], [k, 1]], 16)
        t_lm = jnp.zeros(16, jnp.int32).at[0].set(ids0[0]).at[1].set(ids0[1])
        n_uv, n_val = _padded([[9, k]], 16)
        n_p3, _ = _padded([[0, k, 9]], 16)
        st, ids, _ = add_keyframe(st, CFG, _pose(k), t_uv, t_lm, t_val, n_uv, n_p3, n_val)

    # window size 3 -> kf0 was evicted on inserting kf3 (4th keyframe)
    assert int(st.num_kf) == 4
    # landmarks 2,3 were only seen by kf0 -> freed; 0,1 still tracked
    assert bool(st.lm_valid[ids0[0]]) and bool(st.lm_valid[ids0[1]])
    assert not bool(st.lm_valid[ids0[2]]) and not bool(st.lm_valid[ids0[3]])
    # refcount of landmark 0: kf1,kf2,kf3 -> 3 (kf0's obs decremented)
    assert int(st.lm_refcount[ids0[0]]) == 3
    # newest pose is kf3's
    np.testing.assert_allclose(newest_pose(st)[4], 3.0)
    # freed ids recycle lowest-first
    n_uv, n_val = _padded([[7, 7]], 16)
    n_p3, _ = _padded([[1, 1, 1]], 16)
    st2, ids_new, _ = add_keyframe(st, CFG, _pose(4), tuv, tlm, tval, n_uv, n_p3, n_val)
    assert int(ids_new[0]) == int(ids0[2])  # lowest free slot reused


def test_max_features_cap_truncates_coherently():
    """Cap = max_features - num_tracked (bundle_adjuster.cpp:85-90), with ids
    staying aligned to surviving features (quirk #4 fixed)."""
    cfg = CFG
    st = empty_window(cfg)
    tuv, tlm, tval = _no_tracked(16)
    # 12 candidate new features; cap is 8
    new_uv, nv = _padded([[i, i] for i in range(12)], 16)
    new_p3, _ = _padded([[i, 0, 5] for i in range(12)], 16)
    st, ids, ids_valid = add_keyframe(st, cfg, _pose(0), tuv, tlm, tval, new_uv, new_p3, nv)
    assert int(jnp.sum(ids_valid)) == 8
    assert int(jnp.sum(st.obs_valid[0])) == 8
    # surviving ids refer to the *first* 8 features, coherently
    np.testing.assert_allclose(
        get_world_points(st, ids[:8]), new_p3[:8], atol=0
    )


def test_observation_row_packs_tracked_then_new():
    st = empty_window(CFG)
    tuv0, tlm0, tval0 = _no_tracked(16)
    new_uv, nv = _padded([[1, 1], [2, 2]], 16)
    new_p3, _ = _padded([[0, 0, 5], [1, 0, 5]], 16)
    st, ids, _ = add_keyframe(st, CFG, _pose(0), tuv0, tlm0, tval0, new_uv, new_p3, nv)

    t_uv, t_val = _padded([[5, 5]], 16)
    t_lm = jnp.zeros(16, jnp.int32).at[0].set(ids[1])
    n_uv, n_val = _padded([[6, 6]], 16)
    n_p3, _ = _padded([[2, 0, 5]], 16)
    st, ids2, _ = add_keyframe(st, CFG, _pose(1), t_uv, t_lm, t_val, n_uv, n_p3, n_val)

    row = st.obs_uv[1]
    assert int(jnp.sum(st.obs_valid[1])) == 2
    np.testing.assert_allclose(row[0], [5, 5])  # tracked first
    np.testing.assert_allclose(row[1], [6, 6])  # then new
    assert int(st.obs_lm[1, 0]) == int(ids[1])
