"""Test harness config.

The CPU tier runs on CPU with an 8-device virtual topology so sharding and
collective code paths compile and execute without accelerators. Tests marked
``gpu`` need the card; ``pytest -m gpu`` leaves JAX's platform choice alone so
they can reach it, and each such test decides in its fixture whether a GPU is
present.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    markexpr = config.getoption("markexpr") or ""
    if "gpu" not in markexpr or "not gpu" in markexpr:
        jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU (run on the card with: pytest -m gpu)")
    return devs[0]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# ---------------------------------------------------------------------------
# Fast/slow tiers. `pytest -m "not slow"` is the fast tier; the full suite
# is CI's job. Central
# list instead of per-file decorators so the tier's contents are auditable in
# one place (durations from `pytest --durations`).
# ---------------------------------------------------------------------------
_SLOW = {
    ("test_engine.py", "test_chunked_replay_matches_streaming"),
    ("test_engine.py", "test_checkpoint_resume_bitwise"),
    ("test_engine.py", "test_pipeline_tracks_trajectory"),
    ("test_real_fixtures.py", "test_full_pipeline_on_real_fixtures"),
    ("test_parallel.py", "test_dp_sharded_batch"),
    ("test_parallel.py", "test_sharded_equals_single_device"),
    ("test_parallel.py", "test_sharded_converges_to_gt"),
    ("test_schur.py", "test_schur_step_equals_dense_normal_equations"),
    ("test_schur.py", "test_condition_probe_and_precision_islands"),
    ("test_frontend.py", "test_with_outliers"),
    ("test_frontend.py", "test_track_and_stats"),
    ("test_ops.py", "test_lk_large_motion_uses_pyramid"),
    ("test_ops.py", "test_lk_tracks_synthetic_world"),
    ("test_residuals.py", "test_jacobians_match_autodiff"),
    ("test_lk_fast_motion.py", "test_fast_motion_parity"),
    ("test_engine.py", "test_keyframes_and_tracking_health"),
    ("test_frontend.py", "test_warm_start_dominates_when_good"),
    ("test_real_fixtures.py", "test_lk_parity_on_real_imagery"),
    ("test_frontend.py", "test_fb_gate_kills_occluded"),
    ("test_real_fixtures.py", "test_stereo_bm_on_real_imagery"),
    ("test_schur.py", "test_invalid_window_is_noop"),
    ("test_residuals.py", "test_jacobians_match_finite_differences"),
    ("test_frontend.py", "test_deterministic"),
    ("test_frontend.py", "test_exact_correspondences"),
    ("test_schur.py", "test_noisy_problem_reduces_cost_monotonically"),
    ("test_frontend.py", "test_degenerate_too_few_points"),
    ("test_real_fixtures.py", "test_detection_on_real_imagery"),
    ("test_schur.py", "test_big_window_converges_to_ground_truth"),
    ("test_long_sequence.py", "test_long_sequence_drift_vs_twin"),
    ("test_engine.py", "test_preload_survives_late_bootstrap"),
    ("test_run_sweep.py", "test_run_one_synthetic_world"),
    ("test_stream.py", "test_live_stream_through_run_vo"),
    ("test_stream.py", "test_live_stream_paced_soak_queue_bounded"),
}


def pytest_collection_modifyitems(config, items):
    seen = set()
    files_collected = set()
    for item in items:
        base = item.path.name
        name = item.name.split("[")[0]
        files_collected.add(base)
        if (base, name) in _SLOW:
            item.add_marker(pytest.mark.slow)
            seen.add((base, name))
    # Stale-entry guard (ADVICE r3): a renamed/removed test must not leave a
    # silent _SLOW entry. Only enforced for files that were actually collected
    # in full — skipped when a -k filter or a ::nodeid selection hides tests.
    narrowed = config.getoption("keyword") or any(
        "::" in a for a in config.getoption("file_or_dir", default=[])
    )
    if not narrowed:
        stale = {
            (f, n) for (f, n) in _SLOW
            if f in files_collected and (f, n) not in seen
        }
        if stale:
            raise pytest.UsageError(
                "conftest._SLOW has entries matching no collected test "
                f"(renamed/removed?): {sorted(stale)}"
            )
