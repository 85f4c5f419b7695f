"""Landmark-sharded distributed bundle adjustment.

The scaling design mandated by BASELINE.json's north star: landmark blocks are
embarrassingly parallel in the Schur complement, so the landmark table (and its
observations, held landmark-major) shard across a device mesh axis ``"lm"``:

    per device:  residuals + Jacobians for its landmark block [L/n, W]
                 partial reduced camera system  S_k = sum_l W_l V_l^-1 W_l^T
    collective:  S = psum(S_k),  rhs = psum(rhs_k)        <- the interconnect
    replicated:  dense (W*6)^2 solve — identical on every device
    per device:  back-substitute its own landmark block

The solver core lives in ``backend.schur`` (landmark-major formulation, shared
with the single-device path — only the psum axis differs), so sharded == single
by construction up to summation order; tests assert it on a virtual 8-device
CPU mesh (SURVEY.md §4 "Distributed"). The win over the reference's 4-thread
Ceres (``bundle_adjuster.cpp:12``) is that window x landmark capacity scales
with devices at constant wall-clock — the structural analog of scaling sequence
length (SURVEY.md §5 "Long-context" row).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
from jax.sharding import Mesh, PartitionSpec as P

from stereo_vo.core.camera import CameraInfo
from stereo_vo.core.config import BackendConfig
from stereo_vo.backend.schur import (
    LandmarkMajorProblem,
    lm_loop,
    window_to_landmark_major,
)
from stereo_vo.backend.window import WindowState


def sharded_bundle_adjust(
    window: WindowState,
    cam: CameraInfo,
    cfg: BackendConfig,
    mesh: Mesh,
    lm_axis: str = "lm",
) -> Tuple[WindowState, jax.Array, jax.Array]:
    """Distributed BA over ``mesh``; landmark table sharded along ``lm_axis``.

    Returns ``(window', initial_cost, final_cost)``. Result equals the
    single-device ``backend.schur.bundle_adjust`` (same damping schedule, same
    reduced system — only the summation order differs).
    """
    n_shards = mesh.shape[lm_axis]
    lcap = window.landmark_capacity
    if lcap % n_shards != 0:
        raise ValueError(f"landmark capacity {lcap} not divisible by {n_shards} shards")

    prob = window_to_landmark_major(window)

    poses, lm_pos, cost0, cost1 = sharded_lm_solve(prob, cam, cfg, mesh, lm_axis)
    return window._replace(poses=poses, lm_pos=lm_pos), cost0, cost1


def sharded_lm_solve(
    prob: LandmarkMajorProblem,
    cam: CameraInfo,
    cfg: BackendConfig,
    mesh: Mesh,
    lm_axis: str = "lm",
):
    """Landmark-sharded LM solve on a raw landmark-major problem.

    Returns ``(poses, lm_pos, cost0, cost1)``; equals the single-device
    ``lm_loop`` up to summation order.
    """
    lm_sharded = P(lm_axis)
    repl = P()
    in_specs = LandmarkMajorProblem(
        poses=repl, pose_valid=repl,
        lm_pos=lm_sharded, lm_valid=lm_sharded,
        obs_uv=lm_sharded, obs_valid=lm_sharded,
        lm_prior=lm_sharded, lm_prior_w=lm_sharded,
    )

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(in_specs,),
        out_specs=(repl, lm_sharded, repl, repl),
    )
    def solve(p):
        poses, lm_pos, c0, c1, _, _, _ = lm_loop(p, cam, cfg, lm_axis)
        return poses, lm_pos, c0, c1

    return solve(prob)


def dp_sharded_bundle_adjust(
    batch: LandmarkMajorProblem,
    cam: CameraInfo,
    cfg: BackendConfig,
    mesh: Mesh,
    dp_axis: str = "dp",
    lm_axis: str = "lm",
):
    """Data-parallel batch of landmark-sharded BA solves over a 2-D mesh.

    ``batch`` carries a leading batch dimension on every array (independent VO
    windows, e.g. one per replayed sequence in a benchmark sweep). The batch
    shards over ``dp_axis`` and each solve's landmark table over ``lm_axis`` —
    the dp x model-parallel layout of the full "training step". Returns
    ``(poses [B, W, 7], lm_pos [B, L, 3], cost0 [B], cost1 [B])``.
    """
    b = P(dp_axis)
    b_lm = P(dp_axis, lm_axis)
    in_specs = LandmarkMajorProblem(
        poses=b, pose_valid=b,
        lm_pos=b_lm, lm_valid=b_lm,
        obs_uv=b_lm, obs_valid=b_lm,
        lm_prior=b_lm, lm_prior_w=b_lm,
    )

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(in_specs,),
        out_specs=(b, b_lm, b, b),
    )
    def solve(p):
        def one(pp):
            poses, lm_pos, c0, c1, _, _, _ = lm_loop(pp, cam, cfg, lm_axis)
            return poses, lm_pos, c0, c1

        return jax.vmap(one)(p)

    return solve(batch)