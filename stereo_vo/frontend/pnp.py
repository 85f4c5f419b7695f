"""PnP-RANSAC: camera pose from 2D-3D correspondences, device-native.

Replaces ``cv::solvePnPRansac(world, pixels, K, 0, rvec, tvec, true, 100, 8.0,
0.99, inliers)`` (reference ``image_processor.cpp:76-80``) with a batched,
fixed-shape design (SURVEY.md §7 hard part 5):

- a **fixed** hypothesis count (the reference's 100 iterations; OpenCV's
  0.99-confidence adaptive early exit always terminates at <= its iteration
  cap — a fixed count is the jit-able superset);
- hypothesis 0 is the warm start from the previous frame (the reference's
  ``useExtrinsicGuess=true`` + persistent rvec/tvec, ``image_processor.hpp:57-60``);
- minimal solver: 6-point DLT on K-normalized rays, orthogonalized via SVD —
  batched over all hypotheses with one vmapped computation (instead of P3P's
  quartic, which is numerically fragile in f32);
- inlier = reprojection error < threshold (pixels) and positive depth;
- winner refined by damped Gauss-Newton on its inliers (OpenCV refines with
  ITERATIVE on the RANSAC inlier set); the reported inlier mask is the RANSAC
  model's, pre-refinement — matching OpenCV's output contract.

Deterministic: hypothesis sampling uses a counter-based key derived from the
frame index, so replays are bit-reproducible.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from stereo_vo.core.camera import CameraInfo
from stereo_vo.core.config import FrontendConfig
from stereo_vo.core.geometry import (
    make_pose,
    pose_apply,
    pose_q,
    pose_retract,
    quat_lift_jacobian,
    rotmat_to_quat,
)
from stereo_vo.backend.residuals import reprojection_jacobians




def _inv3(m):
    """Closed-form batched 3x3 inverse."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    adj = jnp.stack(
        [co_a, -(b * i - c * h), b * f - c * e,
         co_b, a * i - c * g, -(a * f - c * d),
         co_c, -(a * h - b * g), a * e - b * d], axis=-1
    ).reshape(m.shape)
    return adj / det[..., None, None]


def _inv_spd_blocked(m, half: int):
    """Batched SPD inverse via 2x2 block-Schur recursion.

    ``half`` is the top-left block size; 3 -> closed-form 3x3 leaves. Avoids
    solver-library custom calls, whose fixed cost dominates tiny batched
    solves.
    """
    a = m[..., :half, :half]
    b = m[..., :half, half:]
    c = m[..., half:, half:]
    inv_a = _inv3(a) if half == 3 else _inv_spd_blocked(a, half // 2 * 0 + 3)
    s = c - jnp.einsum("...ij,...jk,...kl->...il", jnp.swapaxes(b, -1, -2), inv_a, b)
    inv_s = _inv3(s) if s.shape[-1] == 3 else _inv_spd_blocked(s, 3)
    aib = jnp.einsum("...ij,...jk->...ik", inv_a, b)
    tl = inv_a + jnp.einsum("...ij,...jk,...lk->...il", aib, inv_s, aib)
    tr = -jnp.einsum("...ij,...jk->...ik", aib, inv_s)
    bl = jnp.swapaxes(tr, -1, -2)
    return jnp.concatenate(
        [jnp.concatenate([tl, tr], axis=-1), jnp.concatenate([bl, inv_s], axis=-1)],
        axis=-2,
    )


def _solve6_spd(h, g):
    """Solve SPD 6x6 systems batched, closed form (block-Schur with 3x3 leaves)."""
    return jnp.einsum("...ij,...j->...i", _inv_spd_blocked(h, 3), g)


def _polar_so3(m, iters: int = 8):
    """Project batched 3x3 matrices to (scaled) SO(3) via Newton polar
    iteration ``R <- (R + R^-T)/2``; returns (R, scale) with R orthogonal and
    ``scale`` the mean singular value carrying det sign information."""
    # normalize magnitude for iteration stability
    norm = jnp.sqrt(jnp.sum(m * m, axis=(-2, -1), keepdims=True) / 3.0)
    r = m / jnp.maximum(norm, 1e-20)
    for _ in range(iters):
        r = 0.5 * (r + jnp.swapaxes(_inv3(r), -1, -2))
    # scale = mean diag of R^T M (signed mean singular value)
    s = jnp.einsum("...ji,...jk->...ik", r, m)
    scale = jnp.trace(s, axis1=-2, axis2=-1) / 3.0
    return r, scale


def _nullvec_qr(a):
    """Right null vector of batched square ``a [..., n, n]`` — pure XLA ops.

    ``jnp.linalg.svd`` lowers to a batched eigensolver custom call, costly
    for ~100 tiny 12x12 problems; and inverse iteration on A^T A squares the
    condition number, which f32 cannot afford (measured trajectory harm).
    This takes the classical middle path, all in batched static-shape ops:

      1. Householder QR of A^T (backward stable, cond NOT squared),
         so A = R^T Q^T and ``min ||A v|| = min ||R^T z||`` with ``v = Q z``;
      2. two inverse-iteration steps on R R^T via triangular solves
         (unrolled back/forward substitution) — the LAPACK way to pull the
         smallest singular vector out of a factorization;
      3. v = Q z applied as the stored Householder reflector chain.
    """
    n = a.shape[-1]
    b = jnp.swapaxes(a, -1, -2)
    dtype = a.dtype
    vs = []
    for k in range(n - 1):
        x = b[..., k:, k]
        alpha = jnp.sqrt(jnp.sum(x * x, axis=-1))
        sign = jnp.where(x[..., 0] >= 0, 1.0, -1.0).astype(dtype)
        v = x.at[..., 0].add(sign * alpha)
        vn = jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True))
        v = v / jnp.maximum(vn, jnp.asarray(1e-30, dtype))
        sub = b[..., k:, k:]
        w = jnp.einsum("...i,...ij->...j", v, sub)
        b = b.at[..., k:, k:].set(sub - 2.0 * v[..., :, None] * w[..., None, :])
        vs.append(v)
    r = b  # upper triangular (below-diagonal residue is ~0 and never read)

    # guard exactly-zero diagonals (rank-deficient noiseless data): tiny ridge
    # RELATIVE to the matrix scale keeps the inverse iteration finite while
    # still amplifying the near-null direction
    scale = jnp.sqrt(jnp.sum(a * a, axis=(-2, -1), keepdims=False) / (n * n))
    diag = jnp.stack([r[..., i, i] for i in range(n)], axis=-1)
    eps = (1e-12 * scale)[..., None]
    diag = jnp.where(jnp.abs(diag) > eps, diag,
                     jnp.where(diag >= 0, 1.0, -1.0) * eps)

    def back_sub(z):       # solve R y = z
        y = [None] * n
        for i in range(n - 1, -1, -1):
            acc = z[..., i]
            for j in range(i + 1, n):
                acc = acc - r[..., i, j] * y[j]
            y[i] = acc / diag[..., i]
        return jnp.stack(y, axis=-1)

    def fwd_sub(z):        # solve R^T y = z
        y = [None] * n
        for i in range(n):
            acc = z[..., i]
            for j in range(i):
                acc = acc - r[..., j, i] * y[j]
            y[i] = acc / diag[..., i]
        return jnp.stack(y, axis=-1)

    z = jnp.zeros(a.shape[:-2] + (n,), dtype).at[..., n - 1].set(1.0)
    for _ in range(2):
        z = fwd_sub(back_sub(z))
        z = z / jnp.maximum(
            jnp.sqrt(jnp.sum(z * z, axis=-1, keepdims=True)),
            jnp.asarray(1e-30, dtype),
        )
    # v = Q z = H_0 (H_1 (... (H_{n-2} z)))
    for k in range(n - 2, -1, -1):
        v = vs[k]
        zk = z[..., k:]
        coef = jnp.sum(v * zk, axis=-1, keepdims=True)
        z = z.at[..., k:].set(zk - 2.0 * v * coef)
    return z


def _smallest_nullvec_12(b):
    """Approximate null vector of a 12x12 PSD matrix via ridge inverse
    iteration with a block-Schur inverse (no eigendecomposition)."""
    tr = jnp.trace(b, axis1=-2, axis2=-1)
    ridge = (1e-7 * tr)[..., None, None] * jnp.eye(12, dtype=b.dtype)
    # 12x12 SPD inverse: 2x2 blocks of 6x6, each via the 3x3-leaf recursion
    bb = b + ridge
    a11 = bb[..., :6, :6]
    a12 = bb[..., :6, 6:]
    a22 = bb[..., 6:, 6:]
    inv_a11 = _inv_spd_blocked(a11, 3)
    s = a22 - jnp.einsum("...ij,...jk,...kl->...il",
                         jnp.swapaxes(a12, -1, -2), inv_a11, a12)
    inv_s = _inv_spd_blocked(s, 3)
    aib = jnp.einsum("...ij,...jk->...ik", inv_a11, a12)
    tl = inv_a11 + jnp.einsum("...ij,...jk,...lk->...il", aib, inv_s, aib)
    trr = -jnp.einsum("...ij,...jk->...ik", aib, inv_s)
    inv = jnp.concatenate(
        [jnp.concatenate([tl, trr], axis=-1),
         jnp.concatenate([jnp.swapaxes(trr, -1, -2), inv_s], axis=-1)], axis=-2)
    x = jnp.ones(b.shape[:-2] + (12,), b.dtype)
    for _ in range(4):
        x = jnp.einsum("...ij,...j->...i", inv, x)
        x = x / jnp.maximum(jnp.linalg.norm(x, axis=-1, keepdims=True), 1e-30)
    return x


class PnPResult(NamedTuple):
    pose: jnp.ndarray        # [7] T_cw
    inliers: jnp.ndarray     # [F] bool (of the RANSAC model)
    num_inliers: jnp.ndarray  # []
    ok: jnp.ndarray          # [] bool — enough inliers to trust the pose


def _dlt_pose(p3: jnp.ndarray, xn: jnp.ndarray):
    """6-point DLT: world points [6,3] + normalized image coords [6,2] -> (R, t, ok).

    Solves for the 3x4 projection M up to scale via SVD null vector, then
    orthogonalizes M[:, :3] and resolves the global sign by cheirality.
    """
    n = p3.shape[0]
    # Hartley normalization: the closed-form f32 null-vector solve needs the
    # system well-conditioned; raw world coordinates give cond(A^T A) ~ 1e9.
    c = jnp.mean(p3, axis=0)
    s = jnp.sqrt(jnp.mean(jnp.sum((p3 - c) ** 2, axis=1)) / 3.0)
    s = jnp.maximum(s, 1e-6)
    pn = (p3 - c) / s
    zeros = jnp.zeros((n, 4), p3.dtype)
    ph = jnp.concatenate([pn, jnp.ones((n, 1), p3.dtype)], axis=1)  # [6,4]
    rows_x = jnp.concatenate([ph, zeros, -xn[:, 0:1] * ph], axis=1)
    rows_y = jnp.concatenate([zeros, ph, -xn[:, 1:2] * ph], axis=1)
    a = jnp.concatenate([rows_x, rows_y], axis=0)  # [12, 12]
    import os
    variant = os.environ.get("STEREO_VO_DLT", "qr")
    if variant == "svd":
        _, _, vt = jnp.linalg.svd(a, full_matrices=True)
        mn = vt[-1].reshape(3, 4)
    elif variant == "ata":
        mn = _smallest_nullvec_12(a.T @ a).reshape(3, 4)
    else:
        mn = _nullvec_qr(a).reshape(3, 4)
    # denormalize: P = M_n @ [[I/s, -c/s], [0, 1]]
    m = jnp.concatenate(
        [mn[:, :3] / s, (mn[:, 3] - mn[:, :3] @ c / s)[:, None]], axis=1
    )

    def fix(mm):
        r_tilde = mm[:, :3]
        # _polar_so3's scale IS the signed mean singular value of r_tilde
        # (trace(R^T A)/3 = lambda for A = lambda R) — dividing by anything
        # more (a former extra *sqrt(sum(r_tilde^2)/3) factor) divides t by
        # lambda^2 and inflated every DLT translation ~1/lambda (~80x at
        # KITTI scale), silently zeroing RANSAC hypothesis inlier counts.
        r, scale = _polar_so3(r_tilde)
        # flip r to a proper rotation; the scale relative to the flipped r
        # flips with it
        flip = jnp.sign(jnp.linalg.det(r))
        r = r * flip
        scale = scale * flip
        t = mm[:, 3] / jnp.where(jnp.abs(scale) > 1e-12, scale, 1e-12)
        z = (p3 @ r.T + t)[:, 2]
        return r, t, jnp.sum(z > 0), jnp.abs(scale) > 1e-9

    r_a, t_a, npos_a, ok_a = fix(m)
    r_b, t_b, npos_b, ok_b = fix(-m)
    pick_a = npos_a >= npos_b
    r = jnp.where(pick_a, r_a, r_b)
    t = jnp.where(pick_a, t_a, t_b)
    ok = jnp.where(pick_a, ok_a, ok_b)
    return r, t, ok


def _reproj_errors(pose: jnp.ndarray, p3: jnp.ndarray, uv: jnp.ndarray, cam: CameraInfo):
    p_cam = pose_apply(pose[None, :], p3)
    z = p_cam[:, 2]
    safe_z = jnp.where(z > 1e-6, z, 1.0)
    proj = p_cam[:, :2] / safe_z[:, None] * cam.focal + jnp.array(
        [cam.cx, cam.cy], p3.dtype
    )
    err = jnp.linalg.norm(proj - uv, axis=1)
    return jnp.where(z > 1e-6, err, jnp.inf)


def _gn_refine(pose, p3, uv, weight, cam, iters: int):
    """Damped Gauss-Newton on the weighted reprojection cost (pose only)."""

    def body(pose, _):
        r, jp7, _ = reprojection_jacobians(pose[None, :].repeat(p3.shape[0], 0), p3, uv, cam)
        lift = quat_lift_jacobian(pose_q(pose))           # [4, 3]
        jq = jnp.einsum("fij,jk->fik", jp7[..., 0:4], lift)
        j6 = jnp.concatenate([jq, jp7[..., 4:7]], axis=-1)  # [F, 2, 6]
        r = jnp.where(weight[:, None], r, 0.0)
        j6 = jnp.where(weight[:, None, None], j6, 0.0)
        r = jnp.nan_to_num(r)
        j6 = jnp.nan_to_num(j6)
        h = jnp.einsum("fri,frj->ij", j6, j6) + 1e-6 * jnp.eye(6, dtype=pose.dtype)
        g = -jnp.einsum("fri,fr->i", j6, r)
        import os

        if os.environ.get("STEREO_VO_PNP_SOLVE", "lu") == "schur":
            # experiment (round 4): closed-form block-Schur inverse + two
            # same-precision iterative-refinement passes. The bare inverse
            # loses ~3 digits on the reprojection Hessian's conditioning
            # (measured, round 2); refinement with the exact H recovers them
            # IF the refinement converges — gated until trajectory-parity
            # measurements say it matches the LAPACK path.
            hinv = _inv_spd_blocked(h, 3)
            delta = jnp.einsum("ij,j->i", hinv, g)
            for _ in range(2):
                delta = delta + jnp.einsum("ij,j->i", hinv, g - h @ delta)
        else:
            # LAPACK solve: accuracy reference (see the gate above)
            delta = jnp.linalg.solve(h, g)
        return pose_retract(pose, delta), None

    pose, _ = jax.lax.scan(body, pose, None, length=iters)
    return pose


def pnp_ransac(
    p3: jnp.ndarray,
    uv: jnp.ndarray,
    valid: jnp.ndarray,
    cam: CameraInfo,
    prev_pose: jnp.ndarray,
    seed: jnp.ndarray,
    cfg: FrontendConfig,
) -> PnPResult:
    """Estimate T_cw from fixed-capacity correspondence arrays.

    ``p3 [F, 3]`` world points, ``uv [F, 2]`` pixels, ``valid [F]`` mask,
    ``prev_pose [7]`` warm start, ``seed`` int32 (e.g. frame index).
    """
    f_cap = p3.shape[0]
    dtype = p3.dtype
    n_hyp = cfg.pnp_iterations
    k = cfg.pnp_sample_size

    key = jax.random.PRNGKey(seed)
    n_valid = jnp.sum(valid.astype(jnp.int32))
    probs = valid.astype(dtype) / jnp.maximum(n_valid, 1).astype(dtype)

    # normalized coordinates for the DLT
    xn = (uv - jnp.array([cam.cx, cam.cy], dtype)) / jnp.asarray(cam.focal, dtype)

    def one_hypothesis(hkey):
        idx = jax.random.choice(hkey, f_cap, shape=(k,), replace=False, p=probs)
        r, t, ok = _dlt_pose(p3[idx], xn[idx])
        q = rotmat_to_quat(r)
        pose = make_pose(q, t.astype(dtype))
        # per-hypothesis polish on the minimal sample (OpenCV's ITERATIVE
        # minimal solver refines each sample with LM; DLT alone is too crude
        # under noise and loses inliers that a refined model would keep).
        # GN runs on just the k gathered points, not the full capacity array.
        pose = _gn_refine(pose, p3[idx], uv[idx], jnp.ones(k, bool), cam,
                          cfg.pnp_hyp_polish_iters)
        return pose, ok & jnp.all(jnp.isfinite(pose))

    keys = jax.random.split(key, n_hyp - 1)
    hyp_poses, hyp_ok = jax.vmap(one_hypothesis)(keys)

    # hypothesis 0: warm start, polished with trimmed GN on all points (the
    # reference's useExtrinsicGuess warm start followed by OpenCV's internal
    # iterative solve; plain reprojection of the previous pose scores no
    # inliers once the camera has moved)
    def trim_round(pose, _):
        e = _reproj_errors(pose, p3, uv, cam)
        w = valid & (e < 4.0 * cfg.pnp_reproj_thresh)
        return _gn_refine(pose, p3, uv, w, cam, cfg.pnp_warm_iters), None

    warm, _ = jax.lax.scan(trim_round, prev_pose, None,
                           length=cfg.pnp_warm_rounds)
    warm_ok = jnp.all(jnp.isfinite(warm))
    warm = jnp.where(warm_ok, warm, prev_pose)

    hyp_poses = jnp.concatenate([warm[None, :], hyp_poses], axis=0)
    hyp_ok = jnp.concatenate([jnp.array([True]), hyp_ok], axis=0)

    errs = jax.vmap(lambda p: _reproj_errors(p, p3, uv, cam))(hyp_poses)  # [H, F]
    inl = (errs < cfg.pnp_reproj_thresh) & valid[None, :]
    counts = jnp.where(hyp_ok, jnp.sum(inl, axis=1), -1)
    best = jnp.argmax(counts)  # first max wins: deterministic
    best_pose = hyp_poses[best]
    best_inl = inl[best]
    n_inl = jnp.maximum(counts[best], 0)

    # locally-optimized refinement (LO-RANSAC): refine on the current inlier
    # set, recount, repeat. One refine pass is NOT enough — the winning
    # hypothesis (often the warm start) can sit far from its consensus set's
    # optimum, so its inlier selection is biased; refining converges to the
    # optimum of that biased set, and the recount then admits observations the
    # refined model explains. Iterating to a fixed point matches what
    # cv::solvePnPRansac's converged final LM solve delivers
    # (image_processor.cpp:76-80). Divergence guard: a round is kept only if
    # it does not lose inliers.
    def lo_round(carry, _):
        pose, inl_set = carry
        cand = _gn_refine(pose, p3, uv, inl_set, cam, cfg.pnp_refine_iters)
        cand = jnp.where(jnp.all(jnp.isfinite(cand)), cand, pose)
        err_c = _reproj_errors(cand, p3, uv, cam)
        inl_c = (err_c < cfg.pnp_reproj_thresh) & valid
        keep = jnp.sum(inl_c) >= jnp.sum(inl_set)
        return (
            jnp.where(keep, cand, pose),
            jnp.where(keep, inl_c, inl_set),
        ), None

    (final_pose, out_inl), _ = jax.lax.scan(
        lo_round, (best_pose, best_inl), None, length=cfg.pnp_lo_rounds
    )
    out_n = jnp.sum(out_inl)

    ok = out_n >= jnp.asarray(max(cfg.pnp_sample_size, 4), out_n.dtype)
    return PnPResult(pose=final_pose, inliers=out_inl, num_inliers=out_n, ok=ok)
