#!/usr/bin/env python
"""Benchmark harness: VO frames/sec on one GPU vs the reference's CPU twin.

Needs a GPU: it exits non-zero when JAX's default device is anything else,
and any failed leg fails the run. Prints the device and the card's name and
power limit, then ONE JSON line:
    {"metric": "vo_frames_per_sec_1chip", "value": N, "unit": "frames/s",
     "vs_baseline": R, "details": {...}}

- Measured pipeline: full stereo VO (detect -> LK fwd/bwd track -> keyframe
  gate -> PnP-RANSAC -> StereoBM -> triangulate -> sliding-window Schur-LM BA)
  on KITTI-sized (376x1241) synthetic stereo frames under kitti00 intrinsics,
  replayed through the chunked offline path (the per-frame streaming path gives
  the same trajectory; chunking amortizes host/device dispatch).
- Baseline: the reference's algorithmic twin on CPU — OpenCV
  goodFeaturesToTrack + calcOpticalFlowPyrLK (forward+backward) each frame,
  plus StereoBM + solvePnPRansac on keyframes, at the cadence the measured run
  actually produced. The reference's Ceres BA time (0.1 s budget/solve,
  bundle_adjuster.cpp:11) is NOT charged to the baseline — generous to it.
  (BASELINE.md "Measurement plan": no published numbers exist, so the envelope
  is measured empirically.)
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def build_world(n_frames, seed=0, texture=None):
    from stereo_vo.core.config import load_config
    from stereo_vo.data.synthetic import kitti_like_sequence

    cfg = load_config("kitti00")
    return cfg, kitti_like_sequence(cfg.camera, n_frames, seed=seed, texture=texture)


def device_info() -> dict:
    """The device this run measures; exits when it is not a GPU."""
    import jax

    from stereo_vo.utils.device import NoGPUError, card_name_and_power_limit, require_gpu

    try:
        dev = require_gpu()
    except NoGPUError as e:
        raise SystemExit(f"bench.py: {e}")
    info = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "card": card_name_and_power_limit()}
    print(f"[bench] device: {info}", file=sys.stderr)
    return info


def measure_replay(cfg, frames, chunk_size, reps=1):
    """Replay ``frames`` through the chunked pipeline; return the VORun.

    ``reps > 1``: repeat the replay (sharing one compiled engine) and return
    the run with the median fps.
    """
    from stereo_vo.engine.driver import run_vo
    from stereo_vo.engine.step import VOEngine

    engine = VOEngine(cfg, frames[0].left.shape)
    runs = [
        run_vo(iter(frames), cfg, chunk_size=chunk_size,
               preload_device=True, engine=engine)
        for _ in range(max(1, reps))
    ]
    runs.sort(key=lambda r: r.frames_per_sec)
    return runs[len(runs) // 2]


def measure_cpu_twin_once(frames, kf_ratio, n_cpu_frames=20):
    """Per-frame cost of the reference's OpenCV frontend on this host."""
    try:
        import cv2
    except ImportError:
        return None
    frames = frames[:n_cpu_frames + 1]
    prev = frames[0].left
    prev_pts = cv2.goodFeaturesToTrack(prev, 300, 0.1, 30)
    bm = cv2.StereoBM.create(48, 21)
    k = np.array([[718.856, 0, 607.19], [0, 718.856, 185.22], [0, 0, 1]])

    # synthesize a plausible PnP problem once (time scales with count, not values)
    rng = np.random.default_rng(0)
    obj = np.concatenate([rng.uniform(-5, 5, (200, 2)), rng.uniform(8, 30, (200, 1))],
                         axis=1)
    img_pts = (obj[:, :2] / obj[:, 2:3]) * 718.856 + np.array([607.19, 185.22])
    img_pts = (img_pts + rng.normal(size=img_pts.shape)).astype(np.float64)

    # the reference's EXPLICIT LK arguments (feature_tracker.cpp:23-26):
    # TermCriteria(COUNT+EPS, 30, 0.01) and minEigThreshold=1e-2 (OpenCV's
    # default is 1e-4 — omitting it kept weak features the reference kills,
    # skewing both speed and trajectory parity; VERDICT r3 weak #3)
    crit = (cv2.TERM_CRITERIA_COUNT | cv2.TERM_CRITERIA_EPS, 30, 0.01)
    t0 = time.perf_counter()
    n = 0
    for f in frames[1:]:
        cur = f.left
        # every frame: detect + forward/backward LK (feature_tracker.cpp:23-47)
        pts = cv2.goodFeaturesToTrack(cur, 300, 0.1, 30)
        if prev_pts is not None and len(prev_pts):
            fwd, st1, _ = cv2.calcOpticalFlowPyrLK(
                prev, cur, prev_pts, None, winSize=(21, 21), maxLevel=3,
                criteria=crit, minEigThreshold=1e-2)
            cv2.calcOpticalFlowPyrLK(cur, prev, fwd, None, winSize=(21, 21),
                                     maxLevel=3, criteria=crit,
                                     minEigThreshold=1e-2)
        # keyframe work at the measured cadence (StereoBM + PnP;
        # image_processor.cpp:76-80,173-176)
        if (n * kf_ratio) % 1.0 + kf_ratio >= 1.0:
            bm.compute(f.left, f.right)
            cv2.solvePnPRansac(obj, img_pts.reshape(-1, 1, 2), k, np.zeros(4),
                               iterationsCount=100, reprojectionError=8.0,
                               confidence=0.99)
        prev, prev_pts = cur, pts
        n += 1
    dt = time.perf_counter() - t0
    return n / dt


def measure_cpu_twin(frames, kf_ratio, reps=5):
    """Median-of-N twin fps with spread and a host-load guard.

    The round-2 verdict: a single 20-frame twin run swung 30-68 f/s with host
    load, making vs_baseline claims unfalsifiable. Report the median of
    ``reps`` runs, the spread, and the 1-minute load average so a contended
    measurement is visibly flagged rather than silently recorded."""
    import os

    runs = []
    for _ in range(reps):
        fps = measure_cpu_twin_once(frames, kf_ratio)
        if fps is None:
            return None
        runs.append(fps)
    runs.sort()
    median = float(np.median(runs))
    spread = (runs[-1] - runs[0]) / median if median else None
    try:
        load1 = os.getloadavg()[0]
    except OSError:  # pragma: no cover
        load1 = None
    ncpu = os.cpu_count() or 1
    return {
        "fps_median": round(median, 2),
        "fps_min": round(runs[0], 2),
        "fps_max": round(runs[-1], 2),
        "spread_frac": round(spread, 3) if spread is not None else None,
        "host_load1": round(load1, 2) if load1 is not None else None,
        "contended": bool(
            (spread is not None and spread > 0.25)
            or (load1 is not None and load1 > 0.5 * ncpu)
        ),
    }


def measure_twin_trajectory(frames, cfg):
    """Full-pipeline OpenCV twin on the SAME frames: returns (poses, stats).

    Trajectory parity signal only — its Python-loop timing is not the fps
    baseline (see measure_cpu_twin for the op-level envelope)."""
    try:
        from stereo_vo.eval.cv_twin import run_cv_twin
    except ImportError:
        return None, None
    try:
        poses, stats, _ = run_cv_twin(iter(frames), cfg.camera, cfg.frontend)
        return poses, stats
    except ImportError:
        return None, None


def ate_pair(poses, gt, mask=None, align=False):
    from stereo_vo.eval.ate import absolute_trajectory_error

    if mask is not None:
        poses, gt = poses[mask], gt[mask]
    if len(poses) < 3:
        return None
    return round(absolute_trajectory_error(poses, gt, align=align)["rmse"], 3)


def measure_stream_latency(cfg, frames, n=32, skip=48):
    """Per-frame wall latency of the online (chunk_size=0) path: the number a
    20 Hz robot cares about (vo_node.cpp:139). Returns (p50_ms, p99_ms).

    Measures a mid-sequence window (``skip`` frames in) so the keyframe
    cadence matches the sequence-wide regime — the bootstrap-adjacent frames
    are ~75% keyframes vs ~37% overall (see measure_stream_device)."""
    import jax

    from stereo_vo.engine.step import VOEngine

    engine = VOEngine(cfg, frames[0].left.shape)
    state = engine.init_state()
    state, _ = engine.bootstrap(
        state, jax.numpy.asarray(frames[0].left), jax.numpy.asarray(frames[0].right)
    )
    skip = min(skip, max(len(frames) - n - 1, 0))
    for f in frames[1 : 1 + skip]:
        state, _ = engine.step(
            state, jax.numpy.asarray(f.left), jax.numpy.asarray(f.right)
        )
    lat = []
    for i, f in enumerate(frames[1 + skip : 1 + skip + n]):
        t0 = time.perf_counter()
        left = jax.numpy.asarray(f.left)
        right = jax.numpy.asarray(f.right)
        state, out = engine.step(state, left, right)
        np.asarray(out.summary)  # pose available on host = frame done
        if i > 0:  # first step call pays compilation
            lat.append((time.perf_counter() - t0) * 1e3)
    if not lat:
        return None, None
    return round(float(np.percentile(lat, 50)), 1), round(float(np.percentile(lat, 99)), 1)


def measure_ba_iters():
    """LM iterations/s of the Schur solver (BASELINE.md "BA iterations/s"
    target) at the reference size (5 poses x 2048 landmark slots) and a
    scaled one (32 poses x 16384 slots). ``scan_k`` full solves run inside
    one jit call, each on a differently perturbed problem; the rate is the
    median of three timed groups, and the groups' spread is reported."""
    import jax
    import jax.numpy as jnp

    from stereo_vo.backend.schur import lm_loop
    from stereo_vo.core.camera import CameraInfo
    from stereo_vo.core.config import BackendConfig
    from stereo_vo.data.synthetic import synthetic_ba_problem

    cam = CameraInfo(focal=718.856, cx=607.19, cy=185.22, baseline=0.537)
    out = {}
    for tag, w, lcap, iters, scan_k in (
        ("ref_5x2048", 5, 2048, 12, 16), ("big_32x16384", 32, 16384, 12, 2)
    ):
        prob = jax.device_put(synthetic_ba_problem(w, lcap, cam))
        cfg = BackendConfig(window_size=w, landmark_capacity=lcap, max_lm_iters=iters)

        def scanned(p, deltas):
            def body(c, d):
                o = lm_loop(p._replace(lm_pos=p.lm_pos + d), cam, cfg, None)
                return c + o[3], None

            return jax.lax.scan(body, jnp.float32(0.0), deltas)[0]

        fn = jax.jit(scanned)
        deltas = jnp.arange(scan_k, dtype=jnp.float32)[:, None, None] * 1e-6
        _ = np.asarray(fn(prob, deltas))  # compile
        _ = np.asarray(fn(prob, deltas + 7e-7))
        groups = []
        for g in range(3):
            reps = 2
            t0 = time.perf_counter()
            for i in range(reps):
                _ = np.asarray(fn(prob, deltas + (g * reps + i) * 1e-7))
            groups.append(reps * scan_k * iters / (time.perf_counter() - t0))
        groups.sort()
        med = float(np.median(groups))
        out[tag] = round(med, 1)
        out[tag + "_spread"] = round((groups[-1] - groups[0]) / med, 2)
        out[tag + "_scan_k"] = scan_k
    return out


def measure_stream_device(cfg, frames, n=16, skip=48):
    """Per-step time of the streaming program over a mid-sequence window.

    The window starts at frame ``skip``, past the bootstrap-adjacent frames
    whose keyframe cadence is far above the sequence-wide one. ``scan_ms``
    scans ``n`` steps of the STREAMING program (no hoisted precomputation)
    inside one jit call with one final fetch; ``loop_ms`` walks the same
    window with one ``engine.step`` call per frame.

    Returns ``(scan_ms, loop_ms, kf_ratio_in_window)``."""
    import jax
    import jax.numpy as jnp

    from stereo_vo.engine.step import VOEngine

    engine = VOEngine(cfg, frames[0].left.shape)
    state = engine.init_state()
    state, _ = engine.bootstrap(
        state, jnp.asarray(frames[0].left), jnp.asarray(frames[0].right)
    )
    skip = min(skip, max(len(frames) - n - 1, 0))
    window = frames[1 + skip : 1 + skip + n]
    n = len(window)

    # advance state to the window start through the chunked path (fast)
    if skip:
        lefts = jnp.stack([jnp.asarray(f.left) for f in frames[1 : 1 + skip]])
        rights = jnp.stack([jnp.asarray(f.right) for f in frames[1 : 1 + skip]])
        state, _, _ = engine.replay_chunk(state, lefts, rights)

    lefts = jnp.stack([jnp.asarray(f.left) for f in window])
    rights = jnp.stack([jnp.asarray(f.right) for f in window])

    def scan_stream(st, ls, rs):
        def body(s, xs):
            s, out = engine._step(s, xs[0], xs[1])
            return s, out.summary
        return jax.lax.scan(body, st, (ls, rs))

    fn = jax.jit(scan_stream)
    _, summ = fn(state, lefts, rights)
    summ_h = np.asarray(summ)  # compile + fetch
    kf_ratio = float(summ_h[:, 7].mean())
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        _, summ = fn(state, lefts, rights)
        np.asarray(summ)
        ts.append((time.perf_counter() - t0) * 1e3 / n)
    scan_ms = round(float(np.median(ts)), 1)

    # dispatch-pipelined per-call walk over the same window
    devs = [jax.device_put(np.asarray(f.left)) for f in window]
    devs_r = [jax.device_put(np.asarray(f.right)) for f in window]
    st, out = engine.step(state, devs[0], devs_r[0])  # compile
    np.asarray(out.summary)
    ts = []
    for _ in range(3):
        s = state
        t0 = time.perf_counter()
        for le, ri in zip(devs, devs_r):
            s, out = engine.step(s, le, ri)
        np.asarray(out.summary)
        ts.append((time.perf_counter() - t0) * 1e3 / n)
    loop_ms = round(float(np.median(ts)), 1)
    return scan_ms, loop_ms, round(kf_ratio, 3)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--chunk", type=int, default=None)
    args = ap.parse_args()

    device = device_info()
    from stereo_vo.utils.cache import setup_compilation_cache

    setup_compilation_cache()

    if args.chunk is None:
        args.chunk = 16 if args.quick else 64
    n_frames = 48 if args.quick else args.frames
    # bootstrap frame + whole chunks only (a partial tail would stream through
    # engine.step, whose first-use compile would pollute the timed region);
    # at least 2 chunks — the first absorbs compilation and is untimed
    n_frames = 1 + max(2, round((n_frames - 1) / args.chunk)) * args.chunk

    cfg, world = build_world(n_frames)
    frames = list(world)

    # Headline fps on a LONGER sequence and BIGGER chunk than the accuracy
    # legs: 3 timed chunks after the compiling one, median of 3 warm
    # repeats. The trajectory is identical across chunkings (same scan body,
    # same state carry), so accuracy legs keep their length and chunk.
    chunk_s = args.chunk * 2
    n_speed = 1 + 3 * chunk_s
    if n_speed > n_frames:
        _, world_s = build_world(n_speed)
        frames_s = list(world_s)
    else:
        frames_s = frames
    run_speed = measure_replay(cfg, frames_s, chunk_s, reps=3)
    fps = run_speed.frames_per_sec
    kf = sum(1 for s in run_speed.frame_stats if s["is_keyframe"])
    kf_ratio = kf / max(len(run_speed.frame_stats), 1)
    timing_meta = {
        "frames": len(run_speed.frame_stats),
        "chunk": chunk_s,
        "reps": 3,
        "timed_from": "device completion of chunk 1 to device completion of "
                      "the last chunk",
    }

    # accuracy anchor at the standard length (reused as billboard seed 0)
    run = (run_speed if len(frames_s) == len(frames)
           else measure_replay(cfg, frames, args.chunk))

    # BA leg FIRST, before any OpenCV CPU sweep warms host threads/caches
    ba_iters = measure_ba_iters()

    twin = measure_cpu_twin(frames, kf_ratio)
    cpu_fps = twin["fps_median"] if twin else None

    # --- accuracy parity, SAME frames both sides (VERDICT r1 item 2) -------
    # Averaged over seeds: single-run keyframe-ATE is chaotic (sub-pixel
    # perturbations flip 129-frame trajectories between ~0.5 m and ~1.1 m
    # basins — measured across equal-quality builds), so parity is judged on
    # a multi-seed mean, never one draw. Two worlds (VERDICT r3 item 2): the
    # billboard world (band-limited-noise texture, the fps world) AND the
    # photo-textured world (natural image statistics — the regime the
    # pipeline defaults are tuned for; the representative accuracy number).
    acc_seeds = [0] if args.quick else [0, 1, 2]
    # the photo world's twin ATE swings ~4.6x across 3 seeds (VERDICT r4 weak
    # #4): its gate needs >=5 seeds and a per-seed-ratio median to be stable
    photo_seeds = [0] if args.quick else [0, 1, 2, 3, 4]

    def accuracy_for_world(texture, reuse_seed0=None, seeds=None):
        seeds = acc_seeds if seeds is None else seeds
        ours_kf, ours_kfa, ours_all = [], [], []
        twin_kfm, twin_kfa, twin_all = [], [], []
        for seed in seeds:
            if seed == 0 and reuse_seed0 is not None:
                w_s, frames_s, run_s = reuse_seed0
            else:
                _, w_s = build_world(n_frames, seed=seed, texture=texture)
                frames_s = list(w_s)
                run_s = measure_replay(cfg, frames_s, args.chunk)
            gt_s = w_s.gt_poses[: len(run_s.poses)]
            kf_s = np.array([s["is_keyframe"] for s in run_s.frame_stats])
            ours_kf.append(ate_pair(run_s.poses, gt_s, kf_s))
            ours_kfa.append(ate_pair(run_s.poses, gt_s, kf_s, align=True))
            ours_all.append(ate_pair(run_s.poses, gt_s))
            tp, ts = measure_twin_trajectory(frames_s, cfg)
            if tp is not None:
                tp = tp[: len(gt_s)]
                tm = np.array([s["is_keyframe"] for s in ts])[: len(tp)]
                twin_kfm.append(ate_pair(tp, gt_s[: len(tp)], tm))
                twin_kfa.append(ate_pair(tp, gt_s[: len(tp)], tm, align=True))
                twin_all.append(ate_pair(tp, gt_s[: len(tp)]))

        def mean(xs):
            xs = [x for x in xs if x is not None]
            return round(float(np.mean(xs)), 3) if xs else None

        acc = {
            "ate_keyframes_m": mean(ours_kf),
            "ate_keyframes_aligned_m": mean(ours_kfa),
            "ate_all_m": mean(ours_all),
            "ate_seeds": seeds,
            "ate_keyframes_per_seed": ours_kf,
            "ate_all_per_seed": ours_all,
        }
        if twin_all:
            acc.update(
                twin_ate_keyframes_m=mean(twin_kfm),
                twin_ate_keyframes_aligned_m=mean(twin_kfa),
                twin_ate_all_m=mean(twin_all),
                twin_ate_all_per_seed=twin_all,
            )
            if acc["ate_all_m"] and acc["twin_ate_all_m"]:
                acc["ate_vs_twin"] = round(acc["ate_all_m"] / acc["twin_ate_all_m"], 3)
            # per-seed ratios + their median: robust to one bad twin seed
            # (the mean-of-ATEs ratio swings with the denominator's outliers)
            ratios = [
                round(o / t, 3)
                for o, t in zip(ours_all, twin_all)
                if o is not None and t is not None and t > 0
            ]
            if ratios:
                acc["ate_vs_twin_per_seed"] = ratios
                acc["ate_vs_twin_median"] = round(float(np.median(ratios)), 3)
        return acc

    acc_bill = accuracy_for_world(None, reuse_seed0=(world, frames, run))
    from stereo_vo.data.synthetic import load_sample_photo

    photo_tex = load_sample_photo()
    acc_photo = (
        accuracy_for_world(photo_tex, seeds=photo_seeds)
        if photo_tex is not None else None
    )

    # billboard keys stay top-level for cross-round continuity; the photo
    # world is the headline accuracy gate (target ate_vs_twin_photo <= 1.05,
    # judged on the median of per-seed ratios over >=5 seeds — VERDICT r4
    # weak #4: the 3-seed mean ratio rode a 4.6x-spread denominator)
    acc = dict(acc_bill)
    acc["worlds"] = {"billboard": acc_bill, "photo": acc_photo}
    if acc_photo and acc_photo.get("ate_vs_twin") is not None:
        acc["ate_vs_twin_photo"] = acc_photo.get(
            "ate_vs_twin_median", acc_photo["ate_vs_twin"]
        )

    p50, p99 = measure_stream_latency(cfg, frames)
    dev_ms, loop_ms, stream_kf = measure_stream_device(cfg, frames)

    # ---- auditable throughput receipts (VERDICT r4 item 1a) ---------------
    # hint engagement comes free from the headline replay's per-frame rows
    hint_all = [s.get("hinted", False) for s in run.frame_stats]
    cruise = [s.get("hinted", False) for s in run.frame_stats
              if not s["is_keyframe"]]
    engagement = {
        "overall": round(float(np.mean(hint_all)), 3) if hint_all else None,
        "cruise": round(float(np.mean(cruise)), 3) if cruise else None,
    }

    stage_ms = None
    if not args.quick:
        from benchmarks.probe_stages import probe_stage_timings

        stage_ms = probe_stage_timings(k=32)

    # keyframe-cadence sensitivity (VERDICT r4 item 7): fps at a sparser and
    # a denser cadence on the same frames, so the headline's dependence on
    # the bench world's 37% keyframe regime is explicit
    cadence = None
    if not args.quick:
        cadence = {}
        from stereo_vo.core.config import _apply_overrides

        for tag, thresh in (("sparse_kf", 40.0), ("dense_kf", 10.0)):
            cfg_c = _apply_overrides(cfg, {"frontend": {"parallax_thresh": thresh}})
            run_c = measure_replay(cfg_c, frames_s, chunk_s, reps=3)
            kf_c = sum(1 for s in run_c.frame_stats if s["is_keyframe"])
            cadence[tag] = {
                "fps": round(run_c.frames_per_sec, 1),
                "kf_ratio": round(kf_c / max(len(run_c.frame_stats), 1), 3),
                "parallax_thresh": thresh,
            }

    result = {
        "metric": "vo_frames_per_sec_1chip",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / cpu_fps, 2) if cpu_fps else None,
        "device": device,
        "details": {
            "frames": len(run_speed.poses),
            "keyframes": kf,
            "timing": timing_meta,
            # fps depends strongly on the keyframe regime (kf frames pay
            # PnP+StereoBM+BA); state it so rounds are comparable
            "keyframe_ratio": round(kf_ratio, 3),
            "cpu_twin_fps": cpu_fps,
            "cpu_twin": twin,
            **acc,
            "stream_ms_p50": p50,
            "stream_ms_p99": p99,
            # the STREAMING program scanned in one call over a mid-sequence
            # window, and the same window one call per frame (see
            # measure_stream_device)
            "stream_ms_device": dev_ms,
            "stream_ms_loop": loop_ms,
            "stream_window_kf_ratio": stream_kf,
            "hint_engagement": engagement,
            "stage_ms": stage_ms,
            "cadence_fps": cadence,
            "ba_lm_iters_per_sec": ba_iters,
            "image": "376x1241 synthetic (kitti00 intrinsics)",
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
