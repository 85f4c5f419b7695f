#!/usr/bin/env python
"""Smoke test of the stereo VO main path on one NVIDIA GPU.

    python chip_smoke.py

One process, four phases; any failed phase exits non-zero and the JSON
result line is printed only when all pass. There is no CPU fallback.

  a. Device check: JAX's default device must be a GPU. Prints the device,
     JAX version, XLA_FLAGS, the compile-cache directory and the card's name
     and power limit (``nvidia-smi``, run as a child that does not use JAX).
  b. Compile: ``VOEngine.bootstrap``, ``step`` and ``replay_chunk`` (chunk 16)
     at 376x1241 (kitti00, feature capacity 448, landmark capacity 2048,
     window 5). Prints each compile time and ``memory_analysis()``.
  c. Kernel parity at production widths, the card against the same function
     on the CPU under ``jax.default_matmul_precision("highest")``: region
     extraction, fused forward/backward LK, straggler compaction, sparse
     StereoBM, Shi-Tomasi detection and one 5x2048 LM solve. Every statistic
     is printed beside its bound.
  d. End to end through the user entry points: ``svo run --platform gpu
     --synthetic 49 --chunk-size 16`` in-process, then bootstrap + 8 streamed
     ``VOEngine.step`` calls on the same world. Poses must be finite, a
     keyframe must occur, and the aligned ATE must stay within
     2 x (CPU run's ATE on the same frames) + 0.05 m.

The last stdout line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

SHAPE = (376, 1241)
CONFIG = "kitti00"
CHUNK = 16
N_FRAMES = 49
N_STREAM_STEPS = 8
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def check(name: str, value, bound: str, ok: bool, failures: list) -> None:
    log(f"  {name}: {value} (bound: {bound}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(name)


# ----------------------------------------------------------------------------
# a. device check


def device_check():
    import jax

    from stereo_vo.utils.cache import setup_compilation_cache
    from stereo_vo.utils.device import card_name_and_power_limit, require_gpu

    dev = require_gpu()
    cache_dir = setup_compilation_cache()
    log(f"[a] device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    log(f"[a] jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"[a] compile cache: {cache_dir}")
    log(f"[a] nvidia-smi name, power.limit: {card_name_and_power_limit()}")
    return dev, jax.devices("cpu")[0]


# ----------------------------------------------------------------------------
# b. compile


def _compile_and_call(name, fn, args):
    """AOT-compile jitted ``fn`` for ``args`` (timed, with its memory
    analysis), then call it once through the jit, as users do; that call
    reuses the executable just compiled. Returns the call's output."""
    import jax

    t0 = time.perf_counter()
    mem = fn.lower(*args).compile().memory_analysis()
    dt = time.perf_counter() - t0
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes",
              "generated_code_size_in_bytes")
    desc = ", ".join(f"{f[:-9]}={getattr(mem, f, None)}" for f in fields)
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    log(f"[b] {name}: compiled in {dt:.2f} s, first call "
        f"{time.perf_counter() - t0:.2f} s; memory: {desc}")
    return out


def compile_engine(cfg, shape, chunk):
    import jax.numpy as jnp

    from stereo_vo.engine.step import VOEngine

    engine = VOEngine(cfg, shape)
    img = jnp.zeros(shape, jnp.uint8)
    imgs = jnp.zeros((chunk,) + tuple(shape), jnp.uint8)
    booted, _ = _compile_and_call(
        "bootstrap", engine.bootstrap, (engine.init_state(), img, img))
    _compile_and_call("step", engine.step, (booted, img, img))
    _compile_and_call(f"replay_chunk[{chunk}]", engine.replay_chunk,
                      (booted, imgs, imgs))
    return engine


# ----------------------------------------------------------------------------
# c. kernel parity


def _on(dev, tree):
    import jax

    return jax.device_put(tree, dev)


def _reference(cpu, fn, *args):
    """``fn(*args)`` on the CPU at full f32 matmul precision."""
    import jax

    with jax.default_matmul_precision("highest"):
        return jax.device_get(fn(*_on(cpu, args)))


def parity_extract(dev, shape, failures):
    import jax

    from stereo_vo.ops.lk import extract_regions

    rng = np.random.default_rng(SEED)
    pad = 40
    hp, wp = shape[0] + 2 * pad, shape[1] + 2 * pad
    stack = rng.uniform(0, 255, (1, hp, wp)).astype(np.float32)
    for n, ry, rx in ((448, 88, 88), (160, 88, 88), (448, 56, 56),
                      (320, 32, 32), (320, 32, 80)):
        ox = rng.integers(0, wp - rx + 1, n)
        oy = rng.integers(0, hp - ry + 1, n)
        ox[:2], oy[:2] = (0, wp - rx), (0, hp - ry)     # both clip edges
        origins = np.stack([ox, oy], 1).astype(np.int32)
        fn = jax.jit(extract_regions, static_argnums=(2, 3))
        got = np.asarray(fn(*_on(dev, (stack, origins)), ry, rx))
        want = np.stack([stack[:, y:y + ry, x:x + rx] for x, y in origins])
        same = bool(np.array_equal(got, want))
        check(f"extract_regions N={n} {ry}x{rx} vs numpy slicing",
              "bitwise equal" if same else "differs", "bitwise equal", same, failures)


def _tracking_inputs(cfg, world, n_feat):
    """Frames 0 and 1 of ``world`` as host pyramids, and the points to track:
    up to ``n_feat`` Shi-Tomasi corners of frame 0, found on the CPU by the
    pipeline's detector with its corner budget raised to ``n_feat``."""
    import dataclasses

    import jax

    from stereo_vo.frontend.detect import detect_features
    from stereo_vo.ops.pyramid import build_pyramid

    l0, _ = world.render(0)
    l1, _ = world.render(1)
    fe = dataclasses.replace(cfg.frontend, max_detect=n_feat, quality_level=0.01,
                             min_distance=10.0)
    levels = cfg.frontend.lk_max_level
    with jax.default_device(jax.devices("cpu")[0]):
        xy, valid = jax.device_get(detect_features(l0.astype(np.float32), fe))
        pyr0 = [np.asarray(p) for p in build_pyramid(l0.astype(np.float32), levels)]
        pyr1 = [np.asarray(p) for p in build_pyramid(l1.astype(np.float32), levels)]
    return pyr0, pyr1, np.asarray(xy, np.float32), np.asarray(valid)


def lk_fn(fe):
    """The frontend's fused forward/backward LK call, jitted afresh (it
    traces again, so trace-time settings in force at its first call hold)."""
    import jax

    from stereo_vo.ops.lk import lk_track_fwdbwd

    return jax.jit(functools.partial(
        lk_track_fwdbwd, window=fe.lk_window, max_iters=fe.lk_iters, eps=fe.lk_eps,
        min_eig_threshold=fe.lk_min_eig, bwd_levels=fe.lk_bwd_levels,
    ))


def lk_parity(dev, cpu, cfg, world):
    """LK on ``dev`` against the CPU reference at the feature capacity.

    "Tracked" is LK's own status (the forward pass converged in the image);
    "gated" adds the backward pass and the round-trip gate, the set the
    frontend keeps. Returns the statistics, the inputs and the card's output."""
    import jax

    fe = cfg.frontend
    pyr0, pyr1, xy, valid = _tracking_inputs(cfg, world, cfg.backend.feature_capacity)
    args = (pyr0, pyr1, xy, valid)
    got = jax.device_get(lk_fn(fe)(*_on(dev, args)))
    want = _reference(cpu, lk_fn(fe), *args)

    def gated(res):
        _, fwd_ok, back, bwd_ok = res
        return fwd_ok & bwd_ok & (np.linalg.norm(xy - back, axis=1) < fe.fb_thresh)

    def spread(mask):
        d = np.linalg.norm(got[0] - want[0], axis=1)[mask]
        if not d.size:
            return float("nan"), float("nan"), float("nan")
        return float(np.median(d)), float(np.percentile(d, 99)), float(np.max(d))

    tracked = got[1] & want[1]
    kept = gated(got) & gated(want)
    stats = {
        "valid": int(valid.sum()),
        "tracked_cpu": int(want[1].sum()), "tracked_card": int(got[1].sum()),
        "tracked_both": int(tracked.sum()),
        "gated_cpu": int(gated(want).sum()), "gated_card": int(gated(got).sum()),
        "gated_both": int(kept.sum()),
        "tracked_median_max": spread(tracked),
        "gated_median_max": spread(kept),
        "status_agree": float(np.mean(got[1][valid] == want[1][valid])),
        "gated_agree": float(np.mean(gated(got)[valid] == gated(want)[valid])),
    }
    return stats, args, got


@contextlib.contextmanager
def _env(name: str, value: str):
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def parity_lk(dev, cpu, cfg, world, failures):
    import jax

    from stereo_vo.ops.lk import LK_COMPACT_K

    st, args, got = lk_parity(dev, cpu, cfg, world)
    n = st["valid"]
    log(f"  LK: {n} corners seeded; tracked {st['tracked_cpu']} on CPU, "
        f"{st['tracked_card']} on the card, {st['tracked_both']} in both; "
        f"round-trip gated {st['gated_cpu']} / {st['gated_card']} / {st['gated_both']}")
    check("LK features tracked in both runs", st["tracked_both"], f">= 0.85 x {n}",
          st["tracked_both"] >= 0.85 * n, failures)
    for tag, (med, p99, mx) in (("tracked", st["tracked_median_max"]),
                                ("gated", st["gated_median_max"])):
        log(f"  LK {tag}: max |d| {mx:.3g} px")
        check(f"LK {tag} median |d| px", f"{med:.3g}", "<= 0.01", med <= 0.01, failures)
        check(f"LK {tag} p99 |d| px", f"{p99:.3g}", "<= 0.05", p99 <= 0.05, failures)
    check("LK status agreement over valid features", f"{st['status_agree']:.4f}",
          ">= 0.99", st["status_agree"] >= 0.99, failures)
    check("LK gated-status agreement over valid features", f"{st['gated_agree']:.4f}",
          ">= 0.99", st["gated_agree"] >= 0.99, failures)

    # compacting only after the last iteration keeps the full batch throughout
    with _env("STEREO_VO_LK_COMPACT_AFTER", str(cfg.frontend.lk_iters)):
        full = jax.device_get(lk_fn(cfg.frontend)(*_on(dev, args)))
    same = all(np.array_equal(a, b) for a, b in zip(got, full))
    check(f"LK straggler compaction (K={LK_COMPACT_K}) vs full width on the card",
          "bitwise equal" if same else "differs", "bitwise equal", same, failures)


def parity_stereo_bm(dev, cfg, world, failures):
    import jax

    from stereo_vo.ops.stereo_bm import disparity_at, stereo_bm_at, stereo_bm_disparity

    fe = cfg.frontend
    left, right = (x.astype(np.float32) for x in world.render(0))
    h, w = left.shape
    rng = np.random.default_rng(SEED)
    n = fe.max_detect + cfg.backend.feature_capacity
    xy = np.stack([rng.uniform(0, w - 1, n), rng.uniform(0, h - 1, n)], 1)
    xy = xy.astype(np.float32)
    kw = dict(num_disparities=fe.bm_num_disparities, block_size=fe.bm_block_size,
              prefilter_cap=fe.bm_prefilter_cap,
              texture_threshold=fe.bm_texture_threshold,
              uniqueness_ratio=fe.bm_uniqueness_ratio)
    dense = jax.jit(lambda l, r, p: disparity_at(stereo_bm_disparity(l, r, **kw), p))
    sparse = jax.jit(lambda l, r, p, m: stereo_bm_at(
        l, r, p, m, compact_slots=fe.bm_compact_slots, **kw))
    want = np.asarray(dense(*_on(dev, (left, right, xy))))
    for tag, live in (("full width", n), ("compacted", fe.bm_compact_slots - 80)):
        valid = np.zeros(n, bool)
        valid[rng.permutation(n)[:live]] = True
        got = np.asarray(sparse(*_on(dev, (left, right, xy, valid))))
        ref = np.where(valid, want, -1.0)
        same_valid = np.array_equal(got >= 0, ref >= 0)
        ok = ref >= 0
        err = float(np.max(np.abs(got[ok] - ref[ok]))) if ok.any() else 0.0
        log(f"  StereoBM {tag}: {live} live of {n}, {int(ok.sum())} valid disparities")
        check(f"StereoBM sparse vs dense ({tag}) validity", "identical" if same_valid
              else "differs", "identical", same_valid, failures)
        check(f"StereoBM sparse vs dense ({tag}) max |d| px", f"{err:.3g}", "<= 1e-4",
              err <= 1e-4, failures)


def parity_detect(dev, cpu, cfg, world, failures):
    import jax

    from stereo_vo.frontend.detect import detect_features

    left = world.render(0)[0].astype(np.float32)
    fn = jax.jit(lambda img: detect_features(img, cfg.frontend))
    xy_g, ok_g = jax.device_get(fn(_on(dev, left)))
    xy_c, ok_c = _reference(cpu, fn, left)
    ref, got = xy_c[ok_c], xy_g[ok_g]
    if len(ref) == 0 or len(got) == 0:
        check("Shi-Tomasi corners", f"{len(got)} vs {len(ref)}", "> 0", False, failures)
        return
    dist = np.min(np.linalg.norm(ref[:, None] - got[None], axis=-1), axis=1)
    frac = float(np.mean(dist <= 0.5))
    log(f"  Shi-Tomasi: {len(ref)} corners on CPU, {len(got)} on the card")
    check("Shi-Tomasi corners matched within 0.5 px", f"{frac:.4f}", ">= 0.98",
          frac >= 0.98, failures)


def parity_lm(dev, cpu, cfg, failures):
    import dataclasses

    import jax

    from stereo_vo.backend.schur import lm_loop
    from stereo_vo.data.synthetic import synthetic_ba_problem

    w, lcap = cfg.backend.window_size, cfg.backend.landmark_capacity
    bcfg = dataclasses.replace(cfg.backend, max_lm_iters=4, lm_rel_tol=0.0)
    prob = synthetic_ba_problem(w, lcap, cfg.camera)
    fn = jax.jit(lambda p: lm_loop(p, cfg.camera, bcfg, None)[:4])
    got = jax.device_get(fn(_on(dev, prob)))
    want = _reference(cpu, fn, prob)
    dp = float(np.max(np.abs(got[0] - want[0])))
    dl = float(np.max(np.abs(got[1] - want[1])))
    log(f"  LM {w}x{lcap}: cost {float(want[2]):.6g} -> {float(want[3]):.6g} on CPU, "
        f"-> {float(got[3]):.6g} on the card")
    check(f"LM {w}x{lcap} max |pose delta|", f"{dp:.3g}", "<= 2e-4", dp <= 2e-4,
          failures)
    check(f"LM {w}x{lcap} max |landmark delta|", f"{dl:.3g}", "<= 2e-3", dl <= 2e-3,
          failures)


# ----------------------------------------------------------------------------
# d. end to end


def aligned_ate(poses, gt) -> float:
    from stereo_vo.eval.ate import absolute_trajectory_error

    return absolute_trajectory_error(np.asarray(poses), np.asarray(gt), align=True)["rmse"]


def cpu_reference_run(cpu, cfg, frames, chunk):
    """The same replay on the CPU: poses per frame."""
    import jax

    from stereo_vo.engine.driver import run_vo

    with jax.default_device(cpu), jax.default_matmul_precision("highest"):
        run = run_vo(iter(frames), cfg, chunk_size=chunk)
    return run.poses


def cli_run(shape, n_frames, chunk):
    """``svo run --platform gpu`` in this process; returns its summary."""
    from stereo_vo import cli

    argv = ["run", "--platform", "gpu", "--config", CONFIG,
            "--synthetic", str(n_frames), "--synthetic-shape", str(shape[0]),
            str(shape[1]), "--seed", str(SEED), "--chunk-size", str(chunk),
            "--quiet"]
    with tempfile.TemporaryDirectory() as out_dir:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv + ["--out", out_dir])
        if rc != 0:
            raise RuntimeError(f"svo run exited {rc}")
        summary = json.loads(buf.getvalue().strip().splitlines()[-1])
        from stereo_vo.eval.trajectory import load_kitti_trajectory

        positions = load_kitti_trajectory(os.path.join(out_dir, "trajectory_kitti.txt"))
    return summary, positions


def streamed_run(engine, frames):
    """Bootstrap + ``engine.step`` per frame, as a live source would drive
    it, on JAX's default device."""
    import jax
    import jax.numpy as jnp

    from stereo_vo.engine.step import parse_summary

    state = engine.init_state()
    poses, kfs = [], []
    for i, f in enumerate(frames):
        left, right = jnp.asarray(f.left), jnp.asarray(f.right)
        fn = engine.bootstrap if i == 0 else engine.step
        state, out = fn(state, left, right)
        pose, row = parse_summary(jax.device_get(out.summary))
        poses.append(pose)
        kfs.append(row["is_keyframe"])
    return np.stack(poses), kfs


def end_to_end(cpu, cfg, engine, world, shape, chunk, failures):
    frames = list(world)
    gt = np.stack([f.gt_pose for f in frames])
    t0 = time.perf_counter()
    ref_poses = cpu_reference_run(cpu, cfg, frames, chunk)
    log(f"[d] CPU reference replay: {len(ref_poses)} frames in "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    summary, positions = cli_run(shape, len(frames), chunk)
    wall = time.perf_counter() - t0
    ate_gpu = float(summary["ate"]["rmse"]) if summary.get("ate") else float("nan")
    ate_cpu = aligned_ate(ref_poses, gt)
    log(f"[d] svo run: frames={summary['frames']} keyframes={summary['keyframes']} "
        f"wall={wall:.1f} s (compile included)")
    check("svo run frames", summary["frames"], f"== {len(frames)}",
          summary["frames"] == len(frames), failures)
    check("svo run poses finite", bool(np.isfinite(positions).all()), "True",
          bool(np.isfinite(positions).all()), failures)
    check("svo run keyframes", summary["keyframes"], ">= 1",
          summary["keyframes"] >= 1, failures)
    bound = 2.0 * ate_cpu + 0.05
    check("svo run aligned ATE m (card)", f"{ate_gpu:.4f}",
          f"<= 2 x {ate_cpu:.4f} (CPU) + 0.05 = {bound:.4f}", ate_gpu <= bound, failures)

    n = N_STREAM_STEPS + 1
    t0 = time.perf_counter()
    poses, kfs = streamed_run(engine, frames[:n])
    wall = time.perf_counter() - t0
    ate_s = aligned_ate(poses, gt[:n])
    ate_sc = aligned_ate(ref_poses[:n], gt[:n])
    log(f"[d] streamed: bootstrap + {N_STREAM_STEPS} steps, keyframes="
        f"{sum(kfs)} (bootstrap {kfs[0]}), wall={wall:.1f} s")
    check("streamed poses finite", bool(np.isfinite(poses).all()), "True",
          bool(np.isfinite(poses).all()), failures)
    check("streamed keyframes", sum(kfs), ">= 1", sum(kfs) >= 1, failures)
    bound = 2.0 * ate_sc + 0.05
    check("streamed aligned ATE m (card)", f"{ate_s:.4f}",
          f"<= 2 x {ate_sc:.4f} (CPU) + 0.05 = {bound:.4f}", ate_s <= bound, failures)


# ----------------------------------------------------------------------------


def run_phases(dev, cpu, shape=SHAPE, n_frames=N_FRAMES, chunk=CHUNK):
    """Phases b-d on accelerator ``dev`` with CPU references on ``cpu``;
    returns the names of failed checks."""
    from stereo_vo.core.config import load_config
    from stereo_vo.data.synthetic import kitti_like_sequence

    cfg = load_config(CONFIG)
    t0 = time.perf_counter()
    engine = compile_engine(cfg, shape, chunk)
    log(f"[b] done in {time.perf_counter() - t0:.1f} s")

    world = kitti_like_sequence(cfg.camera, n_frames, shape=shape, seed=SEED)
    failures: list = []
    t0 = time.perf_counter()
    log("[c] kernel parity (card vs CPU at highest matmul precision)")
    parity_extract(dev, shape, failures)
    parity_lk(dev, cpu, cfg, world, failures)
    parity_stereo_bm(dev, cfg, world, failures)
    parity_detect(dev, cpu, cfg, world, failures)
    parity_lm(dev, cpu, cfg, failures)
    log(f"[c] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    end_to_end(cpu, cfg, engine, world, shape, chunk, failures)
    log(f"[d] done in {time.perf_counter() - t0:.1f} s")
    return failures


def main() -> int:
    t_start = time.perf_counter()
    # the CPU backend must come up beside the GPU: it runs the references
    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    from stereo_vo.utils.device import NoGPUError, card_name_and_power_limit

    try:
        dev, cpu = device_check()
    except NoGPUError as e:
        print(f"[a] FAIL: {e}", file=sys.stderr)
        return 1
    failures = run_phases(dev, cpu)
    if failures:
        print(f"FAIL: {len(failures)} check(s): {failures}", file=sys.stderr)
        return 1
    import jax

    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(f"card: {card_name_and_power_limit()}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
