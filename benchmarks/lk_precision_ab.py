#!/usr/bin/env python
"""LK sampling precision on the GPU: TF32 (``DEFAULT``) against f32 (``HIGHEST``).

``ops.lk.SAMPLE_PRECISION`` is read when LK is traced; this script sets it
before each trace. One process, three parts:

  1. Kernel. The fused forward/backward LK call at kitti00 width (376x1241,
     4 levels, 448 Shi-Tomasi corners of billboard frame 0) on the card at each
     precision, against the CPU at full f32 (``chip_smoke.lk_parity``): median,
     p99 and max |d| over the features tracked in both runs and over the
     round-trip-gated set, status agreement, and the device time per call.
  2. Gathers. LK straggler compaction (128 of 448 88x88 regions) and the flow
     hint (448 x 2) as ``jnp.take``, against the one-hot matmuls they replaced.
  3. Trajectory. Chunked replay (``run_vo``, chunk 16) of the billboard world
     and a photo-textured world for each seed at each precision, with the
     pipeline otherwise unchanged: aligned ATE over all frames and over the
     first 9, and replay frames/s. The photo world needs ``--photo`` (a
     ``.npy`` texture, e.g. ``data.synthetic.load_sample_photo()`` saved where
     matplotlib exists) or matplotlib's sample photo; without either it is
     skipped.

Usage: python benchmarks/lk_precision_ab.py [--seeds 0 1 2] [--frames 49]
           [--photo texture.npy] [--reps 20]
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CHUNK = 16
N_HEAD = 9  # the streamed window chip_smoke checks: bootstrap + 8 steps


@contextlib.contextmanager
def sample_precision(precision):
    from stereo_vo.ops import lk

    old = lk.SAMPLE_PRECISION
    lk.SAMPLE_PRECISION = precision
    try:
        yield
    finally:
        lk.SAMPLE_PRECISION = old


def render(job):
    """Frames of one (texture, seed) world; runs in a worker process."""
    texture, seed, n_frames = job
    from stereo_vo.core.config import load_config
    from stereo_vo.data.synthetic import kitti_like_sequence

    return list(kitti_like_sequence(load_config("kitti00").camera, n_frames,
                                    seed=seed, texture=texture))


def kernel_ab(dev, cpu, cfg, precisions, reps):
    import chip_smoke as cs
    from benchmarks.extract_bandwidth import time_call
    from stereo_vo.data.synthetic import kitti_like_sequence

    world = kitti_like_sequence(cfg.camera, 2, seed=0)
    for name, p in precisions:
        with sample_precision(p):
            st, args, _ = cs.lk_parity(dev, cpu, cfg, world)
            fn = cs.lk_fn(cfg.frontend)
            dev_s, host_s = time_call(fn, cs._on(dev, args), reps)
        (tm, tp, tx), (gm, gp, gx) = st["tracked_median_max"], st["gated_median_max"]
        print(f"kernel {name}: {st['valid']} seeded, tracked both {st['tracked_both']}, "
              f"gated both {st['gated_both']}; tracked median {tm:.3g} p99 {tp:.3g} "
              f"max {tx:.3g} px; gated median {gm:.3g} p99 {gp:.3g} max {gx:.3g} px; "
              f"status agree {st['status_agree']:.4f}, gated agree "
              f"{st['gated_agree']:.4f}; device {dev_s * 1e3:.3f} ms, host "
              f"{host_s * 1e3:.3f} ms per call", flush=True)


def gathers_ab(dev, reps):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from benchmarks.extract_bandwidth import time_call

    hi = jax.lax.Precision.HIGHEST
    rng = np.random.default_rng(0)
    n, k = 448, 128
    regions = jax.device_put(rng.uniform(-30, 30, (n, 1, 88, 88)).astype(np.float32), dev)
    idx = jax.device_put(rng.permutation(n)[:k].astype(np.int32), dev)
    take = jax.jit(lambda a, i: jnp.take(a, i, axis=0))

    def onehot(p):
        def f(a, i):
            sel = (i[:, None] == jnp.arange(a.shape[0])[None]).astype(a.dtype)
            return jnp.einsum("kn,nq->kq", sel, a.reshape(a.shape[0], -1),
                              precision=p).reshape((i.shape[0],) + a.shape[1:])
        return jax.jit(f)

    want = np.asarray(take(regions, idx))
    for name, fn in (("take", take), ("onehot_highest", onehot(hi))):
        dev_s, host_s = time_call(fn, (regions, idx), reps)
        same = np.array_equal(np.asarray(fn(regions, idx)), want)
        print(f"compaction gather {k} of {n} 88x88 {name}: device {dev_s * 1e6:.2f} us, "
              f"host {host_s * 1e6:.1f} us, equal to take: {same}", flush=True)

    flow = jax.device_put(rng.normal(0, 20, (n, 2)).astype(np.float32), dev)
    nn = jax.device_put(rng.integers(0, n, n).astype(np.int32), dev)
    want = np.asarray(take(flow, nn))
    for name, fn in (("take", take), ("onehot_default", onehot(None)),
                     ("onehot_highest", onehot(hi))):
        dev_s, host_s = time_call(fn, (flow, nn), reps)
        same = np.array_equal(np.asarray(fn(flow, nn)), want)
        print(f"flow hint gather {n}x2 {name}: device {dev_s * 1e6:.2f} us, "
              f"host {host_s * 1e6:.1f} us, equal to take: {same}", flush=True)


def trajectory_ab(cfg, precisions, worlds):
    """``worlds``: {(world, seed): frames}. Prints one line per run."""
    import numpy as np

    import chip_smoke as cs
    from stereo_vo.engine.driver import run_vo
    from stereo_vo.engine.step import VOEngine

    results = {}
    for name, p in precisions:
        with sample_precision(p):
            engine = None
            for (world, seed), frames in worlds.items():
                if engine is None:
                    engine = VOEngine(cfg, frames[0].left.shape)
                    t0 = time.perf_counter()
                    run_vo(iter(frames), cfg, chunk_size=CHUNK, engine=engine)
                    print(f"[{name}] compile + first replay {time.perf_counter() - t0:.1f} s",
                          flush=True)
                gt = np.stack([f.gt_pose for f in frames])
                t0 = time.perf_counter()
                run = run_vo(iter(frames), cfg, chunk_size=CHUNK, engine=engine)
                wall = time.perf_counter() - t0
                poses = np.asarray(run.poses)
                ate = cs.aligned_ate(poses, gt)
                head = cs.aligned_ate(poses[:N_HEAD], gt[:N_HEAD])
                results[(name, world, seed)] = ate
                print(f"trajectory {name} {world} seed {seed}: {len(poses)} frames, "
                      f"aligned ATE {ate:.4f} m, first {N_HEAD} {head:.4f} m, "
                      f"{len(poses) / wall:.1f} frames/s (host wall, incl. upload)",
                      flush=True)
    (a, _), (b, _) = precisions
    rel = [results[(a, w, s)] / results[(b, w, s)] - 1 for (w, s) in worlds]
    rel = np.asarray(rel)
    sem = rel.std(ddof=1) / np.sqrt(len(rel)) if len(rel) > 1 else float("nan")
    print(f"paired ATE change {a} vs {b} over {len(rel)} runs: "
          f"{' '.join(f'{r:+.3f}' for r in rel)}; mean {rel.mean():+.4f}, "
          f"median {np.median(rel):+.4f}, standard error {sem:.4f}", flush=True)
    for w in sorted({w for w, _ in worlds}):
        vals = [results[(b, w, s)] for (ww, s) in worlds if ww == w]
        print(f"seed spread of {b} ATE, {w}: min {min(vals):.4f} max {max(vals):.4f} m",
              flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--frames", type=int, default=49)
    ap.add_argument("--photo", default=None, help=".npy photo texture")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import numpy as np

    from stereo_vo.core.config import load_config
    from stereo_vo.data.synthetic import load_sample_photo
    from stereo_vo.utils.cache import setup_compilation_cache
    from stereo_vo.utils.device import card_name_and_power_limit

    photo = np.load(args.photo) if args.photo else load_sample_photo()
    textures = {"billboard": None}
    if photo is None:
        print("photo world skipped: no --photo and no matplotlib sample photo")
    else:
        textures["photo"] = photo
    jobs = [(name, s) for name in textures for s in args.seeds]
    t0 = time.perf_counter()
    with ProcessPoolExecutor(min(len(jobs), 8), mp_context=get_context("spawn")) as ex:
        seqs = ex.map(render, [(textures[n], s, args.frames) for n, s in jobs])
        worlds = dict(zip(jobs, seqs))
    print(f"rendered {len(jobs)} sequences of {args.frames} frames in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"  # the references run there
    import jax

    from stereo_vo.utils.device import require_gpu

    dev = require_gpu()
    cpu = jax.devices("cpu")[0]
    setup_compilation_cache()
    print(f"device: {dev.device_kind} x{len(jax.devices())}; "
          f"card: {card_name_and_power_limit()}", flush=True)
    cfg = load_config("kitti00")
    precisions = (("DEFAULT", jax.lax.Precision.DEFAULT),
                  ("HIGHEST", jax.lax.Precision.HIGHEST))
    kernel_ab(dev, cpu, cfg, precisions, args.reps)
    gathers_ab(dev, args.reps)
    trajectory_ab(cfg, precisions, worlds)


if __name__ == "__main__":
    main()
