#!/usr/bin/env python
"""Device time per frame of the chunked replay.

Dispatches K sequential `replay_chunk` calls (state carried device-side, real
frame batches) with NO host sync until one final fetch, so per-call dispatch
hides behind compute and wall/(K*chunk) approximates on-device ms per frame.
Compares against the driver-measured fps (which includes host work and result
fetches) to locate the bottleneck.

Usage: python benchmarks/chunk_device_time.py [--chunk 64] [--k 4]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    from stereo_vo.utils.cache import setup_compilation_cache

    setup_compilation_cache()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from stereo_vo.core.config import load_config
    from stereo_vo.data.synthetic import SyntheticStereoSequence
    from stereo_vo.engine.step import VOEngine

    cfg = load_config("kitti00")
    n_frames = 1 + args.chunk * args.k
    world = SyntheticStereoSequence(
        cam=cfg.camera, n_frames=n_frames, shape=(376, 1241), n_points=4000,
        seed=0, speed=0.8, yaw_rate=0.003,
    )
    frames = list(world)
    engine = VOEngine(cfg, frames[0].left.shape)
    state0 = engine.init_state()
    state0, _ = engine.bootstrap(
        state0, jnp.asarray(frames[0].left), jnp.asarray(frames[0].right)
    )

    chunks = []
    for ci in range(args.k):
        lo = 1 + ci * args.chunk
        chunks.append((
            jnp.asarray(np.stack([f.left for f in frames[lo: lo + args.chunk]])),
            jnp.asarray(np.stack([f.right for f in frames[lo: lo + args.chunk]])),
        ))
    jax.block_until_ready(chunks)

    # compile + warm
    st, poses, summ = engine.replay_chunk(state0, *chunks[0])
    np.asarray(summ)

    ts = []
    kf = None
    for _ in range(args.reps):
        st = state0
        t0 = time.perf_counter()
        outs = []
        for le, ri in chunks:
            st, poses, summ = engine.replay_chunk(st, le, ri)
            outs.append(summ)
        total_kf = sum(np.asarray(s)[:, 7].sum() for s in outs)  # blocks
        ts.append(time.perf_counter() - t0)
        kf = total_kf
    n = args.k * args.chunk
    ms = float(np.median(ts)) * 1e3 / n
    print(f"device-pipelined: {ms:.2f} ms/frame ({1e3 / ms:.1f} f/s) over "
          f"{n} frames, {kf:.0f} keyframes ({kf / n:.1%}), reps={args.reps}")


if __name__ == "__main__":
    main()
