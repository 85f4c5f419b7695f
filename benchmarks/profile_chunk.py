#!/usr/bin/env python
"""Attribute on-device time inside the chunked replay to framework source lines.

Runs one warm (pre-compiled) `replay_chunk` call under `jax.profiler.trace` and
prints the top HLO-source hotspots (`utils.profiling.summarize_trace`), plus
the wall time of the traced chunk. Host wall clocks around single ops measure
dispatch, not the device; the trace records device-side op durations
directly.

Usage: python benchmarks/profile_chunk.py [--frames 33] [--chunk 16] [--top 30]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

# invoked as `python benchmarks/profile_chunk.py`, sys.path gets benchmarks/,
# not the repo root where the package lives
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=33)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--skip", type=int, default=0,
                    help="advance the state through this many frames (in "
                         "chunk-size steps) before tracing — profiles a "
                         "cruise-phase window instead of the kf-dense start")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--out", default="/tmp/svo_trace")
    args = ap.parse_args()
    args.skip = (args.skip // args.chunk) * args.chunk

    from stereo_vo.utils.cache import setup_compilation_cache

    setup_compilation_cache()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from stereo_vo.core.config import load_config
    from stereo_vo.data.synthetic import SyntheticStereoSequence
    from stereo_vo.engine.step import VOEngine
    from stereo_vo.utils.profiling import device_trace, summarize_trace

    cfg = load_config("kitti00")
    world = SyntheticStereoSequence(
        cam=cfg.camera, n_frames=max(args.frames, 1 + args.skip + args.chunk),
        shape=(376, 1241), n_points=4000,
        seed=0, speed=0.8, yaw_rate=0.003,
    )
    frames = list(world)
    engine = VOEngine(cfg, frames[0].left.shape)
    state = engine.init_state()
    state, _ = engine.bootstrap(
        state, jnp.asarray(frames[0].left), jnp.asarray(frames[0].right)
    )
    for lo in range(1, 1 + args.skip, args.chunk):
        ch = frames[lo: lo + args.chunk]
        state, _, summ = engine.replay_chunk(
            state,
            jnp.asarray(np.stack([f.left for f in ch])),
            jnp.asarray(np.stack([f.right for f in ch])),
        )
    if args.skip:
        kf_skip = float(np.asarray(summ)[:, 7].sum())
        print(f"[profile] skipped to frame {1 + args.skip} "
              f"(last chunk: {kf_skip:.0f} keyframes)")

    lo = 1 + args.skip
    lefts = jnp.asarray(np.stack([f.left for f in frames[lo: lo + args.chunk]]))
    rights = jnp.asarray(np.stack([f.right for f in frames[lo: lo + args.chunk]]))

    # warm-up: compile + run once so the trace sees steady state
    state2, poses, summ = engine.replay_chunk(state, lefts, rights)
    np.asarray(summ)
    kf = float(np.asarray(summ)[:, 7].sum())
    print(f"[profile] warm chunk: {args.chunk} frames, {kf:.0f} keyframes")

    t0 = time.perf_counter()
    with device_trace(args.out):
        _, poses, summ = engine.replay_chunk(state, lefts, rights)
        np.asarray(summ)
    wall = time.perf_counter() - t0
    print(f"[profile] traced chunk wall: {wall * 1e3:.1f} ms "
          f"({wall * 1e3 / args.chunk:.2f} ms/frame)")

    rows = summarize_trace(args.out, top=args.top)
    total = sum(r[0] for r in rows)
    print(f"[profile] top-{args.top} source attribution (device ms, chunk total"
          f" {total:.1f}):")
    for ms, src in rows:
        print(f"  {ms:8.2f}  {src}")


if __name__ == "__main__":
    main()
