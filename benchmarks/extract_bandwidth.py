#!/usr/bin/env python
"""Region extraction on the GPU against the card's reachable copy bandwidth.

Times ``ops.lk.extract_regions`` (a vmapped ``dynamic_slice``, lowered by XLA)
at the shapes the pipeline uses: LK regions of 88x88 (top pyramid level) and
56x56 (finer levels) for N = 160 (the live-slot compaction width) and N = 448
(feature capacity), from a 376x1241 image plus edge padding, and StereoBM's
32x32 / 32x80 rectangles for N = 320. A large elementwise copy in the same
process gives the bandwidth ceiling. For each shape it prints the device time
per call (summed kernel time from a profiler trace), the host time per call
(``block_until_ready`` after each call), the bytes moved (regions read +
written), those bytes over the device time as a share of the ceiling, and
the device time of a plain copy of the same number of bytes (the floor any
kernel of that size meets).

Usage: python benchmarks/extract_bandwidth.py [--reps 50]
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHAPES = (  # (label, N, RY, RX, pad)
    ("lk_top_88", 448, 88, 88, 39),
    ("lk_top_88", 160, 88, 88, 39),
    ("lk_fine_56", 448, 56, 56, 23),
    ("lk_fine_56", 160, 56, 56, 23),
    ("bm_left_32x32", 320, 32, 32, 66),
    ("bm_right_32x80", 320, 32, 80, 66),
)


def kernel_ns(trace_dir: str) -> int:
    """Summed duration of the GPU kernels in a profiler trace."""
    import jax

    files = glob.glob(os.path.join(trace_dir, "plugins", "profile", "*", "*.xplane.pb"))
    if not files:
        raise FileNotFoundError(f"no xplane.pb under {trace_dir}")
    total = 0
    lines = set()
    for plane in jax.profiler.ProfileData.from_file(files[0]).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            lines.add(line.name)
            if line.name.startswith("Stream"):
                total += sum(ev.duration_ns for ev in line.events)
    if not total:
        raise RuntimeError(f"no GPU kernel events; device lines seen: {sorted(lines)}")
    return total


def time_call(fn, args, reps):
    """(device seconds per call from a trace, host seconds per call)."""
    import jax

    jax.block_until_ready(fn(*args))
    host = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        host.append(time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            for _ in range(reps):
                jax.block_until_ready(fn(*args))
        dev_ns = kernel_ns(d)
    host.sort()
    return dev_ns * 1e-9 / reps, host[len(host) // 2]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from stereo_vo.ops.lk import extract_regions
    from stereo_vo.utils.device import card_name_and_power_limit, require_gpu

    dev = require_gpu()
    print(f"device: {dev.device_kind} x{len(jax.devices())}; "
          f"card: {card_name_and_power_limit()}")

    n_copy = 256 * 2**20                     # 1 GiB of f32
    x = jnp.ones((n_copy,), jnp.float32)
    copy = jax.jit(lambda a: a + 1.0)
    dev_s, host_s = time_call(copy, (x,), args.reps)
    ceiling = 2 * 4 * n_copy / dev_s
    print(f"copy 1 GiB (read + write): device {dev_s * 1e6:.1f} us, host "
          f"{host_s * 1e6:.1f} us -> ceiling {ceiling / 1e9:.1f} GB/s")
    del x

    rng = np.random.default_rng(0)
    h, w = 376, 1241
    fn = jax.jit(extract_regions, static_argnums=(2, 3))
    for label, n, ry, rx, pad in SHAPES:
        hp, wp = h + 2 * pad, w + 2 * pad
        stack = jnp.asarray(rng.uniform(0, 255, (1, hp, wp)).astype(np.float32))
        origins = np.stack([rng.integers(0, wp - rx + 1, n),
                            rng.integers(0, hp - ry + 1, n)], 1).astype(np.int32)
        origins = jnp.asarray(origins)
        dev_s, host_s = time_call(lambda s, o: fn(s, o, ry, rx), (stack, origins),
                                  args.reps)
        moved = 2 * 4 * n * ry * rx
        share = moved / dev_s / ceiling
        same = jnp.ones((n * ry * rx,), jnp.float32)
        copy_s, _ = time_call(copy, (same,), args.reps)
        print(f"extract {label} N={n} {ry}x{rx}: device {dev_s * 1e6:.2f} us, host "
              f"{host_s * 1e6:.1f} us, {moved / 1e6:.2f} MB moved, "
              f"{moved / dev_s / 1e9:.1f} GB/s = {share:.3f} of the copy ceiling; "
              f"same-size copy {copy_s * 1e6:.2f} us")


if __name__ == "__main__":
    main()
