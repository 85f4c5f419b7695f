"""Host driver loop.

The replacement for ``vo_node``'s main loop (``vo_node.cpp:139-227``): drains a
frame stream through the drop gate, runs the compiled bootstrap/step, and
collects poses + per-frame metrics. No ROS: outputs are in-memory arrays plus
optional trajectory files / JSONL metrics / feature-track debug images.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional

import numpy as np

from stereo_vo.core.config import PipelineConfig
from stereo_vo.data.stream import drop_gate
from stereo_vo.engine.metrics import MetricsLogger
from stereo_vo.engine.step import VOEngine


def _write_image(path: str, img: np.ndarray) -> None:
    try:
        import cv2

        cv2.imwrite(path, img[..., ::-1])  # RGB -> BGR
    except ImportError:  # pragma: no cover
        np.save(path + ".npy", img)


@dataclasses.dataclass
class VORun:
    poses: np.ndarray                 # [N, 7] published T_cw per processed frame
    gt_poses: Optional[np.ndarray]    # [N, 7] if the stream provides it
    frame_stats: List[dict]
    frames_per_sec: float
    ate: Optional[dict]
    engine: VOEngine
    state: object                     # final VOState
    # chunks that missed the device-resident preload and re-uploaded from the
    # host (0 whenever preload_device=True — tested; >0 would flag a perf bug)
    preload_misses: int = 0


def run_vo(
    stream,
    config: PipelineConfig,
    out_dir: Optional[str] = None,
    max_frames: Optional[int] = None,
    apply_drop_gate: bool = False,
    checkpoint_every: int = 0,
    resume_from: Optional[str] = None,
    chunk_size: int = 0,
    preload_device: bool = False,
    save_track_images: int = 0,
    save_world_points: bool = False,
    progress: bool = False,
    engine: Optional[VOEngine] = None,
) -> VORun:
    """Run the full VO pipeline over a stereo stream.

    ``apply_drop_gate`` reproduces the reference's 0.05 s minimum inter-frame
    interval (``vo_node.cpp:124``); dataset replay at 11 Hz never triggers it.

    ``chunk_size > 1`` enables offline-replay mode: frames are batched and the
    whole chunk runs as one device program (``lax.scan``), amortizing per-call
    dispatch latency. Online/streaming use keeps ``chunk_size = 0`` (one call
    per frame, pose available immediately).

    ``engine`` reuses an already-constructed (and therefore already-compiled)
    ``VOEngine`` — a live source must not pay the first-frame compile stall
    mid-stream (a 20 Hz camera would overflow the bounded queue); build the
    engine and run a warm-up sequence before attaching the live stream.
    """
    import jax

    it = iter(drop_gate(stream, config.runtime.drop_time) if apply_drop_gate else stream)

    first = next(it)
    if engine is None:
        engine = VOEngine(config, first.left.shape)
    elif engine.image_shape != tuple(first.left.shape):
        raise ValueError(
            f"engine compiled for image shape {engine.image_shape}, "
            f"stream delivers {tuple(first.left.shape)}"
        )

    if resume_from:
        from stereo_vo.engine.checkpoint import load_state

        state, start_idx = load_state(resume_from, engine)
    else:
        state = engine.init_state()
        start_idx = 0

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    logger = MetricsLogger(os.path.join(out_dir, "metrics.jsonl")) if out_dir else None

    poses: List[np.ndarray] = []
    gts: List[Optional[np.ndarray]] = []
    stats: List[dict] = []

    from stereo_vo.engine.step import parse_summary

    n_done = 0
    t_start = None
    n_timed_from = 0
    frame = first
    # device-resident sequence in preload mode (uploaded once, outside the
    # timed region — offline replay keeps the dataset in HBM). Stored as ONE
    # [N, H, W] stack per eye and sliced per chunk with a jitted dynamic
    # slice, so chunk grouping needs no alignment assumption: bootstrap may
    # succeed on any frame (the reference just retries the next frame,
    # image_processor.cpp:23-25) and every chunk still hits device memory.
    preload = None          # (pos_by_index, lefts_all, rights_all, slice_fn)
    preload_misses = 0      # chunks that fell back to a host upload

    if preload_device and chunk_size > 1:
        frames_all = [first] + list(it)
        if max_frames is not None:
            frames_all = frames_all[: max_frames + 1]
        it = iter(frames_all[1:])
        if len(frames_all) > chunk_size:
            pos_by_index = {f.index: i for i, f in enumerate(frames_all)}
            lefts_all = jax.numpy.asarray(np.stack([f.left for f in frames_all]))
            rights_all = jax.numpy.asarray(np.stack([f.right for f in frames_all]))
            slice_fn = jax.jit(
                lambda a, i: jax.lax.dynamic_slice_in_dim(a, i, chunk_size)
            )
            preload = (pos_by_index, lefts_all, rights_all, slice_fn)
            jax.block_until_ready([lefts_all, rights_all])

    def record(frame_index, pose, row, gt, allow_ckpt=True):
        nonlocal n_done
        row = {"frame": int(frame_index), **row}
        poses.append(np.asarray(pose))
        gts.append(gt)
        stats.append(row)
        if logger:
            logger.log(row)
        if progress and n_done % 20 == 0:
            print(
                f"[vo] frame {frame_index}: kf={row['is_keyframe']} "
                f"tracked={row['num_tracked']} inliers={row['num_inliers']}"
            )
        n_done += 1
        if allow_ckpt and checkpoint_every and out_dir and n_done % checkpoint_every == 0:
            from stereo_vo.engine.checkpoint import save_state

            save_state(os.path.join(out_dir, "checkpoint.npz"), state, frame_index + 1)

    def dump_world_points(st, frame_index):
        """Write the live landmark table — the working equivalent of the
        reference's (disabled) ``/vo/features`` marker publisher
        (``vo_node.cpp:191-222``). One ``id x y z refcount`` row per live
        landmark, per keyframe (streaming) / per chunk end (chunked)."""
        if not (save_world_points and out_dir):
            return
        wdir = os.path.join(out_dir, "world_points")
        os.makedirs(wdir, exist_ok=True)
        win = st.window
        valid = np.asarray(win.lm_valid)
        pos = np.asarray(win.lm_pos)[valid]
        refc = np.asarray(win.lm_refcount)[valid]
        ids = np.nonzero(valid)[0]
        with open(os.path.join(wdir, f"points_{frame_index:06d}.txt"), "w") as f:
            for i, p, rc in zip(ids, pos, refc):
                f.write(f"{i} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {rc}\n")

    pending_chunk: List = []
    # Dispatched-but-undrained chunk results. Eager mode (any per-chunk
    # consumer active: checkpoints, world points, metrics logger, progress)
    # holds at most one entry — double buffering, the previous chunk fetched
    # only after the next is dispatched. Deferred mode (pure offline replay,
    # nothing consumes results mid-run) holds ALL chunks and fetches once at
    # the end, so no mid-run host<->device round-trip sits between chunks.
    inflight: List = []  # [(frames, poses_dev, summaries_dev, state_after)]
    defer_fetch = not (
        checkpoint_every or save_world_points or progress or logger is not None
    )

    def drain_inflight():
        nonlocal inflight
        entries, inflight = inflight, []
        for fr, poses_dev, summ_dev, state_after in entries:
            ch_poses = np.asarray(poses_dev)
            ch_summaries = np.asarray(summ_dev)
            n_before = n_done
            any_kf = False
            for f, pose, summ in zip(fr, ch_poses, ch_summaries):
                _, row = parse_summary(summ)
                any_kf = any_kf or row["is_keyframe"]
                # chunked mode checkpoints only at chunk boundaries: by drain
                # time the nonlocal `state` already reflects the NEXT
                # dispatched chunk, so the per-frame checkpoint in record()
                # would pair a too-new state with a too-old resume index
                # (duplicating frames on resume)
                record(f.index, pose, row, f.gt_pose, allow_ckpt=False)
            if any_kf and state_after is not None:
                dump_world_points(state_after, fr[-1].index)
            if (
                checkpoint_every
                and out_dir
                and (n_done // checkpoint_every) > (n_before // checkpoint_every)
            ):
                from stereo_vo.engine.checkpoint import save_state

                # state_after is the state at the END of this drained chunk
                # (captured at dispatch), matching resume index fr[-1].index+1
                save_state(
                    os.path.join(out_dir, "checkpoint.npz"), state_after,
                    fr[-1].index + 1,
                )

    def flush_chunk(allow_partial=False):
        nonlocal state, preload_misses
        if chunk_size > 1 and len(pending_chunk) == chunk_size:
            pos = preload[0].get(pending_chunk[0].index) if preload else None
            if pos is not None and pos + chunk_size <= len(preload[0]):
                _, lefts_all, rights_all, slice_fn = preload
                lefts = slice_fn(lefts_all, pos)
                rights = slice_fn(rights_all, pos)
            else:
                if preload is not None:
                    preload_misses += 1
                lefts = jax.numpy.asarray(np.stack([f.left for f in pending_chunk]))
                rights = jax.numpy.asarray(np.stack([f.right for f in pending_chunk]))
            state, ch_poses, ch_summaries = engine.replay_chunk(state, lefts, rights)
            chunk_frames = list(pending_chunk)
            pending_chunk.clear()
            if t_start is None:
                # the first chunk call compiled replay_chunk: wait for it to
                # finish ON DEVICE (no result fetch) and time from here
                jax.block_until_ready(ch_summaries)
                _start_clock(n_done + len(chunk_frames))
            if not defer_fetch:
                drain_inflight()
            inflight.append(
                (chunk_frames, ch_poses, ch_summaries,
                 state if not defer_fetch else None)
            )
        elif allow_partial and pending_chunk:
            # tail shorter than chunk_size: run it through the streaming step
            # (a different-length scan would trigger a fresh compile)
            drain_inflight()
            for f in list(pending_chunk):
                st_new, out = engine.step(
                    state, jax.numpy.asarray(f.left), jax.numpy.asarray(f.right)
                )
                _set_state(st_new)
                pose, row = parse_summary(out.summary)
                record(f.index, pose, row, f.gt_pose)
                if row["is_keyframe"]:
                    dump_world_points(state, f.index)
            pending_chunk.clear()

    def _start_clock(from_n):
        nonlocal t_start, n_timed_from
        t_start = time.perf_counter()
        n_timed_from = from_n

    def _set_state(v):
        nonlocal state
        state = v

    while True:
        n_seen = (n_done + len(pending_chunk)
                  + sum(len(e[0]) for e in inflight))
        if max_frames is not None and n_seen >= max_frames:
            break
        if frame.index >= start_idx:
            initialized = bool(state.initialized)
            if chunk_size > 1 and initialized:
                pending_chunk.append(frame)
                if len(pending_chunk) >= chunk_size:
                    flush_chunk()
            else:
                left = jax.numpy.asarray(frame.left)
                right = jax.numpy.asarray(frame.right)
                fn = engine.step if initialized else engine.bootstrap
                state, out = fn(state, left, right)
                if t_start is None and initialized:
                    # this call compiled engine.step; start the clock after it
                    # so steady-state frames/s excludes compilation
                    out.pose_cw.block_until_ready()
                    t_start = time.perf_counter()
                    n_timed_from = n_done + 1
                pose, row = parse_summary(out.summary)
                if (
                    save_track_images
                    and out_dir
                    and frame.index % save_track_images == 0
                ):
                    # the /feature_tracking debug image (vo_node.cpp:188-189)
                    from stereo_vo.eval.viz import draw_tracks

                    img = draw_tracks(
                        frame.left, np.asarray(out.track_from),
                        np.asarray(out.track_to), np.asarray(out.track_valid),
                    )
                    _write_image(
                        os.path.join(out_dir, f"tracks_{frame.index:06d}.png"), img
                    )
                record(frame.index, pose, row, frame.gt_pose)
                if row["is_keyframe"]:
                    dump_world_points(state, frame.index)
        try:
            frame = next(it)
        except StopIteration:
            break
    flush_chunk(allow_partial=True)
    if defer_fetch and inflight:
        # stop the clock at device completion of the final chunk; the bulk
        # result fetch below is transport, not pipeline throughput
        jax.block_until_ready(inflight[-1][2])
        elapsed = time.perf_counter() - t_start if t_start else 0.0
        drain_inflight()
    else:
        # eager mode: the final chunk is still undrained — fetch (and hence
        # finish) it inside the timed region so n_timed frames are all paid
        drain_inflight()
        elapsed = time.perf_counter() - t_start if t_start else 0.0
    n_timed = max(n_done - (n_timed_from if t_start else 0), 0)
    fps = n_timed / elapsed if elapsed > 0 and n_timed > 0 else 0.0

    poses_arr = np.stack(poses) if poses else np.zeros((0, 7), np.float32)
    gt_arr = (
        np.stack([g for g in gts]) if gts and all(g is not None for g in gts) else None
    )

    ate = None
    if gt_arr is not None and len(poses_arr) >= 3:
        from stereo_vo.eval.ate import absolute_trajectory_error

        ate = absolute_trajectory_error(poses_arr, gt_arr, align=True)

    if out_dir:
        from stereo_vo.eval.trajectory import write_kitti_trajectory, write_tum_trajectory

        write_kitti_trajectory(os.path.join(out_dir, "trajectory_kitti.txt"), poses_arr)
        write_tum_trajectory(os.path.join(out_dir, "trajectory_tum.txt"), poses_arr)
        if logger:
            logger.close()

    return VORun(
        poses=poses_arr,
        gt_poses=gt_arr,
        frame_stats=stats,
        frames_per_sec=fps,
        ate=ate,
        engine=engine,
        state=state,
        preload_misses=preload_misses,
    )
