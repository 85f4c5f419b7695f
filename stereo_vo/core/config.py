"""Typed configuration tree.

Single source of truth for *every* constant that is hard-coded in the reference
(SURVEY.md §5 "Config / flag system" row), plus the 9 per-camera YAML configs
ported verbatim in meaning (reference ``config/*.yaml``). The camera files are
flat ``key: value`` YAML, read by ``_read_camera_file`` without a YAML
library.

All dataclasses are frozen (hashable) so a ``PipelineConfig`` can be closed over
by jitted functions as a static value.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from stereo_vo.core.camera import CameraInfo

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Detection / tracking / PnP / triangulation constants."""

    # Shi-Tomasi detection (reference image_processor.cpp:22, vo_node.cpp:34)
    max_detect: int = 300
    quality_level: float = 0.1
    min_distance: float = 30.0
    min_detected: int = 4          # bail threshold (image_processor.cpp:23-25)
    detect_block_size: int = 3     # cv::goodFeaturesToTrack default
    # candidate pool fed to greedy min-distance suppression
    nms_candidates: int = 1024

    # Keyframe gate (vo_node.cpp:33, image_processor.cpp:63-65)
    parallax_thresh: float = 20.0
    lost_thresh: float = 0.4

    # Pyramidal LK (feature_tracker.cpp:23-26,47,53)
    lk_window: int = 21
    lk_max_level: int = 3
    lk_iters: int = 30
    lk_eps: float = 0.01
    # Minimum-eigenvalue gate in THIS framework's units: eig of the Scharr/32
    # f32 normal matrix / window area. OpenCV's unit (what the reference's
    # minEigThreshold=1e-2 is expressed in, feature_tracker.cpp:26) is exactly
    # 1/1024 of this (integer Scharr x FLT_SCALE=2^-20; ratio verified
    # numerically), so the reference's gate is 10.24 here. That value is
    # domain-tuned for real-KITTI contrast and measured to starve rendered
    # imagery (see eval/cv_twin.py). The default keeps the gate near-disabled
    # (1e-2 here ~ 1e-5 OpenCV) — the forward-backward round-trip check
    # subsumes it: flat patches that slip the eig gate fail verification.
    lk_min_eig: float = 1e-2
    fb_thresh: float = 2.0         # forward-backward round-trip gate, px
    max_parallax: float = 200.0    # reject absurd tracks (feature_tracker.cpp:53)

    # StereoBM (image_processor.cpp:173-176; OpenCV defaults for the rest)
    bm_num_disparities: int = 48
    bm_block_size: int = 21
    bm_prefilter_cap: int = 31
    bm_texture_threshold: int = 10
    bm_uniqueness_ratio: int = 15
    # Live-slot compaction for the sparse BM call (see lk_compact_slots —
    # same exact gather/scatter trick): the keyframe branch feeds
    # max_detect + feature_capacity slots of which only the deduped new
    # detections + tracked inliers (~240) are valid. 0 disables.
    bm_compact_slots: int = 320

    # PnP-RANSAC (image_processor.cpp:76-80)
    pnp_iterations: int = 100
    pnp_reproj_thresh: float = 8.0
    pnp_confidence: float = 0.99
    # Backward-verification pyramid depth: number of finest levels the
    # round-trip check walks. 0 = all levels, OpenCV's exact coarse-to-fine
    # semantics initialized at the forward endpoint (feature_tracker.cpp:31-47).
    # A truncated pass (1..n_levels-1) instead initializes at the ORIGINAL
    # point — a stricter verification that must re-find the start, not merely
    # round-trip — and skips the costliest (coarsest) backward passes.
    # Measured (160-frame photo-textured sequences, 10 seeds, post-DLT-fix):
    # 2 levels cuts mean ATE 3.28 -> 2.49 m and the worst seed 6.05 -> 3.92
    # (it kills scale-sliding features that full-depth verification passes).
    # On the featureless-billboard bench world it costs ~10% all-frames ATE (1.09 -> 1.20 vs twin 0.97) — natural
    # imagery is the regime that matters. 1 level is too permissive (verifies
    # position only where appearance barely constrains scale): worst seed 1.8x.
    lk_bwd_levels: int = 2
    # Flow-hinted cruise tracking: initialize each feature's forward search
    # at pts + predicted flow (its own previous-step flow; fresh features
    # borrow the nearest tracked neighbor's), so the pyramid only has to
    # absorb the PREDICTION ERROR (~1-3 px at 11 Hz), not the absolute
    # motion (measured per-frame max 30-60 px on KITTI-like worlds — which
    # is why gating on absolute flow never engages). When the previous
    # frame's max prediction error over kept features is below this
    # threshold, LK runs only the lk_hint_levels finest levels, about half
    # the level passes of the full 4-level pyramid. The round-trip gate still verifies every track, and a frame that keeps
    # nothing or kills >15% of its features resets the gate to the full
    # pyramid. 0 disables hinting (OpenCV-exact initialization always).
    lk_hint_pred_err_px: float = 8.0
    lk_hint_levels: int = 2
    # Live-slot compaction: when <= this many feature slots are valid, LK
    # gathers them into a batch of exactly this width (floored to a multiple
    # of 32) and scatters results back; otherwise it runs at full capacity
    # (a lax.cond picks per frame — no feature is ever dropped). Every LK
    # cost scales with batch width (per-feature region extraction, selector
    # matmuls, GN iteration), while the tracker's live count
    # sits far below feature_capacity between keyframes (bench replay:
    # p90 = 115 live of 448 slots), so tracking the ~3x-smaller live set
    # is the single largest frame-time lever. 0 disables.
    lk_compact_slots: int = 160
    pnp_sample_size: int = 6       # DLT minimal sample (batched device solver)
    pnp_refine_iters: int = 4      # GN iterations per LO-RANSAC round
    # PnP inner-loop budgets. PnP is a chain of serial damped-GN iterations
    # (latency-, not FLOP-bound), so these counts ARE the PnP cost model:
    # hypothesis polish (per minimal sample), warm-start trim rounds x
    # iterations, and LO-RANSAC rounds (each running pnp_refine_iters of GN
    # then recounting inliers). On the 6-seed photo-world sweep, polish 2 /
    # warm 2x2 / LO 3x4 matched the ATE of a 3 / 3x2 / 3x10 budget
    # (ratio-vs-twin 0.643 vs 0.638).
    pnp_hyp_polish_iters: int = 2
    pnp_warm_rounds: int = 2
    pnp_warm_iters: int = 2
    pnp_lo_rounds: int = 3


@dataclasses.dataclass(frozen=True)
class BackendConfig:
    """Sliding-window bundle-adjustment constants."""

    window_size: int = 5           # vo_node.cpp:36
    max_features: int = 400        # per-keyframe observation cap (bundle_adjuster.hpp:75)
    # Static per-keyframe feature-array capacity. Must exceed max_features
    # (the only bound on simultaneously-valid slots: tracker re-init packs
    # inlier tracked + new, both capped at 400 total) with headroom for slot
    # packing; every LK cost scales linearly with it, so keep it tight.
    feature_capacity: int = 448
    landmark_capacity: int = 2048  # static landmark-table capacity (>= window*max_features)
    # Ceres budget is 0.1 s wall-clock (bundle_adjuster.cpp:11); here the solve
    # is a fixed iteration cap tuned to land at equivalent accuracy. Solve time
    # is linear in this cap. 10 measured best on 160-frame photo-textured
    # sequences (10-seed mean ATE: 10 iters 2.37 m, 12 iters 2.49, 8 iters 2.83
    # with a 6.1 m worst seed).
    max_lm_iters: int = 10
    # LM early-exit: stop after an accepted step improving cost by less than
    # this fraction (the jit analog of Ceres' function_tolerance; Ceres default
    # 1e-6 with a 0.1 s wall budget, bundle_adjuster.cpp:9-11). With 1e-3,
    # production solves exit in ~4-6 executed iterations instead of always
    # burning the 10-cap, with photo-world ATE unchanged over 6 seeds
    # (ratio-vs-twin 0.636 vs 0.643 at 1e-5, and a TIGHTER worst seed) —
    # sub-0.1% cost improvements are below the block-matching observation
    # noise floor. 1e-5 restores the conservative schedule.
    lm_rel_tol: float = 1e-3
    # Live-landmark compaction for the window solve (the landmark analog of
    # FrontendConfig.lk_compact_slots): the BA build/iteration cost is linear
    # in the landmark axis, but the live count sits far below
    # landmark_capacity (bench replay: 116-291 live of 2048). When at most
    # this many landmarks are valid, gather them (and remap obs_lm) into a
    # problem of exactly this size, solve there, scatter positions back —
    # mathematically the same solve (dead rows contribute zeros). A window
    # with more live landmarks falls back to full capacity. 0 disables.
    ba_compact_landmarks: int = 512
    # reduced-camera-solve precision controls (Ceres runs f64 DENSE_SCHUR,
    # bundle_adjuster.cpp:9; the f32 solve of big ill-conditioned windows can
    # lose accuracy):
    # - refine: mixed-precision iterative-refinement passes on the f32 solve
    # - f64: promote just the (W*6)^2 solve to float64 (needs jax_enable_x64)
    reduced_solve_refine: int = 1
    reduced_solve_f64: bool = False
    init_damping: float = 1e-4
    min_damping: float = 1e-6
    max_damping: float = 1e8
    # Carry the final LM damping λ across consecutive window solves (the
    # problems share all but one keyframe, so last solve's damping regime is
    # the right opening bid — skips the accept/reject ramp a fixed
    # init_damping replays every keyframe). False = Ceres-like fixed init.
    lam_warm_start: bool = True
    min_depth: float = 1e-3        # cheirality guard for residual masking
    # Stereo-triangulation landmark prior: anchors the scale mode the
    # reference's monocular-factor BA leaves free (deliberate accuracy fix;
    # set sigma <= 0 to disable and match reference behavior exactly).
    stereo_prior_sigma_px: float = 1.0
    # Re-anchor tracked landmarks' stereo priors at each keyframe from fresh
    # disparity at their tracked pixel (uses the CURRENT pose estimate, so it
    # can feed pose error back into the map — ablatable for drift studies).
    stereo_prior_refresh: bool = True
    # Huber robust loss on reprojection residuals (pixels). Block-matching
    # disparity has a heavy garbage tail (ambiguous matches yield landmarks at
    # wildly wrong depth); a quadratic loss lets a handful of them steer the
    # solve. The reference uses plain squared loss (no loss function passed at
    # bundle_adjuster.cpp:93-122) — set 0 to match it exactly. Default 2 px:
    # measured best keyframe-ATE across seeds on the synthetic bench world
    # (0.10-0.13 m vs 0.11-0.18 m unrobustified, 49 frames).
    huber_delta_px: float = 2.0


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Host driver constants (vo_node.cpp:124,139; kitti_node.cpp:46)."""

    drop_time: float = 0.05        # min inter-frame interval
    loop_hz: float = 20.0
    replay_hz: float = 11.0
    image_queue_size: int = 5


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    camera: CameraInfo
    frontend: FrontendConfig = FrontendConfig()
    backend: BackendConfig = BackendConfig()
    runtime: RuntimeConfig = RuntimeConfig()
    # Transport metadata carried for parity with the camera YAMLs.
    left_topic: str = "/leftImage"
    right_topic: str = "/rightImage"
    frame_rate: float = 11.0       # read-but-unused in the reference (vo_node.cpp:98)
    name: str = "custom"


def _apply_overrides(cfg, overrides: dict):
    """Apply a flat/nested dict of overrides onto a frozen dataclass tree."""
    if not overrides:
        return cfg
    updates = {}
    for key, val in overrides.items():
        cur = getattr(cfg, key)
        if dataclasses.is_dataclass(cur) and isinstance(val, dict):
            updates[key] = _apply_overrides(cur, val)
        else:
            updates[key] = val
    return dataclasses.replace(cfg, **updates)


def _parse_scalar(text: str):
    """One YAML scalar: quoted string, bool, int, float, else bare string."""
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1]
    low = text.lower()
    if low in ("true", "false"):
        return low == "true"
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def _read_camera_file(path: str) -> dict:
    """Read a camera file: top-level ``key: value`` lines, ``#`` comments,
    and optional one-level sections (``frontend:`` followed by indented
    ``key: value`` lines). That is all the bundled files use."""
    raw: dict = {}
    section = None
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            body = line.split(" #", 1)[0].rstrip()
            if not body.strip() or body.lstrip().startswith("#"):
                continue
            key, sep, value = body.strip().partition(":")
            if not sep or not key:
                raise ValueError(f"{path}:{lineno}: expected 'key: value'")
            value = value.strip()
            if body[0] in " \t":
                if section is None:
                    raise ValueError(f"{path}:{lineno}: indented line outside a section")
                raw[section][key] = _parse_scalar(value)
            elif value:
                section = None
                raw[key] = _parse_scalar(value)
            else:
                section = key
                raw[section] = {}
    return raw


def load_config(name_or_path: str, overrides: Optional[dict] = None) -> PipelineConfig:
    """Load a camera YAML (by bundled name, e.g. ``"kitti00"``, or by path).

    The YAML schema matches the reference's rosparam keys
    (``focal_length cx cy baseline left_topic right_topic frame_rate``,
    ``vo_node.cpp:92-98``) with optional ``frontend:/backend:/runtime:`` override
    sections.
    """
    path = name_or_path
    if not os.path.exists(path):
        path = os.path.join(CONFIG_DIR, name_or_path + ".yaml")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no config named {name_or_path!r}; bundled: {sorted(available_configs())}"
        )
    raw = _read_camera_file(path)

    cam = CameraInfo(
        focal=float(raw["focal_length"]),
        cx=float(raw["cx"]),
        cy=float(raw["cy"]),
        baseline=float(raw["baseline"]),
        k1=float(raw.get("k1", 0.0)),
        k2=float(raw.get("k2", 0.0)),
        p1=float(raw.get("p1", 0.0)),
        p2=float(raw.get("p2", 0.0)),
    )
    cfg = PipelineConfig(
        camera=cam,
        left_topic=str(raw.get("left_topic", "/leftImage")),
        right_topic=str(raw.get("right_topic", "/rightImage")),
        frame_rate=float(raw.get("frame_rate", 11.0)),
        name=os.path.splitext(os.path.basename(path))[0],
    )
    for section in ("frontend", "backend", "runtime"):
        if section in raw:
            cfg = _apply_overrides(cfg, {section: raw[section]})
    if overrides:
        cfg = _apply_overrides(cfg, overrides)
    return cfg


def available_configs():
    return [os.path.splitext(f)[0] for f in os.listdir(CONFIG_DIR) if f.endswith(".yaml")]
