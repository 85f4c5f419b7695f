from stereo_vo.frontend.triangulate import triangulate_features
from stereo_vo.frontend.pnp import pnp_ransac
from stereo_vo.frontend.track import TrackerState, tracker_init, track_step
from stereo_vo.frontend.detect import detect_features, dedup_new_features

__all__ = [
    "triangulate_features",
    "pnp_ransac",
    "TrackerState",
    "tracker_init",
    "track_step",
    "detect_features",
    "dedup_new_features",
]
