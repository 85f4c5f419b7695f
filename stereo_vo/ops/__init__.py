from stereo_vo.ops.shi_tomasi import detect_corners, min_eig_response
from stereo_vo.ops.stereo_bm import stereo_bm_disparity
from stereo_vo.ops.pyramid import build_pyramid, pyr_down
from stereo_vo.ops.lk import lk_track_pyramid

__all__ = [
    "detect_corners",
    "min_eig_response",
    "stereo_bm_disparity",
    "build_pyramid",
    "pyr_down",
    "lk_track_pyramid",
]
