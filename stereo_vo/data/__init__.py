from stereo_vo.data.kitti import KittiSequence, kitti_replay
from stereo_vo.data.synthetic import SyntheticStereoSequence
from stereo_vo.data.stream import StereoFrame, StereoStream

__all__ = [
    "KittiSequence",
    "kitti_replay",
    "SyntheticStereoSequence",
    "StereoFrame",
    "StereoStream",
]
