"""stereo_vo — a sliding-window stereo visual odometry framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the reference
C++/ROS package EpicDuckPotato/stereo_vo (see SURVEY.md):

- ``core``      geometry (quaternions/SE3), camera model, typed config, pytree state
- ``ops``       device kernels: Shi-Tomasi detection, StereoBM disparity,
                pyramidal Lucas-Kanade, NMS, bilinear sampling, pyramids
- ``frontend``  detect -> track -> gate -> PnP-RANSAC -> triangulate, all as
                fixed-shape masked ops
- ``backend``   reprojection residuals + analytic Jacobians, Schur-complement
                Levenberg-Marquardt bundle adjustment, sliding-window state
- ``engine``    the jitted per-frame ``vo_step``, host driver loop, checkpointing,
                metrics
- ``parallel``  device-mesh sharded bundle adjustment (landmark-sharded Schur)
- ``data``      KITTI loader/replay, synthetic stereo world, generic stream API
- ``eval``      ATE/RPE, trajectory writers, benchmark harness, visualization
"""

__version__ = "0.1.0"

from stereo_vo.core.camera import CameraInfo  # noqa: F401
from stereo_vo.core.config import PipelineConfig, load_config  # noqa: F401
