from stereo_vo.backend.residuals import (
    reprojection_residual,
    reprojection_jacobians,
)
from stereo_vo.backend.window import WindowState
from stereo_vo.backend.schur import bundle_adjust, BASolveStats

__all__ = [
    "reprojection_residual",
    "reprojection_jacobians",
    "WindowState",
    "bundle_adjust",
    "BASolveStats",
]
