from stereo_vo.core.camera import CameraInfo
from stereo_vo.core.config import (
    BackendConfig,
    FrontendConfig,
    PipelineConfig,
    RuntimeConfig,
    load_config,
)

__all__ = [
    "CameraInfo",
    "BackendConfig",
    "FrontendConfig",
    "PipelineConfig",
    "RuntimeConfig",
    "load_config",
]
