from stereo_vo.engine.step import VOEngine, VOState, StepOutput
from stereo_vo.engine.driver import run_vo, VORun

__all__ = ["VOEngine", "VOState", "StepOutput", "run_vo", "VORun"]
