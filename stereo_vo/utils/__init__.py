from stereo_vo.utils.profiling import StageTimer, device_trace, summarize_trace

__all__ = ["StageTimer", "device_trace", "summarize_trace"]
