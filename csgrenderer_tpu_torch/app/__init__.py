from .loop import App
from .renderers import PathTraceRenderer, WololoRenderer
from .stats import FrameStats, StatsClock

__all__ = ["App", "FrameStats", "PathTraceRenderer", "StatsClock", "WololoRenderer"]
