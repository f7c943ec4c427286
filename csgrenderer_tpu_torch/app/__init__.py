from .adaptive import AdaptiveSppRenderer, next_pow2_spp
from .loop import App
from .preview import PreviewServer
from .renderers import PathTraceRenderer, WololoRenderer
from .stats import FrameStats, StatsClock

__all__ = [
    "AdaptiveSppRenderer",
    "App",
    "FrameStats",
    "PathTraceRenderer",
    "PreviewServer",
    "StatsClock",
    "WololoRenderer",
    "next_pow2_spp",
]
