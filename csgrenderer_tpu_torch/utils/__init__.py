from .config import MeshConfig, RenderConfig, check_finite, checked
from .logging import get_logger

__all__ = [
    "MeshConfig",
    "RenderConfig",
    "check_finite",
    "checked",
    "get_logger",
]
