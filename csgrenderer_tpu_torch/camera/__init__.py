from .pinhole import Camera

__all__ = ["Camera"]
