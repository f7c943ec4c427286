from .pinhole import Camera, WololoCamera, pixel_st_grid

__all__ = ["Camera", "WololoCamera", "pixel_st_grid"]
