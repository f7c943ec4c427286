from . import image
from .image import read_png, rmse, write_png, write_ppm

__all__ = ["image", "read_png", "rmse", "write_png", "write_ppm"]
