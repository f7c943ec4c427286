from . import image, obj
from .image import read_png, rmse, write_png, write_ppm
from .obj import load_mesh, read_obj, write_obj

__all__ = ["image", "obj", "load_mesh", "read_obj", "read_png", "rmse", "write_obj", "write_png",
           "write_ppm"]
