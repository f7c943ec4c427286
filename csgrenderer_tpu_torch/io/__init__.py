from . import checkpoint, image, obj, video
from .checkpoint import Accumulator
from .image import read_png, rmse, write_png, write_ppm
from .obj import load_mesh, read_obj, write_obj
from .video import write_gif

__all__ = ["checkpoint", "image", "obj", "video", "Accumulator", "load_mesh", "read_obj",
           "read_png", "rmse", "write_gif", "write_obj", "write_png", "write_ppm"]
