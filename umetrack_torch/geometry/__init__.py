from . import affine, cameras, crop
from .cameras import Fisheye62Camera
from .crop import CropCamera, gen_crop_camera_from_points

__all__ = [
    "affine",
    "cameras",
    "crop",
    "Fisheye62Camera",
    "CropCamera",
    "gen_crop_camera_from_points",
]
