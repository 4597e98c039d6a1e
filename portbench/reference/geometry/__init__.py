from . import affine, cameras, crop
from .cameras import Fisheye62Camera, PinholeCamera, camera_from_json
from .crop import CropCamera, gen_crop_camera_from_points

__all__ = [
    "affine",
    "cameras",
    "crop",
    "Fisheye62Camera",
    "PinholeCamera",
    "camera_from_json",
    "CropCamera",
    "gen_crop_camera_from_points",
]
