from .resample import (
    bilinear_sample,
    bilinear_sample_plain,
    bilinear_sample_pool_plain,
    fisheye_to_pinhole_coords,
    resample_images,
    warp_fisheye_to_pinhole,
)
from .warp_image import warp_image_full, warp_image_windowed
from .warp_pool import warp_pool

__all__ = [
    "bilinear_sample",
    "bilinear_sample_plain",
    "bilinear_sample_pool_plain",
    "fisheye_to_pinhole_coords",
    "resample_images",
    "warp_fisheye_to_pinhole",
    "warp_image_full",
    "warp_image_windowed",
    "warp_pool",
]
