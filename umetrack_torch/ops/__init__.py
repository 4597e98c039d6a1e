from .resample import bilinear_sample_pool_plain, fisheye_to_pinhole_coords
from .warp_pool import warp_pool

__all__ = [
    "bilinear_sample_pool_plain",
    "fisheye_to_pinhole_coords",
    "warp_pool",
]
