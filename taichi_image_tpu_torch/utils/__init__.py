from taichi_image_tpu_torch.utils.bounds import (
    Bounds,
    bounds_from_np,
    bounds_to_np,
    image_bounds,
    lerp,
    union_bounds,
)
from taichi_image_tpu_torch.utils.cache import cache

__all__ = [
    "Bounds",
    "bounds_from_np",
    "bounds_to_np",
    "image_bounds",
    "lerp",
    "union_bounds",
    "cache",
]
