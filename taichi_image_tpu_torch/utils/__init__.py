from taichi_image_tpu_torch.utils.bounds import (
    Bounds,
    bounds_from_np,
    bounds_to_np,
    image_bounds,
    lerp,
    union_bounds,
)
from taichi_image_tpu_torch.utils.cache import cache
from taichi_image_tpu_torch.utils.benchmark import Benchmark, benchmark
from taichi_image_tpu_torch.utils.image import mse, psnr
from taichi_image_tpu_torch.utils import profiling

__all__ = [
    "Bounds",
    "bounds_from_np",
    "bounds_to_np",
    "image_bounds",
    "lerp",
    "union_bounds",
    "cache",
    "Benchmark",
    "benchmark",
    "mse",
    "psnr",
    "profiling",
]
