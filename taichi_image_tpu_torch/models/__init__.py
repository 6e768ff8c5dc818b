"""ISP models of the PyTorch port."""

from taichi_image_tpu_torch.models import camera_isp
from taichi_image_tpu_torch.models.camera_isp import (
    Camera16,
    Camera32,
    CameraBF16,
    default_cc,
    moving_average,
)

# `camera_isp` is the submodule (the reference's `from taichi_image import
# camera_isp`); the class factory is `camera_isp.camera_isp`.
__all__ = ["camera_isp", "Camera16", "Camera32", "CameraBF16",
           "default_cc", "moving_average"]
