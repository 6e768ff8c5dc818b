"""taichi_image_tpu_torch — the camera ISP on PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``taichi_image_tpu`` (JAX on a TPU), which stays beside it as
the reference. This package covers every route of the three ISP
classes' step: packed12 decode, MHC/bilinear demosaic for all four Bayer
patterns with the WB/CCM fold, resize, EMA metering, the Reinhard or
linear tonemap, the 8 output transforms and planar u8 RGB or I420
output, through ``CameraBF16``, ``Camera16`` or
``Camera32(pattern, device="cuda").process(raws)`` (bf16, f16 and f32
working dtypes); and the color conversions (``ops.color``) and the
standalone tonemaps (``ops.tonemap``). It imports torch and numpy, never
jax.
"""

from taichi_image_tpu_torch import types
from taichi_image_tpu_torch.models.camera_isp import (
    Camera16, Camera32, CameraBF16, camera_isp, default_cc, fused_isp_step,
    state_from_jax)
from taichi_image_tpu_torch.ops.bayer import BayerPattern
from taichi_image_tpu_torch.ops.interpolate import ImageTransform
from taichi_image_tpu_torch.utils.bounds import lerp

__version__ = "0.1.0"
