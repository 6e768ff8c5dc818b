"""taichi_image_tpu_torch — the camera ISP on PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``taichi_image_tpu`` (JAX on a TPU), which stays beside it as
the reference. This package covers every route of the three ISP
classes' step: the raw decodes (packed12 and packed16 with their
kernels, and the u16, f16 and f32 CFAs through the phase-split kernel),
MHC/bilinear demosaic for all four Bayer patterns with the WB/CCM fold
(frames under 4x4 pixels included), resize, EMA metering, the Reinhard
or linear tonemap, the 8 output transforms and planar u8 RGB or I420
output, through ``CameraBF16``, ``Camera16`` or
``Camera32(pattern, device="cuda").process(raws)`` (bf16, f16 and f32
working dtypes); the reference's per-image API on the same classes
(``load_*`` -> ``update_metering`` -> ``tonemap_*`` on lazy
``PlanarImage`` handles, ``resize_image``, ``process_stream``); the
packed codecs (``ops.packed``), the HWC demosaic and mosaic
(``bayer_to_rgb``, ``rgb_to_bayer``), the color conversions
(``ops.color``) and the standalone tonemaps (``ops.tonemap``); and the
step with a rig's cameras, or each frame's rows, split over the ranks of
a ``torch.distributed`` group, one device each (``parallel``). It
imports torch and numpy, never jax.
"""

from taichi_image_tpu_torch import types
from taichi_image_tpu_torch.ops import (bayer, color, interpolate, kernel,
                                        packed, tonemap)
from taichi_image_tpu_torch.models.camera_isp import (
    Camera16, Camera32, CameraBF16, PlanarImage, camera_isp, default_cc,
    fused_isp_step, moving_average, state_from_jax)
from taichi_image_tpu_torch.ops.bayer import (
    BayerPattern, bayer_to_rgb, bayer_to_rgb_batch, rgb_to_bayer)
from taichi_image_tpu_torch.ops.interpolate import (
    ImageTransform, resize_bilinear, resize_nearest, resize_width,
    scale_bilinear, transform, transformed_size)
from taichi_image_tpu_torch.ops.packed import (decode12, decode16, encode12,
                                               encode16)
from taichi_image_tpu_torch.ops.tonemap import (tonemap_linear,
                                                tonemap_reinhard)
from taichi_image_tpu_torch.ops.color import (
    rgb_gray, bgr_gray, rgb_yuv420_image, yuv420_rgb_image, split_yuv_420)
from taichi_image_tpu_torch.utils import (Bounds, bounds_from_np,
                                          bounds_to_np, lerp)

__version__ = "0.1.0"
