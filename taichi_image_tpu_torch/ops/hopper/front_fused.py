"""K7: the front-fused demosaic + Reinhard map (``csrc/front_fused.cu``,
the bf16 instantiation only).

Replaces ``taichi_image_tpu/ops/pallas/demosaic.py::
demosaic_reinhard_stencil``: phase planes -> pre-gamma ``p`` and the
per-image max in one pass, without the x12 round trip through device
memory. The kernel runs K2's tile loader and stencil and K3's map device
code (``csrc/stencil.cuh``, ``csrc/tonemap.cuh``) with the x12 rounded to
bf16 in shared memory between them, so it is bitwise equal to K2<bf16> ->
K3<bf16>; its plain twin is those two kernels' twins in a row.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from taichi_image_tpu_torch.ops import hopper
from taichi_image_tpu_torch.ops.hopper.demosaic import (
    demosaic_stencil_plain, stencil_params, tap_variant)
from taichi_image_tpu_torch.ops.hopper.reinhard import reinhard_map_plain

__all__ = ["front_fused", "front_fused_plain"]

KERNEL = hopper.register(
    "front_fused_bf16", "front_fused.cu", "tit_front_fused_bf16",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_void_p],
    "taichi_image_tpu/ops/pallas/demosaic.py:466")


def front_fused_plain(phases: torch.Tensor, weights: np.ndarray,
                      finish: dict, scal: torch.Tensor):
  """Plain PyTorch twin of K7: K2's twin, then K3's twin on its bf16 x12
  (color_adapt == 0)."""
  x12, _ = demosaic_stencil_plain(phases, weights, finish)
  return reinhard_map_plain(x12, scal, False, finish["out_dtype"])


def front_fused(phases: torch.Tensor, weights: np.ndarray, finish: dict,
                scal: torch.Tensor, backend: str = "auto"):
  """(N, 4, hh, wh) bf16 phase planes -> ``(p (N, 12, hh, wh) bf16,
  per-image max of the f32 p (N, 1, 1, 1))``: the finished stencil
  (``finish`` from ``ops/bayer._stencil_finish_spec`` with a bf16
  out_dtype, whose ``top_row``/``bot_row`` gate the top and bottom
  factors as in K2) and the color_adapt == 0 map with the (6,) ``scal``
  of ``reinhard_scal``."""
  if phases.ndim != 4 or phases.shape[1] != 4:
    raise ValueError(f"phases must be (N, 4, hh, wh), got "
                     f"{tuple(phases.shape)}")
  n, _, hh, wh = phases.shape
  if (finish["hh"], finish["wh"]) != (hh, wh):
    raise ValueError(f"finish spec is for {finish['hh']}x{finish['wh']}, "
                     f"phases are {hh}x{wh}")
  if phases.dtype != torch.bfloat16 or finish["out_dtype"] != torch.bfloat16:
    raise ValueError(f"the front-fused kernel is bf16 only, got phases "
                     f"{phases.dtype} and output {finish['out_dtype']}")
  if scal.shape != (6,):
    raise ValueError(f"scal must be (6,), got {tuple(scal.shape)}")
  if not hopper.use_kernel(backend, phases):
    return front_fused_plain(phases, weights, finish, scal)
  hopper.check_tensor("phases", phases, torch.bfloat16, 4, phases.device)
  hopper.check_tensor("scal", scal, torch.float32, 1, phases.device)
  hopper.check_frame_size(hh, wh)
  variant = tap_variant(weights)
  dev = phases.device
  p = torch.empty((n, 12, hh, wh), dtype=torch.bfloat16, device=dev)
  # the encoded maxima, then the block counters (csrc/tonemap.cuh)
  scratch = torch.empty((2 * n,), dtype=torch.int32, device=dev)
  mx = torch.empty((n, 1, 1, 1), dtype=torch.float32, device=dev)
  params = stencil_params(weights, finish)
  KERNEL.launch(dev, hopper.ptr(phases), hopper.ptr(p), hopper.ptr(scratch),
                hopper.ptr(mx), n, hh, wh,
                params.ctypes.data_as(ctypes.c_void_p),
                int(finish["cc"] is not None), variant, finish["top_row"],
                finish["bot_row"], hopper.ptr(scal))
  return p, mx
