"""Camera-axis sharding of the fused ISP step over ``torch.distributed``.

Counterpart of ``taichi_image_tpu/parallel/sharding.py``. The cameras of
a rig's batch are split over the ranks of a mesh's camera axis, each
rank running :func:`fused_isp_step` on its cameras with the hand-written
kernels of its device; the one collective of the step is the shared
exposure metering, reduced over the axis's process group (three
all_reduce calls, :func:`metering_update_ca`). Each image lies wholly on
one rank, so its Reinhard max stays local.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from taichi_image_tpu_torch import types
from taichi_image_tpu_torch.models.camera_isp import (decoded_width,
                                                      fused_isp_step)
from taichi_image_tpu_torch.ops.interpolate import ImageTransform
from taichi_image_tpu_torch.parallel.runtime import (CAMERA_AXIS,
                                                     make_camera_mesh,
                                                     mesh_device, mesh_group)

__all__ = ["make_camera_mesh", "shard_cameras", "make_sharded_isp_step",
           "replicate", "sharded_step_for_isp", "gather_cameras"]


def _axis(mesh, axis_name: str):
  """(this rank's coordinate, size) along ``axis_name`` of ``mesh``."""
  return mesh.get_local_rank(axis_name), mesh.size(
      mesh.mesh_dim_names.index(axis_name))


def shard_cameras(batch, mesh, axis_name: str = CAMERA_AXIS) -> torch.Tensor:
  """This rank's contiguous slice of the leading (camera) axis of
  ``batch`` (a tensor or an array, the whole rig's) on its device.
  Raises ``ValueError`` unless the cameras divide over the axis."""
  i, n = _axis(mesh, axis_name)
  batch = types.as_tensor(batch)
  if batch.shape[0] % n:
    raise ValueError(f"{batch.shape[0]} cameras do not divide over the "
                     f"{n} ranks of mesh axis {axis_name!r}")
  k = batch.shape[0] // n
  return types.to_device(batch[i * k:(i + 1) * k],
                         mesh_device(mesh)).contiguous()


def replicate(x, mesh) -> torch.Tensor:
  """``x`` (e.g. the vec9 metering state) on this rank's device, made
  equal on every rank of ``mesh`` by a broadcast from its first rank.
  Every rank passes a tensor or array of the same shape and dtype."""
  t = types.as_tensor(x).to(mesh_device(mesh)).contiguous()
  dist.broadcast(t, src=int(mesh.mesh.flatten()[0]), group=mesh_group(mesh))
  return t


def _all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
  """Every rank's ``t`` (of one shape on every rank), in rank order."""
  parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
  dist.all_gather(parts, t.contiguous(), group=group)
  return parts


def gather_cameras(out, mesh, axis_name: str = CAMERA_AXIS):
  """The whole rig's output from each rank's cameras (planar u8, or the
  I420 pair): every rank's part gathered over ``axis_name`` and joined
  along the camera axis, on every rank. For tests and callers that want
  the whole batch; the step itself never gathers."""
  group = mesh.get_group(axis_name)
  if isinstance(out, tuple):
    return tuple(torch.cat(_all_gather(o, group)) for o in out)
  return torch.cat(_all_gather(out, group))


def _n_total(n_cameras, image_hw, resize_plan, stride) -> int:
  """The metering sample's pixel count over the whole rig: ceil of the
  output's size over the stride on each axis, per camera."""
  h, w = image_hw
  if resize_plan is not None:
    (w, h), _ = resize_plan
  return n_cameras * -(-h // stride) * -(-w // stride)


def make_sharded_isp_step(mesh, *, fmt: str = "packed12",
                          ids_format: bool = False, work_dtype, pattern,
                          cc=None, resize_plan=None, stride: int = 8,
                          transform=ImageTransform.none,
                          tonemap: str = "reinhard", n_cameras: int,
                          image_hw, axis_name: str = CAMERA_AXIS,
                          color_format: str = "rgb"):
  """The whole-rig step with the cameras split over ``axis_name``:

      step(raws, prev_metrics, t, gamma, intensity, light_adapt,
           color_adapt) -> (new_metrics, this rank's u8 outputs)

  ``raws`` is this rank's (n_cameras / n_ranks, H, W_raw) share
  (:func:`shard_cameras`), ``prev_metrics`` the vec9, equal on every rank
  (:func:`replicate`); the new metrics come out equal on every rank.
  ``image_hw`` is the decoded (H, W), from which the metering's pixel
  count over the whole rig is computed. ``color_format="yuv420"`` gives
  this rank's ``(Y, VU)``."""
  n_total = _n_total(n_cameras, image_hw, resize_plan, stride)
  group = mesh.get_group(axis_name)
  device = mesh_device(mesh)
  wd = types.canonical_dtype(work_dtype)

  def step(raws, prev, t, gamma, intensity, light_adapt, color_adapt):
    return fused_isp_step(
        types.to_device(types.as_tensor(raws), device),
        torch.as_tensor(prev, dtype=torch.float32, device=device), t,
        gamma, intensity, light_adapt, color_adapt, fmt, ids_format, wd,
        pattern, cc, resize_plan, stride, transform, tonemap,
        color_format=color_format, group=group, n_total=n_total)

  return step


def sharded_step_for_isp(isp, mesh, raw_shape, fmt: str = "packed12",
                         ids_format: bool = False,
                         tonemap: str = "reinhard",
                         axis_name: str = CAMERA_AXIS,
                         color_format: str = "rgb"):
  """Convenience: :func:`make_sharded_isp_step` from an ISP instance's
  configuration. ``raw_shape`` is the whole rig's (n_cameras, H, W_raw)."""
  n, h, w_raw = raw_shape
  w = decoded_width(fmt, w_raw)
  return make_sharded_isp_step(
      mesh, fmt=fmt, ids_format=ids_format, work_dtype=isp._work_dtype,
      pattern=isp.bayer_pattern, cc=isp._cc_tuple(),
      resize_plan=isp._resize_plan(h, w), stride=isp.metering_stride,
      transform=isp.transform, tonemap=tonemap, n_cameras=n,
      image_hw=(h, w), axis_name=axis_name, color_format=color_format)

