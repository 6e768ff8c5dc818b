"""``dryrun_multigpu``: every mesh variant of the sharded step, run on
``n`` ranks and value-checked against the unsharded step.

Counterpart of ``__graft_entry__.dryrun_multichip``, with the same five
variants, shapes and contract (metrics within 1e-5, u8 within 1 count):
the camera mesh, the row mesh, the row mesh with I420 output (bf16), the
row mesh with a x0.5 resize and rotate_90, and a cameras x rows grid
(``n`` even and at least 4). Where the JAX package runs one process over
``n`` virtual devices, this runs ``n`` processes, one rank each
(:func:`runtime.run_ranks`), and each rank checks its own part of the
output against the unsharded step it computes itself on the full batch.

:func:`run_variants` is the per-rank body, also what the port's
multi-rank tests run: a variant is a plain dict (it crosses a process
boundary), and a rank returns plain numbers and numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from taichi_image_tpu_torch import types
from taichi_image_tpu_torch.models import camera_isp as ci
from taichi_image_tpu_torch.ops import hopper
from taichi_image_tpu_torch.ops.bayer import (_TRANSFORM_SFF, BayerPattern,
                                              demosaic_phases)
from taichi_image_tpu_torch.ops.interpolate import ImageTransform
from taichi_image_tpu_torch.parallel import runtime, sharding, spatial

__all__ = ["dryrun_multigpu", "dryrun_variants", "run_variants"]

# the contract of every variant against the unsharded step
METRICS_ATOL = 1e-5
U8_MAX = 1


def _isp(spec, device):
  kw = dict(spec.get("isp_kw", {}))
  if "transform" in kw:
    kw["transform"] = ImageTransform[kw["transform"]]
  return getattr(ci, spec["cls"])(BayerPattern[spec.get("pattern", "RGGB")],
                                  device=device, **kw)


def _raws(spec) -> np.ndarray:
  """The whole rig's raws of a variant: given, or random u8 bytes of
  ``shape`` from ``seed`` (the same on every rank)."""
  r = spec["raws"]
  if isinstance(r, dict):
    return np.random.default_rng(r["seed"]).integers(
        0, 256, size=r["shape"], dtype=np.uint8)
  return r


def _mesh(kind, grid, device_type, cache):
  """The variant's mesh over every rank (one per shape, reused)."""
  world = dist.get_world_size()
  key = (kind, grid)
  if key not in cache:
    if kind == "camera":
      cache[key] = runtime.make_camera_mesh(device_type=device_type)
    elif kind == "grid":
      cache[key] = init_device_mesh(device_type, tuple(grid),
                                    mesh_dim_names=(runtime.CAMERA_AXIS,
                                                    spatial.ROW_AXIS))
    else:
      cache[key] = init_device_mesh(device_type, (world,),
                                    mesh_dim_names=(spatial.ROW_AXIS,))
  return cache[key]


def _outs(out):
  return out if isinstance(out, tuple) else (out,)


def _part(want, kind, mesh, transform, color_format):
  """The part of the unsharded output ``want`` that this rank's step
  returns: its cameras, and (rows, grid) its band, where the transform
  puts it (``models/large._join``'s rule)."""
  outs = _outs(want)
  if kind in ("camera", "grid"):
    i, n = sharding._axis(mesh, runtime.CAMERA_AXIS)
    outs = tuple(o.narrow(0, i * (o.shape[0] // n), o.shape[0] // n)
                 for o in outs)
  if kind in ("rows", "grid"):
    i, n = sharding._axis(mesh, spatial.ROW_AXIS)
    swap, flip_rows, _ = _TRANSFORM_SFF[transform]
    j = n - 1 - i if flip_rows else i
    axes = ((2, 3) if swap else (1, 2)) if color_format == "yuv420" else (
        (3,) if swap else (2,))
    outs = tuple(o.narrow(ax, j * (o.shape[ax] // n), o.shape[ax] // n)
                 for o, ax in zip(outs, axes, strict=True))
  return outs


def _gathered(out, kind, mesh, transform, color_format):
  """The whole output of a sharded step on every rank (the gather
  helpers)."""
  if kind in ("rows", "grid"):
    out = spatial.gather_rows(out, mesh, transform, color_format)
  if kind in ("camera", "grid"):
    out = sharding.gather_cameras(out, mesh)
  return out


def _numpy(out):
  return tuple(o.cpu().numpy() for o in _outs(out))


def _sync(device):
  if device.type == "cuda":
    torch.cuda.synchronize(device)


def _step(spec, device, cache, keep):
  """One step variant: the sharded step chained ``steps`` times (t = 0,
  then 1 - moving_alpha), each step's output and metrics against the
  unsharded step of a fresh ISP on the whole batch."""
  kind = spec["kind"]
  raws_np = _raws(spec)
  n_cam, h, w_raw = raws_np.shape
  fmt = spec.get("fmt", "packed12")
  tonemap = spec.get("tonemap", "reinhard")
  color_format = spec.get("color_format", "rgb")
  proc = dict(gamma=1.0, intensity=1.0, light_adapt=1.0, color_adapt=0.0)
  proc.update(spec.get("proc", {}))
  scalars = [float(proc[k]) for k in ("gamma", "intensity", "light_adapt",
                                      "color_adapt")]
  mesh = _mesh(kind, spec.get("grid"), device.type, cache)
  isp, ref = _isp(spec, device), _isp(spec, device)
  w = ci.decoded_width(fmt, w_raw)
  raws = types.as_tensor(raws_np, device)
  if kind == "camera":
    if spec.get("direct"):
      step = sharding.make_sharded_isp_step(
          mesh, fmt=fmt, work_dtype=isp._work_dtype,
          pattern=isp.bayer_pattern, cc=isp._cc_tuple(),
          resize_plan=isp._resize_plan(h, w), stride=isp.metering_stride,
          transform=isp.transform, tonemap=tonemap, n_cameras=n_cam,
          image_hw=(h, w), color_format=color_format)
    else:
      step = sharding.sharded_step_for_isp(isp, mesh, raws.shape, fmt=fmt,
                                           tonemap=tonemap,
                                           color_format=color_format)
    local = sharding.shard_cameras(raws, mesh)
  else:
    factory = (spatial.make_grid_isp_step if kind == "grid"
               else spatial.make_spatial_isp_step)
    step = factory(mesh, fmt=fmt, work_dtype=isp._work_dtype,
                   pattern=isp.bayer_pattern, cc=isp._cc_tuple(),
                   stride=isp.metering_stride, tonemap=tonemap,
                   n_cameras=n_cam, image_hw=(h, w),
                   resize_plan=isp._resize_plan(h, w),
                   transform=isp.transform, color_format=color_format)
    local = raws if kind == "rows" else sharding.shard_cameras(raws, mesh)
    local = spatial.shard_rows(local, mesh)
  m = sharding.replicate(np.zeros(9, np.float32), mesh)
  # metrics |d|, u8 |d|, the share of bytes that differ, and by more than 1
  worst = torch.zeros(4, dtype=torch.float64)
  launches, kept = {}, []
  for k in range(spec.get("steps", 1)):
    t = 0.0 if k == 0 else 1.0 - isp.moving_alpha
    _sync(device)
    hopper.reset_launches()
    m, out = step(local, m, t, *scalars)
    _sync(device)
    for name, v in hopper.launch_counts().items():
      if v:
        launches[name] = launches.get(name, 0) + v
    want = ref.process(raws, fmt=fmt, tonemap=tonemap,
                       color_format=color_format, **proc)
    worst[0] = max(worst[0], (m - ref.metrics).abs().max().item())
    for g, r in zip(_outs(out), _part(want, kind, mesh, isp.transform,
                                      color_format), strict=True):
      if g.shape != r.shape or g.dtype != r.dtype:
        raise AssertionError(f"{spec['name']}: this rank's output "
                             f"{tuple(g.shape)}/{g.dtype} against its part "
                             f"of the unsharded {tuple(r.shape)}/{r.dtype}")
      d = (g.int() - r.int()).abs()
      worst[1] = max(worst[1], d.max().item())
      worst[2] = max(worst[2], (d != 0).double().mean().item())
      worst[3] = max(worst[3], (d > 1).double().mean().item())
    if keep:
      kept.append((m.cpu().numpy(), _numpy(_gathered(
          out, kind, mesh, isp.transform, color_format)),
                   [tuple(o.shape) for o in _outs(out)]))
  # the worst of every rank, and the metrics' spread over the ranks (the
  # step hands every rank the same metrics)
  dist.all_reduce(worst, op=dist.ReduceOp.MAX)
  spread = max((x - m).abs().max().item()
               for x in sharding._all_gather(m, dist.group.WORLD))
  return dict(name=spec["name"], metrics_d=worst[0].item(),
              u8_d=int(worst[1].item()), share=worst[2].item(),
              share2=worst[3].item(), spread=spread, launches=launches, kept=kept)


def _demosaic(spec, device, cache):
  """``demosaic_phases_spatial`` of this rank's rows of the phase planes,
  gathered, against the unsharded demosaic."""
  mesh = _mesh("rows", None, device.type, cache)
  phases = torch.from_numpy(spec["phases"]).to(device)
  i, n = sharding._axis(mesh, spatial.ROW_AXIS)
  k = phases.shape[2] // n
  pattern = BayerPattern[spec.get("pattern", "RGGB")]
  got = spatial.demosaic_phases_spatial(phases[:, :, i * k:(i + 1) * k],
                                        mesh, pattern, cc=spec.get("cc"))
  full = torch.cat(sharding._all_gather(got, mesh.get_group(
      spatial.ROW_AXIS)), dim=2)
  cc = spec.get("cc")
  want = demosaic_phases(phases, pattern, cc=None if cc is None else tuple(cc),
                         out_dtype=torch.float32)
  return dict(name=spec["name"], out=full.cpu().numpy(),
              d=(full - want).abs().max().item())


def _refuse(spec, device, cache):
  """A factory called with the variant's arguments: the message of the
  ValueError it raises, or None."""
  kw = dict(spec["kwargs"])
  if "work_dtype" in kw:
    kw["work_dtype"] = types.canonical_dtype(kw["work_dtype"])
  if "pattern" in kw:
    kw["pattern"] = BayerPattern[kw["pattern"]]
  kind = spec["kind_of"]
  mesh = _mesh(kind, spec.get("grid"), device.type, cache)
  try:
    if kind == "camera":
      sharding.shard_cameras(np.zeros(kw["shape"], np.uint8), mesh)
    elif kind == "demosaic":  # this rank's rows of phase planes
      spatial.demosaic_phases_spatial(np.zeros(kw["shape"], np.float32),
                                      mesh, BayerPattern.RGGB)
    elif kind == "grid":
      spatial.make_grid_isp_step(mesh, **kw)
    else:
      spatial.make_spatial_isp_step(mesh, **kw)
  except ValueError as e:
    return dict(name=spec["name"], error=str(e))
  return dict(name=spec["name"], error=None)


def _meter(spec, device, cache):
  """The metering of this rank's cameras of the sample, reduced over the
  world group (``ops/hopper/meter.meter`` with a group: M's three
  launches on CUDA, its twin on the CPU): the new metrics and vectors."""
  from taichi_image_tpu_torch.ops.hopper import meter
  sample = torch.from_numpy(spec["sample"]).to(
      device, types.canonical_dtype(spec["dtype"]))
  i, n = dist.get_rank(), dist.get_world_size()
  k = sample.shape[0] // n
  part = sample[i * k:(i + 1) * k]
  n_total = sample.shape[0] * sample.shape[2] * sample.shape[3]
  got = meter.meter(part, torch.from_numpy(spec["prev"]).to(device),
                    spec["t"], spec.get("intensity", 1.0),
                    spec.get("light_adapt", 1.0), spec["color_adapt"],
                    group=dist.group.WORLD, n_total=n_total)
  return dict(name=spec["name"], **{f: getattr(got, f).cpu().numpy()
                                     for f in got._fields})


def _mesh_info(spec, device, cache):
  """``make_camera_mesh`` over every rank and over the first one."""
  out = {}
  for key, n in (("all", None), ("first", 1)):
    mesh = runtime.make_camera_mesh(n, device_type=device.type)
    c = mesh.get_coordinate()
    out[key] = dict(shape=tuple(mesh.shape), names=mesh.mesh_dim_names,
                    coordinate=None if c is None else list(c),
                    device=str(runtime.mesh_device(mesh)))
  return dict(name=spec["name"], **out)


def run_variants(variants, device="cpu", keep=False) -> list[dict]:
  """This rank's part of every variant (the same list on every rank, in
  one process group): step variants ("camera", "rows", "grid") return
  the worst differences over the ranks against the unsharded step
  (``metrics_d``, ``u8_d``, the ``share`` of bytes that differ and
  ``share2`` of those that differ by more than 1), the metrics'
  spread over the ranks and this rank's kernel launches of the sharded
  steps; with ``keep`` also each step's metrics and the whole output
  (gathered) with this rank's output shapes. "demosaic", "refuse" and
  "mesh" variants check ``demosaic_phases_spatial``, a factory's
  ``ValueError`` and ``make_camera_mesh``; a "meter" variant returns
  the metering reduced over the ranks (:func:`_meter`)."""
  device = torch.device(device)
  if device.type == "cuda":
    device = torch.device("cuda", torch.cuda.current_device())
  cache = {}
  results = []
  for spec in variants:
    kind = spec["kind"]
    if kind == "demosaic":
      results.append(_demosaic(spec, device, cache))
    elif kind == "refuse":
      results.append(_refuse(spec, device, cache))
    elif kind == "mesh":
      results.append(_mesh_info(spec, device, cache))
    elif kind == "meter":
      results.append(_meter(spec, device, cache))
    else:
      results.append(_step(spec, device, cache, keep))
  return results


def dryrun_variants(n: int) -> list[dict]:
  """The JAX dry run's variants for ``n`` ranks (its shapes: 64 x 96
  frames, n cameras on the camera mesh; 2 cameras of 16 n rows on the row
  mesh; 2 cameras of 16 n / 2 rows on the grid)."""
  h, w = 64, 96
  h2 = 8 * n * 2
  out = [
      dict(name="camera-mesh", kind="camera", cls="Camera32",
           isp_kw=dict(moving_alpha=0.1),
           raws=dict(shape=(n, h, w * 3 // 2), seed=0)),
      dict(name="row-mesh", kind="rows", cls="Camera32",
           raws=dict(shape=(2, h2, w * 3 // 2), seed=1)),
      dict(name="row-mesh-i420", kind="rows", cls="CameraBF16",
           color_format="yuv420", raws=dict(shape=(2, h2, w * 3 // 2),
                                            seed=1)),
      dict(name="row-mesh-resize-rot90", kind="rows", cls="Camera32",
           isp_kw=dict(scale=0.5, transform="rotate_90"),
           raws=dict(shape=(2, h2, w * 3 // 2), seed=1)),
  ]
  if n % 2 == 0 and n >= 4:
    out.append(dict(name="grid-mesh", kind="grid", cls="Camera32",
                    grid=(2, n // 2),
                    raws=dict(shape=(2, 8 * (n // 2) * 2, w * 3 // 2),
                              seed=2)))
  return out


def check(result, u8_max: int = U8_MAX) -> None:
  """Hold a step variant's result to the contract: metrics within 1e-5,
  u8 within ``u8_max`` counts (beyond 1 on fewer than 0.1% of bytes),
  the same metrics on every rank."""
  if not (result["metrics_d"] <= METRICS_ATOL and result["u8_d"] <= u8_max
          and result["share2"] < 1e-3 and result["spread"] == 0.0):
    raise AssertionError(
        f"{result['name']}: against the unsharded step metrics |d| "
        f"{result['metrics_d']:.3g} (<= {METRICS_ATOL}), u8 |d| "
        f"{result['u8_d']} (<= {u8_max}; beyond 1 on {result['share2']:.2e} "
        f"of bytes); metrics spread over the ranks {result['spread']:.3g} "
        "(0)")


def dryrun_multigpu(n: int, device: str = "cpu") -> list[dict]:
  """Run the five mesh variants on ``n`` ranks (one process each, a gloo
  group; on "cpu", or all on one CUDA device such as "cuda:0") and
  value-check each against the unsharded step; prints one line per
  variant and raises ``AssertionError`` on a breach of the contract.
  Returns rank 0's results."""
  results = runtime.run_ranks(run_variants, n, dryrun_variants(n), device,
                              device=device)[0]
  for r in results:
    check(r)
    print(f"dryrun value-check {r['name']}: metrics |d|max="
          f"{r['metrics_d']:.2e}, u8 dmax={r['u8_d']} — ok", flush=True)
  return results
