"""Production batch CLI: multi-camera scan folders -> prefetch -> fused
ISP -> JPEG grid (counterpart of ``taichi_image_tpu/scripts/tonemap_scan.py``).

Reference: ``taichi_image/scripts/tonemap_scan.py`` (the console tool the
reference declares at pyproject.toml:34-35). As in the JAX package, raw
frame sets are stacked into one camera batch and run through ONE fused ISP
step per frame set, and images are written with PIL instead of OpenCV;
``--show`` is unavailable headless and replaced by ``--write``. The flags
are the JAX CLI's, plus ``--device`` (default ``cuda``; ``cpu`` runs the
kernels' plain twins).
"""

from __future__ import annotations

import argparse
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from taichi_image_tpu_torch import types
from taichi_image_tpu_torch.models import camera_isp
from taichi_image_tpu_torch.ops.bayer import BayerPattern
from taichi_image_tpu_torch.ops.interpolate import ImageTransform
from taichi_image_tpu_torch.scripts.util import (
    concat_image_grid, find_folder_images, find_scan_folders,
    load_images_iter, load_raw_bytes, progress, write_image)
from taichi_image_tpu_torch.utils.debug import validate_raw_file


def rgb_grid(planar: np.ndarray, rows: int) -> np.ndarray:
  """Planar (n, 3, h, w) u8 host array -> the HWC grid of the cameras."""
  return concat_image_grid(list(np.moveaxis(planar, 1, -1)), rows=rows)


def i420_grid(y: np.ndarray, uv: np.ndarray, rows: int) -> np.ndarray:
  """I420 (Y (n, H, W), UV (n, 2, H/2, W/2)) -> per-camera HWC YCbCr
  (chroma nearest-upsampled) -> the grid of the cameras.

  JPEG is natively YCbCr 4:2:0, so PIL encodes this mode without an RGB
  trip. Plane mapping measured against the RGB output on saturated
  patches: uv[1] carries the Cr-like plane (red -> 240), uv[0] the Cb-like
  one. Saturated colors keep the reference yuv_420 kernel's
  channel-REVERSED matrix quirk (ops/color.py): this mode reproduces the
  reference's yuv420 values, not libjpeg's BT.601.
  """
  cams = []
  for i in range(y.shape[0]):
    cb = uv[i, 0].repeat(2, axis=0).repeat(2, axis=1)
    cr = uv[i, 1].repeat(2, axis=0).repeat(2, axis=1)
    cams.append(np.stack([y[i], cb, cr], axis=-1))
  return concat_image_grid(cams, rows=rows)


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument("--scan", type=Path)
  parser.add_argument("--images", type=Path)
  parser.add_argument("--reverse", action="store_true")
  parser.add_argument("--width", type=int, default=4096)

  # tonemap parameters (reference defaults, tonemap_scan.py:115-121)
  parser.add_argument("--gamma", type=float, default=0.9)
  parser.add_argument("--intensity", type=float, default=3.0)
  parser.add_argument("--color_adapt", type=float, default=0.0)
  parser.add_argument("--light_adapt", type=float, default=0.9)
  parser.add_argument("--moving_alpha", type=float, default=0.02)
  parser.add_argument("--resize_width", type=int, default=0)
  parser.add_argument("--transform", type=ImageTransform,
                      default=ImageTransform.rotate_90)
  parser.add_argument("--correct_colors", action="store_true")
  parser.add_argument("--write", type=Path, default=None)
  parser.add_argument("--rows", type=int, default=2)
  parser.add_argument("--ids_format", action="store_true")
  parser.add_argument("--debug", action="store_true",
                      help="enable the step's validation checks "
                           "(TAICHI_IMAGE_TPU_DEBUG=1; reference: "
                           "ti.init(debug=True))")
  parser.add_argument("--dtype", choices=["f16", "f32", "bf16"],
                      default="f32")
  parser.add_argument("--pipeline_depth", type=int, default=2,
                      help="device outputs kept in flight before the "
                           "oldest is fetched (0 = fully serial)")
  parser.add_argument("--fetch", choices=["rgb", "yuv420"], default="rgb",
                      help="yuv420 fetches fused I420 from the device "
                           "(half the D2H bytes) and JPEG-encodes from "
                           "YCbCr")
  parser.add_argument("--device", default="cuda",
                      help="torch device of the ISP (cuda runs the Hopper "
                           "kernels; cpu their plain twins)")
  args = parser.parse_args(argv)

  if args.debug:
    import os
    os.environ["TAICHI_IMAGE_TPU_DEBUG"] = "1"

  device = torch.device(args.device)
  cls = {"f16": camera_isp.Camera16, "f32": camera_isp.Camera32,
         "bf16": camera_isp.CameraBF16}[args.dtype]
  isp = cls(BayerPattern.RGGB,
            transform=args.transform,
            moving_alpha=args.moving_alpha,
            resize_width=args.resize_width,
            correct_colors=args.correct_colors,
            device=device)

  if args.scan is not None:
    folders, names = find_scan_folders(args.scan)
  elif args.images is not None:
    folders, names = find_folder_images(args.images)
  else:
    raise ValueError("No --scan or --images specified")

  if args.reverse:
    names = list(reversed(names))

  images = load_images_iter(load_raw_bytes, folders, names)
  row_bytes = (args.width * 3) // 2

  if args.write is not None:
    args.write.mkdir(exist_ok=True, parents=True)

  def encode_and_write(name, planar):
    # worker thread: planar (n, 3, h, w) host array -> HWC grid -> JPEG
    write_image(args.write / f"{Path(name).stem}.jpg",
                rgb_grid(planar, args.rows))

  def encode_and_write_i420(name, y, uv):
    write_image(args.write / f"{Path(name).stem}.jpg",
                i420_grid(y, uv, args.rows), mode="YCbCr")

  def drain(pending, encodes, pool):
    """Wait for the oldest set's download (started at dispatch time) and
    hand it to an encode worker."""
    name0, hosts, copied = pending.popleft()
    if copied is not None:
      copied.synchronize()
    host = [h.numpy() for h in hosts]
    if args.write is not None:
      fn = encode_and_write_i420 if args.fetch == "yuv420" else encode_and_write
      encodes.append(pool.submit(fn, name0, *host))
    while len(encodes) > 8:  # bound encode backlog / surface errors
      encodes.pop(0).result()

  # Pipelined driver (reference prefetch philosophy, tonemap_scan.py:70-87,
  # extended to the device boundary): disk reads prefetch one set ahead
  # (load_images_iter); each set goes up from a pinned buffer without
  # blocking the host; each step's outputs come down on the copy stream
  # while the next sets are uploaded and stepped; JPEG encoding runs on a
  # thread pool. The EMA metering chain stays on the device, so the loop
  # blocks only on a pinned buffer's reuse and on the oldest download.
  upload = types.Uploader(device, args.pipeline_depth + 2)
  download = types.Downloader(device)
  color_format = "yuv420" if args.fetch == "yuv420" else "rgb"
  pending, encodes = deque(), []
  with ThreadPoolExecutor(max_workers=4) as pool:
    for name, group in progress(images, total=len(names), desc="tonemap"):
      for b in group.values():
        # clear error on a wrong --width instead of scrambled frames
        validate_raw_file(b.size, args.width, "packed12")
      raws = upload([b.reshape(-1, row_bytes) for b in group.values()])
      out = isp.process(raws, ids_format=args.ids_format,
                        gamma=args.gamma, intensity=args.intensity,
                        light_adapt=args.light_adapt,
                        color_adapt=args.color_adapt, layout="planar",
                        color_format=color_format)
      pending.append((name, *download.start(
          out if isinstance(out, tuple) else (out,))))
      if len(pending) > args.pipeline_depth:
        drain(pending, encodes, pool)
    while pending:
      drain(pending, encodes, pool)
    for f in encodes:
      f.result()


if __name__ == "__main__":
  main()
