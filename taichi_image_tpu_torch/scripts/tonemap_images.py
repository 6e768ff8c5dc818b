"""Single-folder batch tonemap CLI (counterpart of
``taichi_image_tpu/scripts/tonemap_images.py``).

Reference: ``taichi_image/scripts/tonemap_images.py`` (bitrotted there —
tifffile ndarray ``.to(cuda)``, tonemap_images.py:36-39). This version
loads TIFF/PNG CFA images with PIL, runs each through the reference's
per-image API (``load_16u``/``load_32f`` -> ``tonemap_reinhard``), and
writes tonemapped JPEGs. ``--device`` (default ``cuda``) places the ISP.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from taichi_image_tpu_torch.models import camera_isp
from taichi_image_tpu_torch.ops.bayer import BayerPattern
from taichi_image_tpu_torch.ops.interpolate import ImageTransform
from taichi_image_tpu_torch.scripts.util import natsorted, progress, write_image


def load_cfa(path: Path) -> np.ndarray:
  from PIL import Image
  arr = np.asarray(Image.open(str(path)))
  if arr.ndim != 2:
    raise ValueError(f"expected mono CFA image, got shape {arr.shape}"
                     f" in {path}")
  return arr


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument("images", type=Path)
  parser.add_argument("--gamma", type=float, default=0.9)
  parser.add_argument("--intensity", type=float, default=3.0)
  parser.add_argument("--color_adapt", type=float, default=0.0)
  parser.add_argument("--light_adapt", type=float, default=0.9)
  parser.add_argument("--moving_alpha", type=float, default=1.0)
  parser.add_argument("--resize_width", type=int, default=0)
  parser.add_argument("--transform", type=ImageTransform,
                      default=ImageTransform.none)
  parser.add_argument("--pattern", type=lambda s: BayerPattern[s],
                      default=BayerPattern.RGGB)
  parser.add_argument("--write", type=Path, default=None)
  parser.add_argument("--debug", action="store_true",
                      help="enable the step's validation checks "
                           "(TAICHI_IMAGE_TPU_DEBUG=1; reference: "
                           "ti.init(debug=True))")
  parser.add_argument("--dtype", choices=["f16", "f32", "bf16"],
                      default="f32", help="working dtype")
  parser.add_argument("--device", default="cuda",
                      help="torch device of the ISP (cuda runs the Hopper "
                           "kernels; cpu their plain twins)")
  args = parser.parse_args(argv)

  if args.debug:
    import os
    os.environ["TAICHI_IMAGE_TPU_DEBUG"] = "1"

  cls = {"f16": camera_isp.Camera16, "f32": camera_isp.Camera32,
         "bf16": camera_isp.CameraBF16}[args.dtype]
  isp = cls(args.pattern, transform=args.transform,
            moving_alpha=args.moving_alpha,
            resize_width=args.resize_width, device=args.device)

  files = natsorted(p for p in args.images.iterdir()
                    if p.suffix in (".tiff", ".tif", ".png"))
  for path in progress(files, total=len(files), desc="tonemap"):
    cfa = load_cfa(path)
    if cfa.dtype == np.uint16:
      image = isp.load_16u(cfa)
    else:
      image = isp.load_32f(cfa.astype(np.float32) / 255.0)
    out = isp.tonemap_reinhard([image], gamma=args.gamma,
                               intensity=args.intensity,
                               light_adapt=args.light_adapt,
                               color_adapt=args.color_adapt)[0]
    if args.write is not None:
      args.write.mkdir(exist_ok=True, parents=True)
      write_image(args.write / f"{path.stem}.jpg", np.asarray(out))


if __name__ == "__main__":
  main()
