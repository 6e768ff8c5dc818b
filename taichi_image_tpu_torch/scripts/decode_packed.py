"""Decode a packed-RAW file through the full ISP to a viewable image
(counterpart of ``taichi_image_tpu/scripts/decode_packed.py``).

Reference: ``taichi_image/test/decode_packed.py`` (decode .npy/raw ->
pipeline -> visual check). Reads raw bytes (or a .npy of bytes), runs
packed12 decode -> demosaic -> Reinhard on ``--device`` (default
``cuda``), writes a JPEG/PNG.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from taichi_image_tpu_torch.models import camera_isp
from taichi_image_tpu_torch.ops.bayer import BayerPattern
from taichi_image_tpu_torch.scripts.util import write_image
from taichi_image_tpu_torch.utils.debug import validate_raw_file


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument("raw", type=Path)
  parser.add_argument("--width", type=int, required=True,
                      help="image width in pixels")
  parser.add_argument("--pattern", type=lambda s: BayerPattern[s],
                      default=BayerPattern.RGGB)
  parser.add_argument("--ids_format", action="store_true")
  parser.add_argument("--debug", action="store_true",
                      help="enable the step's validation checks "
                           "(TAICHI_IMAGE_TPU_DEBUG=1; reference: "
                           "ti.init(debug=True))")
  parser.add_argument("--gamma", type=float, default=1.0)
  parser.add_argument("--intensity", type=float, default=1.0)
  parser.add_argument("--out", type=Path, default=None)
  parser.add_argument("--device", default="cuda",
                      help="torch device of the ISP (cuda runs the Hopper "
                           "kernels; cpu their plain twins)")
  args = parser.parse_args(argv)

  if args.debug:
    import os
    os.environ["TAICHI_IMAGE_TPU_DEBUG"] = "1"

  if args.raw.suffix == ".npy":
    data = np.load(args.raw).astype(np.uint8)
  else:
    data = np.frombuffer(args.raw.read_bytes(), np.uint8)
  # fail with a clear message on a wrong --width before reshaping garbage
  validate_raw_file(data.size, args.width, "packed12")
  row_bytes = args.width * 3 // 2
  raws = data.reshape(1, -1, row_bytes)

  isp = camera_isp.Camera32(args.pattern, moving_alpha=1.0,
                            device=args.device)
  out = isp.process(raws, ids_format=args.ids_format, gamma=args.gamma,
                    intensity=args.intensity, layout="hwc")[0]
  dest = args.out or args.raw.with_suffix(".jpg")
  write_image(dest, out)
  print(f"wrote {dest} ({out.shape[1]}x{out.shape[0]})")


if __name__ == "__main__":
  main()
