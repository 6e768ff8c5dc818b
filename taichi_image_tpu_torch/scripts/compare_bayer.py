"""Demosaic quality shoot-out: PSNR of MHC / bilinear / OpenCV on an image
(counterpart of ``taichi_image_tpu/scripts/compare_bayer.py``).

Reference: ``taichi_image/test/compare_bayer.py`` (PSNR vs external
implementations: OpenCV debayer + colour_demosaicing). Loads an RGB image
(PIL), mosaics it for each Bayer pattern, demosaics with this package's
two methods on ``--device`` (default ``cuda``: the K2 stencil in f32) AND
OpenCV's independent debayer (when cv2 is installed; colour_demosaicing is
not available in this environment) and prints PSNR per pattern.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from taichi_image_tpu_torch.ops import bayer
from taichi_image_tpu_torch.utils.image import psnr


def load_rgb(path: Path) -> np.ndarray:
  from PIL import Image
  img = np.asarray(Image.open(str(path)).convert("RGB"))
  return (img.astype(np.float32) / 255.0)


def opencv_demosaic(cfa_u8: np.ndarray, pattern) -> np.ndarray:
  """Demosaic a u8 CFA with OpenCV's independent implementation, or None
  if cv2 is unavailable.

  OpenCV's Bayer code naming is offset by one pixel from the top-left-quad
  convention used here (cv2 names the pattern by the 2x2 quad starting at
  (1, 1)); the mapping below is the empirically-validated correspondence.
  """
  try:
    import cv2
  except Exception:
    return None
  code = {
      "RGGB": cv2.COLOR_BayerBG2RGB,
      "GRBG": cv2.COLOR_BayerGB2RGB,
      "GBRG": cv2.COLOR_BayerGR2RGB,
      "BGGR": cv2.COLOR_BayerRG2RGB,
  }[pattern.name]
  return cv2.cvtColor(cfa_u8, code)


def display_or_write(name: str, rgb01: np.ndarray, show: bool,
                     outdir: Path | None) -> None:
  """Show a demosaiced result in a window (the reference's interactive
  harness, test/bayer.py:34-41) or write it as a PNG when headless.

  ``--show`` tries ``cv2.imshow``; on a display-less host (cv2 built
  without GUI, or no X server) it falls back to writing into ``outdir``
  (default ``./compare_bayer_out``) and says so.
  """
  u8 = np.clip(rgb01 * 255.0, 0, 255).astype(np.uint8)
  if show:
    # cv2.imshow on a display-less host ABORTS the process (Qt fatal,
    # not a catchable exception) — gate on an actual display being set.
    import os
    if os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY"):
      try:
        import cv2
        cv2.imshow(name, cv2.cvtColor(u8, cv2.COLOR_RGB2BGR))
        cv2.waitKey(0)
        return
      except Exception as e:
        print(f"--show unavailable here ({type(e).__name__}); "
              "writing PNG instead")
    else:
      print("--show unavailable here (no display); writing PNG instead")
    outdir = outdir or Path("compare_bayer_out")
  if outdir is None:
    return
  outdir.mkdir(parents=True, exist_ok=True)
  from PIL import Image
  path = outdir / f"{name}.png"
  Image.fromarray(u8).save(str(path))
  print(f"wrote {path}")


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument("image", type=Path)
  parser.add_argument("--crop", type=int, default=0,
                      help="ignore an n-pixel border in the PSNR")
  parser.add_argument("--show", action="store_true",
                      help="display each demosaiced result in a window "
                      "(falls back to --write on headless hosts)")
  parser.add_argument("--write", type=Path, default=None, metavar="DIR",
                      help="write each demosaiced result as DIR/"
                      "{pattern}_{method}.png")
  parser.add_argument("--device", default="cuda",
                      help="torch device of the demosaic (cuda runs the "
                           "Hopper stencil; cpu its plain twin)")
  args = parser.parse_args(argv)

  img = load_rgb(args.image)
  h, w = (img.shape[0] // 2) * 2, (img.shape[1] // 2) * 2
  img = img[:h, :w]
  c = args.crop

  print(f"{'pattern':8} {'mhc':>8} {'bilinear':>8} {'opencv':>8}  (PSNR dB)")
  for pattern in bayer.BayerPattern:
    cfa_t = bayer.rgb_to_bayer(img, pattern, device=args.device)
    scores = []
    for method in ("mhc", "bilinear"):
      rgb = bayer.bayer_to_rgb(cfa_t, pattern, method=method).cpu().numpy()
      if args.show or args.write is not None:
        display_or_write(f"{pattern.name}_{method}", rgb, args.show,
                         args.write)
      ref, got = (img, rgb) if c == 0 else (img[c:-c, c:-c],
                                            rgb[c:-c, c:-c])
      scores.append(psnr(got, ref, peak=1.0))
    cfa = cfa_t.cpu().numpy()
    cfa_u8 = np.clip(cfa * 255.0, 0, 255).astype(np.uint8)
    cv_rgb = opencv_demosaic(cfa_u8, pattern)
    if cv_rgb is not None:
      got = cv_rgb.astype(np.float32) / 255.0
      ref = img
      if c:
        got, ref = got[c:-c, c:-c], img[c:-c, c:-c]
      cv_score = f"{psnr(got, ref, peak=1.0):8.2f}"
    else:
      cv_score = "     n/a"
    print(f"{pattern.name:8} {scores[0]:8.2f} {scores[1]:8.2f} {cv_score}")


if __name__ == "__main__":
  main()
