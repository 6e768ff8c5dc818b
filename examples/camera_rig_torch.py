"""End-to-end example: a simulated 6-camera 4K rig streaming through the
PyTorch port's fused ISP, with RGB-grid JPEG output and an I420 branch for
a video encoder (the rig of examples/camera_rig.py, on
``taichi_image_tpu_torch``).

Run (the rig's full size, 6 x 2160 x 3840, on the CUDA device):

    python examples/camera_rig_torch.py --frames 8 --out /tmp/rig_out

``--device cpu`` runs the kernels' plain twins on the CPU (give it a small
``--height``/``--width``: the size does not shrink by itself).

Demonstrates the API surface a taichi_image user needs:
  * synthesizing packed12 RAW from RGB (`rgb_to_bayer` + `encode12`) —
    the reference's own test-fixture recipe (test/camera_isp.py:10-21) —
    on the device, fetched into host numpy sets, as a rig's capture
    driver delivers them;
  * the fused per-frame step `isp.process` (decode -> demosaic+WB/CCM ->
    EMA metering -> Reinhard -> u8) and the streaming driver
    `isp.process_stream`: host sets go up through a pinned ring on a copy
    stream and HWC frames come down on a download stream, with steps in
    flight on the device;
  * I420 output for video encoders (`color_format="yuv420"`);
  * gray-world auto white balance from the metering state;
  * checkpointing the only cross-frame state (`state_dict`).
"""

import argparse
import os
import sys
import time
from pathlib import Path

import torch

# runnable without installation: the repo root is the example's parent
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def synth_scene(h, w, t, n_cams, device):
  """A moving smooth scene with per-camera exposure differences
  (deterministic in (h, w, t, n_cams)): (n_cams, h, w, 3) f32 in [0, 1]
  on ``device``."""
  yy, xx = torch.meshgrid(
      torch.arange(h, dtype=torch.float32, device=device),
      torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
  frames = []
  for cam in range(n_cams):
    phase = t * 0.3 + cam * 0.7
    r = 0.5 + 0.4 * torch.sin(xx / 97.0 + phase)
    g = 0.5 + 0.4 * torch.sin(yy / 71.0 - phase * 1.3)
    b = 0.5 + 0.4 * torch.sin((xx + yy) / 133.0 + phase * 0.5)
    img = torch.stack([r, g, b], dim=-1) * (0.6 + 0.1 * cam)
    frames.append(torch.clamp(img, 0.0, 1.0))
  return torch.stack(frames)


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__)
  ap.add_argument("--frames", type=int, default=8)
  ap.add_argument("--cameras", type=int, default=6)
  ap.add_argument("--height", type=int, default=2160)
  ap.add_argument("--width", type=int, default=3840)
  ap.add_argument("--out", type=Path, default=Path("/tmp/rig_out"))
  ap.add_argument("--device", default="cuda")
  args = ap.parse_args(argv)

  import taichi_image_tpu_torch as tit
  from taichi_image_tpu_torch.ops import packed
  from taichi_image_tpu_torch.scripts.util import (concat_image_grid,
                                                   write_image)

  h, w, device = args.height, args.width, torch.device(args.device)

  # --- camera simulator: RGB scene -> packed12 RAW per camera ----------
  # rendered on the device once, up front, and kept as host numpy sets:
  # the frames a capture driver hands over (fetching each set while the
  # stream runs would wait for the steps in flight)
  recorded = []
  for t in range(args.frames):
    raws = [packed.encode12(tit.rgb_to_bayer(img, tit.BayerPattern.RGGB),
                            scaled=True)
            for img in synth_scene(h, w, t, args.cameras, device)]
    recorded.append(torch.stack(raws).cpu().numpy())

  def raw_stream():
    yield from recorded  # (n_cams, h, w*3//2) u8 host arrays

  # --- the rig ----------------------------------------------------------
  isp = tit.Camera16(tit.BayerPattern.RGGB, moving_alpha=0.1,
                     correct_colors=True, device=device)

  args.out.mkdir(parents=True, exist_ok=True)
  t0 = time.perf_counter()
  n_done = 0
  for i, out in enumerate(isp.process_stream(raw_stream(), prefetch=2,
                                             gamma=1.0, layout="hwc")):
    grid = concat_image_grid(list(out), rows=2)
    write_image(args.out / f"frame{i:04d}.jpg", grid)
    n_done += 1
  dt = time.perf_counter() - t0
  print(f"RGB: {n_done} frame sets x {args.cameras} cams "
        f"({args.cameras * n_done / dt:.1f} frames/s incl. upload, download "
        f"and JPEG) -> {args.out}")

  # --- I420 branch (what a video encoder consumes) ----------------------
  isp2 = tit.Camera16(tit.BayerPattern.RGGB, moving_alpha=0.1,
                      device=device)
  raws = next(iter(raw_stream()))
  y, uv = isp2.process(raws, color_format="yuv420")
  print(f"I420: Y {tuple(y.shape)} u8 + UV {tuple(uv.shape)} u8 "
        f"(V-then-U plane order) on {y.device}")

  # --- gray-world auto white balance -------------------------------------
  # the EMA metering already carries per-channel means; each call nudges
  # the WB gains toward equal means (a real rig's AWB feedback loop)
  wb = isp.auto_white_balance(strength=0.7)
  print(f"AWB gains after this scene (G==1 convention): {wb}")

  # --- checkpoint/resume -------------------------------------------------
  state = isp.state_dict()  # EMA metering vec9 + AWB white balance
  isp3 = tit.Camera16(tit.BayerPattern.RGGB, moving_alpha=0.1,
                      correct_colors=True, device=device)
  isp3.load_state(state)
  print(f"EMA metering state carried over: {isp3.metrics.cpu().numpy()}")
  print(f"white balance carried over: {isp3.white_balance}")
  return dict(rgb_sets=n_done, y=y, uv=uv, state=state,
              restored=isp3.state_dict())


if __name__ == "__main__":
  main()
