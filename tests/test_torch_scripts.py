"""The port's CLIs (``taichi_image_tpu_torch/scripts``) and the rig example
on the CPU, against the JAX package's on the same files.

Mirrors tests/test_scripts.py (its 13 cases; the shootout's is in
tests/test_torch_bench.py). Contracts:
  * ``scripts.util`` is a copy: every function gives JAX's result exactly;
  * ``tonemap_scan``'s JPEGs, decoded, are within PSNR > 40 dB of the JAX
    CLI's on the same scan (the u8 outputs agree within 1 count, and JPEG
    is deterministic), and are bitwise ``write_image`` of the port's own
    ``process`` outputs through the same grid;
  * ``compare_bayer``'s PSNR table is within 0.01 dB of JAX's;
  * every CLI runs on ``--device cpu`` only when asked: its default is the
    CUDA device, which this host lacks.
"""

import os
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("PIL")

from PIL import Image  # noqa: E402

from taichi_image_tpu.ops import packed  # noqa: E402
from taichi_image_tpu.scripts import util as jutil  # noqa: E402
from taichi_image_tpu_torch.models import camera_isp as tci  # noqa: E402
from taichi_image_tpu_torch.ops.bayer import BayerPattern  # noqa: E402
from taichi_image_tpu_torch.ops.interpolate import ImageTransform  # noqa: E402
from taichi_image_tpu_torch.scripts import util as sutil  # noqa: E402
from taichi_image_tpu_torch.scripts import tonemap_scan as tscan  # noqa: E402
from conftest import make_test_rgb  # noqa: E402
from oracle import rgb_to_bayer_oracle  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]


def _write_scan(tmp_path, n_cams=2, n_frames=3, h=64, w=96):
  tmp_path.mkdir(parents=True, exist_ok=True)
  for cam in range(n_cams):
    d = tmp_path / f"cam{cam}"
    d.mkdir()
    for f in range(n_frames):
      img = make_test_rgb(h, w, seed=cam * 10 + f)
      cfa = rgb_to_bayer_oracle(img, "RGGB")
      raw = np.asarray(packed.encode12(cfa, scaled=True))
      (d / f"frame{f:03d}.raw").write_bytes(raw.tobytes())
  return tmp_path


def _jpeg(path) -> np.ndarray:
  return np.asarray(Image.open(path)).astype(np.float64)


def _psnr(a, b) -> float:
  mse = ((a - b) ** 2).mean()
  return 10 * np.log10(255.0 ** 2 / max(mse, 1e-9))


# -- scripts.util ------------------------------------------------------------

def test_natsorted():
  assert sutil.natsorted(["f10", "f2", "f1"]) == ["f1", "f2", "f10"]


@pytest.mark.parametrize("items", [
    ["f10", "f2", "f1"], ["cam10", "Cam2", "cam1", "b"],
    ["a1b10", "a1b2", "a10b1", "a2"], ["frame000.raw", "frame010.raw",
                                       "frame9.raw"]])
def test_natsorted_is_jax(items):
  assert sutil.natsorted(items) == jutil.natsorted(items)


def test_find_scan_folders(tmp_path):
  _write_scan(tmp_path)
  folders, names = sutil.find_scan_folders(tmp_path)
  assert len(folders) == 2
  assert names == ["frame000.raw", "frame001.raw", "frame002.raw"]


def test_scan_discovery_is_jax(tmp_path):
  _write_scan(tmp_path, n_cams=3, n_frames=4)
  (tmp_path / "cam1" / "extra.raw").write_bytes(b"\0" * 9)  # not common
  (tmp_path / "notes.txt").write_text("x")
  assert sutil.find_scan_folders(tmp_path) == jutil.find_scan_folders(tmp_path)
  assert (sutil.find_folder_images(tmp_path / "cam1")
          == jutil.find_folder_images(tmp_path / "cam1"))
  for mod in (sutil, jutil):
    with pytest.raises(FileNotFoundError):
      mod.find_scan_folders(tmp_path / "missing")


def test_load_images_iter(tmp_path):
  _write_scan(tmp_path, n_cams=2, n_frames=3)
  folders, names = sutil.find_scan_folders(tmp_path)
  seen = list(sutil.load_images_iter(sutil.load_raw_bytes, folders, names))
  assert [n for n, _ in seen] == names
  for _, group in seen:
    assert len(group) == 2
    for arr in group.values():
      assert arr.dtype == np.uint8


def test_load_images_iter_is_jax(tmp_path):
  _write_scan(tmp_path, n_cams=2, n_frames=3)
  folders, names = sutil.find_scan_folders(tmp_path)
  names = list(reversed(names))
  ours = list(sutil.load_images_iter(sutil.load_raw_bytes, folders, names))
  theirs = list(jutil.load_images_iter(jutil.load_raw_bytes, folders, names))
  assert [n for n, _ in ours] == [n for n, _ in theirs]
  for (_, g1), (_, g2) in zip(ours, theirs):
    assert list(g1) == list(g2)
    for k in g1:
      np.testing.assert_array_equal(g1[k], g2[k])


def test_concat_image_grid():
  imgs = [np.full((4, 6, 3), i, np.uint8) for i in range(4)]
  grid = sutil.concat_image_grid(imgs, rows=2)
  assert grid.shape == (8, 12, 3)
  assert grid[0, 0, 0] == 0 and grid[0, 11, 0] == 1
  assert grid[7, 0, 0] == 2 and grid[7, 11, 0] == 3


@pytest.mark.parametrize("n,rows", [(4, 2), (6, 2), (5, 2), (3, 1), (6, 3)])
def test_concat_image_grid_is_jax(n, rows):
  rng = np.random.default_rng(n * 10 + rows)
  imgs = [rng.integers(0, 256, (4, 6, 3), dtype=np.uint8) for _ in range(n)]
  if n % -(-n // rows):  # a ragged last row: both refuse it alike
    for mod in (sutil, jutil):
      with pytest.raises(ValueError):
        mod.concat_image_grid(imgs, rows=rows)
    return
  np.testing.assert_array_equal(sutil.concat_image_grid(imgs, rows=rows),
                                jutil.concat_image_grid(imgs, rows=rows))


def test_write_image_takes_a_cpu_tensor(tmp_path):
  img = np.random.default_rng(0).integers(0, 256, (8, 12, 3), dtype=np.uint8)
  sutil.write_image(tmp_path / "a.png", torch.from_numpy(img))
  jutil.write_image(tmp_path / "b.png", img)
  assert ((tmp_path / "a.png").read_bytes()
          == (tmp_path / "b.png").read_bytes())


# -- tonemap_scan ------------------------------------------------------------

def test_tonemap_scan_end_to_end(tmp_path):
  scan = _write_scan(tmp_path / "scan", h=64, w=96)
  out = tmp_path / "out"
  tscan.main(["--scan", str(scan), "--width", "96", "--resize_width", "48",
              "--write", str(out), "--transform", "none", "--rows", "1"]
             + CPU)
  files = sorted(out.glob("*.jpg"))
  assert len(files) == 3
  img = np.asarray(Image.open(files[0]))
  # 2 cameras side by side, resized to width 48 (height 32)
  assert img.shape == (32, 96, 3)
  assert img.std() > 5  # not a blank image


def test_tonemap_scan_serial_matches_pipelined(tmp_path):
  """--pipeline_depth 0 (fully serial) writes the same JPEGs as the
  pipelined default (pipelining only reorders host work; the EMA chain
  order is identical)."""
  scan = _write_scan(tmp_path / "scan", h=64, w=96)
  out_p, out_s = tmp_path / "outp", tmp_path / "outs"
  base = ["--scan", str(scan), "--width", "96", "--resize_width", "48",
          "--transform", "none", "--rows", "1"] + CPU
  tscan.main(base + ["--write", str(out_p)])
  tscan.main(base + ["--write", str(out_s), "--pipeline_depth", "0"])
  files = sorted(out_p.glob("*.jpg"))
  assert len(files) == 3
  for f in files:
    assert (out_s / f.name).read_bytes() == f.read_bytes()


def test_tonemap_scan_i420_fetch(tmp_path):
  """--fetch yuv420 (the device emits fused I420; JPEG encodes natively
  from YCbCr) stays close to the RGB-fetch output: the only differences
  are the ISP's BT.601 matrix quirks vs libjpeg's and the nearest (vs
  fancy) chroma upsample."""
  scan = _write_scan(tmp_path / "scan", h=64, w=96)
  out_rgb, out_yuv = tmp_path / "outr", tmp_path / "outy"
  base = ["--scan", str(scan), "--width", "96", "--resize_width", "48",
          "--transform", "none", "--rows", "1"] + CPU
  tscan.main(base + ["--write", str(out_rgb)])
  tscan.main(base + ["--write", str(out_yuv), "--fetch", "yuv420"])
  files = sorted(out_yuv.glob("*.jpg"))
  assert len(files) == 3
  for f in files:
    a, b = _jpeg(out_rgb / f.name), _jpeg(f)
    assert a.shape == b.shape == (32, 96, 3)
    assert _psnr(a, b) > 30, f"{f.name}: {_psnr(a, b):.1f} dB"


def test_tonemap_scan_debug_flag(tmp_path, monkeypatch):
  """--debug turns on the step's validation checks (reference --debug ->
  ti.init(debug=True), test/arguments.py:7,27) and clean data passes."""
  # setenv registers the restore-to-original undo, so the CLI's direct
  # os.environ write below is rolled back after the test (a plain
  # delenv(raising=False) on an absent var registers NO undo and the
  # flag would leak into every later test).
  monkeypatch.setenv("TAICHI_IMAGE_TPU_DEBUG", "0")
  scan = _write_scan(tmp_path / "scan", h=64, w=96, n_frames=1)
  out = tmp_path / "out"
  tscan.main(["--scan", str(scan), "--width", "96", "--write", str(out),
              "--transform", "none", "--rows", "1", "--debug"] + CPU)
  assert os.environ.get("TAICHI_IMAGE_TPU_DEBUG") == "1"
  assert len(sorted(out.glob("*.jpg"))) == 1


# (flags, the ISP class and its keywords): resize, the default rotate_90,
# the I420 fetch, and the two other classes
_SCAN_CASES = {
    "resize48": (["--resize_width", "48", "--transform", "none"],
                 tci.Camera32, dict(resize_width=48)),
    "rotate_90": ([], tci.Camera32, dict(transform=ImageTransform.rotate_90)),
    "i420": (["--fetch", "yuv420"], tci.Camera32,
             dict(transform=ImageTransform.rotate_90)),
    "bf16-resize48-i420": (["--dtype", "bf16", "--resize_width", "48",
                            "--fetch", "yuv420", "--rows", "2"],
                           tci.CameraBF16,
                           dict(resize_width=48,
                                transform=ImageTransform.rotate_90)),
    "f16-flip": (["--dtype", "f16", "--transform", "flip_horiz"],
                 tci.Camera16, dict(transform=ImageTransform.flip_horiz)),
}


@pytest.mark.parametrize("case", ["resize48", "rotate_90", "i420"])
def test_tonemap_scan_is_jax_cli(tmp_path, case):
  from taichi_image_tpu.scripts.tonemap_scan import main as jax_main
  flags = _SCAN_CASES[case][0]
  scan = _write_scan(tmp_path / "scan", h=64, w=96)
  base = ["--scan", str(scan), "--width", "96", "--rows", "1"] + flags
  tscan.main(base + ["--write", str(tmp_path / "port")] + CPU)
  jax_main(base + ["--write", str(tmp_path / "jax")])
  files = sorted((tmp_path / "port").glob("*.jpg"))
  assert len(files) == 3
  for f in files:
    a, b = _jpeg(f), _jpeg(tmp_path / "jax" / f.name)
    assert a.shape == b.shape
    assert _psnr(a, b) > 40, f"{case} {f.name}: {_psnr(a, b):.1f} dB"


@pytest.mark.parametrize("case", list(_SCAN_CASES))
def test_tonemap_scan_bytes_are_process_outputs(tmp_path, case):
  """Each JPEG is bitwise write_image of the grid of a fresh ISP's
  ``process`` outputs on the same frame sets, in the same order."""
  flags, cls, isp_kw = _SCAN_CASES[case]
  scan = _write_scan(tmp_path / "scan", h=64, w=96)
  out = tmp_path / "out"
  tscan.main(["--scan", str(scan), "--width", "96", "--rows", "1"] + flags
             + ["--write", str(out)] + CPU)
  rows = int(flags[flags.index("--rows") + 1]) if "--rows" in flags else 1
  i420 = "yuv420" in flags
  isp = cls(BayerPattern.RGGB, moving_alpha=0.02, device="cpu", **isp_kw)
  folders, names = sutil.find_scan_folders(scan)
  assert len(list(out.glob("*.jpg"))) == len(names) == 3
  for name in names:
    raws = np.stack([sutil.load_raw_bytes(d / name).reshape(-1, 144)
                     for d in folders])
    res = isp.process(raws, gamma=0.9, intensity=3.0, light_adapt=0.9,
                      color_adapt=0.0,
                      color_format="yuv420" if i420 else "rgb")
    ref = tmp_path / f"ref_{Path(name).stem}.jpg"
    if i420:
      sutil.write_image(ref, tscan.i420_grid(res[0].numpy(), res[1].numpy(),
                                             rows), mode="YCbCr")
    else:
      sutil.write_image(ref, tscan.rgb_grid(res.numpy(), rows))
    assert (out / f"{Path(name).stem}.jpg").read_bytes() == ref.read_bytes()


def test_tonemap_scan_rejects_wrong_width(tmp_path):
  scan = _write_scan(tmp_path / "scan", h=64, w=96, n_frames=1)
  with pytest.raises(ValueError, match="wrong --width"):
    tscan.main(["--scan", str(scan), "--width", "100"] + CPU)


# -- the other CLIs ----------------------------------------------------------

def _write_cfa_pngs(d, n=2, h=32, w=48):
  d.mkdir()
  for i in range(n):
    img = make_test_rgb(h, w, seed=i)
    cfa = (rgb_to_bayer_oracle(img, "RGGB") * 65535).astype(np.uint16)
    Image.fromarray(cfa).save(str(d / f"im{i}.png"))
  return d


def test_tonemap_images_end_to_end(tmp_path):
  d = _write_cfa_pngs(tmp_path / "imgs")
  out = tmp_path / "out"
  from taichi_image_tpu_torch.scripts.tonemap_images import main
  main([str(d), "--write", str(out)] + CPU)
  assert len(list(out.glob("*.jpg"))) == 2


def test_tonemap_images_is_jax_cli(tmp_path):
  from taichi_image_tpu.scripts.tonemap_images import main as jax_main
  from taichi_image_tpu_torch.scripts.tonemap_images import main
  d = _write_cfa_pngs(tmp_path / "imgs")
  main([str(d), "--write", str(tmp_path / "port")] + CPU)
  jax_main([str(d), "--write", str(tmp_path / "jax")])
  for f in sorted((tmp_path / "port").glob("*.jpg")):
    a, b = _jpeg(f), _jpeg(tmp_path / "jax" / f.name)
    assert a.shape == b.shape == (32, 48, 3)
    assert _psnr(a, b) > 40, f"{f.name}: {_psnr(a, b):.1f} dB"


def test_decode_packed_is_jax_cli(tmp_path, capsys):
  from taichi_image_tpu.scripts.decode_packed import main as jax_main
  from taichi_image_tpu_torch.scripts.decode_packed import main
  cfa = rgb_to_bayer_oracle(make_test_rgb(32, 48, seed=3), "RGGB")
  raw = tmp_path / "f.raw"
  raw.write_bytes(np.asarray(packed.encode12(cfa, scaled=True)).tobytes())
  main([str(raw), "--width", "48", "--out", str(tmp_path / "port.jpg")]
       + CPU)
  assert "wrote" in capsys.readouterr().out
  jax_main([str(raw), "--width", "48", "--out", str(tmp_path / "jax.jpg")])
  a, b = _jpeg(tmp_path / "port.jpg"), _jpeg(tmp_path / "jax.jpg")
  assert a.shape == b.shape == (32, 48, 3)
  assert _psnr(a, b) > 40
  with pytest.raises(ValueError, match="wrong --width"):
    main([str(raw), "--width", "50"] + CPU)


def _compare_table(out: str):
  rows = {}
  for line in out.splitlines():
    parts = line.split()
    if parts and parts[0] in ("RGGB", "GRBG", "GBRG", "BGGR"):
      rows[parts[0]] = [None if p == "n/a" else float(p) for p in parts[1:]]
  return rows


def _rgb_png(tmp_path):
  img = (make_test_rgb(48, 64) * 255).astype(np.uint8)
  p = tmp_path / "rgb.png"
  Image.fromarray(img).save(str(p))
  return p


def test_compare_bayer_cli(tmp_path, capsys):
  p = _rgb_png(tmp_path)
  from taichi_image_tpu_torch.scripts.compare_bayer import main
  main([str(p)] + CPU)
  out = capsys.readouterr().out
  assert "RGGB" in out and "BGGR" in out


@pytest.mark.parametrize("crop", [0, 2])
def test_compare_bayer_table_is_jax(tmp_path, capsys, crop):
  from taichi_image_tpu.scripts.compare_bayer import main as jax_main
  from taichi_image_tpu_torch.scripts.compare_bayer import main
  p = _rgb_png(tmp_path)
  main([str(p), "--crop", str(crop)] + CPU)
  ours = _compare_table(capsys.readouterr().out)
  jax_main([str(p), "--crop", str(crop)])
  theirs = _compare_table(capsys.readouterr().out)
  assert set(ours) == set(theirs) == {"RGGB", "GRBG", "GBRG", "BGGR"}
  for pattern, row in ours.items():
    assert len(row) == len(theirs[pattern]) == 3
    for a, b in zip(row, theirs[pattern]):
      assert (a is None) == (b is None)
      if a is not None:
        assert abs(a - b) <= 0.01, (pattern, row, theirs[pattern])


def test_compare_bayer_write_and_headless_show(tmp_path, capsys,
                                               monkeypatch):
  """--write saves per-pattern/method PNGs; --show falls back to
  writing on a headless host (the reference's interactive harness,
  test/bayer.py:34-41)."""
  monkeypatch.delenv("DISPLAY", raising=False)
  monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
  p = _rgb_png(tmp_path)
  from taichi_image_tpu_torch.scripts.compare_bayer import main
  out = tmp_path / "imgs"
  main([str(p), "--write", str(out)] + CPU)
  pngs = sorted(f.name for f in out.glob("*.png"))
  assert "RGGB_mhc.png" in pngs and "BGGR_bilinear.png" in pngs
  assert len(pngs) == 8  # 4 patterns x 2 methods
  # round-trip: the written PNG is the demosaic output, not garbage
  back = np.asarray(Image.open(str(out / "RGGB_mhc.png")))
  assert back.shape == (48, 64, 3) and back.std() > 1.0
  # --show on this display-less host must not raise; it redirects to
  # --write's directory and says so
  main([str(p), "--show", "--write", str(out)] + CPU)
  msg = capsys.readouterr().out
  assert "unavailable" in msg and "wrote" in msg


# -- no silent CPU fallback --------------------------------------------------

@pytest.mark.parametrize("cli", ["tonemap_scan", "tonemap_images",
                                 "decode_packed", "compare_bayer"])
def test_cli_defaults_to_the_card(tmp_path, cli, monkeypatch):
  """Without --device a CLI places its work on the CUDA device; on a host
  without one it raises instead of running on the CPU."""
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present: the default runs there")
  import importlib
  mod = importlib.import_module(f"taichi_image_tpu_torch.scripts.{cli}")
  scan = _write_scan(tmp_path / "scan", n_frames=1)
  argv = {"tonemap_scan": ["--scan", str(scan), "--width", "96"],
          "tonemap_images": [str(_write_cfa_pngs(tmp_path / "imgs", n=1))],
          "decode_packed": [str(scan / "cam0" / "frame000.raw"),
                            "--width", "96", "--out",
                            str(tmp_path / "x.jpg")],
          "compare_bayer": [str(_rgb_png(tmp_path))]}[cli]
  monkeypatch.chdir(tmp_path)
  with pytest.raises((RuntimeError, AssertionError),
                     match="CUDA|accelerator"):
    mod.main(argv)
  assert not list(tmp_path.glob("*.jpg"))


# -- the rig example ---------------------------------------------------------

_RIG = REPO / "examples" / "camera_rig_torch.py"
_RIG_ARGS = ["--frames", "2", "--cameras", "2", "--height", "64",
             "--width", "96", "--device", "cpu"]


def test_example_camera_rig_torch(tmp_path, capsys):
  """examples/camera_rig_torch.py runs end-to-end as a script
  (streaming + I420 + AWB + checkpoint branches)."""
  argv = sys.argv
  sys.argv = ["camera_rig_torch.py", *_RIG_ARGS, "--out", str(tmp_path / "rig")]
  try:
    runpy.run_path(str(_RIG), run_name="__main__")
  finally:
    sys.argv = argv
  assert len(list((tmp_path / "rig").glob("*.jpg"))) == 2
  out = capsys.readouterr().out
  assert "I420: Y (2, 64, 96)" in out and "carried over" in out


def test_example_camera_rig_torch_state(tmp_path):
  """The rig's I420 branch and its carried-over state."""
  main = runpy.run_path(str(_RIG), run_name="camera_rig_torch")["main"]
  res = main([*_RIG_ARGS, "--out", str(tmp_path / "rig")])
  assert res["rgb_sets"] == 2
  assert len(list((tmp_path / "rig").glob("*.jpg"))) == 2
  y, uv = res["y"], res["uv"]
  assert y.dtype == uv.dtype == torch.uint8
  assert tuple(y.shape) == (2, 64, 96) and tuple(uv.shape) == (2, 2, 32, 48)
  assert y.float().std() > 1
  st, back = res["state"], res["restored"]
  assert st["metrics"].shape == (9,) and np.isfinite(st["metrics"]).all()
  np.testing.assert_array_equal(back["metrics"], st["metrics"])
  np.testing.assert_array_equal(back["white_balance"], st["white_balance"])
  assert st["white_balance"][1] == 1.0  # AWB keeps green at 1


def test_console_entries_name_the_port_clis():
  """pyproject.toml's `<name>_torch` entries point at the port's CLIs,
  beside the JAX package's `<name>` entries."""
  import importlib
  import tomllib
  scripts = tomllib.loads((REPO / "pyproject.toml").read_text())[
      "project"]["scripts"]
  for name in ("tonemap_scan", "tonemap_images"):
    target = scripts[f"{name}_torch"]
    assert target == scripts[name].replace("taichi_image_tpu.",
                                           "taichi_image_tpu_torch.")
    mod, fn = target.split(":")
    assert callable(getattr(importlib.import_module(mod), fn))
