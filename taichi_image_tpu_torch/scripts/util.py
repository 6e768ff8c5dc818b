"""Shared CLI utilities: folder scanning, natural sort, prefetching loader,
grid concat, image write (a copy of ``taichi_image_tpu/scripts/util.py``,
numpy and PIL only).

Reference: ``taichi_image/scripts/tonemap_scan.py:20-101``. ``natsorted``
is implemented inline (the reference depends on the ``natsort`` package);
image writing uses PIL instead of OpenCV.
"""

from __future__ import annotations

import re
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, List, Tuple

import numpy as np

IMAGE_SUFFIXES = [".tiff", ".raw"]


def natsorted(items):
  """Natural ("version") sort: foo2 < foo10."""
  def key(s):
    return [int(t) if t.isdigit() else t.lower()
            for t in re.split(r"(\d+)", str(s))]
  return sorted(items, key=key)


def is_image_file(f: Path) -> bool:
  return f.is_file() and f.suffix in IMAGE_SUFFIXES


def find_images(folder: Path) -> List[str]:
  return natsorted([f.name for f in folder.iterdir() if is_image_file(f)])


def find_folder_images(folder: Path) -> Tuple[List[Path], List[str]]:
  return [folder], find_images(folder)


def set_intersections(image_sets):
  common = set(image_sets[0])
  for images in image_sets[1:]:
    common.intersection_update(set(images))
  return list(common)


def find_scan_images(scan_folder: Path) -> Tuple[List[Path], List[str]]:
  """Per-camera dirs intersected on common frame names
  (reference tonemap_scan.py:39-52)."""
  cam_folders = {f.name: images for f in scan_folder.iterdir()
                 if f.is_dir() and len(images := find_images(f)) > 0}
  if not cam_folders:
    raise ValueError(f"No camera folders with images in {scan_folder}")
  common_images = set_intersections(list(cam_folders.values()))
  cam_ids = natsorted(cam_folders.keys())
  if len(common_images) == 0:
    raise ValueError(f"No common images found in {cam_ids}")
  print(f"Scanning {len(cam_ids)} camera folders {cam_ids}: "
        f"{len(common_images)} common frames")
  return [scan_folder / i for i in cam_ids], sorted(common_images)


def find_scan_folders(scan_folder) -> Tuple[List[Path], List[str]]:
  folder = Path(scan_folder)
  if not folder.is_dir():
    raise FileNotFoundError(
        f"Folder {folder} does not exist or is not a directory")
  return find_scan_images(folder)


def load_raw_bytes(filepath) -> np.ndarray:
  """Raw file bytes as a u8 array, no decoding
  (reference tonemap_scan.py:63-68)."""
  with open(filepath, "rb") as f:
    return np.frombuffer(f.read(), dtype=np.uint8)


def load_images_iter(f: Callable[[Path], np.ndarray], folders, names):
  """Prefetching loader with one-group lookahead
  (reference tonemap_scan.py:70-87): while frame-set i is processed,
  frame-set i+1 loads on a thread pool."""
  with ThreadPoolExecutor() as executor:
    def add_group(name):
      return {folder: executor.submit(f, folder / name)
              for folder in folders}

    group = add_group(names[0])
    for i in range(1, len(names) + 1):
      next_group = add_group(names[i]) if i < len(names) else None
      result = {k: future.result() for k, future in group.items()}
      yield names[i - 1], result
      group = next_group


def concat_image_grid(images: List[np.ndarray], rows: int) -> np.ndarray:
  """Reference tonemap_scan.py:90-100."""
  n_images = len(images)
  n_cols = (n_images + rows - 1) // rows
  grid_rows = []
  for i in range(0, n_images, n_cols):
    row = images[i:i + n_cols]
    grid_rows.append(np.concatenate(row, axis=1))
  return np.concatenate(grid_rows, axis=0)


def write_image(path: Path, image: np.ndarray, quality: int = 96,
                mode: str | None = None):
  """Write a u8 image (JPEG/PNG by suffix) via PIL: a numpy array or a
  CPU tensor (a CUDA tensor raises; copy it to the host first).
  ``mode='YCbCr'`` encodes JPEG natively from (h, w, 3) YCbCr without an
  RGB trip (the tonemap_scan --fetch yuv420 path)."""
  from PIL import Image
  im = Image.fromarray(np.asarray(image), mode=mode)
  if mode == "YCbCr" and path.suffix.lower() not in (".jpg", ".jpeg"):
    im = im.convert("RGB")  # PNG etc. cannot store YCbCr
  im.save(str(path), quality=quality)


def progress(iterable, total=None, desc=""):
  """Minimal tqdm stand-in."""
  count = 0
  for x in iterable:
    count += 1
    print(f"\r{desc} {count}" + (f"/{total}" if total else ""),
          end="", flush=True)
    yield x
  print()
