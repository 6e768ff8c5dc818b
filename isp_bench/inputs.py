"""The raw sets a cell feeds the program, made from ``--seed``.

Uniform random packed12 bytes, as the upstream and port benches use: a
pool of distinct sets made on the device by one seeded generator in one
call, cycled through the run. The program keys no cache on input values,
and one set of a 6x4K rig (74.6 MB) already exceeds the card's L2.
"""

from __future__ import annotations

import torch


def raw_shape(cfg: dict) -> tuple[int, int, int]:
  """(cameras, height, bytes a row) of one packed12 set."""
  if cfg["raw_format"] != "packed12":
    raise ValueError(f"no generator for raw format {cfg['raw_format']!r}")
  return cfg["cameras"], cfg["height"], cfg["width"] * 3 // 2


def raw_pool(cfg: dict, n_sets: int, seed: int,
             device: torch.device) -> torch.Tensor:
  """(n_sets, cameras, H, 1.5 W) u8 on ``device``, from ``seed``."""
  gen = torch.Generator(device=device)
  gen.manual_seed(int(seed))
  return torch.randint(0, 256, (n_sets, *raw_shape(cfg)), generator=gen,
                       dtype=torch.uint8, device=device)

