"""The comparison that decides ``correct``.

After the window, the reference (``reference/isp.py``) runs the same
chain of sets the program ran, warm-up included, in order, and the
program's outputs at the kept steps (a few drawn from the seed, and the
last) and its final metering state are held to it:

- ``metrics_gap``: the final vec9's widest gap to the reference's, each
  entry against the larger of its own size and the median entry's;
- ``u8_off_share``: the share of the kept outputs' u8 values (RGB, or Y
  and VU) that differ from the reference's, a difference of one at a
  tie of the reference (a tone within ``reference.isp.TIE_COUNTS`` of a
  u8 step) not counted. A working dtype of 16 bits gives each value of
  p to thousands of pixels; where one value's tone is a tie, all of
  them may flip together, and the share would read by luck;
- ``u8_off_max``: the widest difference of one u8 value, in counts.

A control is a computation one precision below the configuration's,
put in the program's place (``CONTROLS``): the program's own class of
that working dtype (``program``) over the same sets, or the reference
itself in that dtype (``reference``) over the same chain. Each has to
come out as not correct.
"""

from __future__ import annotations

import torch

from isp_bench.reference import isp as ref


# the controls of each working dtype, nearest first: (kind, what)
CONTROLS = {
    "float16": (("program", "CameraBF16"), ("reference", "bfloat16"),
                ("reference", "float8_e4m3fn")),
    "float32": (("program", "Camera16"), ("reference", "float16"),
                ("reference", "bfloat16")),
}
# the working dtype of each of the program's classes
CLASS_DTYPE = {"CameraBF16": "bfloat16", "Camera16": "float16",
               "Camera32": "float32"}


def work_dtype(cfg: dict) -> torch.dtype:
  return getattr(torch, cfg["work_dtype"])


def controls(cfg: dict) -> tuple:
  """The configuration's controls, ``(kind, what)``."""
  return CONTROLS[cfg["work_dtype"]]


def as_control(cfg: dict, isp_class: str) -> dict:
  """The configuration with the program's class of a lower precision."""
  return dict(cfg, isp_class=isp_class, work_dtype=CLASS_DTYPE[isp_class])


def planes(output, device) -> list:
  """A step's output as a list of device u8 tensors: planar RGB as it
  is, the I420 pair as two planes."""
  if isinstance(output, (tuple, list)):
    return [o.to(device) for o in output]
  return [output.to(device)]


def gap(metrics: torch.Tensor, want: torch.Tensor) -> float:
  """The widest gap of a vec9 to the reference's, each entry against the
  larger of its own size and the median entry's."""
  a = metrics.to(torch.float64).cpu()
  b = want.to(torch.float64).cpu()
  scale = torch.maximum(b.abs(), b.abs().median())
  return float(((a - b).abs() / scale).max())


def readings(pipe: ref.Pipeline, chain: list, outputs: dict,
             final_metrics: torch.Tensor, color_format: str) -> dict:
  """The numbers of a run against the reference pipeline ``pipe``:
  ``outputs`` {chain position: the step's output}, ``final_metrics``
  the state after the chain's last step."""
  last = len(chain) - 1
  states = pipe.states(chain, set(outputs) | {last})
  off = raw = total = widest = 0
  for pos in sorted(outputs):
    want, ties = pipe.output(chain[pos], states[pos], color_format)
    want = planes(want, states[pos].device)
    ties = ([None] * len(want) if ties is None
            else planes(ties, states[pos].device))
    got = planes(outputs[pos], states[pos].device)
    for g, w, t in zip(got, want, ties, strict=True):
      if g.shape != w.shape:
        raise ValueError(f"step {pos}: output {tuple(g.shape)}, the "
                         f"reference's {tuple(w.shape)}")
      d = (g.to(torch.int16) - w.to(torch.int16)).abs()
      raw += int((d > 0).sum())
      widest = max(widest, int(d.max()))
      if t is not None:
        d = torch.where(t & (d == 1), 0, d)
      off += int((d > 0).sum())
      total += d.numel()
  return {"metrics_gap": gap(final_metrics, states[last]),
          "u8_off_share": off / total, "u8_off_max": float(widest),
          # beside the numbers compared, for the record: ties counted
          "u8_off_share_raw": raw / total}


def reference_control(cfg: dict, dtype: str, pool, chain: list, positions,
                      color_format: str) -> tuple[dict, torch.Tensor]:
  """The reference in ``dtype`` put in the program's place: (its
  outputs at ``positions``, its final state)."""
  pipe = ref.Pipeline(cfg, pool, getattr(torch, dtype))
  last = len(chain) - 1
  states = pipe.states(chain, set(positions) | {last})
  outs = {pos: pipe.output(chain[pos], states[pos], color_format)[0]
          for pos in positions}
  return outs, states[last]


def judge(values: dict, limits: dict) -> bool:
  """Whether every number that ``limits`` names is within its limit."""
  return all(values[k] <= limits[k] for k in limits)
