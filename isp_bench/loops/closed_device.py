"""Closed loop over sets already on the card: each set is submitted as
soon as ``process`` returns for the one before, and its output stays on
the card. The window runs from the first submission to a device sync
after the last, so every stall inside counts."""

from __future__ import annotations

import time

from isp_bench.harness import MARK_EVERY, LoopResult


def warmup(ctx) -> None:
  for _ in range(int(ctx.traffic["warmup_sets"])):
    _, raws = ctx.take()
    ctx.isp.process(raws, **ctx.kwargs)
  ctx.sync()


def run(ctx) -> LoopResult:
  isp, kwargs = ctx.isp, ctx.kwargs
  ctx.start_window()
  end = ctx.t_start + ctx.seconds
  n, marks = 0, []
  while True:
    ctx.tracer.before_set()
    pos, raws = ctx.take()
    ctx.keep(pos, isp.process(raws, **kwargs))
    n += 1
    now = time.perf_counter()
    if n % MARK_EVERY == 0:
      marks.append(now - ctx.t_start)
    if now >= end:
      break
  ctx.tracer.finish()
  with ctx.spans("sync"):
    ctx.sync()
  return LoopResult(n, n, time.perf_counter() - ctx.t_start, marks)
