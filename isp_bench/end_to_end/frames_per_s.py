"""Camera frames completed (sets x cameras) over the whole window: from
the first set submitted to a device sync after the last."""


def read(run):
  return run.loop.completed * run.cfg["cameras"] / run.loop.window_s
