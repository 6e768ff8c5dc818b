"""K4's launches through its axis-swap kernel a set: the program's
``finish_layouts["swap"]`` counter (a finish launch under a transform that
swaps the axes) over the sets its tracer saw; 0.0 where K4 launched
without a swap only. Missing unless the program's tracer was on in the
run and counted a K4 launch."""

from isp_bench import program_tracer


def read(run):
  snap = program_tracer.snapshot()
  n = program_tracer.sets(snap)
  layouts = (snap or {}).get("finish_layouts", {})
  if not n or not layouts:
    return None
  return layouts.get("swap", 0) / n
