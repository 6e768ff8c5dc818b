"""K12's launches on its aligned path a set: the program's
``resize_paths["aligned"]`` counter (a resize launch whose taps are the
half-res grid and whose rows are whole 16-byte runs) over the sets its
tracer saw; 0.0 where K12 launched on its direct path only. Missing unless
the program's tracer was on in the run and counted a K12 launch."""

from isp_bench import program_tracer


def read(run):
  snap = program_tracer.snapshot()
  n = program_tracer.sets(snap)
  paths = (snap or {}).get("resize_paths", {})
  if not n or not paths:
    return None
  return paths.get("aligned", 0) / n
