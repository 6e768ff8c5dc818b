"""K4's I420-mode launches a set: the program's ``i420_paths["rows"]``
counter (a launch of ``finish_yuv420`` without an axis swap) over the sets
its tracer saw; 0.0 where only the other I420 paths launched (the tile
kernel under a swap, the planar tonemap form, the conversion of u8 RGB).
Missing unless the program's tracer was on in the run and counted an I420
launch."""

from isp_bench import program_tracer


def read(run):
  snap = program_tracer.snapshot()
  n = program_tracer.sets(snap)
  paths = (snap or {}).get("i420_paths", {})
  if not n or not paths:
    return None
  return paths.get("rows", 0) / n
