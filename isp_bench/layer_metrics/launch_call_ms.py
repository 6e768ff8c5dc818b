"""Host ms a set inside the kernels' C launcher calls: the program's
``launch_ns`` counters summed over its kernels, over the sets its tracer
saw. A launch held up by a full launch queue counts whole, so this is the
launches' cost plus back-pressure. Missing unless the program's tracer was
on in the run and counted a launch."""

from isp_bench import program_tracer


def read(run):
  snap = program_tracer.snapshot()
  n = program_tracer.sets(snap)
  launch_ns = (snap or {}).get("launch_ns", {})
  if not n or not launch_ns:
    return None
  return sum(launch_ns.values()) / n / 1e6
