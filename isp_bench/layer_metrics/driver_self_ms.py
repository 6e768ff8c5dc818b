"""The program's own host work a set, ms: its ``isp.process`` spans less
the ``isp.launch`` spans inside them (the kernels' C launcher calls),
mean over the sets its tracer saw. Missing unless the program's tracer was
on in the run. Where the device sets the pace, the sum of this and
``launch_call_ms`` (the ``isp.process`` span a set) follows the device,
and the split between them varies from run to run."""

from isp_bench import program_tracer


def read(run):
  snap = program_tracer.snapshot()
  n = program_tracer.sets(snap)
  if not n:
    return None
  spans = program_tracer.spans(snap)
  launch_ns = spans.get(program_tracer.LAUNCH, {}).get("ns", 0)
  return (spans[program_tracer.PROCESS]["ns"] - launch_ns) / n / 1e6
