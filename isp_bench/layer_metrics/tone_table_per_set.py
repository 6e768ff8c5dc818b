"""K4's table-form launches a set: the program's ``tone_forms["table"]``
counter (a finish launch that toned through its per-image byte tables)
over the sets its tracer saw; 0.0 where the tone kernels launched in
another form only. Missing unless the program's tracer was on in the run
and counted a tone kernel's launch."""

from isp_bench import program_tracer


def read(run):
  snap = program_tracer.snapshot()
  n = program_tracer.sets(snap)
  forms = (snap or {}).get("tone_forms", {})
  if not n or not forms:
    return None
  return forms.get("table", 0) / n
