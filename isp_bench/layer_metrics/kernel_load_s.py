"""Seconds the program spent loading its kernels' libraries in this
process, all of it in set-up: its ``isp.load`` spans, one a source's first
load (hashing the sources, ``nvcc --version``, nvcc where the build cache
misses, ``dlopen``), which it keeps whether or not its tracer is on.
Missing where the program keeps no such span."""

from isp_bench import program_tracer


def read(run):
  load = program_tracer.spans(program_tracer.snapshot()).get(
      program_tracer.LOAD)
  if not load:
    return None
  return load["ns"] / 1e9
