"""Process start to the first timed set: imports, the kernels' build or
their load from the checkout's cache, the inputs, the warm-up."""


def read(run):
  return run.setup_s
