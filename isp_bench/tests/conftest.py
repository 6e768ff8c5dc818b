"""The benchmark's own tests. Those marked ``card`` need a CUDA device;
each decides in a fixture whether there is one and skips here on the CPU.
Run them all with ``python3 -m pytest isp_bench/tests``."""

import pytest


def pytest_configure(config):
  config.addinivalue_line(
      "markers", "card: needs a CUDA device (skipped where there is none)")


@pytest.fixture
def card():
  import torch
  if not torch.cuda.is_available():
    pytest.skip("no CUDA device: this test runs on the card")
  return torch.device("cuda", 0)
