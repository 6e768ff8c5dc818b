from taichi_image_tpu_torch.utils.benchmark import Benchmark, benchmark

__all__ = ["Benchmark", "benchmark"]
