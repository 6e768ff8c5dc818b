"""K2, the MHC stencil (``demosaic_<T>``): the phase planes in, the
12-channel phase RGB and the metering sample out (chip_smoke's stage
table)."""

from isp_bench.work.isp_set import STAGE_OPS, item_bytes, pixels

SYMBOLS = ("stencil_kernel",)


def logical_bytes(cfg: dict, color_format: str) -> int:
  s = cfg["metering_stride"]
  sample = (cfg["cameras"] * 3 * -(-cfg["height"] // s)
            * -(-cfg["width"] // s))
  return (pixels(cfg) + 3 * pixels(cfg) + sample) * item_bytes(cfg)


def ops(cfg: dict, color_format: str) -> float:
  return STAGE_OPS["demosaic"] * pixels(cfg)
