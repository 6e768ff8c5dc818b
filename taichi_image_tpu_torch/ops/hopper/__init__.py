"""Hand-written Hopper (sm_90a) kernels: build, load and launch.

Counterpart of ``taichi_image_tpu/ops/pallas/__init__.py``. Each kernel
lives in ``csrc/<name>.cu`` as CUDA C++ templated over the working dtype
T (bf16, f16, f32), with one ``extern "C"`` launcher per instantiation
that takes raw device pointers, sizes and a ``cudaStream_t`` and returns
``cudaGetLastError()``. Each instantiation is a registered
:class:`Kernel` named ``<stage>_<suffix>`` (``decode_f16``,
``demosaic_f32``, ...); the front-fused stencil exists for bf16 only
(``front_fused_bf16``), the planar I420 conversion for u8 only
(``yuv420_planar``) and the metering's vectors for f32 metrics only
(``meter_vectors``), each registered with :func:`register`, as is each
instantiation of the CFA split, a template over its source type too
(``split_<source>_<suffix>``: ``split_u16_bf16``, ...). A source's
library, holding all its instantiations, is compiled with ``nvcc`` on
first use into ``_build/``
(keyed by a hash of the sources, the flags and ``nvcc --version``) and
loaded with ``ctypes``; nothing includes PyTorch's headers, so a kernel
builds in seconds and needs no ``ninja``. A source may take ``-D``
definitions from the module that registers it (``defines``), so that a
launch geometry the wrapper plans with has one home.

No fallback hides the device or the kernel: a failed build raises with
nvcc's stderr, a failed launch raises with the CUDA error, and a CUDA
device other than capability (9, 0) raises. The plain PyTorch twin of a
kernel runs only for CPU tensors (``backend="auto"``) or when asked for
by name (``backend="plain"``).

A kernel launches on the device of the tensors its wrapper was given,
with that device current (:meth:`Kernel.launch`), on its current stream.

Every wrapper adds to its kernel's ``launches`` count the kernels its
launcher call enqueues (one, or two for K4's table form), where it calls
the launcher and nowhere else, so a run can show that the main path went
through the kernels, and a device trace can be held to the count
(``launch_counts``/``reset_launches``).
The tracer (``utils/profiling.py``) times each C launcher call while it is
on (``isp.launch``, ``launch_ns``), and each library's first load in this
process (``isp.load``) and nvcc run (``builds``) always.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from taichi_image_tpu_torch.utils import profiling

__all__ = ["Kernel", "KERNELS", "DTYPE_SUFFIX", "register", "register_per_dtype",
           "nvcc_flags", "build_all", "launch_counts", "reset_launches",
           "use_kernel", "check_dtype", "check_tensor", "check_int32_extent",
           "check_frame_size", "enter_device", "leave_device", "stream_of",
           "ptr"]

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"

# --fmad=false: the plain twins round after every op, and an FMA
# contraction of e.g. the map's .299r + .587g + .114b or the CCM would
# break the kernel-vs-plain comparison. No --use_fast_math either.
# --split-compile=0 runs the device compiler's optimizer on every CPU core:
# the 24 stencil instantiations of demosaic.cu take about 3 minutes in one
# thread.
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "--fmad=false", "--split-compile=0", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")

BACKENDS = ("auto", "kernel", "plain")

# The working dtypes every kernel is instantiated for, and the suffix of
# their C launchers and registered names (csrc/common.cuh
# TIT_FOR_EACH_DTYPE).
DTYPE_SUFFIX = {torch.bfloat16: "bf16", torch.float16: "f16",
                torch.float32: "f32"}


def _nvcc() -> str:
  from torch.utils.cpp_extension import CUDA_HOME
  if CUDA_HOME is None:
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
  nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
  if not nvcc.exists():
    raise RuntimeError(f"nvcc not found at {nvcc}")
  return str(nvcc)


@functools.cache
def _nvcc_version(nvcc: str) -> str:
  return subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                        check=True).stdout


# {source: {macro: value}}: the ``-D`` definitions a source is built with
DEFINES: dict[str, dict[str, int]] = {}


def nvcc_flags(source: str) -> tuple[str, ...]:
  """The flags ``csrc/<source>`` is built with: NVCC_FLAGS and its
  DEFINES."""
  return NVCC_FLAGS + tuple(f"-D{name}={value}" for name, value
                            in sorted(DEFINES.get(source, {}).items()))


def _build(source: str) -> Path:
  """Compile ``csrc/<source>`` into a shared library (cached by key);
  returns its path. Raises ``RuntimeError`` with nvcc's stderr."""
  nvcc = _nvcc()
  src = CSRC / source
  flags = nvcc_flags(source)
  h = hashlib.sha256()
  for f in [src, *sorted(CSRC.glob("*.cuh"))]:
    h.update(f.name.encode() + b"\0" + f.read_bytes())
  h.update(" ".join(flags).encode())
  h.update(_nvcc_version(nvcc).encode())
  out = BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"
  if out.exists():
    return out
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
  profiling.count_build(source)
  proc = subprocess.run([nvcc, *flags, "-o", str(tmp), str(src)],
                        capture_output=True, text=True)
  if proc.returncode != 0:
    tmp.unlink(missing_ok=True)
    raise RuntimeError(f"nvcc failed to build {src.name} "
                       f"(exit {proc.returncode}):\n{proc.stderr}")
  out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
  os.replace(tmp, out)
  return out


# {source: its loaded library}
_LIBS: dict[str, ctypes.CDLL] = {}


def _library(source: str) -> ctypes.CDLL:
  """``csrc/<source>``'s library, built if its cache misses and loaded
  once a process (the ``isp.load`` span)."""
  lib = _LIBS.get(source)
  if lib is None:
    with profiling.load(source):
      lib = _LIBS[source] = ctypes.CDLL(str(_build(source)))
  return lib


class Kernel:
  """One hand-written kernel: its source, its C launcher and its launch
  count. ``replaces`` names the TPU kernel it ports (file:line)."""

  def __init__(self, name: str, source: str, symbol: str, argtypes,
               replaces: str):
    self.name = name
    self.source = source
    self.symbol = symbol
    self.argtypes = list(argtypes)
    self.replaces = replaces
    self.launches = 0
    self._fn = None

  def build(self) -> Path:
    return _build(self.source)

  def _launcher(self):
    if self._fn is None:
      fn = getattr(_library(self.source), self.symbol)
      fn.argtypes = self.argtypes
      fn.restype = ctypes.c_int
      self._fn = fn
    return self._fn

  def launch(self, device: torch.device, *args, kernels: int = 1) -> None:
    """Call the C launcher with ``args`` and the current stream of
    ``device`` (the device of the tensors it is given), with ``device``
    the current device: the CUDA runtime launches on the current device,
    and the launchers size their grids from it (``tit::resident_blocks``).
    Count the ``kernels`` the call enqueues; raise on a CUDA error."""
    fn = self._launcher()
    prev = enter_device(device)
    try:
      stream = stream_of(device)
      if profiling.ON:
        with profiling.launch(self.name):
          err = fn(*args, stream)
      else:
        err = fn(*args, stream)
    finally:
      leave_device(prev)
    if err != 0:
      raise RuntimeError(f"{self.name} kernel launch failed: cudaError_t "
                         f"{err}")
    self.launches += kernels


KERNELS: dict[str, Kernel] = {}


def register(name: str, source: str, symbol: str, argtypes,
             replaces: str) -> Kernel:
  """Register one :class:`Kernel` (a single instantiation, such as the
  bf16-only front-fused stencil)."""
  k = KERNELS[name] = Kernel(name, source, symbol, argtypes, replaces)
  return k


def register_per_dtype(stage: str, source: str, symbol: str, argtypes,
                       replaces: dict, defines: dict | None = None
                       ) -> dict[torch.dtype, Kernel]:
  """Register one :class:`Kernel` per working dtype: ``<stage>_<suffix>``
  launched through ``<symbol>_<suffix>``; ``replaces`` maps each dtype to
  the TPU kernel (or XLA route) it ports; ``source`` is built with
  ``-D<macro>=<value>`` for each of ``defines``. Returns {dtype: Kernel}."""
  if defines:
    DEFINES[source] = dict(defines)
  return {dtype: register(f"{stage}_{suffix}", source, f"{symbol}_{suffix}",
                          argtypes, replaces[dtype])
          for dtype, suffix in DTYPE_SUFFIX.items()}


def build_all() -> dict[str, Path]:
  """Build every kernel source's library, one nvcc process per source, all
  in parallel; returns {source: library path}."""
  _import_kernel_modules()
  sources = sorted({k.source for k in KERNELS.values()})
  with ThreadPoolExecutor(max_workers=len(sources)) as pool:
    return dict(zip(sources, pool.map(_build, sources)))


def _import_kernel_modules():
  from taichi_image_tpu_torch.ops.hopper import (  # noqa: F401
      decode, demosaic, finish, front_fused, meter, reinhard, resize, yuv420)


def launch_counts() -> dict[str, int]:
  _import_kernel_modules()
  return {name: k.launches for name, k in KERNELS.items()}


def reset_launches() -> None:
  _import_kernel_modules()
  for k in KERNELS.values():
    k.launches = 0


@functools.cache
def _capability(device: torch.device) -> tuple[int, int]:
  return torch.cuda.get_device_capability(device)


def use_kernel(backend: str, x: torch.Tensor) -> bool:
  """Pick the route for tensor ``x``: the kernel for a CUDA tensor (on
  any device; it launches there) under ``backend="auto"``, the plain twin
  for a CPU tensor. ``"kernel"`` on a CPU tensor raises; ``"plain"``
  always takes the twin."""
  if backend not in BACKENDS:
    raise ValueError(f"unknown backend {backend!r}; expected one of "
                     f"{BACKENDS}")
  if backend == "plain":
    return False
  if not x.is_cuda:
    if backend == "kernel":
      raise ValueError(
          f"backend='kernel' needs CUDA tensors, got a tensor on {x.device}")
    return False
  major_minor = _capability(x.device)
  if major_minor != (9, 0):
    raise RuntimeError(
        f"the Hopper kernels are built for sm_90a; {x.device} has "
        f"capability {major_minor}")
  return True


def check_dtype(name: str, dtype: torch.dtype) -> None:
  """A wrapper's dtype guard on both routes: the kernels are instantiated
  for bf16, f16 and f32 only."""
  if dtype not in DTYPE_SUFFIX:
    raise ValueError(f"{name} must be bfloat16, float16 or float32 (the "
                     f"kernels' instantiations), got {dtype}")


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 ndim: int, device: torch.device) -> None:
  """A wrapper's input guard: device, dtype, rank and contiguity."""
  if t.device != device:
    raise ValueError(f"{name} is on {t.device}, expected {device}")
  if t.dtype != dtype:
    raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
  if t.ndim != ndim:
    raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
  if not t.is_contiguous():
    raise ValueError(f"{name} must be contiguous")


def check_int32_extent(what: str, count: int) -> None:
  """The kernels index within one image in 32 bits: the ``count`` values
  (or bytes) that ``what`` names, per image, must be fewer than 2**31."""
  if count >= 2 ** 31:
    raise ValueError(f"{what} is too large for the kernels' 32-bit "
                     f"indexing ({count} >= 2**31 per image)")


def check_frame_size(hh: int, wh: int) -> None:
  """The 12 half-res planes of an image must hold fewer than 2**31 values
  (csrc/common.cuh image_fits_int32)."""
  check_int32_extent(f"a {hh}x{wh} half-res frame's 12 planes", 12 * hh * wh)


# A launch's device switch and stream, as ``torch.cuda.device(device)``
# and ``torch.cuda.current_stream(device).cuda_stream`` give them, without
# their argument parsing and Stream objects: a few microseconds a launch
# that the host pays on every kernel of a step.

def _index(device: torch.device) -> int:
  return torch.cuda.current_device() if device.index is None else device.index


def enter_device(device: torch.device) -> int:
  """Make the CUDA ``device`` current, as ``torch.cuda.device`` enters;
  returns the device that was current, for :func:`leave_device`."""
  return torch._C._cuda_exchangeDevice(_index(device))


def leave_device(prev: int) -> None:
  """Make ``prev`` (from :func:`enter_device`) current again, as
  ``torch.cuda.device`` leaves."""
  torch._C._cuda_maybeExchangeDevice(prev)


def stream_of(device: torch.device) -> int:
  """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``."""
  return torch._C._cuda_getCurrentRawStream(_index(device))


def ptr(t: torch.Tensor) -> int:
  """``t``'s device address, for a launcher's ``c_void_p`` argument (the
  launchers' ``argtypes`` convert it, so no ctypes object is made a
  pointer)."""
  return t.data_ptr()
