"""Device runtime: discovery, meshes over ``torch.distributed``, a
serialized dispatch queue for host-threaded camera drivers, and a helper
that runs a function on ``n`` ranks, one process each.

Counterpart of ``taichi_image_tpu/parallel/runtime.py``. A JAX mesh is a
grid of devices driven by one process; here each device is driven by its
own process (a rank of a ``torch.distributed`` process group), and a mesh
is a :class:`torch.distributed.device_mesh.DeviceMesh` over the ranks:
named dims, and ``mesh.get_group(name)`` for the collectives along one.

The dispatch queue is the JAX package's, unchanged: one place that owns
device set-up and serializes submission (reference ``taichi_queue.py``).
torch's current device is per thread, so a rig's initializer may call
``torch.cuda.set_device`` on the queue's worker.
"""

from __future__ import annotations

import os
import queue as queue_mod
import tempfile
import threading
import time
import traceback
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import torch
import torch.distributed as dist

__all__ = [
    "devices", "device_count", "make_camera_mesh", "mesh_device",
    "mesh_group", "CAMERA_AXIS", "NullExecutor", "DispatchQueue",
    "dispatch_queue", "queued", "run_ranks",
]

CAMERA_AXIS = "cam"


def devices(backend: Optional[str] = None) -> list[torch.device]:
  """The devices of ``backend``: the CUDA devices visible to this process
  (``None`` or ``"cuda"``), or the one CPU device (``"cpu"``)."""
  if backend == "cpu":
    return [torch.device("cpu")]
  if backend not in (None, "cuda", "gpu"):
    raise ValueError(f"unknown backend {backend!r}")
  return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def device_count(backend: Optional[str] = None) -> int:
  return len(devices(backend))


def make_camera_mesh(n_devices: Optional[int] = None,
                     axis_name: str = CAMERA_AXIS,
                     device_type: Optional[str] = None):
  """1-D mesh over the camera/batch axis: the first ``n_devices`` ranks
  of the initialized default process group (all of them by default),
  each driving one device of ``device_type`` ("cuda" unless the caller
  asks for "cpu"; raises when no CUDA device is visible). Every rank of
  the group must call it; a rank outside the mesh gets a mesh in which it
  has no coordinate."""
  from torch.distributed.device_mesh import DeviceMesh
  if not dist.is_initialized():
    raise RuntimeError("make_camera_mesh needs an initialized default "
                       "process group (torch.distributed.init_process_group)")
  world = dist.get_world_size()
  n = world if n_devices is None else int(n_devices)
  if not 1 <= n <= world:
    raise ValueError(f"n_devices={n_devices} must be in [1, {world}] (the "
                     "process group's ranks)")
  device_type = device_type or "cuda"
  if device_type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("make_camera_mesh: no CUDA device is visible; pass "
                       "device_type='cpu' to build a CPU mesh")
  return DeviceMesh(device_type, torch.arange(n),
                    mesh_dim_names=(axis_name,))


def mesh_device(mesh) -> torch.device:
  """This rank's device in ``mesh``: the CPU, or its current CUDA
  device."""
  if mesh.device_type == "cpu":
    return torch.device("cpu")
  return torch.device(mesh.device_type, torch.cuda.current_device())


def mesh_group(mesh):
  """The process group of every rank of ``mesh``: its one dim's group, or
  the default group for a mesh of more dims, which must then hold every
  rank."""
  if mesh.ndim == 1:
    return mesh.get_group(0)
  if mesh.mesh.numel() != dist.get_world_size():
    raise ValueError(f"a {mesh.ndim}-D mesh must hold every rank of the "
                     f"process group ({dist.get_world_size()}), got "
                     f"{tuple(mesh.shape)}")
  return dist.group.WORLD


class NullExecutor:
  """Inline (non-threaded) executor (reference taichi_queue.py:9-20)."""

  def __init__(self, initializer=None, **kwargs):
    if initializer is not None:
      initializer()
    self._threads = []

  def submit(self, fn, *args, **kwargs):
    future = Future()
    future.set_result(fn(*args, **kwargs))
    return future

  def shutdown(self, wait=True):
    pass


class DispatchQueue:
  """Process-wide serialized dispatcher (reference taichi_queue.py:40-85).

  ``init(threaded=True)`` starts a single worker thread that owns the
  initializer (e.g. device selection or warm-up); ``run_sync`` and
  ``run_async`` submit callables to it from any host thread. Futures
  passed as arguments are resolved before the call (taichi_queue.py:66-68).
  """

  executor = None
  _worker_ident = None  # set by the worker thread itself at init

  @classmethod
  def init(cls, initializer=None, *, threaded: bool = False):
    if cls.executor is not None:
      raise RuntimeError("DispatchQueue already initialized")
    init_fn = initializer if initializer is not None else (lambda: None)

    def _record_and_init():
      cls._worker_ident = threading.get_ident()
      init_fn()

    if threaded:
      cls.executor = ThreadPoolExecutor(
          max_workers=1, thread_name_prefix="isp-dispatch",
          initializer=_record_and_init)
    else:
      cls._worker_ident = None  # inline mode: no dedicated worker
      cls.executor = NullExecutor(initializer=init_fn)
    return cls.executor

  @staticmethod
  def thread_id():
    DispatchQueue.queue()  # raises if not initialized
    return DispatchQueue._worker_ident

  @classmethod
  def queue(cls):
    if cls.executor is None:
      raise RuntimeError(
          "DispatchQueue not initialized (run DispatchQueue.init())")
    return cls.executor

  @staticmethod
  def _await_run(func, *args, **kwargs):
    args = [a.result() if isinstance(a, Future) else a for a in args]
    return func(*args, **kwargs)

  @staticmethod
  def run_async(func, *args, **kwargs) -> Future:
    return DispatchQueue.queue().submit(DispatchQueue._await_run, func,
                                        *args, **kwargs)

  @staticmethod
  def run_sync(func, *args, **kwargs):
    ident = DispatchQueue.thread_id()
    if ident is not None and threading.get_ident() == ident:
      raise RuntimeError(
          "DispatchQueue.run_sync() called from worker thread (deadlock)")
    return DispatchQueue.run_async(func, *args, **kwargs).result()

  @classmethod
  def stop(cls):
    executor = cls.executor
    if executor is not None:
      executor.shutdown(wait=True)
      cls.executor = None
      cls._worker_ident = None


class _DispatchQueueContext:
  def __init__(self, *args, **kwargs):
    self.args = args
    self.kwargs = kwargs

  def __enter__(self):
    return DispatchQueue.init(*self.args, **self.kwargs)

  def __exit__(self, exc_type, exc_value, traceback):
    DispatchQueue.stop()


def dispatch_queue(*args, **kwargs):
  """Context manager (reference taichi_queue.py:23-36)."""
  return _DispatchQueueContext(*args, **kwargs)


def queued(fn):
  """Wrap a callable so any host thread runs it through the queue
  (reference taichi_queue.py:88-91)."""
  def f(*args, **kwargs):
    return DispatchQueue.run_sync(fn, *args, **kwargs)
  return f


def _rank_main(fn, rank, n, init_method, backend, device, args, results):
  """One rank's process: join the group, run ``fn(*args)``, hand back
  ``(rank, ok, result or traceback)``, leave the group."""
  torch.set_num_threads(1)
  try:
    if device.startswith("cuda"):
      torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=n, rank=rank)
    try:
      results.put((rank, True, fn(*args)))
    finally:
      dist.destroy_process_group()
  except BaseException:
    results.put((rank, False, traceback.format_exc()))
    raise


def run_ranks(fn, n: int, *args, device: str = "cpu", backend: str = "gloo",
              timeout: float = 600.0) -> list:
  """Run ``fn(*args)`` on ``n`` ranks, one spawned process each, joined in
  one ``backend`` process group (file:// rendezvous in a temporary
  directory) with ``device`` current (``"cpu"``, or a CUDA device that
  every rank shares, e.g. ``"cuda:0"``); returns each rank's result, in
  rank order. ``fn`` and its results must pickle, and ``fn`` must live in
  a module the children can import. Raises ``RuntimeError`` with the
  tracebacks if any rank fails or none answers within ``timeout``
  seconds; every child is stopped before it returns."""
  import multiprocessing as mp
  ctx = mp.get_context("spawn")
  results = ctx.Queue()
  with tempfile.TemporaryDirectory(prefix="tit-ranks-") as tmp:
    init = "file://" + os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, n, init, backend, device, args,
                               results), daemon=True)
             for r in range(n)]
    for p in procs:
      p.start()
    got, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
      while len(got) < n:
        try:
          rank, ok, value = results.get(timeout=1.0)
        except queue_mod.Empty:
          # a rank that died before it could answer (e.g. in start-up)
          dead = {r: p.exitcode for r, p in enumerate(procs)
                  if r not in got and p.exitcode not in (None, 0)}
          if dead:
            errors.append(f"rank(s) exited without a result: {dead}")
            break
          if time.monotonic() > deadline:
            errors.append(f"no answer from {n - len(got)} rank(s) within "
                          f"{timeout} s")
            break
          continue
        if not ok:
          errors.append(f"rank {rank}:\n{value}")
          break
        got[rank] = value
    finally:
      for p in procs:
        p.join(timeout=5 if errors else timeout)
        if p.is_alive():
          p.kill()
          p.join()
  if errors:
    raise RuntimeError("run_ranks failed:\n" + "\n".join(errors))
  return [got[r] for r in range(n)]
