"""The host/device staging of the port (``types.HostRing``, ``Uploader``,
``Downloader``) and ``process_stream`` against the JAX package's, on the
CPU.

Contracts:
  * the ring's bookkeeping, driven with a stand-in allocator, events and
    copy (pinned memory and CUDA events need the card): buffers are used
    in ring order; a buffer is refilled only after its own copy's event,
    and only that event is waited on; a set of another shape or dtype
    replaces the buffers after every copy in flight; each set is copied
    once into its buffer, whatever its layout (read-only, non-contiguous,
    a list of frames, a CPU tensor); uint16 moves as its int16 bits and
    float64 arrays as float32.
  * ``process_stream``, all three classes, planar RGB, HWC and I420, at
    ``prefetch`` 0, 1 and 3, on a stream that mixes numpy sets (read-only
    and non-contiguous too) and tensors and changes shape midway: each
    output bitwise ``process`` of the same set on a fresh ISP, and within
    the JAX package's ``process_stream`` by test_torch_resize's
    ``compare_step``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import taichi_image_tpu as jtit  # noqa: E402
import taichi_image_tpu_torch as ttit  # noqa: E402
from taichi_image_tpu_torch import types as ttypes  # noqa: E402
from test_torch_resize import CLASSES, compare_step  # noqa: E402


# --------------------------------------------------------------------------
# The ring's bookkeeping.
# --------------------------------------------------------------------------

class Event:
  """A stand-in for a CUDA event: ``synchronize`` writes its name to the
  shared log."""

  def __init__(self, name, log):
    self.name, self.log = name, log

  def synchronize(self):
    self.log.append(("wait", self.name))


class Rig:
  """A ring with a stand-in allocator (plain CPU tensors) and a stand-in
  copy (a clone, and an event named after the set it copies), logging
  every allocation and wait in order."""

  def __init__(self, n):
    self.log, self.sent = [], []
    self.ring = ttypes.HostRing(n, alloc=self.alloc)

  def alloc(self, shape, dtype):
    self.log.append(("alloc", tuple(shape), dtype))
    return torch.empty(shape, dtype=dtype)

  def send(self, buf):
    name = len(self.sent)
    self.sent.append(buf)
    return buf.clone(), Event(name, self.log)

  def stage(self, x):
    return self.ring.stage(x, self.send)

  def waits(self):
    got = [e[1] for e in self.log if e[0] == "wait"]
    self.log.clear()
    return got


def _set(seed, shape=(2, 4, 6), dtype=np.uint8):
  return np.random.default_rng(seed).integers(0, 200, size=shape).astype(
      dtype)


def test_ring_reuses_its_buffers_in_order():
  rig = Rig(3)
  for s in range(7):
    x = _set(s)
    got = rig.stage(x)
    assert torch.equal(got, torch.from_numpy(x))
  assert [e for e in rig.log if e[0] == "alloc"] == [
      ("alloc", (2, 4, 6), torch.uint8)] * 3
  ids = [b.data_ptr() for b in rig.sent]
  assert len(set(ids[:3])) == 3
  assert ids[3:] == ids[:3] + ids[:1]


def test_ring_waits_only_on_the_slots_own_event():
  rig = Rig(3)
  for s in range(3):
    rig.stage(_set(s))
  assert rig.waits() == []  # three fresh buffers: nothing to wait for
  for s in range(3, 8):
    rig.stage(_set(s))
    # set s reuses set s - 3's buffer and waits on that copy's event alone
    assert rig.waits() == [s - 3]


@pytest.mark.parametrize("change", ["shape", "dtype"])
def test_ring_replaced_after_every_copy_in_flight(change):
  rig = Rig(3)
  rig.stage(_set(0))
  rig.stage(_set(1))
  assert rig.waits() == []
  new = _set(2, shape=(2, 4, 8)) if change == "shape" else _set(
      2, dtype=np.float32)
  got = rig.stage(new)
  assert torch.equal(got, torch.from_numpy(new))
  # both copies in flight are waited on before the new buffers exist
  assert rig.log[:2] == [("wait", 0), ("wait", 1)]
  assert rig.log[2:] == [("alloc", new.shape, got.dtype)] * 3
  rig.log.clear()
  # the new ring starts at its first buffer, with nothing in flight
  assert rig.sent[-1].data_ptr() != rig.sent[0].data_ptr()
  rig.stage(_set(3, shape=new.shape, dtype=new.dtype))
  rig.stage(_set(4, shape=new.shape, dtype=new.dtype))
  assert rig.waits() == []
  rig.stage(_set(5, shape=new.shape, dtype=new.dtype))
  assert rig.waits() == [2]


def test_ring_drain_waits_for_every_copy():
  rig = Rig(2)
  rig.ring.drain()
  assert rig.waits() == []
  rig.stage(_set(0))
  rig.stage(_set(1))
  rig.ring.drain()
  assert rig.waits() == [0, 1]


def _layouts():
  base = _set(7, shape=(2, 8, 12))
  ro = base.copy()
  ro.setflags(write=False)
  return {
      "writable": base,
      "read-only": ro,
      "non-contiguous": base[:, ::2, 1::2],
      "transposed": np.swapaxes(base, 1, 2),
      "Fortran order": np.asfortranarray(base),
      "list of frames": [base[0], base[1]],
      "tuple of read-only frames": tuple(ro),
      "tensor": torch.from_numpy(base),
      "non-contiguous tensor": torch.from_numpy(base).transpose(1, 2),
  }


@pytest.mark.parametrize("name", list(_layouts()))
def test_ring_copies_any_layout_once(name):
  x = _layouts()[name]
  want = torch.from_numpy(np.stack(x) if isinstance(x, (list, tuple))
                          else np.array(x))
  rig = Rig(2)
  got = rig.stage(x)
  assert got.dtype == torch.uint8 and torch.equal(got, want)
  assert rig.sent[0].is_contiguous()
  assert tuple(rig.sent[0].shape) == tuple(want.shape)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_ring_moves_uint16_as_int16(as_tensor):
  x = np.random.default_rng(3).integers(0, 65536, size=(2, 4, 6),
                                        dtype=np.uint16)
  x[0, 0, 0] = 65535  # negative as int16
  rig = Rig(2)
  got = rig.stage(torch.from_numpy(x) if as_tensor else x)
  assert rig.sent[0].dtype == torch.int16
  assert rig.log[0] == ("alloc", (2, 4, 6), torch.int16)
  assert got.dtype == torch.uint16
  np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                x)


def test_ring_takes_float64_as_float32():
  x = np.random.default_rng(4).random((2, 4, 6))
  rig = Rig(2)
  got = rig.stage(x)
  assert rig.sent[0].dtype == got.dtype == torch.float32
  np.testing.assert_array_equal(got.numpy(), x.astype(np.float32))


def test_ring_needs_a_buffer():
  with pytest.raises(ValueError, match="at least one buffer"):
    ttypes.HostRing(0)


def test_uploader_and_downloader_on_the_cpu():
  """On the CPU nothing is staged: a set is stacked into a plain tensor,
  a tensor is taken as it is, and the outputs are the host tensors."""
  up = ttypes.Uploader("cpu", 2)
  frames = [_set(0)[0], _set(1)[0]]
  assert torch.equal(up(frames), torch.from_numpy(np.stack(frames)))
  t = torch.from_numpy(_set(2))
  assert up(t) is t
  ro = _set(3)
  ro.setflags(write=False)
  assert torch.equal(up(ro), torch.from_numpy(ro.copy()))
  hosts, copied = ttypes.Downloader("cpu").start((t,))
  assert hosts == [t] and copied is None


# --------------------------------------------------------------------------
# process_stream against the JAX package.
# --------------------------------------------------------------------------

N_CAM = 2
SHAPES = [(32, 192), (24, 144)]  # (H, W bytes): W = 128, then 96


def _stream_sets():
  """Six sets: a writable, a read-only and a non-contiguous numpy set and
  a tensor at the first shape, then a numpy set and a tensor at the
  second; returns (the port's inputs, the same sets as numpy)."""
  rng = np.random.default_rng(21)
  sets = [rng.integers(0, 256, size=(N_CAM, *SHAPES[0 if i < 4 else 1]),
                       dtype=np.uint8) for i in range(6)]
  ro = sets[1].copy()
  ro.setflags(write=False)
  wide = np.zeros((N_CAM, SHAPES[0][0], 2 * SHAPES[0][1]), np.uint8)
  wide[:, :, ::2] = sets[2]
  port = [sets[0], ro, wide[:, :, ::2], torch.from_numpy(sets[3]),
          sets[4], torch.from_numpy(sets[5])]
  return port, sets


LAYOUTS = {"planar": {}, "hwc": {"layout": "hwc"},
           "I420": {"color_format": "yuv420"}}


def _outputs(o):
  return o if isinstance(o, tuple) else (o,)


@pytest.mark.parametrize("prefetch", [0, 1, 3])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("cls", CLASSES)
def test_process_stream_matches_process_and_jax(cls, layout, prefetch):
  jcls, tcls = CLASSES[cls]
  kw = dict(gamma=0.8, intensity=1.2, **LAYOUTS[layout])
  port, sets = _stream_sets()
  jisp = jcls(jtit.BayerPattern.GRBG, moving_alpha=0.3)
  tisp = tcls(ttit.BayerPattern.GRBG, moving_alpha=0.3, device="cpu")
  ref = tcls(ttit.BayerPattern.GRBG, moving_alpha=0.3, device="cpu")
  outs = list(tisp.process_stream(iter(port), prefetch=prefetch, **kw))
  jouts = list(jisp.process_stream(iter(sets), prefetch=prefetch, **kw))
  assert len(outs) == len(jouts) == len(sets)
  for f, (o, jo, raws) in enumerate(zip(outs, jouts, sets)):
    want = ref.process(raws, **kw)
    if layout == "hwc":
      assert isinstance(o, np.ndarray) and o.shape[-1] == 3
      np.testing.assert_array_equal(o, want)
      o, jo = np.moveaxis(o, -1, 1), np.moveaxis(np.asarray(jo), -1, 1)
      o = torch.from_numpy(np.ascontiguousarray(o))
    else:
      for a, b in zip(_outputs(o), _outputs(want)):
        assert torch.equal(a, b), f"set {f}: not bitwise process"
    if f == len(sets) - 1:
      assert torch.equal(tisp.metrics, ref.metrics)
    # the JAX stream within the port's contract (the metrics of the last
    # set, checked again each frame)
    for a, b in zip(_outputs(o), _outputs(jo)):
      compare_step(tisp.metrics, a, jisp.metrics, b, tcls._work_dtype)
