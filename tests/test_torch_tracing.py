"""The port's tracer (``utils/profiling.py``) on the CPU: off by default and
free of spans, clocks and ``record_function`` while off; while on, one
``isp.process`` span a set with the set's id, the stages of the route taken
in order inside it, each kernel launch inside its stage, self times less
what children cover, the spans in ``trace(log_dir)``'s Chrome file, and the
launch, tone-form, I420-path and build counters, the load spans, and the
set markers on a fake card. The kernels' launchers and nvcc are stubbed, as
in test_torch_meter.py."""

import itertools
import json
import os
import subprocess
import sys
import tempfile
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import taichi_image_tpu_torch as ttit  # noqa: E402
from taichi_image_tpu_torch.ops import hopper  # noqa: E402
from taichi_image_tpu_torch.ops.hopper import meter as th_meter  # noqa: E402
from taichi_image_tpu_torch.ops.interpolate import ImageTransform  # noqa: E402
from taichi_image_tpu_torch.utils import profiling  # noqa: E402

H, W = 16, 24   # a frame's pixels: packed12 rows of 36 bytes
NO_MARKERS = dict.fromkeys(profiling.MARKERS, 0)

# the stages of each route, in order
PHASE = ["isp.decode", "isp.demosaic", "isp.meter", "isp.reinhard",
         "isp.finish"]
ROUTES = {
    "phase": (dict(), dict(), PHASE),
    "linear": (dict(), dict(tonemap="linear"),
               ["isp.decode", "isp.demosaic", "isp.meter", "isp.finish"]),
    "resize": (dict(resize_width=12), dict(),
               ["isp.decode", "isp.demosaic", "isp.resize", "isp.meter",
                "isp.reinhard", "isp.finish"]),
    "odd stride i420": (dict(metering_stride=3), dict(color_format="yuv420"),
                        PHASE),
    "rotate_90": (dict(transform=ImageTransform.rotate_90), dict(), PHASE),
}


@pytest.fixture(autouse=True)
def _clean():
  profiling.reset()
  yield
  profiling.disable()
  profiling.reset()


def _raws(n=2, seed=0):
  rng = np.random.default_rng(seed)
  return rng.integers(0, 256, (n, H, W * 3 // 2), dtype=np.uint8)


def _profiled(fn):
  """Run ``fn`` in a torch.profiler session; return the session's
  ``isp.*`` events as (name, tag, set id, start, end), by start."""
  from torch.profiler import ProfilerActivity, profile
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    fn()
  with tempfile.TemporaryDirectory() as tmp:
    path = f"{tmp}/trace.json"
    prof.export_chrome_trace(path)
    with open(path) as f:
      events = json.load(f)["traceEvents"]
  out = []
  for e in events:
    if e.get("cat") != "user_annotation" or not e["name"].startswith("isp."):
      continue
    words = e["name"].split(" ")
    sets = [int(w[4:]) for w in words if w.startswith("set=")]
    tag = [w for w in words[1:] if not w.startswith("set=")]
    out.append((words[0], tag[0] if tag else None,
                sets[0] if sets else None, e["ts"], e["ts"] + e["dur"]))
  return sorted(out, key=lambda ev: ev[3])


def _inside(inner, outer) -> bool:
  return outer[3] <= inner[3] and inner[4] <= outer[4]


def test_off_by_default_and_records_nothing(monkeypatch):
  assert profiling.ON is False
  opened, clock = [], []
  monkeypatch.setattr(profiling, "record_function",
                      lambda *a: opened.append(a))
  real = profiling.perf_counter_ns
  monkeypatch.setattr(profiling, "perf_counter_ns",
                      lambda: clock.append(1) or real())
  # one shared object, no span made
  assert profiling.span("isp.process", itertools.count()) is \
      profiling.span("isp.decode") is profiling.stages()
  isp = ttit.CameraBF16(ttit.BayerPattern.RGGB, device="cpu")
  # even inside a profiler session nothing is opened while tracing is off
  events = _profiled(lambda: [isp.process(_raws()) for _ in range(2)])
  assert events == [] and opened == [] and clock == []
  assert profiling.snapshot() == {"spans": {}, "launch_ns": {},
                                  "tone_forms": {}, "finish_layouts": {},
                                  "resize_paths": {}, "i420_paths": {},
                                  "builds": {}, "markers": NO_MARKERS}


@pytest.mark.parametrize("route", ROUTES)
def test_each_set_holds_its_stages_in_route_order(route):
  cls_kw, call_kw, stages = ROUTES[route]
  isp = ttit.CameraBF16(ttit.BayerPattern.RGGB, device="cpu", **cls_kw)
  n = 3
  with profiling.tracing():
    events = _profiled(lambda: [isp.process(_raws(seed=i), **call_kw)
                                for i in range(n)])
  assert profiling.ON is False   # as it was before the block
  sets = [e for e in events if e[0] == "isp.process"]
  assert [e[2] for e in sets] == list(range(n))
  for p in sets:
    inside = [e for e in events if e[0] != "isp.process" and _inside(e, p)]
    assert [e[0] for e in inside] == stages
    assert all(e[2] == p[2] for e in inside)
  snap = profiling.snapshot()["spans"]
  assert snap["isp.process"]["calls"] == n
  assert {name: s["calls"] for name, s in snap.items()} == {
      "isp.process": n, **{s: n for s in stages}}
  assert set(snap) <= set(profiling.SPANS)


def test_process_large_opens_a_set_of_the_same_count():
  isp = ttit.Camera32(ttit.BayerPattern.RGGB, device="cpu")
  with profiling.tracing():
    events = _profiled(lambda: (isp.process(_raws()),
                                isp.process_large(_raws(), driver="auto")))
  sets = [e for e in events if e[0] == "isp.process"]
  assert [e[2] for e in sets] == [0, 1]
  assert [e[0] for e in events if e[2] == 1 and e[0] != "isp.process"] == \
      PHASE


def test_set_ids_are_per_instance():
  a = ttit.Camera16(ttit.BayerPattern.RGGB, device="cpu")
  b = ttit.Camera16(ttit.BayerPattern.RGGB, device="cpu")
  with profiling.tracing():
    events = _profiled(lambda: (a.process(_raws()), a.process(_raws()),
                                b.process(_raws())))
  assert [e[2] for e in events if e[0] == "isp.process"] == [0, 1, 0]


def _fake_clock(monkeypatch, ticks):
  it = iter(ticks)
  monkeypatch.setattr(profiling, "perf_counter_ns", lambda: next(it))


def test_self_time_is_the_duration_less_the_children(monkeypatch):
  # outer 0..100 holds a 10..30 (itself holding b 12..20) and c 40..45
  _fake_clock(monkeypatch, [0, 10, 12, 20, 30, 40, 45, 100])
  span = profiling.span
  with profiling.tracing():
    with span("outer", itertools.count(7)):
      with span("a"):
        with span("b"):
          pass
      with span("c"):
        pass
  snap = profiling.snapshot()["spans"]
  assert snap["outer"] == {"calls": 1, "ns": 100, "self_ns": 100 - 20 - 5}
  assert snap["a"] == {"calls": 1, "ns": 20, "self_ns": 20 - 8}
  assert snap["b"] == {"calls": 1, "ns": 8, "self_ns": 8}
  assert snap["c"] == {"calls": 1, "ns": 5, "self_ns": 5}


def test_a_failing_child_still_closes(monkeypatch):
  _fake_clock(monkeypatch, [0, 5, 15, 40])
  with profiling.tracing():
    with profiling.span("outer"):
      with pytest.raises(KeyError):
        with profiling.span("inner"):
          raise KeyError("stage failed")
  snap = profiling.snapshot()["spans"]
  assert snap["inner"]["ns"] == 10 and snap["outer"]["self_ns"] == 30
  assert profiling._local.stack == []


def test_annotate_and_spans_reach_the_trace_file(tmp_path):
  isp = ttit.CameraBF16(ttit.BayerPattern.RGGB, device="cpu")
  with profiling.trace(str(tmp_path)):
    assert profiling.ON
    with profiling.annotate("isp step"):
      isp.process(_raws())
      isp.process(_raws())
  assert profiling.ON is False
  files = list(tmp_path.glob("*.pt.trace.json"))
  assert len(files) == 1
  names = {e.get("name") for e in
           json.loads(files[0].read_text())["traceEvents"]}
  assert "isp step" in names
  for i in (0, 1):
    assert {f"{s} set={i}" for s in ["isp.process", *PHASE]} <= names


def test_annotate_is_a_span_of_the_tracer():
  with profiling.annotate("region"):
    pass
  assert profiling.snapshot()["spans"] == {}
  with profiling.tracing():
    with profiling.annotate("region"):
      pass
  assert profiling.snapshot()["spans"]["region"]["calls"] == 1


def test_threads_lose_no_update():
  """Spans on more threads than cores, switching often: every call and
  every counted ns arrives, and each thread's nesting stays its own."""
  n_threads, n = 4 * (os.cpu_count() or 1), 4000
  interval = sys.getswitchinterval()
  sys.setswitchinterval(1e-6)
  try:
    with profiling.tracing():
      def work(i):
        for _ in range(n):
          with profiling.span("isp.process", itertools.count(i)):
            with profiling.launch(f"k{i % 3}"):
              pass
      with ThreadPoolExecutor(n_threads) as pool:
        for f in [pool.submit(work, i) for i in range(n_threads)]:
          f.result(timeout=60)
  finally:
    sys.setswitchinterval(interval)
  snap = profiling.snapshot()
  assert snap["spans"]["isp.process"]["calls"] == n_threads * n
  launch = snap["spans"]["isp.launch"]
  assert launch["calls"] == n_threads * n
  assert sum(snap["launch_ns"].values()) == launch["ns"] == launch["self_ns"]
  process = snap["spans"]["isp.process"]
  assert process["ns"] - process["self_ns"] == launch["ns"]


def test_no_span_name_is_one_of_the_benchmarks():
  # the benchmark's own host spans and its slice (isp_bench/trace.py)
  assert all(name.startswith("isp.") for name in profiling.SPANS)
  assert not set(profiling.SPANS) & {"process", "sync", "slice"}


# -- the kernels' launches and loads, with stubbed launchers and nvcc --------

@pytest.fixture
def stub_launch(monkeypatch):
  """Kernel.launch on the CPU: no device to enter, stream 0."""
  monkeypatch.setattr(hopper, "enter_device", lambda device: None)
  monkeypatch.setattr(hopper, "leave_device", lambda prev: None)
  monkeypatch.setattr(hopper, "stream_of", lambda device: 0)


def _stub_nvcc(monkeypatch, tmp_path):
  """nvcc that writes an empty library; returns the list of its runs."""
  runs = []

  def run(cmd, **kwargs):
    runs.append(cmd)
    open(cmd[cmd.index("-o") + 1], "wb").close()
    return subprocess.CompletedProcess(cmd, 0, "", "")
  monkeypatch.setattr(hopper, "_nvcc", lambda: "nvcc")
  monkeypatch.setattr(hopper, "_nvcc_version", lambda nvcc: "V")
  monkeypatch.setattr(hopper, "BUILD_DIR", tmp_path)
  monkeypatch.setattr(hopper.subprocess, "run", run)
  return runs


class _Lib:
  """A loaded library whose every symbol returns ``err``."""

  def __init__(self, path, err=0):
    self.path = path
    self.err = err

  def __getattr__(self, symbol):
    def fn(*args):
      return self.err
    return fn


def test_a_build_a_cache_hit_and_the_loads_are_counted(monkeypatch, tmp_path,
                                                       stub_launch):
  runs = _stub_nvcc(monkeypatch, tmp_path)
  monkeypatch.setattr(hopper, "_LIBS", {})
  monkeypatch.setattr(hopper.ctypes, "CDLL", _Lib)
  k = hopper.Kernel("decode_t", "decode.cu", "tit_t", [], "none")
  k.launch(torch.device("cpu"), 1, 2)   # tracing off: the load still counts
  snap = profiling.snapshot()
  assert len(runs) == 1 and snap["builds"] == {"decode.cu": 1}
  load = snap["spans"]["isp.load"]
  assert load["ns"] > 0
  assert snap["spans"] == {"isp.load": {
      "calls": 1, "ns": load["ns"], "self_ns": load["ns"]}}
  assert snap["launch_ns"] == {} and k.launches == 1
  # a sibling kernel of the source loads nothing more
  hopper.Kernel("decode_u", "decode.cu", "tit_u", [], "none").launch(
      torch.device("cpu"))
  assert profiling.snapshot()["spans"]["isp.load"]["calls"] == 1
  # a new process: the cache hits, nvcc does not run, the load counts
  monkeypatch.setattr(hopper, "_LIBS", {})
  first = profiling.snapshot()["spans"]["isp.load"]["ns"]
  hopper.Kernel("decode_v", "decode.cu", "tit_v", [], "none").launch(
      torch.device("cpu"))
  snap = profiling.snapshot()
  assert len(runs) == 1 and snap["builds"] == {"decode.cu": 1}
  assert snap["spans"]["isp.load"]["calls"] == 2
  assert snap["spans"]["isp.load"]["ns"] > first


def test_launch_ns_counts_each_launch_while_on(monkeypatch, stub_launch):
  _fake_clock(monkeypatch, [0, 7, 100, 103])
  k = hopper.Kernel("demosaic_t", "demosaic.cu", "tit_t", [], "none")
  calls = []
  k._fn = lambda *args: calls.append(args) or 0
  k.launch(torch.device("cpu"), 5)        # off: no clock read
  with profiling.tracing():
    k.launch(torch.device("cpu"), 6)
    k.launch(torch.device("cpu"), 7)
  assert calls == [(5, 0), (6, 0), (7, 0)] and k.launches == 3
  snap = profiling.snapshot()
  assert snap["launch_ns"] == {"demosaic_t": 7 + 3}
  assert snap["spans"]["isp.launch"] == {"calls": 2, "ns": 10, "self_ns": 10}


def test_a_failed_launch_still_raises(stub_launch):
  k = hopper.Kernel("finish_t", "finish.cu", "tit_t", [], "none")
  k._fn = lambda *args: 700
  with profiling.tracing():
    with pytest.raises(RuntimeError, match="cudaError_t 700"):
      k.launch(torch.device("cpu"))
  assert k.launches == 0 and profiling.snapshot()["launch_ns"]["finish_t"] >= 0


def test_reset_clears_everything(stub_launch, card):
  profiling.count_build("x.cu")
  with profiling.tracing(), profiling.span("isp.process"):
    profiling.count_tone("pow_rcp")
  with profiling.tracing():
    _mark_sets(2)
  card.finish(2)    # one set resolved, one pending
  assert profiling.snapshot()["markers"]["sets"] == 1
  profiling.reset()
  assert profiling.snapshot() == {"spans": {}, "launch_ns": {},
                                  "tone_forms": {}, "finish_layouts": {},
                                  "resize_paths": {}, "i420_paths": {},
                                  "builds": {}, "markers": NO_MARKERS}
  # the set left pending is gone with the rest
  card.finish(len(card.recorded))
  assert profiling.snapshot()["markers"] == NO_MARKERS
  assert profiling._devices == {}


@pytest.fixture
def kernel_route(monkeypatch, stub_launch):
  """The kernel route on CPU tensors: every launcher a stub that records
  its kernel's name (th_meter's SMs and scratch as in test_torch_meter)."""
  launched = []
  monkeypatch.setattr(hopper, "use_kernel", lambda backend, x: True)
  monkeypatch.setattr(th_meter, "_sms", lambda device: 132)
  monkeypatch.setattr(th_meter, "_scratch",
                      lambda device: torch.zeros(th_meter.SCRATCH_BYTES,
                                                 dtype=torch.uint8))
  hopper._import_kernel_modules()
  for name, k in hopper.KERNELS.items():
    monkeypatch.setattr(k, "_fn",
                        lambda *args, name=name: launched.append(name) or 0)
  return launched


@pytest.mark.parametrize("cls,suffix", [(ttit.CameraBF16, "bf16"),
                                        (ttit.Camera32, "f32")])
def test_each_launch_lies_inside_its_stage(kernel_route, cls, suffix):
  isp = cls(ttit.BayerPattern.RGGB, device="cpu")
  with profiling.tracing():
    events = _profiled(lambda: [isp.process(_raws()) for _ in range(2)])
  want = {"isp.decode": f"decode_{suffix}", "isp.demosaic": f"demosaic_{suffix}",
          "isp.meter": f"meter_{suffix}", "isp.reinhard": f"reinhard_{suffix}",
          "isp.finish": f"finish_{suffix}"}
  assert kernel_route == list(want.values()) * 2
  launches = [e for e in events if e[0] == "isp.launch"]
  assert len(launches) == 10
  for stage in (e for e in events if e[0] in want):
    inner = [e for e in launches if _inside(e, stage)]
    assert [(e[1], e[2]) for e in inner] == [(want[stage[0]], stage[2])]
  snap = profiling.snapshot()
  assert set(snap["launch_ns"]) == set(want.values())
  assert sum(snap["launch_ns"].values()) == snap["spans"]["isp.launch"]["ns"]
  # every ns of a set is some span's own: the self times add up to the sets
  spans = snap["spans"]
  assert sum(s["self_ns"] for s in spans.values()) == \
      spans["isp.process"]["ns"]


def test_tone_forms_count_each_tone_launch(kernel_route):
  """The tone kernels' wrappers count each launch by the form they pass
  (gamma 1, the division-free pow below gamma 7 and for the linear tone,
  the division's pow from 7 up) while tracing is on, and nothing while it
  is off."""
  from taichi_image_tpu_torch.ops.hopper import finish, yuv420
  tones = []
  for k in [*finish.KERNELS.values(), *finish.YUV420_KERNELS.values(),
            *finish.PLANAR_TONE_KERNELS.values(),
            *yuv420.TONE_KERNELS.values()]:
    k._fn = lambda *args: tones.append(args[6:8] if len(args) < 16
                                       else args[7:9]) or 0
  x12 = torch.rand(1, 12, 4, 8, dtype=torch.float16)
  img = torch.rand(1, 3, 8, 16)
  mx, lin = torch.ones(1, 1, 1, 1), torch.tensor([0.0, 1.0])

  def launch_all():
    finish.finish_planar_u8(x12, mx, 1.0)
    finish.finish_planar_u8(x12, mx, 0.6,
                            transform=ImageTransform.rotate_90)
    finish.finish_planar_u8(x12, lin, 7.5, "linear")
    finish.finish_yuv420(x12, mx, 0.9)
    finish.finish_yuv420(x12, mx, 7.5)
    finish.finish_planar_tone(img, mx, 2.2)
    yuv420.yuv420_planar_tone(img, mx, 7.0)
    yuv420.yuv420_planar_tone(img, lin, 1.0, "linear")

  launch_all()   # tracing off: launched, not counted
  assert profiling.snapshot()["tone_forms"] == {}
  with profiling.tracing():
    launch_all()
  # (linear, tone) as each launcher was given them
  want = [(0, 0), (0, 1), (1, 1), (0, 1), (0, 2), (0, 1), (0, 2), (1, 0)]
  assert tones == want * 2
  # the f16 linear launch at 7.5 takes K4's table form, and so do the f16
  # I420 launches at 0.9 and 7.5
  assert profiling.snapshot()["tone_forms"] == {"gamma1": 2, "pow_rcp": 4,
                                                "pow_div": 2, "table": 3}
  profiling.reset()
  assert profiling.snapshot()["tone_forms"] == {}


def test_tone_forms_count_table_launches(kernel_route, monkeypatch):
  """A K4 launch in the table form, RGB or I420, counts
  ``tone_forms["table"]`` beside its form while tracing is on, whatever the
  frame's size; no other tone launch does (gamma 1, an axis swap, f32, P's
  direct form, the planar I420 tonemap form)."""
  from taichi_image_tpu_torch.ops.hopper import finish, yuv420
  monkeypatch.setattr(finish, "_tables", lambda device, n: torch.zeros(
      n * finish.TABLE_BYTES, dtype=torch.uint8))
  tables = []
  for k in finish.KERNELS.values():
    k._fn = lambda *args: tables.append(args[12] is not None) or 0
  big = torch.rand(1, 12, 1, 43691).to(torch.float16)
  small = torch.rand(1, 12, 4, 8).to(torch.float16)
  img = torch.rand(1, 3, 8, 16)
  mx = torch.ones(1, 1, 1, 1)

  def launch_all():
    finish.finish_planar_u8(big, mx, 0.6)
    finish.finish_planar_u8(big, mx, 1.0)
    finish.finish_planar_u8(big, mx, 0.6,
                            transform=ImageTransform.rotate_90)
    finish.finish_planar_u8(big.float(), mx, 0.6)
    finish.finish_planar_u8(small, mx, 0.6)
    finish.finish_yuv420(big, mx, 0.6)
    finish.finish_planar_tone(img, mx, 0.6)
    yuv420.yuv420_planar_tone(img, mx, 0.6)

  launch_all()   # tracing off: launched, not counted
  assert profiling.snapshot()["tone_forms"] == {}
  with profiling.tracing():
    launch_all()
  assert tables == [True, False, False, False, True] * 2
  forms = profiling.snapshot()["tone_forms"]
  assert forms == {"pow_rcp": 7, "gamma1": 1, "table": 3}


def test_tone_forms_count_planar_table_launches(kernel_route, monkeypatch):
  """A P launch in the table form (a 16-bit image of at least 65,536
  values at gamma != 1, no axis swap) counts ``tone_forms["table"]``
  beside its pow form while tracing is on, and two launches; P's direct
  form (an image under 65,536 values, f32, gamma 1, an axis swap) counts
  its form and no table."""
  from taichi_image_tpu_torch.ops.hopper import finish
  monkeypatch.setattr(finish, "_tables", lambda device, n: torch.zeros(
      n * finish.TABLE_BYTES, dtype=torch.uint8))
  tables = []
  for k in finish.PLANAR_TONE_KERNELS.values():
    k._fn = lambda *args: tables.append(args[12] is not None) or 0
  big = torch.rand(2, 3, 96, 240).to(torch.float16)  # 69,120 values
  small = torch.rand(2, 3, 96, 220).to(torch.float16)  # 63,360
  mx = torch.ones(2, 1, 1, 1)
  lin = torch.tensor([0.0, 1.0])

  def launch_all():
    finish.finish_planar_tone(big, mx, 0.6)
    finish.finish_planar_tone(big.to(torch.bfloat16), lin, 7.5, "linear")
    finish.finish_planar_tone(big, mx, 7.5)
    finish.finish_planar_tone(small, mx, 0.6)
    finish.finish_planar_tone(big.float(), mx, 0.6)
    finish.finish_planar_tone(big, mx, 1.0)
    finish.finish_planar_tone(big, mx, 0.6,
                              transform=ImageTransform.rotate_90)

  launch_all()   # tracing off: launched, not counted
  assert profiling.snapshot()["tone_forms"] == {}
  launches = hopper.launch_counts()
  with profiling.tracing():
    launch_all()
  assert tables == [True, True, True, False, False, False, False] * 2
  assert profiling.snapshot()["tone_forms"] == {
      "pow_rcp": 5, "pow_div": 1, "gamma1": 1, "table": 3}
  counted = {name: n - launches[name]
             for name, n in hopper.launch_counts().items()
             if n != launches[name]}
  assert counted == {"finish_planar_tone_f16": 7,
                     "finish_planar_tone_bf16": 2,
                     "finish_planar_tone_f32": 1}


@pytest.mark.parametrize("transform", list(ImageTransform),
                         ids=[t.value for t in ImageTransform])
def test_finish_layouts_count_each_swap_launch(kernel_route, monkeypatch,
                                               transform):
  """Each K4 RGB launch counts the layout of its output while tracing is
  on: ``swap`` (its axis-swap kernel) under each transform that swaps the
  axes, whatever the dtype and the tone form, ``rows`` under every other;
  K4's I420 mode and P count no layout, and nothing counts while tracing
  is off."""
  from taichi_image_tpu_torch.ops.bayer import _TRANSFORM_SFF
  from taichi_image_tpu_torch.ops.hopper import finish
  monkeypatch.setattr(finish, "_tables", lambda device, n: torch.zeros(
      n * finish.TABLE_BYTES, dtype=torch.uint8))
  swaps = []
  for k in finish.KERNELS.values():
    k._fn = lambda *args: swaps.append(args[9]) or 0
  x12 = torch.rand(2, 12, 4, 8)
  mx = torch.ones(2, 1, 1, 1)
  lin = torch.tensor([0.0, 1.0])
  img = torch.rand(2, 3, 8, 16)

  def launch_all():
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
      finish.finish_planar_u8(x12.to(dtype), mx, 1.0, transform=transform)
      finish.finish_planar_u8(x12.to(dtype), mx, 0.9, transform=transform)
    finish.finish_planar_u8(x12, lin, 7.5, "linear", transform=transform)
    finish.finish_yuv420(x12, mx, 0.9, transform=transform)
    finish.finish_planar_tone(img, mx, 0.9, transform=transform)

  launch_all()   # tracing off: launched, not counted
  assert profiling.snapshot()["finish_layouts"] == {}
  with profiling.tracing():
    launch_all()
  swap = _TRANSFORM_SFF[transform][0]
  assert swaps == [int(swap)] * 14
  assert profiling.snapshot()["finish_layouts"] == {
      "swap" if swap else "rows": 7}


# K12's half-res shapes: rows of whole 16-byte runs in every dtype, and
# rows that are not (150 is 4 mod 8: f32 rows are whole runs, 16-bit not)
RESIZE_PATH_CASES = {
    "half, whole runs": ((48, 256), 0.5, torch.float16, "aligned"),
    "half, f32": ((48, 256), 0.5, torch.float32, "aligned"),
    "x0.37": ((48, 256), 0.37, torch.float16, "direct"),
    "half, rows not whole runs": ((19, 150), 0.5, torch.bfloat16, "direct"),
    "x1.5": ((19, 150), 1.5, torch.float32, "direct"),
}


def _resize_taps(hh, wh, scale):
  from taichi_image_tpu_torch.models import camera_isp as tci
  from taichi_image_tpu_torch.ops.hopper import resize
  size = (max(1, round(2 * wh * scale)), max(1, round(2 * hh * scale)))
  return resize.resize_taps(hh, wh, size,
                            tci._plan_scales(2 * hh, 2 * wh, size, scale),
                            torch.device("cpu"))


@pytest.mark.parametrize("case", RESIZE_PATH_CASES)
def test_resize_paths_count_each_k12_launch(kernel_route, case):
  """Each K12 launch counts the path its wrapper planned while tracing is
  on: ``aligned`` where a resize halves both axes and the rows are whole
  16-byte runs, ``direct`` elsewhere; nothing while tracing is off, and
  the reset clears the counter."""
  from taichi_image_tpu_torch.ops.hopper import resize
  (hh, wh), scale, dtype, path = RESIZE_PATH_CASES[case]
  x12 = torch.zeros(2, 12, hh, wh, dtype=dtype)
  taps = _resize_taps(hh, wh, scale)
  assert resize.plan(x12, taps) == path
  resize.resize_x12(x12, taps)   # tracing off: launched, not counted
  assert profiling.snapshot()["resize_paths"] == {}
  with profiling.tracing():
    resize.resize_x12(x12, taps)
    resize.resize_x12(x12, taps)
  assert kernel_route == [resize.KERNELS[dtype].name] * 3
  assert profiling.snapshot()["resize_paths"] == {path: 2}
  profiling.reset()
  assert profiling.snapshot()["resize_paths"] == {}


@pytest.mark.parametrize("cls", [ttit.CameraBF16, ttit.Camera16,
                                 ttit.Camera32], ids=lambda c: c.__name__)
def test_resize_paths_count_one_aligned_launch_a_set(kernel_route, cls):
  """``process`` at a ``resize_width`` of half the frame's width takes
  K12's aligned path once a set; the other routes launch no K12."""
  w = 32   # half-res rows of 16 columns: whole 16-byte runs in every dtype
  rng = np.random.default_rng(0)
  raws = rng.integers(0, 256, (2, H, w * 3 // 2), dtype=np.uint8)
  plain = cls(ttit.BayerPattern.RGGB, device="cpu")
  isp = cls(ttit.BayerPattern.RGGB, device="cpu", resize_width=w // 2)
  with profiling.tracing():
    plain.process(raws)
    assert profiling.snapshot()["resize_paths"] == {}
    for _ in range(3):
      isp.process(raws)
  snap = profiling.snapshot()
  assert snap["spans"]["isp.process"]["calls"] == 4
  assert snap["resize_paths"] == {"aligned": 3}


def _i420_launchers():
  """{path: a call of the wrapper that launches that path's I420 kernel,
  and a call of its plain twin}, on small CPU tensors."""
  from taichi_image_tpu_torch.ops.hopper import finish, yuv420
  x12 = torch.rand(2, 12, 4, 8).to(torch.float16)
  img = torch.rand(2, 3, 8, 16)
  rgb = torch.randint(0, 256, (2, 3, 8, 16), dtype=torch.uint8)
  mx = torch.ones(2, 1, 1, 1)
  rot = ImageTransform.rotate_90
  return {
      "rows": (lambda: finish.finish_yuv420(x12, mx, 0.6),
               lambda: finish.finish_yuv420_plain(x12, mx, 0.6)),
      "swap": (lambda: finish.finish_yuv420(x12, mx, 0.6, transform=rot),
               lambda: finish.finish_yuv420_plain(x12, mx, 0.6,
                                                  transform=rot)),
      "planar_tone": (lambda: yuv420.yuv420_planar_tone(img, mx, 0.6),
                      lambda: yuv420.yuv420_planar_tone_plain(img, mx, 0.6)),
      "planar_u8": (lambda: yuv420.yuv420_planar(rgb),
                    lambda: yuv420.yuv420_planar_plain(rgb)),
  }


I420_KERNELS = {"rows": "finish_yuv420_f16", "swap": "finish_yuv420_f16",
                "planar_tone": "yuv420_planar_tone_f32",
                "planar_u8": "yuv420_planar"}


@pytest.mark.parametrize("path", I420_KERNELS)
def test_i420_paths_count_each_launch(kernel_route, path):
  """Each launch of a step's I420 kernel counts its path while tracing is
  on: K4's I420 mode ``rows``, or ``swap`` under a transform that swaps
  the axes, the planar tonemap form ``planar_tone``, the conversion of u8
  RGB ``planar_u8``; nothing while tracing is off, nothing on the plain
  twins, and the reset clears the counter."""
  launch, plain = _i420_launchers()[path]
  launch()   # tracing off: launched, not counted
  assert profiling.snapshot()["i420_paths"] == {}
  with profiling.tracing():
    plain()
    assert profiling.snapshot()["i420_paths"] == {}
    launch()
    launch()
  assert kernel_route == [I420_KERNELS[path]] * 3
  assert profiling.snapshot()["i420_paths"] == {path: 2}
  profiling.reset()
  assert profiling.snapshot()["i420_paths"] == {}


def test_i420_paths_count_nothing_on_the_plain_route():
  """On CPU tensors every I420 wrapper takes its plain twin, which counts
  no path."""
  with profiling.tracing():
    for launch, _ in _i420_launchers().values():
      launch()
  assert profiling.snapshot()["i420_paths"] == {}
  assert profiling.snapshot()["tone_forms"] == {}


# the I420 path each route of ``process`` takes, by the class's options
I420_ROUTES = {
    "rows": dict(metering_stride=8),
    "swap": dict(transform=ImageTransform.rotate_90),
    "planar_tone": dict(resize_width=12),
    "planar_u8": dict(metering_stride=3),
}


@pytest.mark.parametrize("path", I420_ROUTES)
def test_i420_paths_count_one_launch_a_set(kernel_route, path):
  """``Camera16.process(..., color_format="yuv420")`` launches one I420
  kernel a set, on the path of its route: at stride 8 K4's I420 mode;
  RGB output launches none."""
  isp = ttit.Camera16(ttit.BayerPattern.RGGB, device="cpu",
                      **I420_ROUTES[path])
  with profiling.tracing():
    isp.process(_raws())
    assert profiling.snapshot()["i420_paths"] == {}
    for i in range(3):
      isp.process(_raws(seed=i), color_format="yuv420")
  snap = profiling.snapshot()
  assert snap["spans"]["isp.process"]["calls"] == 4
  assert snap["i420_paths"] == {path: 3}


# -- the set markers, on a fake card ------------------------------------------

CUDA = torch.device("cuda", 0)
STREAM = types.SimpleNamespace(device_index=0)   # the card's current stream


class _Card:
  """A fake CUDA card for the set markers. Each event recorded on it takes
  the next of the card's times (us on the card's clock, 0, 10, 20, ...
  unless the test gives them) and a place in submission order; the test
  completes records with :meth:`finish`. Waiting on an event fails."""

  def __init__(self):
    self.made, self.recorded, self.done = 0, [], set()
    self.times = itertools.count(0, 10)

  def event(self):
    self.made += 1
    return _Event(self)

  def finish(self, n: int, *more: int) -> None:
    """Complete the first ``n`` records, and those at ``more``."""
    self.done |= set(range(n)) | set(more)


class _Event:
  """A timing event on a :class:`_Card`."""

  def __init__(self, card):
    self.card, self.seq, self.t = card, None, None

  def record(self, stream):
    assert stream is STREAM
    self.seq, self.t = len(self.card.recorded), next(self.card.times)
    self.card.recorded.append(self)

  def query(self):
    return self.seq in self.card.done

  def elapsed_time(self, end):
    assert self.query() and end.query(), "elapsed time of a pending marker"
    return (end.t - self.t) / 1e3

  def synchronize(self):
    raise AssertionError("a set marker was waited for")

  wait = synchronize


@pytest.fixture
def card(monkeypatch):
  """The markers' event factory on a fake card whose one stream is every
  CUDA device's current stream (a CPU device has none, as on a card)."""
  card = _Card()
  monkeypatch.setattr(profiling, "_event", card.event)
  monkeypatch.setattr(profiling, "_stream",
                      lambda device: STREAM if device.type == "cuda" else None)
  return card


def _mark_sets(n: int, sets=None) -> None:
  """``n`` empty sets opened on the CUDA device."""
  sets = itertools.count() if sets is None else sets
  for _ in range(n):
    with profiling.span("isp.process", sets, CUDA):
      pass


def _markers() -> dict:
  return profiling.snapshot()["markers"]


def test_set_markers_off_make_no_event_and_read_no_clock(monkeypatch, card):
  streams, clock = [], []
  monkeypatch.setattr(profiling, "_stream", lambda d: streams.append(d))
  real = profiling.perf_counter_ns
  monkeypatch.setattr(profiling, "perf_counter_ns",
                      lambda: clock.append(1) or real())
  assert profiling.span("isp.process", itertools.count(), CUDA) is \
      profiling._OFF
  _mark_sets(3)
  assert card.made == 0 and streams == [] and clock == []
  assert _markers() == NO_MARKERS


def test_a_cpu_device_records_no_marker(monkeypatch):
  made = []
  monkeypatch.setattr(profiling, "_event", lambda: made.append(1))
  isp = ttit.CameraBF16(ttit.BayerPattern.RGGB, device="cpu")
  with profiling.tracing():
    isp.process(_raws())
    isp.process_large(_raws(), driver="auto")
  snap = profiling.snapshot()
  assert snap["spans"]["isp.process"]["calls"] == 2
  assert made == [] and snap["markers"] == NO_MARKERS
  assert profiling._devices == {}


def test_sets_resolve_in_order(card):
  with profiling.tracing():
    _mark_sets(3)   # set i: start record 2i, end record 2i + 1
  assert _markers()["sets"] == 0
  # set 1's end has completed, set 0's has not: set 0 holds both back
  card.finish(0, 2, 3)
  assert _markers()["sets"] == 0
  card.finish(2)
  m = _markers()
  assert m["sets"] == 2 and m["set_device_ns"] == 2 * 10_000
  card.finish(6)
  m = _markers()
  assert m["sets"] == 3 and m["set_device_ns"] == 3 * 10_000
  # in one stretch each set after the first follows its predecessor
  assert m["waited_sets"] == 2 and m["wait_ns"] == 2 * 10_000
  assert not profiling._devices[0].fifo


def test_the_events_are_reused(card):
  with profiling.tracing():
    for i in range(50):
      _mark_sets(1)
      card.finish(len(card.recorded))
      assert _markers()["sets"] == i + 1
  # a timed set's start goes back at once, an end once the next set is timed
  assert card.made <= 4


def test_sets_are_timed_in_the_snapshot_alone(monkeypatch, card):
  timed = []
  real = _Event.elapsed_time
  monkeypatch.setattr(_Event, "elapsed_time",
                      lambda self, end: timed.append(1) or real(self, end))
  with profiling.tracing():
    for _ in range(5):
      _mark_sets(1)
      card.finish(len(card.recorded))
  # each set popped as the next opened, none timed
  assert timed == [] and len(profiling._devices[0].untimed) == 4
  m = _markers()
  assert m["sets"] == 5 and m["waited_sets"] == 4 and len(timed) == 9
  assert not profiling._devices[0].untimed


def test_sets_beyond_the_untimed_bound_are_timed_at_their_pop(monkeypatch,
                                                              card):
  monkeypatch.setattr(profiling, "UNTIMED_SETS", 2)
  with profiling.tracing():
    for _ in range(40):
      _mark_sets(1)
      card.finish(len(card.recorded))
    marks = profiling._devices[0]
    assert len(marks.untimed) == 2
    # the sets timed at their pop gave their events back
    assert card.made <= 10
  m = _markers()
  assert m["sets"] == 40 and m["set_device_ns"] == 40 * 10_000
  assert m["waited_sets"] == 39 and m["wait_ns"] == 39 * 10_000


def test_a_snapshot_never_waits(monkeypatch, card):
  monkeypatch.setattr(torch.cuda, "synchronize", _Event.synchronize)
  with profiling.tracing():
    _mark_sets(4)
    card.finish(4)   # sets 0 and 1 done, 2 and 3 in flight
    m = _markers()
  assert m["sets"] == 2 and len(profiling._devices[0].fifo) == 2
  card.finish(8)
  assert _markers()["sets"] == 4


def test_in_flight_counts_the_pending_sets(card):
  with profiling.tracing():
    _mark_sets(3)            # 0, 1 and 2 sets pending as each opens
    card.finish(6)
    _mark_sets(1)            # the three resolve first: none pending
    card.finish(8)
  m = _markers()
  assert m["sets"] == 4 and m["in_flight"] == 0 + 1 + 2 + 0


def test_a_switch_of_the_tracer_breaks_the_pair(card):
  card.times = iter([0, 10, 14, 20, 30, 40, 45, 50, 60, 61])
  sets = itertools.count()
  profiling.enable()
  _mark_sets(2, sets)          # 0..10, 14..20: a wait of 4 us
  profiling.disable()
  _mark_sets(1, sets)          # off: unmarked, a gap that is not counted
  profiling.enable()
  _mark_sets(1, sets)          # 30..40: after a switch, no pair
  with profiling.tracing():    # a switch, though the tracer stays on
    _mark_sets(1, sets)        # 45..50: no pair
  _mark_sets(1, sets)          # 60..61: no pair after the block's end
  card.finish(len(card.recorded))
  m = _markers()
  assert m["sets"] == 5
  assert m["set_device_ns"] == (10 + 6 + 10 + 5 + 1) * 1000
  assert m["waited_sets"] == 1 and m["wait_ns"] == 4000


def test_a_set_opened_inside_another_is_not_paired(card):
  card.times = iter([0, 2, 3, 10, 12, 13])
  sets = itertools.count()
  with profiling.tracing():
    with profiling.span("isp.process", sets, CUDA):      # 0..10
      with profiling.span("isp.process", sets, CUDA):    # 2..3
        pass
    _mark_sets(1, sets)                                  # 12..13
  card.finish(len(card.recorded))
  m = _markers()
  assert m["sets"] == 3 and m["set_device_ns"] == (10 + 1 + 1) * 1000
  # the inner set opened with the outer open: the last follows the inner
  assert m["waited_sets"] == 1 and m["wait_ns"] == (12 - 3) * 1000
  assert profiling._devices[0].busy == 0


def test_reset_breaks_the_pair(card):
  with profiling.tracing():
    _mark_sets(1)
    card.finish(2)
    profiling.reset()
    _mark_sets(2)
  card.finish(len(card.recorded))
  m = _markers()
  assert m["sets"] == 2 and m["waited_sets"] == 1


def test_the_fifo_is_bounded(monkeypatch, card):
  monkeypatch.setattr(profiling, "MARKED_SETS", 3)
  with profiling.tracing():
    _mark_sets(5)                  # 3 marked, 2 beyond the bound
    assert len(profiling._devices[0].fifo) == 3 and card.made == 6
    card.finish(6)
    _mark_sets(2)                  # room again; the first follows no mark
  card.finish(len(card.recorded))
  m = _markers()
  assert m["unmarked_sets"] == 2 and m["sets"] == 5
  # pairs 0-1, 1-2 and the last two; not the first after the unmarked
  assert m["waited_sets"] == 3
  assert profiling.snapshot()["spans"]["isp.process"]["calls"] == 7


def test_process_large_marks_its_set(monkeypatch, card):
  monkeypatch.setattr(profiling, "_stream", lambda device: STREAM)
  isp = ttit.Camera32(ttit.BayerPattern.RGGB, device="cpu")
  with profiling.tracing():
    isp.process_large(_raws(), driver="auto")
    assert card.made == 2 and len(card.recorded) == 2
    isp.process(_raws())
  card.finish(4)
  m = _markers()
  assert m["sets"] == 2 and m["waited_sets"] == 1


def test_threads_lose_no_marker(monkeypatch, card):
  """Sets marked on one card from more threads than cores, switching
  often: every set resolves once, and none pairs with a set still open on
  another thread. The bound is raised past the sets: a thread held with
  the front set open can leave the others any number of sets ahead."""
  n_threads, n = 4 * (os.cpu_count() or 1), 500
  monkeypatch.setattr(profiling, "MARKED_SETS", n_threads * n)
  card.finish(10 ** 7)   # every record completes as it is made
  interval = sys.getswitchinterval()
  sys.setswitchinterval(1e-6)
  try:
    with profiling.tracing():
      with ThreadPoolExecutor(n_threads) as pool:
        for f in [pool.submit(_mark_sets, n, itertools.count())
                  for _ in range(n_threads)]:
          f.result(timeout=60)
  finally:
    sys.setswitchinterval(interval)
  m = _markers()
  assert m["sets"] == n_threads * n and m["unmarked_sets"] == 0
  assert m["wait_ns"] >= 0 and m["waited_sets"] < m["sets"]
  assert not profiling._devices[0].fifo
  assert len(card.recorded) == 2 * n_threads * n
