"""The metric arithmetic on synthetic spans, loop results and trace
events."""

import pytest

from isp_bench import manifest, reduce, trace
from isp_bench.harness import LoopResult, Run
from isp_bench.trace import DeviceOp, Slice, Spans

CFG = manifest.config(manifest.load(), "rig6x4k_f16")
FAMILIES = {n: m.SYMBOLS for n, m in manifest.modules("work").items()
            if hasattr(m, "SYMBOLS")}


def _run(loop=None, slices=(), spans=None, traffic=None):
  return Run(CFG, traffic or {"color_format": "rgb"},
             loop or LoopResult(10, 10, 2.0), 12.5, spans or Spans(),
             list(slices))


def _read(kind, name, run):
  return manifest.module(kind, name).read(run)


def test_rate_is_over_the_whole_window():
  run = _run(LoopResult(attempted=300, completed=300, window_s=0.25))
  assert _read("end_to_end", "frames_per_s", run) == pytest.approx(
      300 * 6 / 0.25)


def test_union_of_intervals_not_a_sum():
  iv = [(0, 10), (5, 15), (20, 30), (29, 31), (50, 60)]
  assert reduce.busy(iv, 0, 40) == 15 + 11
  assert reduce.gaps(iv, 0, 40) == [(15, 20), (31, 40)]
  assert reduce.busy(iv, 8, 25) == 7 + 5


def _slice(ops, sets=2, launches=None, host=(), t0=0.0, t1=100.0):
  device = [DeviceOp(k, lab, s, d) for k, lab, s, d in ops]
  n = sum(op.kind == reduce.KERNEL for op in device)
  return Slice(t0, t1, sets, n if launches is None else launches, device,
               list(host))


def test_idle_share_and_kernel_time_per_set():
  sl = _slice([(reduce.KERNEL, "decode", 0, 20),
               (reduce.KERNEL, "demosaic", 10, 30),    # overlaps: union 40
               (reduce.MEMSET, "Memset", 50, 5),
               (reduce.MEMCPY, "Memcpy HtoD", 60, 20),
               (reduce.MEMCPY, "Memcpy DtoH", 70, 20)])   # union 60..90
  run = _run(slices=[sl])
  assert _read("layer_metrics", "device_idle_share", run) == \
      pytest.approx(100 * (1 - (40 + 5 + 30) / 100))
  assert _read("layer_metrics", "kernel_ms", run) == pytest.approx(
      (20 + 30 + 5) / 2 / 1e3)
  assert reduce.busy_window_s([sl]) == (pytest.approx(75e-6),
                                        pytest.approx(100e-6))


def test_missing_when_the_trace_dropped_kernels():
  sl = _slice([(reduce.KERNEL, "decode", 0, 20)], launches=5)
  run = _run(slices=[sl])
  assert _read("layer_metrics", "kernel_ms", run) is None
  assert _read("layer_metrics", "kernels_roofline", run) is None
  assert _read("layer_metrics", "kernel_ms", _run()) is None
  assert _read("layer_metrics", "device_idle_share", _run()) is None


def test_a_slice_that_lost_kernels_is_left_out():
  whole = _slice([(reduce.KERNEL, "decode", 0, 40)], sets=1)
  lost = _slice([(reduce.KERNEL, "decode", 0, 10)], sets=1, launches=2)
  run = _run(slices=[whole, lost])
  assert _read("layer_metrics", "kernel_ms", run) == pytest.approx(0.04)
  assert _read("layer_metrics", "device_idle_share", run) == \
      pytest.approx(60.0)
  assert reduce.complete([whole, lost]) == [whole]


def test_roofline_counts_the_set_not_the_kernels():
  one = _slice([(reduce.KERNEL, "k", 0, 800)], sets=1, t1=1000)
  two = _slice([(reduce.KERNEL, "a", 0, 400), (reduce.KERNEL, "b", 400, 400)],
               sets=1, t1=1000)
  r1 = _read("layer_metrics", "kernels_roofline", _run(slices=[one]))
  r2 = _read("layer_metrics", "kernels_roofline", _run(slices=[two]))
  assert r1 == pytest.approx(r2)
  # the f16 rig's set: 223.9 MB over 3.35 TB/s (its 3.85 GFLOP over 67
  # TFLOP/s take less), against 0.8 ms
  assert r1 == pytest.approx(100 * 223948800 / 3.35e12 / 0.8e-3)


def test_idle_gaps_by_the_innermost_host_span():
  host = [("sync", 0, 100), ("process", 10, 30), ("sync", 90, 10)]
  sl = _slice([(reduce.KERNEL, "k", 0, 10), (reduce.KERNEL, "k", 40, 45)],
              host=host)
  # gaps: 10..40 inside process, 85..100 inside sync
  assert reduce.idle_by_span([sl]) == {"process": pytest.approx(30e-6),
                                       "sync": pytest.approx(15e-6)}


def test_driver_span_is_the_mean_over_the_window():
  spans = Spans()
  spans.durations["process"] = [0.010, 0.014, 0.018]
  run = _run(spans=spans)
  assert _read("layer_metrics", "driver_ms.throughput", run) == \
      pytest.approx(14.0)
  assert _read("layer_metrics", "driver_ms.throughput", _run()) is None


def test_parse_a_chrome_trace():
  events = [
      {"ph": "X", "cat": "user_annotation", "name": "slice", "ts": 1000.0,
       "dur": 500.0},
      {"ph": "X", "cat": "user_annotation", "name": "process", "ts": 1010.0,
       "dur": 40.0},
      {"ph": "X", "cat": "user_annotation", "name": "K:other", "ts": 1010.0,
       "dur": 4.0},
      {"ph": "X", "cat": "kernel", "ts": 1100.0, "dur": 50.0,
       "name": "void (anonymous namespace)::stencil_kernel<__half, 0>(int)"},
      {"ph": "X", "cat": "kernel", "ts": 1150.0, "dur": 20.0,
       "name": "void (anonymous namespace)::finish_rows_kernel<float>()"},
      {"ph": "X", "cat": "kernel", "ts": 0.0, "dur": 0.0,
       "name": "void (anonymous namespace)::map_kernel<float>()"},
      {"ph": "X", "cat": "gpu_memset", "ts": 1170.0, "dur": 2.0,
       "name": "Memset (Device)"},
      {"ph": "X", "cat": "gpu_memcpy", "ts": 1200.0, "dur": 30.0,
       "name": "Memcpy HtoD (Pinned -> Device)"},
      {"ph": "X", "cat": "cuda_runtime", "ts": 1020.0, "dur": 3.0,
       "name": "cudaLaunchKernel"},
      {"ph": "X", "cat": "kernel", "ts": 990.0, "dur": 2.0,
       "name": "void at::native::vectorized_elementwise_kernel<4>()"},
  ]
  sl = trace.parse(events, sets=1, launches=3, families=FAMILIES)
  assert (sl.t0, sl.t1) == (1000.0, 1500.0)
  assert [(op.kind, op.label) for op in sl.device] == [
      (reduce.KERNEL, "demosaic"), (reduce.KERNEL, "finish"),
      (reduce.MEMSET, "Memset"),
      (reduce.MEMCPY, "Memcpy HtoD (Pinned -> Device)")]
  assert sl.host == [("process", 1010.0, 40.0)]
  # the event without a time was lost: two kernels against three launches
  assert reduce.complete([sl]) == []


def test_family_symbols_are_whole_words():
  assert trace.family_of("void finish_rows_kernel<float>()", FAMILIES) == \
      "finish"
  assert trace.family_of("void finish_yuv420_kernel<float>()", FAMILIES) \
      is None
  assert trace.family_of("void (anonymous namespace)::resize_kernel<__half, "
                         "true>(int)", FAMILIES) == "resize"
  assert trace.family_of("void resize_kernel_v2<float>()", FAMILIES) is None
  for kind in ("rows", "swap"):
    assert trace.family_of(f"void (anonymous namespace)::planar_tone_{kind}"
                           f"_kernel<__half, 1>(int)", FAMILIES) == \
        "planar_tone"
  assert trace.family_of("void yuv420_planar_tone_kernel<float>()",
                         FAMILIES) is None


def test_demosaic_counts_the_least_arithmetic():
  from isp_bench.reference import isp as ref
  from isp_bench.work import isp_set
  # 9 taps in 3 weights: 6 adds in the groups, 3 multiplies, 2 adds, the
  # normalising multiply and the clip's 2
  assert isp_set._stencil_ops(ref._G_AT_RB) == 14
  assert isp_set._stencil_ops(ref._RB_AT_BR) == 14
  # 11 taps in 4 weights, one of them 1
  assert isp_set._stencil_ops(ref._VERT) == 16
  assert isp_set._stencil_ops(ref._IDENT) == 0
  assert isp_set.STAGE_OPS["demosaic"] == (28 + 32 + 32 + 28) / 4


PIXELS = 6 * 2160 * 3840
OUT_W1920 = 6 * 1080 * 1920
# each configuration's set and kernel families on its own route: (bytes,
# operations); the full-resolution routes as counted before the resize
# route was, the x0.5 resize route worked by hand
COUNTS = {
    "rig6x4k_f16": {
        "set": (223948800, 3852230400),
        "decode": (174182400, 49766400),
        "demosaic": (402796800, 1492992000),
        "meter": (4665720, 20217600),
        "reinhard": (597196848, 1393459200),
        "finish": (447897624, 895795200)},
    "scan6x4k_f32_rot90": {
        "set": (223948800, 3852230400),
        "decode": (273715200, 49766400),
        "demosaic": (805593600, 1492992000),
        "meter": (9331320, 20217600),
        "reinhard": (1194393648, 1393459200),
        "finish": (746496024, 895795200)},
    "rig6x4k_f16_w1920": {
        # raws 1.5 bytes a pixel, u8 RGB out; decode and demosaic (1 +
        # 30) a pixel, then a resized pixel: the resize 27, the stride-8
        # metering 26 / 64, the map 28, the tone at gamma 0.6 3 x 6
        "set": (PIXELS * 3 // 2 + OUT_W1920 * 3,
                31 * PIXELS + (27 + 26 / 64 + 28 + 18) * OUT_W1920),
        "decode": (PIXELS * 3 // 2 + PIXELS * 2, PIXELS),
        # the CFA in, x12 out, no metering sample
        "demosaic": ((PIXELS + 3 * PIXELS) * 2, 30 * PIXELS),
        # at x0.5 the taps touch every row and column of x12
        "resize": ((3 * PIXELS + 3 * OUT_W1920) * 2, 27 * OUT_W1920),
        "meter": (3 * 6 * 135 * 240 * 2 + 4 * 30, 26 * 6 * 135 * 240),
        "reinhard": (2 * 3 * OUT_W1920 * 2 + 4 * 12, 28 * OUT_W1920),
        "planar_tone": (3 * OUT_W1920 * 3 + 4 * 6, 18 * OUT_W1920)},
}


def _config(name):
  if name == "rig6x4k_f16_w1920":
    return dict(CFG, name=name, resize_width=1920)
  return manifest.config(manifest.load(), name)


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_counts_of_the_set_and_the_families(name):
  from isp_bench.work import isp_set
  cfg, want = _config(name), COUNTS[name]
  assert (isp_set.irreducible_bytes(cfg, "rgb"), isp_set.ops(cfg, "rgb")) \
      == want["set"]
  work = manifest.modules("work")
  for fam, counts in want.items():
    if fam != "set":
      assert (work[fam].logical_bytes(cfg, "rgb"),
              work[fam].ops(cfg, "rgb")) == counts, fam


def test_the_resized_sets_least_time_is_its_operations():
  from isp_bench import peaks
  from isp_bench.work import isp_set
  cfg = _config("rig6x4k_f16_w1920")
  assert isp_set.out_size(cfg) == (1080, 1920)
  # 111,974,400 bytes (0.0334 ms) against 2,456,049,600 operations
  # (0.0367 ms), most of them the full-resolution demosaic's
  assert isp_set.irreducible_bytes(cfg, "rgb") == 111974400
  assert isp_set.ops(cfg, "rgb") == 2456049600
  bytes_s = isp_set.irreducible_bytes(cfg, "rgb") / peaks.HBM_BYTES_S
  ops_s = isp_set.ops(cfg, "rgb") / peaks.F32_FLOPS
  assert ops_s > bytes_s
