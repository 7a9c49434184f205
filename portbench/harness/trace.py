"""Device activity from the profiler, and what the traced window reads.

``device_spans`` is a frozen copy of ``chip_smoke.py::device_spans`` (CUDA
activity only: host-side tracing of a train step's ~100k small operations
takes minutes to process; the raw kineto events, not the profiler's event
tree), with a throwaway profile first to take the tracer's start-up. Beside
it, the benchmark's own host ranges: each call it makes in the traced
window is a named range on the host clock, and an idle gap of the device
is labelled by the innermost range it falls in.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch


class TraceFailure(RuntimeError):
  pass


@dataclasses.dataclass
class HostRanges:
  """Named host intervals, (name, start ns, end ns) on ``time.time_ns``,
  with the same instants on ``time.monotonic_ns`` and ``perf_counter_ns``
  to find the profiler's clock."""
  ranges: list = dataclasses.field(default_factory=list)

  @contextlib.contextmanager
  def __call__(self, name: str):
    clocks = (time.time_ns(), time.monotonic_ns(), time.perf_counter_ns())
    try:
      yield
    finally:
      self.ranges.append((name, clocks, (time.time_ns(), time.monotonic_ns(),
                                          time.perf_counter_ns())))


def device_spans(fn):
  """Runs fn once under torch.profiler (CUDA activity only). Returns (fn's
  result, the sorted (start us, end us, name) of its device activities),
  read from the profiler's raw events."""
  from torch.profiler import ProfilerActivity, profile
  # A first profile of one small kernel takes the tracer's start-up, which
  # would otherwise read as an idle gap at the start of the window.
  with profile(activities=[ProfilerActivity.CUDA]):
    torch.ones(1, device='cuda').add_(1)
    torch.cuda.synchronize()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    result = fn()
    torch.cuda.synchronize()
  cuda = torch.autograd.DeviceType.CUDA
  results = getattr(prof.profiler, 'kineto_results', None)
  if results is None:
    raise TraceFailure('torch.profiler keeps no kineto_results here: the '
                       'raw device events cannot be read')
  spans = sorted((e.start_ns() / 1e3, e.end_ns() / 1e3, e.name())
                 for e in results.events() if e.device_type() == cuda)
  if not spans:
    raise TraceFailure('the profiler recorded no device activity')
  return result, spans


def busy_intervals(spans):
  """The union of the spans' intervals, [(start us, end us)]."""
  merged = []
  for start, stop, _ in spans:
    if merged and start <= merged[-1][1]:
      merged[-1][1] = max(merged[-1][1], stop)
    else:
      merged.append([start, stop])
  return merged


def host_window_us(host: HostRanges, spans):
  """(window start, window end, clock index) in the profiler's time base:
  the clock of the three on which the device spans lie inside the host
  window; (None, None, None) when none fits."""
  first, last = host.ranges[0][1], host.ranges[-1][2]
  lo, hi = spans[0][0], max(s[1] for s in spans)
  for index in range(3):
    start, end = first[index] / 1e3, last[index] / 1e3
    if start - 1e3 <= lo and hi <= end + 1e3:
      return start, end, index
  return None, None, None


def reduce(spans, host: HostRanges, wall_s: float, top: int = 10) -> dict:
  """busy_s, the idle share of the host window, the activity count, and the
  breakdown: device time by kernel name and the longest idle gaps, each
  named by the innermost host range it lies in."""
  busy = busy_intervals(spans)
  busy_s = sum(stop - start for start, stop in busy) / 1e6
  by_name = {}
  for start, stop, name in spans:
    by_name[name] = by_name.get(name, 0.0) + (stop - start) / 1e6
  device_ops = sorted(([name[:160], seconds] for name, seconds in
                       by_name.items()), key=lambda item: -item[1])[:top]
  start, end, clock = host_window_us(host, spans)
  gaps = []
  if clock is not None:
    edges = [start] + [x for interval in busy for x in interval] + [end]
    for gap_start, gap_end in zip(edges[::2], edges[1::2]):
      if gap_end > gap_start:
        gaps.append((gap_start, gap_end))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for gap_start, gap_end in gaps[:top]:
      middle = (gap_start + gap_end) / 2
      label, width = 'outside any range', float('inf')
      for name, opened, closed in host.ranges:
        lo, hi = opened[clock] / 1e3, closed[clock] / 1e3
        if lo <= middle <= hi and hi - lo < width:
          label, width = name, hi - lo
      named.append([f'{label} at +{(gap_start - start) / 1e3:.1f} ms',
                    (gap_end - gap_start) / 1e6])
    gaps = named
  return {'busy_s': busy_s, 'window_s': wall_s, 'activities': len(spans),
          'idle_share': 1.0 - busy_s / wall_s,
          'breakdown': {'device_ops': device_ops, 'idle_gaps': gaps}}


def event_ms(fn, repeats: int = 2, warmup: int = 1) -> float:
  """Milliseconds a call of fn takes on the card, by CUDA events around
  ``repeats`` calls after ``warmup`` calls (``chip_smoke.py::timed``)."""
  for _ in range(warmup):
    fn()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(repeats):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / repeats


def host_ms(fn, seconds: float = 0.5, warmup: int = 1) -> float:
  """Milliseconds a call of fn takes by the host's clock: after ``warmup``
  calls, calls each followed by a synchronize until ``seconds`` have
  passed, over their count."""
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  calls, start = 0, time.perf_counter()
  while True:
    fn()
    torch.cuda.synchronize()
    calls += 1
    elapsed = time.perf_counter() - start
    if elapsed >= seconds:
      return elapsed / calls * 1e3
