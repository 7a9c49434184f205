# Copyright 2026.
#
# Licensed under the Apache License, Version 2.0 (the "License");
# you may not use this file except in compliance with the License.
# You may obtain a copy of the License at
#
#     http://www.apache.org/licenses/LICENSE-2.0
#
# Unless required by applicable law or agreed to in writing, software
# distributed under the License is distributed on an "AS IS" BASIS,
# WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
# See the License for the specific language governing permissions and
# limitations under the License.

"""Tracing and timing helpers, PyTorch port.

Counterpart of ``last_torch_tpu/utils/profiling.py``. ``span`` marks a
region of the program (``GNATModel.decode`` and the layers under it carry
spans named after the JAX package's ``named_scope`` regions); while
``recording`` is on, each span is kept in memory with its parent, its
host interval and, where CUDA is in use, its interval on the device.
``trace`` captures a ``torch.profiler`` trace (CPU and, with a card, CUDA
activity) into a directory as a Chrome trace, with recording on, so the
spans appear in it by name. ``StepTimer`` times steps on the host clock and
reports percentiles, and ``benchmark`` times a function with it. The timer
synchronises the device when it stops, so a step's time includes its
kernels and not only their launch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Anchor:
  """Three host clocks read together, to place spans (on
  ``time.perf_counter_ns``) on whichever clock another trace uses."""
  time_ns: int
  monotonic_ns: int
  perf_counter_ns: int

  @classmethod
  def now(cls) -> Anchor:
    return cls(time.time_ns(), time.monotonic_ns(), time.perf_counter_ns())

  def on(self, clock: str, perf_counter_ns: int) -> int:
    """``perf_counter_ns`` as a reading of ``clock`` ('time_ns',
    'monotonic_ns' or 'perf_counter_ns')."""
    return perf_counter_ns - self.perf_counter_ns + getattr(self, clock)


@dataclasses.dataclass
class Span:
  """One recorded region. ``call`` is the id of its root span, shared by
  every span under it. ``start_ns`` / ``end_ns`` are ``time.perf_counter_ns``
  readings; the events, where CUDA was initialised, were recorded on the
  current stream at its start and end, so they fire when the device reaches
  those points of its queue."""
  name: str
  id: int
  parent: Optional[int]
  call: int
  start_ns: int
  end_ns: Optional[int] = None
  start_event: Optional[torch.cuda.Event] = None
  end_event: Optional[torch.cuda.Event] = None

  @property
  def duration_ns(self) -> int:
    return self.end_ns - self.start_ns


@dataclasses.dataclass
class Recording:
  """What ``recording`` keeps: the spans in the order they opened, the
  clocks' anchor, and the CUDA event their device times are measured from
  (recorded when recording starts, or else with the first span that finds
  CUDA initialised). Spans nest in the order they open and close, so they
  are recorded from one thread."""
  anchor: Anchor
  spans: list[Span] = dataclasses.field(default_factory=list)
  reference: Optional[torch.cuda.Event] = None
  open_spans: list[Span] = dataclasses.field(default_factory=list)

  def children(self, span: Span) -> list[Span]:
    return [s for s in self.spans if s.parent == span.id]

  def self_ns(self, span: Span) -> int:
    """The span's duration less its children's."""
    return span.duration_ns - sum(c.duration_ns for c in self.children(span))

  def device_ms(self, span: Span) -> Optional[tuple[float, float]]:
    """(start, end) of the span on the device, in ms from ``reference``,
    once its work has run; None for a span recorded without CUDA."""
    if span.start_event is None:
      return None
    span.end_event.synchronize()
    return (self.reference.elapsed_time(span.start_event),
            self.reference.elapsed_time(span.end_event))

  def _event(self) -> Optional[torch.cuda.Event]:
    """A timing event recorded on the current stream, where CUDA is
    initialised; the first one made is the reference."""
    if not torch.cuda.is_initialized():
      return None
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    if self.reference is None:
      self.reference = event
    return event


_recording: Optional[Recording] = None


class _NoSpan:
  """The one context ``span`` returns while recording is off."""

  def __enter__(self):
    return None

  def __exit__(self, *exc):
    return False


_NO_SPAN = _NoSpan()


class _RecordedSpan:

  def __init__(self, record: Recording, name: str):
    self._record, self._name = record, name
    self._function = None  # the record_function range, under a profiler

  def __enter__(self) -> Span:
    record = self._record
    if torch.autograd.profiler._is_profiler_enabled:
      self._function = torch.profiler.record_function(self._name)
      self._function.__enter__()
    parent = record.open_spans[-1] if record.open_spans else None
    number = len(record.spans) + 1
    span = Span(self._name, number, parent.id if parent else None,
                parent.call if parent else number, time.perf_counter_ns())
    span.start_event = record._event()
    record.spans.append(span)
    record.open_spans.append(span)
    return span

  def __exit__(self, *exc):
    span = self._record.open_spans.pop()
    span.end_event = self._record._event() if span.start_event else None
    span.end_ns = time.perf_counter_ns()
    if self._function is not None:
      self._function.__exit__(*exc)
    return False


def span(name: str):
  """Marks a region of the program, for ``with span('layer.op'): ...``.

  While recording is off it returns one shared no-op context: no clock is
  read and no event recorded. While ``recording`` is on, the region is kept
  as a ``Span``; while a ``torch.profiler`` session is active it is also a
  ``record_function`` range of that name.
  """
  if _recording is None:
    return _NO_SPAN
  return _RecordedSpan(_recording, name)


@contextlib.contextmanager
def recording():
  """Turns span recording on for its duration and yields the
  ``Recording``, kept in memory (nothing is written). Inside another
  ``recording`` it yields that one.

  Example:
    with profiling.recording() as record:
      model.decode(params, frames, num_frames)
    for s in record.spans:
      print(s.name, s.duration_ns, record.device_ms(s))
  """
  global _recording
  if _recording is not None:
    yield _recording
    return
  record = Recording(Anchor.now())
  # The reference event now, so that making it costs no span its time
  # (about 2 ms on the host under a profiler, on an H100).
  record._event()
  _recording = record
  try:
    yield record
  finally:
    _recording = None


@contextlib.contextmanager
def trace(log_dir: str):
  """Captures a profiler trace into ``log_dir`` (a Chrome trace, viewable in
  Perfetto or TensorBoard), with CUDA activity when a card is present, and
  the program's spans recorded (yielded as the ``Recording``) and named in
  it.

  Example:
    with profiling.trace('/tmp/torch-trace'):
      step_fn(state, batch)
  """
  activities = [torch.profiler.ProfilerActivity.CPU]
  if torch.cuda.is_available():
    activities.append(torch.profiler.ProfilerActivity.CUDA)
  os.makedirs(log_dir, exist_ok=True)
  with torch.profiler.profile(
      activities=activities,
      on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
    with recording() as record:
      yield record


def _synchronize() -> None:
  """Waits for the card's queued work, where CUDA is in use."""
  if torch.cuda.is_available() and torch.cuda.is_initialized():
    torch.cuda.synchronize()


class StepTimer:
  """Wall-clock step timer with percentile reporting.

  Example:
    timer = StepTimer()
    for batch in data:
      with timer:
        step_fn(state, batch)
    print(timer.summary())
  """

  def __init__(self, skip_first: int = 1):
    self._times: list[float] = []
    self._skip = skip_first
    self._t0: Optional[float] = None

  def __enter__(self):
    _synchronize()
    self._t0 = time.perf_counter()
    return self

  def __exit__(self, *exc):
    _synchronize()
    elapsed = time.perf_counter() - self._t0
    if self._skip > 0:
      self._skip -= 1
    else:
      self._times.append(elapsed)
    return False

  @property
  def times(self) -> list[float]:
    return list(self._times)

  def percentile(self, q: float) -> float:
    if not self._times:
      return float('nan')
    return float(np.percentile(self._times, q))

  def summary(self) -> dict:
    return {
        'steps': len(self._times),
        'p50_ms': self.percentile(50) * 1e3,
        'p90_ms': self.percentile(90) * 1e3,
        'mean_ms': float(np.mean(self._times) * 1e3) if self._times else
                   float('nan'),
    }


def benchmark(fn: Callable, *args, iters: int = 5, warmup: int = 1) -> dict:
  """Times ``fn(*args)``: ``warmup`` untimed calls, then ``iters`` timed
  ones; returns ``StepTimer.summary()``."""
  timer = StepTimer(skip_first=0)
  for _ in range(warmup):
    fn(*args)
  for _ in range(iters):
    with timer:
      fn(*args)
  return timer.summary()
