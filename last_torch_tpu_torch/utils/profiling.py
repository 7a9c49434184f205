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

Counterpart of ``last_torch_tpu/utils/profiling.py``: ``trace`` captures a
``torch.profiler`` trace (CPU and, with a card, CUDA activity) into a
directory as a Chrome trace; ``named_scope`` labels a region in it;
``StepTimer`` times steps on the host clock and reports percentiles, and
``benchmark`` times a function with it. The timer synchronises the device
when it stops, so a step's time includes its kernels and not only their
launch.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

named_scope = torch.profiler.record_function


@contextlib.contextmanager
def trace(log_dir: str):
  """Captures a profiler trace into ``log_dir`` (a Chrome trace, viewable in
  Perfetto or TensorBoard), with CUDA activity when a card is present.

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
    yield


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
