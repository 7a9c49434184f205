"""One run of one cell: set-up, the measured window, the traced window
with the per-layer readers (``--trace 1``), the correctness comparison,
and the result line.

The driver (``drivers/<kind>.py``, named by the traffic mix) supplies
``setup``, ``window``, ``profile`` and ``check``; this module times set-up,
reads the memory peak, runs the readers, judges, and prints.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import sys
import time
from typing import Any, Optional

import torch

from portbench.harness import judge, port, spec, trace

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'last_torch_tpu')


def forbidden_modules() -> list[str]:
  """Loaded modules whose top-level name, compared whole, is JAX's or the
  JAX package's (``last_torch_tpu_torch`` is neither)."""
  return sorted(name for name in list(sys.modules)
                if name.split('.')[0] in FORBIDDEN)


@dataclasses.dataclass
class Context:
  """What a per-layer reader reads: the cell, the driver's session, the
  measured window's record and the traced window's."""
  cell: spec.Cell
  session: Any
  window: dict
  profile: Optional[dict]
  device: torch.device


def memory_peak(device: torch.device) -> int:
  return torch.cuda.max_memory_allocated() if device.type == 'cuda' else 0


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool,
        device: torch.device, started: float):
  """Runs the cell once. Returns (the result object, the numbers compared,
  notes for standard error). ``started``: ``time.perf_counter()`` at
  process start."""
  driver = spec.driver(cell)
  session = driver.setup(cell, seed, device)
  port.sync(device)
  setup_s = time.perf_counter() - started
  setup_peak = memory_peak(device)
  if device.type == 'cuda':
    torch.cuda.reset_peak_memory_stats()
  window = driver.window(session, seconds)
  window['peak_bytes'] = memory_peak(device)
  peak = max(setup_peak, window['peak_bytes'])
  found = forbidden_modules()
  if found:
    raise SystemExit(f'modules of JAX or the JAX package are loaded: {found}')

  result: dict[str, Any] = {'correct': False,
                            'attempted': window['attempted'],
                            'failed': window['failed']}
  device_info = {'platform': 'gpu' if device.type == 'cuda' else 'cpu',
                 'kind': (torch.cuda.get_device_name(0)
                          if device.type == 'cuda' else 'cpu'),
                 'count': cell.chips, 'memory_peak_bytes': peak}
  if traced:
    host = trace.HostRanges()
    profiled = driver.profile(session, host)
    reduced = trace.reduce(profiled['spans'], host, profiled['wall_s'])
    profiled.update(reduced)
    context = Context(cell, session, window, profiled, device)
    metrics = {}
    for metric in cell.per_layer:
      value = spec.metric_reader(cell, metric['name'])(context)
      if value is not None:
        metrics[metric['name']] = {'value': float(value),
                                   'unit': metric['unit']}
    device_info['busy_s'] = reduced['busy_s']
    device_info['window_s'] = reduced['window_s']
    result['breakdown'] = reduced['breakdown']
  else:
    metrics = {'setup_s': {'value': setup_s, 'unit': 's'}}
    metrics.update(window['metrics'])
  result['metrics'] = metrics
  result['device'] = device_info

  checked = time.perf_counter()
  numbers = driver.check(session, seed)
  window.setdefault('notes', []).append(
      f'check: the comparison took {time.perf_counter() - checked!r} s')
  gc.collect()
  numbers.append(judge.number('route_faults', len(window['route_faults']),
                              {'route_faults': {'limit': 0}}))
  result['failed'] += getattr(session, 'failed', 0)
  result['correct'] = judge.verdict(numbers)
  result['compared'] = {n['name']: {'value': n['value'], 'limit': n['limit']}
                        for n in numbers}
  notes = window.get('notes', []) + [
      f'route fault: {fault}' for fault in window['route_faults']]
  return result, numbers, notes


def report(result: dict, numbers: list[dict], window_notes: list[str]):
  """Prints the notes and the numbers compared on standard error, the
  numbers last, then the result line on standard output."""
  for note in window_notes:
    print(note, file=sys.stderr)
  for n in numbers:
    print(f'compared {n["name"]} {n["value"]!r} limit {n["limit"]!r}',
          file=sys.stderr)
  sys.stderr.flush()
  print(json.dumps(result), flush=True)
