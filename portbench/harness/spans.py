"""The program's own spans in one recorded decode call, placed on the device
trace's clock, for the readers of ``encoder_ms.decode``,
``backtrace_device_ms.decode`` and ``host_held_ms.decode``.

Once a session, the first of those readers decodes the pool's first batch
(the batch ``viterbi_roofline`` reads) through ``session.model.decode``,
outside the window's record and the calls ``check`` samples. The call runs
with the program's span recording on (``utils/profiling.py::recording``),
under ``torch.cuda.set_sync_debug_mode('warn')``, inside
``trace.device_spans``. A span's device interval comes from the CUDA
events the program records at its start and end; its host interval is
moved onto the profiler's clock through the recording's anchor, on the
clock that ``trace.host_window_us`` finds. Device idle time inside the
call is put down, piece by piece, to the innermost span open over it on
the host. The result is kept on the session, so the readers share one
call. Without a card, without device activity, or with a program that
records no spans, the readers get None.
"""

from __future__ import annotations

import collections
import contextlib
import importlib
import sys
import time
import warnings
from typing import Optional

import torch

from portbench.harness import port, trace

# trace.HostRanges' order of the three clocks.
CLOCKS = ('time_ns', 'monotonic_ns', 'perf_counter_ns')
ROOT = 'gnat.decode'
CACHE = 'program_spans'
# What torch's sync debug mode warns with at each synchronising operation.
SYNC_WARNING = 'called a synchronizing CUDA operation'
# The caching allocator's counts of device allocations, frees (each
# cudaFree waits for the device) and retries after freeing its cache.
ALLOCATOR = ('num_device_alloc', 'num_device_free', 'num_alloc_retries')


def clocks(anchor, perf_counter_ns: int) -> tuple[int, int, int]:
  """A ``perf_counter_ns`` reading on each of ``CLOCKS``, through the
  recording's anchor (the three clocks read together)."""
  return tuple(anchor.on(clock, perf_counter_ns) for clock in CLOCKS)


def place(spans, anchor, end_ns: int, activities):
  """(clock index or None, {span id: (start us, end us)}): the spans' host
  intervals on the clock the device activities use. ``spans``: (name, id,
  parent, start ns, end ns) on ``perf_counter_ns``, the root first;
  ``end_ns``: the end of the synchronize after the call; the clock is
  ``trace.host_window_us``'s choice for the window from the root's start
  to ``end_ns``."""
  root = spans[0]
  host = trace.HostRanges([(root[0], clocks(anchor, root[3]),
                            clocks(anchor, root[4])),
                           ('torch.cuda.synchronize', clocks(anchor, root[4]),
                            clocks(anchor, end_ns))])
  _, _, index = trace.host_window_us(host, activities)
  if index is None:
    return None, {}
  return index, {s[1]: (clocks(anchor, s[3])[index] / 1e3,
                        clocks(anchor, s[4])[index] / 1e3) for s in spans}


def idle_gaps(activities, start: float, end: float):
  """The intervals of [start, end] (us) in which no activity ran."""
  edges = [start]
  for lo, hi in trace.busy_intervals(activities):
    if hi > start and lo < end:
      edges += [max(lo, start), min(hi, end)]
  edges.append(end)
  return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]


def depths(spans) -> dict[int, int]:
  """Span id -> its depth in the tree (a root is 0)."""
  parent = {s[1]: s[2] for s in spans}
  out = {}
  for sid in parent:
    depth, up = 0, parent[sid]
    while up is not None:
      depth, up = depth + 1, parent.get(up)
    out[sid] = depth
  return out


def attribute(gaps, spans, placed):
  """Each gap cut at the span edges inside it, each piece put down to the
  innermost span open over it on the host. Returns ({span name: us}, [(gap
  start, gap end, {span name: us})]); pieces outside every span are
  left out."""
  depth = depths(spans)
  names = {s[1]: s[0] for s in spans}
  total = collections.defaultdict(float)
  per_gap = []
  for start, end in gaps:
    cuts = sorted({start, end} | {x for lo, hi in placed.values()
                                  for x in (lo, hi) if start < x < end})
    split = collections.defaultdict(float)
    for lo, hi in zip(cuts, cuts[1:]):
      middle = (lo + hi) / 2
      open_ = [sid for sid, (a, b) in placed.items() if a <= middle <= b]
      if open_:
        split[names[max(open_, key=depth.get)]] += hi - lo
    for name, us in split.items():
      total[name] += us
    per_gap.append((start, end, dict(split)))
  return dict(total), per_gap


def device_on_clock(device, root: int, activities):
  """{span id: (start us, end us)}: the spans' device intervals, ``device``
  {span id: (start ms, end ms)} from the CUDA events, on the activities'
  clock, the root's end lined up with the last activity's end (the root
  ends right after the call's last kernel)."""
  offset = max(a[1] for a in activities) - device[root][1] * 1e3
  return {sid: (lo * 1e3 + offset, hi * 1e3 + offset)
          for sid, (lo, hi) in device.items()}


def kernels_by_span(placed, spans, activities, top: int = 3):
  """{span name: [(kernel name, device s)], the ``top`` longest}: each
  activity put down to the innermost span whose device interval
  (``device_on_clock``) holds its middle."""
  depth = depths(spans)
  names = {s[1]: s[0] for s in spans}
  found = collections.defaultdict(lambda: collections.defaultdict(float))
  for start, end, kernel in activities:
    middle = (start + end) / 2
    open_ = [sid for sid, (a, b) in placed.items() if a <= middle <= b]
    name = names[max(open_, key=depth.get)] if open_ else 'outside any span'
    found[name][kernel[:60]] += (end - start) / 1e6
  return {name: sorted(kernels.items(), key=lambda k: -k[1])[:top]
          for name, kernels in found.items()}


@contextlib.contextmanager
def counted_syncs(record, counts: collections.Counter,
                  sites: collections.Counter):
  """Counts the synchronising operations torch flags in ``'warn'`` sync
  debug mode, by the innermost program span open when each ran, and by
  that span and the Python line that ran it."""
  previous = torch.cuda.get_sync_debug_mode()
  with warnings.catch_warnings():
    warnings.simplefilter('always')
    shown = warnings.showwarning

    def count(message, category, filename, lineno, *rest):
      if SYNC_WARNING in str(message):
        innermost = (record.open_spans[-1].name if record.open_spans else
                     'outside any span')
        counts[innermost] += 1
        sites[f'{innermost} at {filename}:{lineno}'] += 1
      else:
        shown(message, category, filename, lineno, *rest)

    warnings.showwarning = count
    torch.cuda.set_sync_debug_mode('warn')
    try:
      yield
    finally:
      torch.cuda.set_sync_debug_mode(previous)


def recorded(ctx) -> Optional[dict]:
  """The recorded call's readings (``read_call``), once a session."""
  session = ctx.session
  if not hasattr(session, CACHE):
    found = None
    if ctx.device.type == 'cuda' and ctx.profile:
      found = read_call(session)
    setattr(session, CACHE, found)
  return getattr(session, CACHE)


def note(text: str):
  print(f'spans: {text}', file=sys.stderr)


def read_call(session) -> Optional[dict]:
  """Decodes the pool's first batch once on the card with the program's
  spans recorded. Returns {'clock', 'device_ms' (by span name),
  'call_device_ms' (first activity start to last activity end), 'held_us'
  (device idle by span, None without a clock), 'gaps' (the ten longest:
  start ms from the call's start, ms, split by span), 'syncs' (by span),
  'sync_sites' (by span and line)}; None where the program records no
  spans."""
  profiling = importlib.import_module(f'{port.PORT}.utils.profiling')
  recording = getattr(profiling, 'recording', None)
  if recording is None:
    note('the program records no spans: no readings')
    return None
  batch = session.pool[0]
  syncs, sites = collections.Counter(), collections.Counter()

  def call():
    before = torch.cuda.memory_stats()
    with recording() as record:
      with counted_syncs(record, syncs, sites):
        session.model.decode(session.params, batch.frames, batch.num_frames)
    torch.cuda.synchronize()
    end_ns = time.perf_counter_ns()
    after = torch.cuda.memory_stats()
    return record, end_ns, {k: after.get(k, 0) - before.get(k, 0)
                            for k in ALLOCATOR}

  (record, end_ns, allocator), activities = trace.device_spans(call)
  note(f'caching allocator during the call: {allocator}')
  roots = [s.id for s in record.spans if s.name == ROOT and s.parent is None]
  if not roots:
    note(f'the call recorded no {ROOT} span: no readings')
    return None
  mine = [s for s in record.spans if s.call == roots[0]]
  spans = [(s.name, s.id, s.parent, s.start_ns, s.end_ns) for s in mine]
  device = {s.id: record.device_ms(s) for s in mine}
  device_ms = collections.defaultdict(float)
  for s in mine:
    device_ms[s.name] += device[s.id][1] - device[s.id][0]
  call_ms = (max(a[1] for a in activities) - activities[0][0]) / 1e3
  children = sum(ms for name, ms in device_ms.items() if name != ROOT)
  note('device ms by span (CUDA events): ' + ', '.join(
      f'{name} {ms!r}' for name, ms in device_ms.items()))
  note(f'spans below {ROOT} sum to {children!r} ms of the call\'s device '
       f'interval {call_ms!r} ms (first activity start to last end): '
       f'{100 * children / call_ms!r}%')
  on_device = device_on_clock(device, roots[0], activities)
  for name, kernels in kernels_by_span(on_device, spans, activities).items():
    note(f'{name}: longest kernels (device s): {kernels}')
  index, placed = place(spans, record.anchor, end_ns, activities)
  held, gaps = None, []
  if index is None:
    note('no clock puts the device activities inside the call: spans not '
         'placed')
  else:
    note(f'spans placed on the profiler\'s clock: time.{CLOCKS[index]}')
    start = placed[spans[0][1]][0]
    end = max(placed[spans[0][1]][1], max(a[1] for a in activities))
    for name, sid, *_ in spans:
      host = [(x - start) / 1e3 for x in placed[sid]]
      dev = [(x - start) / 1e3 for x in on_device[sid]]
      note(f'{name}: ms from the call\'s start on the host {host!r}, on the '
           f'device {dev!r}')
    held, per_gap = attribute(idle_gaps(activities, start, end), spans,
                              placed)
    per_gap.sort(key=lambda g: g[0] - g[1])
    gaps = [((lo - start) / 1e3, (hi - lo) / 1e3,
             {name: us / 1e3 for name, us in split.items()})
            for lo, hi, split in per_gap[:10]]
  return {'clock': None if index is None else CLOCKS[index],
          'device_ms': dict(device_ms), 'call_device_ms': call_ms,
          'held_us': held, 'gaps': gaps, 'syncs': dict(syncs),
          'sync_sites': dict(sites)}
