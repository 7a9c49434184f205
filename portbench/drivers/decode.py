"""Closed-loop batch decoding: ``GNATModel.decode`` on a pool of batches,
one batch in flight, each call ending in a synchronize.

Set-up makes the model, the benchmark's seeded weights and the pool, and
decodes ``warmup_batches`` pool batches (every batch has the one padded
shape the window decodes). The window keeps every call's output. Once it
has closed, every utterance's output is checked for its form (as many
alignment labels as the alignment gives its frames, labels in 0..V, blank
past them and in each frame's blank slot), and a sample of the utterances
decoded, drawn from the seed and always holding the longest, is compared
with the reference's Viterbi decode of the same weights and frames: the
program's path weight against the reference's best, and against the
program's own alignment rescored under the reference's weights (an altered
label or weight shows there, a path the lower precision also finds does
not).
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any

import numpy as np
import torch

from portbench.harness import judge, port, traffic, weights
from portbench.reference import gnat as reference


@dataclasses.dataclass
class Session:
  cell: Any
  device: torch.device
  model: Any
  params: dict
  pool: list
  next_batch: int = 0
  calls: list = dataclasses.field(default_factory=list)
  failed: int = 0

  def decode(self):
    """One decode call on the next pool batch; returns (index, output)."""
    index = self.next_batch % len(self.pool)
    self.next_batch += 1
    batch = self.pool[index]
    return index, self.model.decode(self.params, batch.frames,
                                    batch.num_frames)


def setup(cell, seed: int, device: torch.device) -> Session:
  gnat = port.gnat()
  model = gnat.GNATModel(port.model_config(cell.config), device=device)
  generator = torch.Generator(device).manual_seed(seed)
  params = weights.make(cell.config, generator, device)
  pool = traffic.make_pool(cell.traffic, cell.config, seed, device)
  session = Session(cell, device, model, params, pool)
  for _ in range(cell.traffic['warmup_batches']):
    session.decode()
  port.sync(device)
  return session


def window(session: Session, seconds: float) -> dict:
  """Decodes until ``seconds`` have passed; the rate is every real frame of
  every call over the time from the window's start to the last call's
  end."""
  route = session.cell.config['routes']['decode']
  counters = port.Counters(route.get('counters', ()))
  device = session.device
  calls, frames = 0, 0
  port.sync(device)
  start = time.perf_counter()
  while True:
    index, output = session.decode()
    port.sync(device)
    now = time.perf_counter()
    calls += 1
    session.calls.append((index, output))
    frames += session.pool[index].real_frames
    if now - start >= seconds:
      break
  span = now - start
  batch = session.cell.traffic['batch']
  return {
      'metrics': {'decode_frames_per_s': {'value': frames / span,
                                          'unit': 'frames/s'}},
      'attempted': calls * batch, 'failed': 0, 'span_s': span,
      'units': calls, 'frames': frames,
      'batches': [index for index, _ in session.calls],
      'route_faults': port.route_faults(route, counters, calls,
                                        session.model.lattice, device),
      'notes': [f'window: {calls} decode calls ({calls * batch} utterances, '
                f'{frames} real frames) in {span!r} s'],
  }


def profile(session: Session, host) -> dict:
  """``profile_batches`` decode calls under the profiler, each call and its
  synchronize a host range."""
  from portbench.harness import trace
  calls = session.cell.traffic['profile_batches']

  def run():
    for _ in range(calls):
      with host('GNATModel.decode'):
        session.decode()
      with host('torch.cuda.synchronize'):
        torch.cuda.synchronize()

  _, spans = trace.device_spans(run)
  first, last = host.ranges[0][1][2], host.ranges[-1][2][2]
  return {'spans': spans, 'wall_s': (last - first) / 1e9, 'units': calls}


def malformed(output, num_frames, slots: int, vocab: int) -> torch.Tensor:
  """[B] whether each utterance's output departs from the decode's form."""
  labels, num_labels, weights_ = output
  b = labels.shape[0]
  position = torch.arange(labels.shape[1], device=labels.device)[None]
  bad = num_labels.long() != slots * num_frames
  bad |= ((labels < 0) | (labels > vocab)).any(dim=1)
  bad |= ((position >= num_labels[:, None]) & (labels != 0)).any(dim=1)
  per_frame = labels.view(b, -1, slots)
  bad |= (per_frame[:, :, -1] != 0).any(dim=1)
  bad |= ~torch.isfinite(weights_)
  return bad


def sample(session: Session, seed: int) -> list[tuple[int, int]]:
  """(call, row) of the utterances compared: the longest utterance decoded
  (in the last call of its batch), and ``check_utterances - 1`` others
  drawn from the seed among every utterance the window decoded."""
  batch = session.cell.traffic['batch']
  called = {p for p, _ in session.calls}
  longest = max(called, key=lambda p: max(session.pool[p].lengths))
  lengths = session.pool[longest].lengths
  first = (max(i for i, (p, _) in enumerate(session.calls) if p == longest),
           lengths.index(max(lengths)))
  every = len(session.calls) * batch
  count = min(session.cell.traffic['check_utterances'] - 1, every - 1)
  drawn = np.random.default_rng(seed).choice(every - 1, size=count,
                                             replace=False)
  skip = first[0] * batch + first[1]
  others = sorted(int(i) + int(i >= skip) for i in drawn)
  return [first] + [divmod(i, batch) for i in others]


def sampled(session: Session, seed: int):
  """(the sampled utterances as one batch, their alignment labels, their
  path weights), from the pool and the window's outputs."""
  chosen = sample(session, seed)
  frames, num_frames, labels, path_weights = [], [], [], []
  for call, row in chosen:
    index, (call_labels, _, call_weights) = session.calls[call]
    batch = session.pool[index]
    frames.append(batch.frames[row])
    num_frames.append(batch.num_frames[row])
    labels.append(call_labels[row])
    path_weights.append(call_weights[row])
  lengths = [int(n) for n in num_frames]
  return (traffic.Batch(torch.stack(frames), torch.stack(num_frames),
                        sum(lengths), lengths),
          torch.stack(labels), torch.stack(path_weights))


def reference_decode(cell, params, batch, head_dtype, labels=None):
  """(reference best path weight [B], the given alignments rescored under
  the reference's weights [B] float64 or None)."""
  config = cell.config
  reference.check_config(config)
  k = config['max_expansions']
  normalize = 'hat' if config['locally_normalized'] else 'none'
  with torch.no_grad(), reference.tf32(False):
    encoded = reference.encode(params['encoder'], batch.frames,
                               batch.num_frames, config['encoder_heads'])
    pc, pf = reference.projections(params['lattice'], encoded)
    wf = params['lattice']['weight_fn']
    best, _ = reference.viterbi(wf, pc, pf, batch.num_frames, k, head_dtype,
                                normalize, with_path=False)
    rescored = None
    if labels is not None:
      rescored = reference.rescore(wf, pc, pf, batch.num_frames, labels, k,
                                   head_dtype, normalize)
  return best, rescored


def compare(cell, params, batch, labels, path_weights,
            head_dtype) -> tuple[float, float]:
  """(weight gap, rescore gap) of decoded utterances against the
  reference's decode of the same weights and frames: the largest gap
  between a path weight and the reference's best path weight, and between
  a path weight and its own alignment rescored in float64 under the
  reference's weights, each over max(1, |best|)."""
  best, rescored = reference_decode(cell, params, batch, head_dtype, labels)
  scale = best.double().abs().clamp(min=1.0)
  path_weights = path_weights.double()
  return (judge.worst(((path_weights - best.double()).abs() / scale).tolist()),
          judge.worst(((path_weights - rescored).abs() / scale).tolist()))


def release(session: Session):
  """Drops the program's model and the window's outputs."""
  session.model = None
  session.calls = []
  gc.collect()
  if session.device.type == 'cuda':
    torch.cuda.empty_cache()


def check(session: Session, seed: int) -> list[dict]:
  """The form of every output, then the sampled utterances against the
  reference once the program's model is dropped."""
  cell = session.cell
  config = cell.config
  slots = config['max_expansions'] + 1
  bad = 0
  for index, output in session.calls:
    bad += int(malformed(output, session.pool[index].num_frames, slots,
                         config['vocab_size']).sum())
  session.failed = bad
  batch, labels, path_weights = sampled(session, seed)
  release(session)
  weight_gap, rescore_gap = compare(cell, session.params, batch, labels,
                                    path_weights,
                                    port.head_dtype(config, session.device))
  limits = cell.limits
  return [judge.number('malformed', bad, limits),
          judge.number('weight_gap', weight_gap, limits),
          judge.number('rescore_gap', rescore_gap, limits)]
