#!/usr/bin/env python3
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

"""The redesigned bfloat16 kernels of two trees, timed in turns on one GPU.

Run from the root of a checkout, with an older tree unpacked beside it
(``git archive <commit> | tar -x -C _archive/parent``)::

  python3 tools/ab_kernels.py --parent _archive/parent [--cases ...]

It runs, each in its own process and in this order, the plain versions of
this checkout, then the kernels of the parent, this checkout, this checkout
and the parent (each tree builds its own ``csrc/`` into its ``_build/``).
Each run times, with CUDA events after a warm-up:

* ``lp8``: ``fused_backward`` ('cache', bf16, FLD(2), S=1025, V=1024,
  h=512) at ``chip_smoke.py`` phase 6's shape (B=8, T_max=1600, its
  lengths), the mean of 2 calls;
* ``lp32``: the same at bench.py's headline (B=32, T=1600, every row full),
  one call;
* ``lp9o``: ``fused_backward`` in 'online' mode at bench.py's config 9
  (B=8, T=200, S=4097, V=4096, h=512, FLD(2), bf16), one call;
  ``lp9o512``: the same with d_lex formed 512 states at a time
  (``ONLINE_CHUNK_STATES``); ``lp9omem``: the device memory (MiB) that one
  such backward allocates beyond what was allocated before it (its peak);
* ``fr1024`` / ``fr256``: ``frame_reduce_backward`` (bf16, B=8, S=1025,
  h=512) at Vl=1024 and at one of 4 shards (Vl=256), phase 12b's inputs, the
  mean of 10 calls;
* ``jhf``: ``joint_head_forward`` (bf16, B=8, S=1025, V=1024, h=512),
  ``chip_smoke.py`` phase 11b's headline inputs, the mean of 100 calls
  back to back (a call this short can be bound by its host work);
  ``jhfd``: its device time per call, the summed kernel durations of 100
  calls under ``torch.profiler``;
* ``lp8f``, ``lp32f``, ``lp9f``: ``fused_forward`` ('cache', bf16, FLD(2),
  with the residuals the backward reads) at the shapes of ``lp8``,
  ``lp32`` and config 9 (B=8, T=200, S=4097, V=4096), one call each;
  ``lp9of``: the 'online' forward at config 9; ``lp8fp``: one ``lp8f``
  call (after a warm-up) under ``torch.profiler``, its device time by
  kernel name;
* ``fr1024f`` / ``fr256f``: ``frame_reduce_forward`` (bf16, B=8, S=1025,
  h=512, phase 12b's inputs) at Vl=1024 and 256, the mean of 100 calls
  back to back; ``fr1024fd`` / ``fr256fd``: its device time per call;
* ``fr256fh`` / ``jhfh``: the host's time per call of ``fr256f`` /
  ``jhf``: the wall time of 100 calls issued with no synchronisation,
  divided by 100 (too few launches to fill the device's queue, so the host
  never waits); ``fr256fa`` / ``jhfa``: of that, the time per call spent
  in CUDA runtime and driver calls (launches, tensor maps, attributes),
  under ``torch.profiler``;
* ``jhfk``, ``jhfi``, ``jhfo``: a timeline of 32 back-to-back
  ``jhf`` calls under ``torch.profiler`` (the device's kernels in start
  order): the median per call of the kernels' summed durations, of the
  gap between a call's two kernels (joint pass, product), and of the gap
  from a call's product to the next call's joint pass;
* ``jhb``, ``jhbd``, ``jhbh``: ``joint_head_backward`` (bf16, B=8,
  S=1025, V=1024, h=512, phase 11b's inputs and cotangents) per call over
  100 calls back to back, its device time and its host time per call;
* ``jhf32m`` / ``jhb32m``: ``joint_head_forward`` / ``_backward`` in
  float32 at the MWER step's beta-pass shape (B=8, S=1025, V=1024, h=512),
  per call over 100 calls back to back; ``jhf32t`` / ``jhb32t``: the same at
  the trigram probe's shape (B=8, S=4161, V=64, h=512); a ``d`` suffix
  (``jhf32md``, ...): the device time per call; a ``p`` suffix: one call's
  device time by kernel name; an ``l`` suffix: the library composition of
  the same function (``chip_smoke.py``'s ``joint_head_library``: tanh and
  addmm; its backward's two mm and the tanh derivative), the same in every
  tree;
* ``numb8``: ``numerator_backward`` in float32 (hat) at ``chip_smoke.py``
  phase 6b's HAT step shape (B=8, T_max=1600, U+1=101, h=512, V=1024,
  the lengths of ``lp8``, U_b = T_b // 16 labels, cotangents zero past
  them as the string DP's), one call; ``numb32``: in bfloat16 at bench.py's
  config 7 (B=32, T=1600, U=100, every row full), one call; ``jhbp``,
  ``numb8p``, ``numb32p``: one call of ``jhb`` (after a warm-up),
  ``numb8`` or ``numb32`` under ``torch.profiler``, its device time by
  kernel name (ms, summed over launches);
* ``vit8``: ``viterbi_forward`` (bf16, normalize 'none', FLD(2), S=1025,
  V=1024, h=512) at ``chip_smoke.py`` phase 4's shape (B=8, T_max=1600,
  its lengths), one call; ``vit8h``: the same with normalize 'hat' (phase
  4b); ``vit10``: at V=4096 (S=4097) and the lengths / 8 (phase 9's
  decode, bench config 10); ``vit8p``: one ``vit8`` call under
  ``torch.profiler``, its device time by kernel name;
* ``marg8``: ``fused_marginals`` (bf16, FLD(2), S=1025, V=1024, h=512) at
  ``lp8``'s shape, on forward residuals made once, one call; ``marg32``:
  the same at bench.py's config 8 (B=32, T=1600, every row full);
  ``margmem``: the device memory (MiB) one ``marg32`` call allocates beyond
  what was allocated before it (its peak); ``marg8p``: one ``marg8`` call
  under ``torch.profiler``, its device time by kernel name;
* ``numf8``: ``numerator_forward`` in float32 (hat) at ``numb8``'s shape
  and inputs, one call; ``numf32``: in bfloat16 at ``numb32``'s (config
  7); ``numf8p``, ``numf32p``: one call of each under ``torch.profiler``,
  its device time by kernel name;
* ``tri10f`` / ``tri10b``: ``trigram_forward`` / ``trigram_backward``
  (bf16, FLD(2), V=64, S=4161, h=512) at ``chip_smoke.py`` phase 10's
  shape (B=8, T_max=200, the lengths of ``lp8`` / 8: 1033 real frames),
  the backward on forward residuals made once, the mean of 3 calls;
  ``tri8f`` / ``tri8b``: the same at the JAX package's trigram probe
  shape (B=8, every row T=200); ``tri8fp`` / ``tri8bp``: one probe call
  under ``torch.profiler``, its device time by kernel name;
  ``trifmem`` / ``tribmem``: the MiB one probe forward / backward
  allocates beyond what was allocated before it (its peak).

Prints the card's name and power limit, one line per run, and one JSON
object of milliseconds (MiB for ``lp9omem`` and ``margmem``) by run and
case. ``--rounds R`` repeats the parent, change, change, parent turns R
times (the plain run stays one, and ``--no-plain`` drops it). ``--tree DIR
--cases ...`` runs one tree in this process (what the turns call).
"""

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

# chip_smoke.py (the library compositions) from the checkout that holds this
# script; a tree timed with --tree goes before it on the path.
sys.path.append(str(pathlib.Path(__file__).resolve().parent.parent))

NUM_FRAMES = [1600, 1523, 1400, 1211, 1000, 804, 517, 230]
CASES = ('lp8', 'lp32', 'lp9o', 'lp9o512', 'lp9omem', 'fr1024', 'fr256',
         'jhf', 'jhfd', 'jhfh', 'jhfa', 'jhfk', 'jhfi', 'jhfo', 'lp8f',
         'lp32f', 'lp9f', 'lp9of', 'fr1024f', 'fr256f', 'fr1024fd',
         'fr256fd', 'fr256fh', 'fr256fa', 'jhb', 'jhbd', 'jhbh', 'jhbp',
         'numb8', 'numb32', 'numb8p', 'numb32p', 'vit8', 'vit8h', 'vit10',
         'vit8p', 'lp8fp', 'marg8', 'marg32', 'margmem', 'marg8p', 'numf8',
         'numf32', 'numf8p', 'numf32p', 'tri10f', 'tri10b', 'tri8f',
         'tri8b', 'tri8fp', 'tri8bp', 'trifmem', 'tribmem', 'jhf32m',
         'jhb32m', 'jhf32t', 'jhb32t', 'jhf32md', 'jhb32md', 'jhf32td',
         'jhb32td', 'jhf32mp', 'jhb32mp', 'jhf32tp', 'jhb32tp', 'jhf32ml',
         'jhb32ml', 'jhf32tl', 'jhb32tl')
# The float32 joint+head cases' shapes (B=8, h=512): (S, V).
JH_F32_SHAPES = {'m': (1025, 1024), 't': (4161, 64)}
# The trigram cases' lengths (B=8, T_max=200): phase 10's, the probe's.
TRIGRAM_LENGTHS = {'tri10': [n // 8 for n in NUM_FRAMES], 'tri8': [200] * 8}


# The forward cases: (shape, mode).
LP_SHAPES = {'lp8': (8, NUM_FRAMES, 1600, 1024),
             'lp32': (32, [1600] * 32, 1600, 1024),
             'lp9': (8, [200] * 8, 200, 4096)}
FORWARD_CASES = {'lp8f': ('lp8', 'cache'), 'lp32f': ('lp32', 'cache'),
                 'lp9f': ('lp9', 'cache'), 'lp9of': ('lp9', 'online'),
                 'lp8fp': ('lp8', 'cache')}
# How a call is timed (``timed``, ``device_time``, ``host_time``,
# ``api_time``), by the case's last letter.
CLOCKS = {'d': 'device', 'h': 'host', 'a': 'api'}
FRAME_REDUCE_FORWARD_CASES = {'fr1024f': 1024, 'fr256f': 256,
                              'fr1024fd': 1024, 'fr256fd': 256,
                              'fr256fh': 256, 'fr256fa': 256}


def timed(torch, fn, repeats):
  """(result of the last call, mean ms per call) with CUDA events."""
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(repeats):
    out = fn()
  end.record()
  torch.cuda.synchronize()
  return out, start.elapsed_time(end) / repeats


def host_time(torch, fn, repeats):
  """ms of host time per call of fn: repeats calls issued back to back
  with no synchronisation."""
  fn()
  torch.cuda.synchronize()
  start = time.perf_counter()
  for _ in range(repeats):
    fn()
  elapsed = time.perf_counter() - start
  torch.cuda.synchronize()
  return elapsed * 1e3 / repeats


def api_time(torch, fn, repeats):
  """ms per call of fn spent in CUDA runtime and driver calls, under
  torch.profiler."""
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    for _ in range(repeats):
      fn()
    torch.cuda.synchronize()
  cuda = torch.autograd.DeviceType.CUDA
  total_ns = sum(e.end_ns() - e.start_ns()
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() != cuda and e.name().startswith('cu')
                 and 'Synchronize' not in e.name())
  return total_ns / repeats / 1e6


def clocked(torch, fn, clock, repeats=100):
  """ms per call of fn by ``clock`` (a value of CLOCKS, or None for the
  mean of back-to-back calls with CUDA events)."""
  if clock is None:
    return timed(torch, fn, repeats)[1]
  return {'device': device_time, 'host': host_time,
          'api': api_time}[clock](torch, fn, repeats)


def rand(rng, shape, scale=1.0):
  return (rng.standard_normal(shape) * scale).astype(np.float32)


def peak_mib(torch, call):
  """The MiB one call allocates at its peak beyond what was allocated
  before it."""
  torch.cuda.synchronize()
  before = torch.cuda.memory_allocated()
  torch.cuda.reset_peak_memory_stats()
  call()
  torch.cuda.synchronize()
  return (torch.cuda.max_memory_allocated() - before) / 2**20


def lattice_inputs(torch, batch, lengths, max_t, vocab):
  """(pf, pc, head, is_pad) of the bigram cases (h=512), from seed 0."""
  rng = np.random.default_rng(0)
  hidden = 512
  cuda = lambda x: torch.from_numpy(x).cuda()
  pf = cuda(rand(rng, (max_t, batch, hidden)))
  pc = cuda(rand(rng, (vocab + 1, hidden)))
  head = {'vocab_w': cuda(rand(rng, (hidden, vocab), hidden**-0.5)),
          'vocab_b': cuda(rand(rng, (vocab,), 0.1)),
          'blank_w': cuda(rand(rng, (hidden,), hidden**-0.5)),
          'blank_b': torch.tensor(0.3, device='cuda')}
  is_pad = (torch.arange(max_t, device='cuda')[:, None] >=
            torch.tensor(lengths, device='cuda')[None])
  return pf, pc, head, is_pad


def marginals_ms(torch, fused_scan, batch, lengths, plain, clock=None):
  """ms of one ``fused_marginals`` (bf16, FLD(2), T=1600, V=1024) at
  (batch, lengths) on the forward kernel's residuals, made once; with
  ``clock`` 'mem' the MiB it allocates at its peak, with 'p' its device
  time by kernel name."""
  pf, pc, head, is_pad = lattice_inputs(torch, batch, lengths, 1600, 1024)
  kw = dict(max_expansions=2, frame_dependent=False,
            compute_dtype=torch.bfloat16)
  log_z, _, hist, slabs = fused_scan.fused_forward(
      pf, pc, head, is_pad, with_residuals=True, **kw)
  marginals = (fused_scan.fused_marginals_plain if plain else
               fused_scan.fused_marginals)
  call = lambda: marginals(pf, pc, head, is_pad, log_z, hist, slabs, **kw)
  if clock == 'mem':
    return peak_mib(torch, call)
  return by_kernel(torch, call) if clock == 'p' else timed(torch, call, 1)[1]


def log_partition_ms(torch, fused_scan, batch, lengths, plain, repeats,
                     max_t=1600, vocab=1024, mode='cache', memory=False,
                     forward_only=False, profiled=False):
  """ms of one bigram backward (or with ``forward_only`` forward, by kernel
  name with ``profiled``) in ``mode`` at (batch, lengths), or with
  ``memory`` the MiB the backward allocates at its peak beyond what was
  allocated before it."""
  pf, pc, head, is_pad = lattice_inputs(torch, batch, lengths, max_t, vocab)
  kw = dict(max_expansions=2, frame_dependent=False,
            compute_dtype=torch.bfloat16, mode=mode)
  forward = fused_scan.fused_forward_plain if plain else (
      fused_scan.fused_forward)
  backward = fused_scan.fused_backward_plain if plain else (
      fused_scan.fused_backward)
  if forward_only:
    call = lambda: forward(pf, pc, head, is_pad, with_residuals=True, **kw)
    return by_kernel(torch, call) if profiled else timed(torch, call,
                                                         repeats)[1]
  log_z, _, hist, slabs = forward(pf, pc, head, is_pad, with_residuals=True,
                                  **kw)
  g = torch.ones(batch, device='cuda')
  call = lambda: backward(pf, pc, head, is_pad, log_z, g, hist, slabs, **kw)
  if memory:
    return peak_mib(torch, call)
  return timed(torch, call, repeats)[1]


def trigram_ms(torch, trigram_scan, case, plain):
  """ms of one trigram forward or backward (bf16, FLD(2), V=64, S=4161,
  h=512) at the case's lengths (``TRIGRAM_LENGTHS``), the mean of 3 calls;
  by kernel name for the 'p' cases, the peak MiB for the 'mem' ones."""
  lengths = TRIGRAM_LENGTHS['tri10' if case.startswith('tri10') else 'tri8']
  vocab, hidden, max_t, batch = 64, 512, 200, len(lengths)
  rng = np.random.default_rng(0)
  cuda = lambda x: torch.from_numpy(x).cuda()
  pf = cuda(rand(rng, (max_t, batch, hidden), 0.5))
  pc = cuda(rand(rng, (1 + vocab + vocab**2, hidden), 0.5))
  head = {'vocab_w': cuda(rand(rng, (hidden, vocab), hidden**-0.5)),
          'vocab_b': cuda(rand(rng, (vocab,), 0.1)),
          'blank_w': cuda(rand(rng, (hidden,), hidden**-0.5)),
          'blank_b': torch.tensor(0.3, device='cuda')}
  is_pad = (torch.arange(max_t, device='cuda')[:, None] >=
            torch.tensor(lengths, device='cuda')[None])
  kw = dict(max_expansions=2, frame_dependent=False,
            compute_dtype=torch.bfloat16)
  forward = (trigram_scan.trigram_forward_plain if plain else
             trigram_scan.trigram_forward)
  backward = (trigram_scan.trigram_backward_plain if plain else
              trigram_scan.trigram_backward)
  call = lambda: forward(pf, pc, head, is_pad, with_residuals=True, **kw)
  if case in ('tri10b', 'tri8b', 'tri8bp', 'tribmem'):
    log_z, _, hist, slabs = call()
    g = torch.ones(batch, device='cuda')
    call = lambda: backward(pf, pc, head, is_pad, log_z, g, hist, slabs,
                            **kw)
  if case.endswith('mem'):
    return peak_mib(torch, call)
  return by_kernel(torch, call) if case.endswith('p') else timed(
      torch, call, 3)[1]


def frame_reduce_ms(torch, sharded_scan, vocab, direction, plain,
                    clock=None):
  """ms of one frame_reduce backward at B=8, S=1025, h=512, Vl=vocab, on
  inputs drawn as chip_smoke.py's phase 12b draws them; with ``direction``
  'forward' of one forward, by ``clock`` (``clocked``) over 100 calls."""
  rng = np.random.default_rng(13)
  batch, states, hidden = 8, 1025, 512
  cuda = lambda x: torch.from_numpy(x).cuda()
  vec = rand(rng, (batch, states), 3.0)
  vec[:, rng.random(states) < 0.25] = -np.inf
  vec[:, 0] = 0.0
  inputs = {'vec': cuda(vec), 'pf_t': cuda(rand(rng, (batch, hidden), 0.5)),
            'pc': cuda(rand(rng, (states, hidden), 0.5)),
            'vw': cuda(rand(rng, (hidden, vocab), hidden**-0.5)),
            'vb': cuda(rand(rng, (vocab,), 0.1)),
            'bw': cuda(rand(rng, (hidden,), hidden**-0.5)),
            'bb': torch.tensor(0.3, device='cuda')}
  d_red = cuda(rand(rng, (batch, vocab)))
  d_blank = cuda(rand(rng, (batch, states)))
  dtype = torch.bfloat16
  if direction != 'backward':
    forward = (sharded_scan.frame_reduce_plain if plain else
               sharded_scan.frame_reduce_forward)
    call = lambda: forward(**inputs, compute_dtype=dtype)
    return clocked(torch, call, clock)
  red = sharded_scan.frame_reduce_plain(**inputs, compute_dtype=dtype)[0]
  backward = (sharded_scan.frame_reduce_backward_plain if plain else
              sharded_scan.frame_reduce_backward)
  args = [inputs[n] for n in ('vec', 'pf_t', 'pc', 'vw', 'vb', 'bw')]
  return timed(torch, lambda: backward(*args, red, d_red, d_blank,
                                       compute_dtype=dtype), 10)[1]


def device_time(torch, fn, repeats):
  """ms of device activity per call of fn, under torch.profiler."""
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(repeats):
      fn()
    torch.cuda.synchronize()
  cuda = torch.autograd.DeviceType.CUDA
  total_ns = sum(e.end_ns() - e.start_ns()
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == cuda)
  return total_ns / repeats / 1e6


def timeline(torch, fn, calls=32):
  """{'k': kernel ms, 'i': the gap between a call's kernels, 'o': the gap
  from a call's last kernel to the next call's first}, each the median per
  call over ``calls`` back-to-back calls of fn, from torch.profiler's
  device events in start order. A call starts at each event named as the
  first one (fn's first kernel)."""
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(calls):
      fn()
    torch.cuda.synchronize()
  cuda = torch.autograd.DeviceType.CUDA
  events = sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == cuda)
  groups = []
  for start, end, name in events:
    if not groups or name == events[0][2]:
      groups.append([])
    groups[-1].append((start, end))
  median = lambda xs: float(np.median(xs)) / 1e6 if xs else None
  kernels, inner, outer = [], [], []
  for mine, after in zip(groups, groups[1:] + [None]):
    kernels.append(sum(end - start for start, end in mine))
    inner += [b[0] - a[1] for a, b in zip(mine, mine[1:])]
    if after:
      outer.append(after[0][0] - mine[-1][1])
  return {'k': median(kernels), 'i': median(inner), 'o': median(outer)}


def by_kernel(torch, fn):
  """{kernel name: ms} of one call of fn (after a warm-up) under
  torch.profiler, each name's device time summed over its launches."""
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    fn()
    torch.cuda.synchronize()
  cuda = torch.autograd.DeviceType.CUDA
  out = {}
  for e in prof.profiler.kineto_results.events():
    if e.device_type() == cuda:
      name = e.name().replace('(anonymous namespace)::', '')
      name = name.removeprefix('void ').split('(')[0].split('<')[0].strip()
      out[name] = out.get(name, 0.0) + (e.end_ns() - e.start_ns()) / 1e6
  return out


def joint_head_ms(torch, joint_head, plain, clock=None, backward=False,
                  states=1025, vocab=1024, dtype=None, library=False):
  """ms of one joint+head forward (or, with ``backward``, backward) at
  B=8, S=states, V=vocab, h=512, in ``dtype`` (bf16 by default), on inputs
  drawn as chip_smoke.py's phase 11b draws them, by ``clock``
  (``clocked``) over 100 calls, or with a ``timeline`` key ('k', 'i', 'o')
  that number of the timeline, or with 'p' one call's device time by
  kernel name. With ``library`` the library composition instead."""
  rng = np.random.default_rng(12)
  batch, hidden = 8, 512
  cuda = lambda x: torch.from_numpy(x).cuda()
  inputs = {'pc': cuda(rand(rng, (states, hidden), 0.5)),
            'pf': cuda(rand(rng, (batch, hidden), 0.5)),
            'vocab_w': cuda(rand(rng, (hidden, vocab), hidden**-0.5)),
            'blank_w': cuda(rand(rng, (hidden,), hidden**-0.5)),
            'vocab_b': cuda(rand(rng, (vocab,), 0.1)),
            'blank_b': torch.tensor(0.3, device='cuda')}
  dtype = dtype or torch.bfloat16
  g_blank = cuda(rand(rng, (batch, states)))
  g_lexical = cuda(rand(rng, (batch, states, vocab)))
  if library:
    import chip_smoke  # the checkout's, beside tools/
    forward, backward_ = chip_smoke.joint_head_library(torch, inputs, g_blank,
                                                       g_lexical, dtype)
    call = backward_ if backward else forward
  elif backward:
    step = (joint_head.joint_head_backward_plain if plain else
            joint_head.joint_head_backward)
    args = [inputs[n] for n in ('pc', 'pf', 'vocab_w', 'blank_w')]
    call = lambda: step(*args, g_blank, g_lexical, compute_dtype=dtype)
  else:
    forward = (joint_head.joint_head_forward_plain if plain else
               joint_head.joint_head_forward)
    call = lambda: forward(**inputs, compute_dtype=dtype)
  if clock in ('k', 'i', 'o'):
    return timeline(torch, call)[clock]
  if clock == 'p':
    return by_kernel(torch, call)
  return clocked(torch, call, clock)


def numerator_backward_ms(torch, numerator_scan, batch, lengths, dtype,
                          plain, profiled=False, forward=False):
  """ms of one numerator backward (hat) at (batch, lengths), T_max=1600,
  U+1=101, h=512, V=1024: random inputs, cotangents zero at frames past a
  row's length and label positions past its T_b // 16 labels (the string
  DP's mask; 100 labels at full length); with ``forward`` of one forward
  on the same inputs (every (frame, position) pair: it has no lengths).
  With ``profiled`` the call's device time by kernel name."""
  rng = np.random.default_rng(14)
  max_t, u1, hidden, vocab = 1600, 101, 512, 1024
  rows = batch * u1
  cuda = lambda x: torch.from_numpy(x).cuda()
  head = {'vocab_w': cuda(rand(rng, (hidden, vocab), hidden**-0.5)),
          'vocab_b': cuda(rand(rng, (vocab,), 0.1)),
          'blank_w': cuda(rand(rng, (hidden,), hidden**-0.5)),
          'blank_b': torch.tensor(0.3, device='cuda')}
  pc, wy = (cuda(rand(rng, (rows, hidden), s)) for s in (0.5, hidden**-0.5))
  pf = cuda(rand(rng, (max_t, batch, hidden), 0.5))
  by = cuda(rand(rng, (rows,), 0.1))
  frames = np.array(lengths)
  labels = np.minimum(frames // 16, u1 - 1)
  live = ((np.arange(max_t)[:, None, None] < frames[None, :, None]) &
          (np.arange(u1)[None, None, :] <= labels[None, :, None]))
  g_b, g_l = (cuda((rand(rng, (max_t, batch, u1)) * live).reshape(
      max_t, rows)) for _ in range(2))
  kw = dict(hat=True, compute_dtype=dtype)
  if forward:
    step = (numerator_scan.numerator_forward_plain if plain else
            numerator_scan.numerator_forward)
    call = lambda: step(pc, pf, head, wy, by, **kw)
    return by_kernel(torch, call) if profiled else timed(torch, call, 1)[1]
  _, _, z, blank = numerator_scan.numerator_forward_plain(pc, pf, head, wy,
                                                          by, **kw)
  backward = (numerator_scan.numerator_backward_plain if plain else
              numerator_scan.numerator_backward)
  call = lambda: backward(pc, pf, head, wy, by, z, blank, g_b, g_l, **kw)
  return by_kernel(torch, call) if profiled else timed(torch, call, 1)[1]


# The Viterbi cases: (batch, lengths, T_max, V, normalize).
VITERBI_CASES = {'vit8': (8, NUM_FRAMES, 1600, 1024, 'none'),
                 'vit8h': (8, NUM_FRAMES, 1600, 1024, 'hat'),
                 'vit10': (8, [n // 8 for n in NUM_FRAMES], 200, 4096, 'none'),
                 'vit8p': (8, NUM_FRAMES, 1600, 1024, 'none')}


def viterbi_ms(torch, viterbi, case, plain):
  """ms of one Viterbi forward (bf16, FLD(2), h=512) of ``case``
  (``VITERBI_CASES``) on random inputs, or for 'vit8p' its device time by
  kernel name."""
  batch, lengths, max_t, vocab, normalize = VITERBI_CASES[case]
  rng = np.random.default_rng(15)
  hidden = 512
  cuda = lambda x: torch.from_numpy(x).cuda()
  pf = cuda(rand(rng, (max_t, batch, hidden), 0.5))
  pc = cuda(rand(rng, (vocab + 1, hidden), 0.5))
  head = {'vocab_w': cuda(rand(rng, (hidden, vocab), hidden**-0.5)),
          'vocab_b': cuda(rand(rng, (vocab,), 0.1)),
          'blank_w': cuda(rand(rng, (hidden,), hidden**-0.5)),
          'blank_b': torch.tensor(0.3, device='cuda')}
  is_pad = (torch.arange(max_t, device='cuda')[:, None] >=
            torch.tensor(lengths, device='cuda')[None])
  forward = (viterbi.viterbi_forward_plain if plain else
             viterbi.viterbi_forward)
  call = lambda: forward(pf, pc, head, is_pad, max_expansions=2,
                         frame_dependent=False, compute_dtype=torch.bfloat16,
                         normalize=normalize)
  return by_kernel(torch, call) if case == 'vit8p' else timed(torch, call,
                                                                1)[1]


def run_tree(tree, cases, plain):
  """Times `cases` with the kernels of `tree` (or its plain versions);
  returns {case: ms}."""
  sys.path.insert(0, str(pathlib.Path(tree).resolve()))
  import torch
  from last_torch_tpu_torch.ops import (fused_scan, joint_head,
                                        numerator_scan, sharded_scan,
                                        trigram_scan, viterbi)
  torch.backends.cuda.matmul.allow_tf32 = False
  out = {}
  for case in cases:
    clock = CLOCKS.get(case[-1])
    if case in FORWARD_CASES:
      shape, mode = FORWARD_CASES[case]
      batch, lengths, max_t, vocab = LP_SHAPES[shape]
      out[case] = log_partition_ms(torch, fused_scan, batch, lengths, plain,
                                   1, max_t=max_t, vocab=vocab, mode=mode,
                                   forward_only=True,
                                   profiled=case.endswith('p'))
    elif case in FRAME_REDUCE_FORWARD_CASES:
      out[case] = frame_reduce_ms(torch, sharded_scan,
                                  FRAME_REDUCE_FORWARD_CASES[case],
                                  'forward', plain, clock)
    elif case == 'lp8':
      out[case] = log_partition_ms(torch, fused_scan, 8, NUM_FRAMES, plain, 2)
    elif case == 'lp32':
      out[case] = log_partition_ms(torch, fused_scan, 32, [1600] * 32, plain,
                                   1)
    elif case.startswith('lp9o'):
      chunk = fused_scan.ONLINE_CHUNK_STATES
      if case == 'lp9o512':
        fused_scan.ONLINE_CHUNK_STATES = 512
      out[case] = log_partition_ms(torch, fused_scan, 8, [200] * 8, plain, 1,
                                   max_t=200, vocab=4096, mode='online',
                                   memory=case == 'lp9omem')
      fused_scan.ONLINE_CHUNK_STATES = chunk
    elif case.startswith('jhf32') or case.startswith('jhb32'):
      states, vocab = JH_F32_SHAPES[case[5]]
      kind = case[6:] or None
      out[case] = joint_head_ms(torch, joint_head, plain,
                                None if kind == 'l' else
                                CLOCKS.get(kind, kind),
                                backward=case.startswith('jhb'),
                                states=states, vocab=vocab,
                                dtype=torch.float32, library=kind == 'l')
    elif case.startswith('jh'):
      kind = case[3:] or None
      out[case] = joint_head_ms(torch, joint_head, plain,
                                CLOCKS.get(kind, kind),
                                backward=case.startswith('jhb'))
    elif case.startswith('numb8'):
      out[case] = numerator_backward_ms(torch, numerator_scan, 8, NUM_FRAMES,
                                        torch.float32, plain,
                                        case.endswith('p'))
    elif case in VITERBI_CASES:
      out[case] = viterbi_ms(torch, viterbi, case, plain)
    elif case.startswith('numb32'):
      out[case] = numerator_backward_ms(torch, numerator_scan, 32,
                                        [1600] * 32, torch.bfloat16, plain,
                                        case.endswith('p'))
    elif case.startswith('numf'):
      full = case.startswith('numf32')
      out[case] = numerator_backward_ms(
          torch, numerator_scan, 32 if full else 8,
          [1600] * 32 if full else NUM_FRAMES,
          torch.bfloat16 if full else torch.float32, plain,
          case.endswith('p'), forward=True)
    elif case.startswith('tri'):
      out[case] = trigram_ms(torch, trigram_scan, case, plain)
    elif case.startswith('marg'):
      full = case in ('marg32', 'margmem')
      out[case] = marginals_ms(
          torch, fused_scan, 32 if full else 8,
          [1600] * 32 if full else NUM_FRAMES, plain,
          {'margmem': 'mem', 'marg8p': 'p'}.get(case))
    else:
      out[case] = frame_reduce_ms(torch, sharded_scan, int(case[2:]),
                                  'backward', plain)
  return out


def main():
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--parent', help='the older tree (driver mode)')
  parser.add_argument('--tree', help='time this tree in this process')
  parser.add_argument('--cases', nargs='+', default=list(CASES),
                      choices=CASES)
  parser.add_argument('--plain', action='store_true',
                      help='time the plain versions')
  parser.add_argument('--rounds', type=int, default=1,
                      help='parent, change, change, parent turns, repeated')
  parser.add_argument('--no-plain', action='store_true',
                      help='leave out the plain versions\' run')
  args = parser.parse_args()
  if args.tree:
    print(json.dumps(run_tree(args.tree, args.cases, args.plain)))
    return
  if not args.parent:
    parser.error('give --parent (driver) or --tree (one run)')
  card = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True,
      check=False).stdout.strip()
  print(card, flush=True)
  here = str(pathlib.Path(__file__).resolve().parent.parent)
  turns = [] if args.no_plain else [('plain', here, ['--plain'])]
  turns += [('parent', args.parent, []), ('change', here, []),
            ('change', here, []), ('parent', args.parent, [])] * args.rounds
  results = []
  for name, tree, flags in turns:
    proc = subprocess.run(
        [sys.executable, __file__, '--tree', tree, '--cases', *args.cases,
         *flags], capture_output=True, text=True, check=False)
    if proc.returncode != 0:
      print(proc.stdout[-2000:], proc.stderr[-4000:], flush=True)
      sys.exit(f'{name} run failed')
    ms = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f'{name}: ' + ', '.join(
        f'{c} null' if t is None else
        f'{c} {{' + ', '.join(f'{k} {v:.4f}' for k, v in t.items()) + '} ms'
        if isinstance(t, dict) else
        f'{c} {t:.4f} {"MiB" if c.endswith("mem") else "ms"}'
        for c, t in ms.items()), flush=True)
    results.append({'run': name, 'ms': ms})
  print(json.dumps({'card': card, 'turns': results}))


if __name__ == '__main__':
  main()
