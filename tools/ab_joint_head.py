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

"""The joint+head kernels against the einsum route of JointWeightFn.apply,
end to end on one GPU.

Run from the root of a checkout::

  python3 tools/ab_joint_head.py [--root DIR]

``--root`` names the tree whose ``last_torch_tpu_torch`` is imported
(default: this checkout), so that one script times an older tree, whose
``apply`` has no kernels and takes the einsum route, beside a newer one:
run it parent, change, change, parent in one session. It times, with CUDA
events after a warm-up (the mean of ``--repeats`` calls):

* ``arc``: ``arc_marginals`` of ``gnat_global_bigram()`` (S=1025, V=1024,
  bf16 heads) at B=2, T=100, as ``chip_smoke.py``'s phase 8 runs it; in
  every tree.
* Where the tree has the joint+head kernels: the same with their gate
  closed (``arc_einsum``), and the densified headline's loss (mean) and
  backward, ``chip_smoke.py``'s phase 11 step 1 (``NextStateTable``, S=1025,
  V=1024, h=512, bf16, B=8, T_max=1600), through the kernels (``loss``) and
  the einsum route (``loss_einsum``), in the order kernel, einsum, einsum,
  kernel.

Prints the card's name and power limit, then one JSON object of
milliseconds.
"""

import argparse
import contextlib
import json
import pathlib
import subprocess
import sys

import numpy as np

NUM_FRAMES = [1600, 1523, 1400, 1211, 1000, 804, 517, 230]
NUM_LABELS = [n // 16 for n in NUM_FRAMES]


def timed(torch, fn, repeats):
  """(result of the last call, mean ms per call) with CUDA events."""
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(repeats):
    out = fn()
  end.record()
  torch.cuda.synchronize()
  return out, start.elapsed_time(end) / repeats


@contextlib.contextmanager
def einsum_route(weight_fns):
  """Closes the joint+head kernels' gate: apply takes its einsum route."""
  saved = weight_fns.joint_head.supported
  weight_fns.joint_head.supported = lambda *args, **kwargs: False
  try:
    yield
  finally:
    weight_fns.joint_head.supported = saved


def arc_marginals(torch, gnat, presets, repeats):
  """arc_marginals of gnat_global_bigram() at B=2, T=100: a function that
  runs it."""
  config = presets.gnat_global_bigram()
  model = gnat.GNATModel(config, device='cuda')
  params = model.init(torch.Generator().manual_seed(0))
  rng = np.random.default_rng(0)
  frames = torch.from_numpy(rng.standard_normal(
      (2, 100, config.feature_size)).astype(np.float32)).cuda()
  num_frames = torch.tensor([100, 100], device='cuda')
  with torch.no_grad():
    encoded = model.encoder.apply(params['encoder'], frames, num_frames)

  def run():
    out = model.lattice.arc_marginals(params['lattice'], encoded, num_frames)
    if model.lattice.last_path != 'generic':
      raise RuntimeError('arc_marginals left the generic route')
    return out

  run()  # warm-up
  return lambda: timed(torch, run, repeats)[1]


def headline_loss(torch, lattices, contexts, alignments, weight_fns):
  """The densified headline's loss (mean) and backward at chip_smoke.py's
  phase 11 shapes: a function that runs it, and one on 16 frames."""
  vocab, hidden = 1024, 512
  context = contexts.NextStateTable(
      contexts.FullNGram(vocab_size=vocab, context_size=1).next_state_table())
  lattice = lattices.RecognitionLattice(
      context=context,
      alignment=alignments.FrameLabelDependent(max_expansions=2),
      weight_fn_cacher_factory=lambda ctx: weight_fns.SharedEmbCacher(
          num_context_states=ctx.shape()[0], embedding_size=hidden),
      weight_fn_factory=lambda ctx: weight_fns.JointWeightFn(
          vocab_size=vocab, hidden_size=hidden, compute_dtype=torch.bfloat16))
  params = lattice.init(torch.Generator().manual_seed(0),
                        feature_size=hidden, device='cuda')
  leaves = [leaf.requires_grad_(True) for leaf in
            (x for part in params.values() for x in part.values())]
  rng = np.random.default_rng(0)
  batch_size, max_t = len(NUM_FRAMES), max(NUM_FRAMES)
  frames = torch.from_numpy((rng.standard_normal(
      (batch_size, max_t, hidden)) * 0.5).astype(np.float32)).cuda()
  labels = torch.from_numpy(rng.integers(
      1, vocab + 1, size=(batch_size, max(NUM_LABELS)))).cuda()
  num_frames = torch.tensor(NUM_FRAMES, device='cuda')
  num_labels = torch.tensor(NUM_LABELS, device='cuda')

  def step(frames, num_frames, labels, num_labels):
    loss = lattice.loss(params, frames, num_frames, labels, num_labels).mean()
    torch.autograd.grad(loss, leaves)
    if lattice.last_path != 'generic':
      raise RuntimeError('the NextStateTable loss left the generic route')

  short = (frames[:, :16].contiguous(), num_frames.clamp(max=16),
           labels[:, :1], num_labels.clamp(max=1))
  return (lambda: step(frames, num_frames, labels, num_labels),
          lambda: step(*short))


def main():
  parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  parser.add_argument('--root', default=str(pathlib.Path(__file__).resolve()
                                            .parent.parent))
  parser.add_argument('--repeats', type=int, default=3)
  args = parser.parse_args()
  sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
  import torch
  if not torch.cuda.is_available():
    sys.exit('no CUDA device')
  torch.backends.cuda.matmul.allow_tf32 = False
  from last_torch_tpu_torch import (alignments, contexts, lattices,
                                    weight_fns)
  from last_torch_tpu_torch.models import gnat, presets
  print(subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip(), flush=True)
  has_kernels = hasattr(weight_fns, 'joint_head')
  result = {'root': args.root, 'joint_head_kernels': has_kernels}
  arc = arc_marginals(torch, gnat, presets, args.repeats)
  result['arc'] = arc()
  if has_kernels:
    with einsum_route(weight_fns):
      arc()  # warm-up
      result['arc_einsum'] = arc()
    step, warm_up = headline_loss(torch, lattices, contexts, alignments,
                                  weight_fns)
    warm_up()
    with einsum_route(weight_fns):
      warm_up()
    result['loss'], result['loss_einsum'] = [], []
    for route in ('loss', 'loss_einsum', 'loss_einsum', 'loss'):
      with (einsum_route(weight_fns) if route == 'loss_einsum' else
            contextlib.nullcontext()):
        result[route].append(timed(torch, step, 1)[1])
  print(json.dumps(result), flush=True)


if __name__ == '__main__':
  main()
