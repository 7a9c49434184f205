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

"""The model-parallel train steps across cards: one process per card, an
NCCL group over localhost, ``gnat_global_bigram()`` at full width.

Run from the root of a checkout on a host with ``--cards`` GPUs::

  python3 tools/tp_multicard.py [--cards 4] [--model-parallel 4] [--steps 3]
  python3 tools/tp_multicard.py --seq-parallel 4 [--steps 3]
  python3 tools/tp_multicard.py --pipe-parallel 4 [--microbatches 4]
  python3 tools/tp_multicard.py --pp-seq [--microbatches 4]
  python3 tools/tp_multicard.py --sharded [--model-parallel 4]
  python3 tools/tp_multicard.py --cpu [any of the above]  # gloo, small

The modes, on ``chip_smoke.py``'s phase 6 batch (8 utterances of up to
1600 frames, seed 0):

* default: ``parallel.sharding.make_tp_train_step`` over a ('data',
  'model') mesh: the vocab head sharded (the lattice loss through the
  ``frame_reduce`` kernels) and the encoder Megatron-sharded, the batch
  rows split over the data axis. Step 1 is held to the same loss computed
  on rank 0 with one shard (``tp_lattice_loss`` without a group, the whole
  head and encoder), on each data rank's rows in turn so that every batched
  product has the ranks' shapes.
* ``--seq-parallel D`` (D = ``--cards``): a ('seq',) mesh of D ranks,
  ``parallel.sequence.make_time_sharded_train_step(fused='auto')`` on the
  whole batch, each rank's block T / D frames of it (400 at D = 4): the
  log-partition kernels chained over the ranks by their relay seeds.
* ``--pipe-parallel P``: a ('data', 'pipe') mesh (``make_pp_mesh``),
  ``parallel.pipeline.make_pp_train_step`` with ``--microbatches`` M: stage
  p runs encoder blocks [p L / P, (p + 1) L / P), the last stage the
  lattice loss through the 'cache' pair.
* ``--pp-seq``: a ('pipe', 'seq') mesh of 2 x cards / 2,
  ``make_pp_seq_train_step(fused='auto')``: the pipelined encoder and the
  kernel relay.
* ``--sharded``: the fallback of ``models.train.train(model_parallel >
  1)`` where no tensor-parallel plan exists, on the trigram
  ``gnat_global_bigram(vocab_size=64, context_size=2)`` at phase 10's shape
  (the lengths / 8): ``fused='never'`` and ``make_sharded_train_step`` over
  a ('data', 'model') mesh, the generic route through the joint+head
  kernels on the gathered head.

Outside the default mode, step 1 (its loss and its gradients before
clipping, summed or gathered over the ranks) is held to ``gnat.train_step``
's on one card, computed on rank 0 (``fused='never'`` for ``--sharded``)
over the rows the ranks' kernels take at once: each data rank's rows, and
each microbatch of them for the encoder and, outside ``--pp-seq``, the
lattice. (FLD's ``blank_b`` gradient is float32 residue, which the kernels'
batch shapes move by ~1e-3 of the largest gradient: 1.04e-03 for the
pipelined step against the whole batch.) Loss rtol 1e-5; gradients within
1e-4 of the largest in the default mode and ``--sharded``, 1e-3 for the
bigram kernels' relay and pipeline modes (``chip_smoke.py`` phase 6's rule:
at T=1600 the bfloat16 kernels' float32 sums move with their order, and
the ranks sum the accumulators in another). Then ``--steps`` steps, each
timed with CUDA events on every rank. Prints the card's name and power
limit, one line per rank (its step times, kernel launches a step and peak
device memory) and one JSON line.
"""

import argparse
import json
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np

ROOT = str(pathlib.Path(__file__).resolve().parent.parent)
NUM_FRAMES = [1600, 1523, 1400, 1211, 1000, 804, 517, 230]
# The CPU rehearsal's model: every axis of 4 divides its layers, heads, FFN
# and vocabulary.
SMALL = dict(feature_size=8, vocab_size=256, encoder_size=16,
             encoder_layers=4, encoder_heads=4, encoder_ffn_size=32,
             hidden_size=16, embedding_size=16)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
SEQ_GRAD_RTOL = 1e-3


def batch(torch, config, device, small, divisor=1, frames_per_label=16):
  """chip_smoke.py's phase 6 batch: its lengths / ``divisor`` (and / 100
  more with --cpu), one label per ``frames_per_label`` frames."""
  num_frames = [max(1, n // divisor // (100 if small else 1))
                for n in NUM_FRAMES]
  num_labels = [max(1, n // frames_per_label) for n in num_frames]
  rng = np.random.default_rng(0)
  frames = (rng.standard_normal(
      (len(num_frames), max(num_frames), config.feature_size))).astype(
          np.float32)
  labels = rng.integers(1, config.vocab_size + 1,
                        size=(len(num_frames), max(num_labels)))
  return tuple(torch.as_tensor(x, device=device) for x in
               (frames, num_frames, labels, num_labels))


def tp_reference(torch, pytree, sharded_scan, model, params, whole, parts):
  """(mean loss, [gradient of each leaf]) of the loss with one shard of the
  head, computed on ``parts`` consecutive row blocks of ``whole`` in turn."""
  leaves = pytree.tree_map(
      lambda x: x.detach().clone().requires_grad_(True), params)
  size = len(whole[0]) // parts
  total = count = 0
  for i in range(parts):
    frames, num_frames, labels, num_labels = (
        x[i * size:(i + 1) * size] for x in whole)
    encoded = model.encoder.apply(leaves['encoder'], frames, num_frames)
    per_seq = sharded_scan.tp_lattice_loss(model.lattice, leaves['lattice'],
                                           encoded, num_frames, labels,
                                           num_labels)
    finite = torch.isfinite(per_seq)
    total = total + torch.where(finite, per_seq, 0.0).sum()
    count = count + finite.sum()
  loss = total / count.clamp(min=1)
  loss.backward()
  return loss.item(), [x.grad for x in pytree.tree_leaves(leaves)]


def one_card_reference(torch, pytree, model, params, whole, parts=1,
                       whole_lattice=False):
  """(mean loss, [gradient of each leaf]) of ``gnat.train_step``'s step 1
  on one card, the rows taken in ``parts`` consecutive blocks (the ranks'
  shapes); ``whole_lattice``: the encoder by blocks, the lattice on the
  whole batch."""
  leaves = pytree.tree_map(
      lambda x: x.detach().clone().requires_grad_(True), params)
  size = len(whole[0]) // parts
  rows = lambda i: [x[i * size:(i + 1) * size] for x in whole]
  if whole_lattice:
    encoded = torch.cat([model.encoder.apply(leaves['encoder'], *rows(i)[:2])
                         for i in range(parts)])
    per_seqs = [model.lattice(leaves['lattice'], encoded, *whole[1:])]
  else:
    per_seqs = [model.loss(leaves, *rows(i)) for i in range(parts)]
  total = count = 0
  for per_seq in per_seqs:
    finite = torch.isfinite(per_seq)
    total = total + torch.where(finite, per_seq, 0.0).sum()
    count = count + finite.sum()
  loss = total / count.clamp(min=1)
  loss.backward()
  return loss.item(), [x.grad for x in pytree.tree_leaves(leaves)]


def step1_errors(pytree, params, loss, grads, want):
  """Step 1's loss and gradients against ``want``: relative loss error and
  the worst gradient error over the largest gradient."""
  loss_1, grads_1 = want
  largest = max(g.abs().max().item() for g in grads_1)
  paths = [pytree.keystr(p) for p, _ in
           pytree.tree_flatten_with_path(params)[0]]
  worst = max(((a - b).abs().max().item() / largest, path)
              for path, a, b in zip(paths, grads, grads_1))
  return {'loss_rel': abs(loss - loss_1) / abs(loss_1),
          'grad_of_largest': worst[0], 'worst_leaf': worst[1]}


def timed_steps(torch, args, device, step, state, local, counters):
  """``args.steps`` steps, each timed (CUDA events on the card): (state,
  ms a step, [{counter: launches} a step], peak memory in GiB or None)."""
  step_ms, launches = [], []
  if not args.cpu:
    torch.cuda.reset_peak_memory_stats(device)
  for _ in range(args.steps):
    before = {name: getattr(m, c) for name, (m, c) in counters.items()}
    if args.cpu:
      t0 = time.perf_counter()
      state, _ = step(state, *local)
      step_ms.append((time.perf_counter() - t0) * 1e3)
    else:
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
      state, _ = step(state, *local)
      end.record()
      torch.cuda.synchronize()
      step_ms.append(start.elapsed_time(end))
    launches.append({name: getattr(m, c) - before[name]
                     for name, (m, c) in counters.items()})
  peak = None if args.cpu else torch.cuda.max_memory_allocated(device) / 2**30
  return state, step_ms, launches, peak


def worker_run(rank, args, device):
  """One rank's mode: its report, and on rank 0 the step-1 errors."""
  import torch
  from torch.distributed.device_mesh import init_device_mesh
  from torch.utils import _pytree as pytree
  from last_torch_tpu_torch.models import gnat, presets
  from last_torch_tpu_torch.ops import fused_scan, joint_head, sharded_scan
  from last_torch_tpu_torch.parallel import pipeline, sequence, sharding

  if args.sharded:
    config = (gnat.GNATConfig(**dict(SMALL, vocab_size=8, context_size=2))
              if args.cpu else
              presets.gnat_global_bigram(vocab_size=64, context_size=2))
    whole = batch(torch, config, device, args.cpu, divisor=8,
                  frames_per_label=4)
  else:
    config = (gnat.GNATConfig(**SMALL) if args.cpu else
              presets.gnat_global_bigram())
    whole = batch(torch, config, device, args.cpu)
  model = gnat.GNATModel(config, device=device)
  if args.sharded:
    model.lattice.fused = 'never'
  optimizer = gnat.make_optimizer(1e-3)
  full = gnat.init_train_state(model, torch.Generator().manual_seed(0),
                               optimizer)
  cache_pair = {'cache_forward': (fused_scan, 'forward_launches'),
                'cache_backward': (fused_scan, 'backward_launches')}
  local = whole
  gather = None
  if args.seq_parallel:
    mesh = init_device_mesh(device.type, (args.seq_parallel,),
                            mesh_dim_names=('seq',))
    step = sequence.make_time_sharded_train_step(model, optimizer, mesh,
                                                 fused='auto')
    counters = cache_pair
  elif args.pipe_parallel:
    mesh = pipeline.make_pp_mesh(pipeline_parallel=args.pipe_parallel,
                                 device_type=device.type)
    step = pipeline.make_pp_train_step(model, optimizer, mesh,
                                       args.microbatches, data_axis='data')
    counters = cache_pair
  elif args.pp_seq:
    mesh = init_device_mesh(device.type, (2, args.cards // 2),
                            mesh_dim_names=('pipe', 'seq'))
    step = pipeline.make_pp_seq_train_step(model, optimizer, mesh,
                                           args.microbatches, fused='auto')
    counters = cache_pair
  else:
    mesh = sharding.make_mesh(model_parallel=args.model_parallel,
                              device_type=device.type)
    make = (sharding.make_sharded_train_step if args.sharded else
            sharding.make_tp_train_step)
    step, shard_state = make(model, optimizer, mesh)
    local = sharding.shard_batch(whole, mesh)
    gather = lambda grads: pytree.tree_leaves(
        sharding.gather_params(grads, mesh))
    counters = ({'joint_head_forward': (joint_head, 'forward_launches'),
                 'joint_head_backward': (joint_head, 'backward_launches')}
                if args.sharded else
                {'frame_reduce_forward': (sharded_scan, 'forward_launches'),
                 'frame_reduce_backward': (sharded_scan,
                                           'backward_launches')})

  want = None
  if rank == 0:
    if args.pipe_parallel:
      want = one_card_reference(
          torch, pytree, model, full.params, whole,
          args.cards // args.pipe_parallel * args.microbatches)
    elif args.pp_seq:
      want = one_card_reference(torch, pytree, model, full.params, whole,
                                args.microbatches, whole_lattice=True)
    elif args.seq_parallel:
      want = one_card_reference(torch, pytree, model, full.params, whole)
    elif args.sharded:
      want = one_card_reference(torch, pytree, model, full.params, whole,
                                args.cards // args.model_parallel)
    else:
      want = tp_reference(torch, pytree, sharded_scan, model, full.params,
                          whole, args.cards // args.model_parallel)
  if not args.cpu:
    torch.cuda.reset_peak_memory_stats(device)
  state = full if gather is None else shard_state(full)
  loss = step.loss_and_grads(state, *local).item()
  grads = pytree.tree_map(lambda x: x.grad, state.params)
  grads = pytree.tree_leaves(grads) if gather is None else gather(grads)
  errors = (None if rank != 0 else
            step1_errors(pytree, full.params, loss, grads, want))
  step1_peak = (None if args.cpu else
                torch.cuda.max_memory_allocated(device) / 2**30)
  state = (gnat.init_train_state(model, torch.Generator().manual_seed(0),
                                 optimizer) if gather is None else
           shard_state(gnat.init_train_state(
               model, torch.Generator().manual_seed(0), optimizer)))
  state, step_ms, launches, peak = timed_steps(torch, args, device, step,
                                               state, local, counters)
  report = {'rank': rank, 'coords': dict(zip(mesh.mesh_dim_names,
                                             mesh.get_coordinate())),
            'step_ms': step_ms, 'launches_per_step': launches,
            'peak_memory_gib': peak, 'step1_peak_memory_gib': step1_peak,
            'loss': loss}
  return report, errors


def mode_layout(args):
  if args.seq_parallel:
    return {'mode': 'seq', 'seq_parallel': args.seq_parallel}
  if args.pipe_parallel:
    return {'mode': 'pipe', 'pipe_parallel': args.pipe_parallel,
            'microbatches': args.microbatches}
  if args.pp_seq:
    return {'mode': 'pp_seq', 'pipe': 2, 'seq': args.cards // 2,
            'microbatches': args.microbatches}
  return {'mode': 'sharded' if args.sharded else 'tp',
          'model_parallel': args.model_parallel}


def worker(rank, args, port):
  import torch
  import torch.distributed as dist
  sys.path.insert(0, ROOT)

  if args.cpu:
    torch.set_num_threads(1)
    device = torch.device('cpu')
  else:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(rank)
    device = torch.device('cuda', rank)
  dist.init_process_group('gloo' if args.cpu else 'nccl',
                          init_method=f'tcp://localhost:{port}', rank=rank,
                          world_size=args.cards)
  try:
    report, errors = worker_run(rank, args, device)
    reports = [None] * args.cards
    dist.all_gather_object(reports, report)
    if rank == 0:
      for r in reports:
        print(json.dumps(r), flush=True)
      print(json.dumps({
          'cards': args.cards, **mode_layout(args),
          'device': 'cpu' if args.cpu else torch.cuda.get_device_name(0),
          'step1_vs_one_shard' if mode_layout(args)['mode'] == 'tp' else
          'step1_vs_one_card': errors,
          'step_ms_max_over_ranks': [max(r['step_ms'][i] for r in reports)
                                     for i in range(args.steps)],
          'peak_memory_gib_max_over_ranks': (
              None if args.cpu else
              max(r['peak_memory_gib'] for r in reports))}), flush=True)
      grad_rtol = (GRAD_RTOL if mode_layout(args)['mode'] in ('tp',
                                                              'sharded')
                   else SEQ_GRAD_RTOL)
      ok = (errors['loss_rel'] <= LOSS_RTOL and
            errors['grad_of_largest'] <= grad_rtol)
      if not ok:
        raise SystemExit(f'FAILED: step 1 {errors}')
  finally:
    dist.destroy_process_group()


def main():
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--cards', type=int, default=4)
  parser.add_argument('--model-parallel', type=int, default=None)
  parser.add_argument('--steps', type=int, default=3)
  parser.add_argument('--seq-parallel', type=int, default=None,
                      help='time-shard the frames over this many ranks '
                      '(all of --cards) instead of the vocab head')
  parser.add_argument('--pipe-parallel', type=int, default=None,
                      help='stage the encoder over this many ranks (GPipe)')
  parser.add_argument('--microbatches', type=int, default=4)
  parser.add_argument('--pp-seq', action='store_true',
                      help="pipelined encoder x time-sharded loss on a "
                      "('pipe', 'seq') mesh of 2 x cards / 2")
  parser.add_argument('--sharded', action='store_true',
                      help='the trigram fallback: fused=never and '
                      'make_sharded_train_step')
  parser.add_argument('--cpu', action='store_true')
  args = parser.parse_args()
  args.model_parallel = args.model_parallel or args.cards
  if args.seq_parallel:
    args.cards = args.seq_parallel
  import torch
  import torch.multiprocessing as mp
  if not args.cpu:
    if torch.cuda.device_count() < args.cards:
      raise SystemExit(f'needs {args.cards} GPUs, found '
                       f'{torch.cuda.device_count()}')
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
  with socket.socket() as s:
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
  mp.spawn(worker, args=(args, port), nprocs=args.cards)


if __name__ == '__main__':
  main()
