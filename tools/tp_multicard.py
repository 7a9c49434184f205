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

"""The tensor-parallel or the time-sharded train step across cards: one
process per card, an NCCL group over localhost, the vocab head of
``gnat_global_bigram()`` sharded over the mesh's model axis, or its frames
over a time axis (``--seq-parallel``).

Run from the root of a checkout on a host with ``--cards`` GPUs::

  python3 tools/tp_multicard.py [--cards 4] [--model-parallel 4] [--steps 3]
  python3 tools/tp_multicard.py --seq-parallel 4 [--steps 3]
  python3 tools/tp_multicard.py --cpu [--seq-parallel 4]  # gloo, small

Each rank takes ``make_tp_train_step`` steps on ``chip_smoke.py``'s phase 6
batch (8 utterances of up to 1600 frames, seed 0; its rows split over the
data axis). Step 1's loss and gradients (before clipping; each vocab
shard's gathered) are held to the same loss computed on rank 0 with one
shard (``tp_lattice_loss`` without a group, the whole head), on each data
rank's rows in turn so that every batched product has the ranks' shapes:
loss rtol 1e-5, gradients within 1e-4 of the largest (the same bfloat16
roundings; float32 sums in another order across shards). Then ``--steps`` steps, each
timed with CUDA events on every rank. Prints the card's name and power
limit, one line per rank and one JSON line.

``--seq-parallel D`` (D = ``--cards``): a ('seq',) mesh of D ranks,
``parallel.sequence.make_time_sharded_train_step(fused='auto')`` on the same
batch, whole on every rank, each rank's block T / D frames of it (400 at D
= 4): the log-partition kernels chained over the ranks by their relay
seeds. Step 1's loss and gradients (before clipping, summed over the ranks)
are held to ``gnat.train_step``'s on one card, computed on rank 0: loss
rtol 1e-5, gradients within 1e-3 of the largest (``chip_smoke.py`` phase
6's rule: at T=1600 the bfloat16 kernels' float32 sums move with their
order, and the blocks sum the accumulators in another). Each rank prints
its step times and its peak device memory.
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
NUM_LABELS = [n // 16 for n in NUM_FRAMES]
SMALL = dict(feature_size=8, vocab_size=256, encoder_size=16,
             encoder_layers=1, encoder_heads=2, encoder_ffn_size=32,
             hidden_size=16, embedding_size=16)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
SEQ_GRAD_RTOL = 1e-3


def batch(torch, config, device, small):
  """chip_smoke.py's phase 6 batch (its lengths / 100 with --cpu)."""
  num_frames = [max(1, n // 100) for n in NUM_FRAMES] if small else NUM_FRAMES
  num_labels = [max(1, n // 16) for n in num_frames]
  rng = np.random.default_rng(0)
  frames = (rng.standard_normal(
      (len(num_frames), max(num_frames), config.feature_size))).astype(
          np.float32)
  labels = rng.integers(1, config.vocab_size + 1,
                        size=(len(num_frames), max(num_labels)))
  return tuple(torch.as_tensor(x, device=device) for x in
               (frames, num_frames, labels, num_labels))


def reference(torch, pytree, sharded_scan, model, params, whole, parts):
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


def seq_worker(rank, args, device):
  """One rank of ``--seq-parallel``: its report, and on rank 0 the step-1
  errors against one card's ``gnat.train_step``."""
  import torch
  from torch.distributed.device_mesh import init_device_mesh
  from torch.utils import _pytree as pytree
  from last_torch_tpu_torch.models import gnat, presets
  from last_torch_tpu_torch.ops import fused_scan
  from last_torch_tpu_torch.parallel import sequence

  mesh = init_device_mesh(device.type, (args.seq_parallel,),
                          mesh_dim_names=('seq',))
  config = (gnat.GNATConfig(**SMALL) if args.cpu else
            presets.gnat_global_bigram())
  model = gnat.GNATModel(config, device=device)
  optimizer = gnat.make_optimizer(1e-3)

  def state0():
    return gnat.init_train_state(model, torch.Generator().manual_seed(0),
                                 optimizer)

  whole = batch(torch, config, device, args.cpu)
  errors = None
  if rank == 0:
    single = state0()
    loss_1 = model.mean_loss(single.params, *whole)
    loss_1.backward()
    want = (loss_1.item(), [leaf.grad for leaf in
                            pytree.tree_leaves(single.params)])
  step = sequence.make_time_sharded_train_step(model, optimizer, mesh,
                                               fused='auto')
  state = state0()
  if not args.cpu:
    torch.cuda.reset_peak_memory_stats(device)
  loss = step.loss_and_grads(state, *whole).item()
  if rank == 0:
    loss_1, grads_1 = want
    largest = max(g.abs().max().item() for g in grads_1)
    paths = [pytree.keystr(p) for p, _ in
             pytree.tree_flatten_with_path(state.params)[0]]
    worst = max(((a.grad - b).abs().max().item() / largest, path)
                for path, a, b in zip(paths,
                                      pytree.tree_leaves(state.params),
                                      grads_1))
    errors = {'loss_rel': abs(loss - loss_1) / abs(loss_1),
              'grad_of_largest': worst[0], 'worst_leaf': worst[1]}
  step_ms, launches = [], []
  state = state0()
  for _ in range(args.steps):
    before = (fused_scan.forward_launches, fused_scan.backward_launches)
    if args.cpu:
      t0 = time.perf_counter()
      state, _ = step(state, *whole)
      step_ms.append((time.perf_counter() - t0) * 1e3)
    else:
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
      state, _ = step(state, *whole)
      end.record()
      torch.cuda.synchronize()
      step_ms.append(start.elapsed_time(end))
    launches.append((fused_scan.forward_launches - before[0],
                     fused_scan.backward_launches - before[1]))
  peak = None if args.cpu else torch.cuda.max_memory_allocated(device)
  report = {'rank': rank, 'seq': mesh.get_local_rank('seq'),
            'step_ms': step_ms, 'lattice_kernel_launches': launches,
            'peak_memory_gib': None if peak is None else peak / 2**30,
            'loss': loss}
  return report, errors, (SEQ_GRAD_RTOL, {'seq_parallel': args.seq_parallel})


def tp_worker(rank, args, device):
  """One rank of the tensor-parallel step: its report, and on rank 0 the
  step-1 errors against one shard."""
  import torch
  import torch.distributed as dist
  from torch.utils import _pytree as pytree
  from last_torch_tpu_torch.models import gnat, presets
  from last_torch_tpu_torch.ops import sharded_scan
  from last_torch_tpu_torch.parallel import sharding

  mesh = sharding.make_mesh(model_parallel=args.model_parallel,
                            device_type=device.type)
  config = (gnat.GNATConfig(**SMALL) if args.cpu else
            presets.gnat_global_bigram())
  model = gnat.GNATModel(config, device=device)
  optimizer = gnat.make_optimizer(1e-3)
  full = gnat.init_train_state(model, torch.Generator().manual_seed(0),
                               optimizer)
  whole = batch(torch, config, device, args.cpu)
  want = None
  if rank == 0:
    want = reference(torch, pytree, sharded_scan, model, full.params,
                     whole, args.cards // args.model_parallel)
  step, shard_state = sharding.make_tp_train_step(model, optimizer, mesh)
  state = shard_state(full)
  local = sharding.shard_batch(whole, mesh)

  loss = step.loss_and_grads(state, *local).item()
  model_group = mesh.get_group('model')
  grads = []
  for leaf, dim in zip(pytree.tree_leaves(state.params),
                       sharding.param_shardings(state.params).values()):
    grad = leaf.grad
    if dim is not None:
      parts = [torch.empty_like(grad) for _ in range(model_group.size())]
      dist.all_gather(parts, grad.contiguous(), group=model_group)
      grad = torch.cat(parts, dim)
    grads.append(grad)
  errors = None
  if rank == 0:
    loss_1, grads_1 = want
    largest = max(g.abs().max().item() for g in grads_1)
    worst = max(((a - b).abs().max().item() / largest, name)
                for name, a, b in zip(sharding.param_shardings(full.params),
                                      grads, grads_1))
    errors = {'loss_rel': abs(loss - loss_1) / abs(loss_1),
              'grad_of_largest': worst[0], 'worst_leaf': worst[1]}

  step_ms, launches = [], []
  for _ in range(args.steps):
    before = (sharded_scan.forward_launches, sharded_scan.backward_launches)
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
    launches.append((sharded_scan.forward_launches - before[0],
                     sharded_scan.backward_launches - before[1]))
  report = {'rank': rank, 'data': mesh.get_local_rank('data'),
            'model': mesh.get_local_rank('model'), 'step_ms': step_ms,
            'frame_reduce_launches': launches, 'loss': loss}
  return report, errors, (GRAD_RTOL,
                          {'model_parallel': args.model_parallel})


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
    run = seq_worker if args.seq_parallel else tp_worker
    report, errors, (grad_rtol, layout) = run(rank, args, device)
    reports = [None] * args.cards
    dist.all_gather_object(reports, report)
    if rank == 0:
      for r in reports:
        print(json.dumps(r), flush=True)
      print(json.dumps({
          'cards': args.cards, **layout,
          'device': 'cpu' if args.cpu else torch.cuda.get_device_name(0),
          'step1_vs_one_card' if args.seq_parallel else
          'step1_vs_one_shard': errors,
          'step_ms_max_over_ranks': [max(r['step_ms'][i] for r in reports)
                                     for i in range(args.steps)]}),
            flush=True)
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
