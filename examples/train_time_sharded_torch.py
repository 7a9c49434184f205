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

"""Training on utterances too long for one card, on the PyTorch port:
time-axis sharding.

The recognition-lattice recursion is sequential in time with a small
carry, so the frames split into blocks over the ranks of a time axis and
the alpha carry relays between neighbouring ranks
(``last_torch_tpu_torch.parallel.sequence``); the backward relays the
carry's cotangent, or the log-partition kernels' beta, in reverse. Each
rank's alpha history and per-frame temporaries shrink by the axis size;
with the banded encoder attention, long utterances train without an
O(T^2) tensor.

This demo trains a small causal-Conformer GNAT on synthetic long
utterances with ``make_time_sharded_train_step`` and checks that the loss
decreases. On the cards (one NCCL rank per card, a world of 1 on one
card)::

    python3 examples/train_time_sharded_torch.py

or on 4 gloo ranks spawned on the CPU::

    python3 examples/train_time_sharded_torch.py --cpu
"""

import argparse
import datetime
import os
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from last_torch_tpu_torch.models import gnat  # noqa: E402
from last_torch_tpu_torch.parallel import sequence  # noqa: E402

CPU_RANKS = 4
STEPS = 5


def rank_main(rank, world, port, cpu):
  if cpu:
    torch.set_num_threads(1)
    device = torch.device('cpu')
  else:
    torch.cuda.set_device(rank)
    device = torch.device('cuda', rank)
  dist.init_process_group('gloo' if cpu else 'nccl',
                          init_method=f'tcp://localhost:{port}', rank=rank,
                          world_size=world,
                          timeout=datetime.timedelta(seconds=300))
  try:
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh(device.type, (world,), mesh_dim_names=('seq',))
    config = gnat.GNATConfig(
        feature_size=16,
        vocab_size=32,
        context_size=1,
        encoder_size=32,
        encoder_layers=2,
        encoder_heads=2,
        encoder_ffn_size=64,
        hidden_size=32,
        embedding_size=32,
        max_expansions=1,
        encoder_causal=True,
        encoder_window=8,  # banded attention engages at T > 16
        encoder_conv_kernel=4)
    model = gnat.GNATModel(config, device=device)
    optimizer = gnat.make_optimizer(learning_rate=3e-3)
    state = gnat.init_train_state(model, torch.Generator().manual_seed(0),
                                  optimizer)

    # "Long" synthetic utterances: T = 64 frames, T / world of them in each
    # rank's block (scale T freely: each rank's lattice state stays T /
    # world frames).
    batch, max_t, max_u = 2, 64, 6
    rng = np.random.default_rng(0)
    frames = rng.normal(size=(batch, max_t, 16)).astype(np.float32)
    num_frames = np.array([64, 48], np.int32)
    labels = rng.integers(1, 33, size=(batch, max_u)).astype(np.int32)
    num_labels = np.array([6, 4], np.int32)

    step = sequence.make_time_sharded_train_step(model, optimizer, mesh,
                                                 axis_name='seq',
                                                 fused='auto')
    losses = []
    for i in range(STEPS):
      state, loss = step(state, frames, num_frames, labels, num_labels)
      losses.append(float(loss))
      if rank == 0:
        print(f'step {i}: loss {losses[-1]:.4f}', flush=True)
    if losses[-1] >= losses[0]:
      raise SystemExit(f'the loss did not decrease: {losses}')
    if rank == 0:
      print(f'time-sharded training converges on {world} ranks; each rank '
            f'holds the lattice state of {max_t // world} of {max_t} frames',
            flush=True)
  finally:
    dist.destroy_process_group()


def main():
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--cpu', action='store_true',
                      help=f'{CPU_RANKS} gloo ranks on the CPU')
  args = parser.parse_args()
  if args.cpu:
    world = CPU_RANKS
  else:
    if not torch.cuda.is_available():
      raise SystemExit('no CUDA device: pass --cpu to run on the CPU')
    world = torch.cuda.device_count()
  with socket.socket() as s:
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
  mp.spawn(rank_main, args=(world, port, args.cpu), nprocs=world)


if __name__ == '__main__':
  main()
