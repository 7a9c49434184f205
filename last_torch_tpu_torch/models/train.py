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

"""Restartable GNAT training loop, PyTorch port.

Counterpart of ``last_torch_tpu/models/train.py``: data-parallel and
tensor-parallel train steps over ``torch.distributed``, checkpoint and
resume (``utils.checkpoint``), JSON-line metrics with step-time
percentiles (``utils.profiling.StepTimer``), batches staged on the card by
a background thread (``data.prefetch_to_device``), Viterbi evaluation
through ``GNATModel.decode``, and the same synthetic, alignment-friendly
data source as the JAX package (its arrays equal JAX's bit for bit).

Run directly for a smoke training session (on the card unless asked for the
CPU):

  python -m last_torch_tpu_torch.models.train --steps 50 --workdir /tmp/run

Under ``torchrun`` (or with ``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE`` and ``RANK`` set) every process joins one process group
and the batch is split over the ranks.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
from typing import Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from last_torch_tpu_torch import data as data_lib
from last_torch_tpu_torch.models import gnat
from last_torch_tpu_torch.models import metrics
from last_torch_tpu_torch.ops import sharded_scan
from last_torch_tpu_torch.parallel import sharding
from last_torch_tpu_torch.utils import checkpoint as checkpoint_lib
from last_torch_tpu_torch.utils import profiling


def maybe_initialize_distributed(device='cuda') -> bool:
  """Joins the default process group when the launcher's variables say so.

  With ``MASTER_ADDR`` and ``WORLD_SIZE`` set (as ``torchrun`` sets them,
  with ``MASTER_PORT`` and ``RANK``), initializes
  ``torch.distributed`` from the environment: NCCL for a CUDA ``device``
  (each process on card ``LOCAL_RANK``), gloo for the CPU. Without them
  it is a no-op, so the trainer can always call it; it is idempotent.

  Returns:
    True if the process is in a process group.
  """
  if dist.is_initialized():
    return True
  if not (os.environ.get('MASTER_ADDR') and os.environ.get('WORLD_SIZE')):
    return False
  if not os.environ.get('RANK'):
    raise ValueError('WORLD_SIZE is set but RANK is not: a launcher must '
                     'give every process both')
  on_card = torch.device(device).type == 'cuda'
  if on_card:
    torch.cuda.set_device(int(os.environ.get('LOCAL_RANK',
                                             os.environ['RANK'])))
  dist.init_process_group('nccl' if on_card else 'gloo',
                          init_method='env://')
  return True


def process_local_slice(global_batch_size: int, num_processes: int,
                        process_index: int) -> tuple[int, int]:
  """This process's (start, size) slice of the global batch.

  Each process feeds its own contiguous rows; the global batch must divide
  evenly so that every rank's step sees the same shapes.

  Args:
    global_batch_size: Total batch size across all processes.
    num_processes: The world size.
    process_index: This process's rank.

  Returns:
    (start, size): this process's contiguous slice of the batch axis.
  """
  if global_batch_size % num_processes != 0:
    raise ValueError(
        f'global_batch_size={global_batch_size} must be divisible by '
        f'num_processes={num_processes}')
  size = global_batch_size // num_processes
  return process_index * size, size


@dataclasses.dataclass(frozen=True)
class DataConfig:
  """Synthetic data configuration.

  Frames are random features weakly correlated with the label sequence, so
  the loss is meaningfully learnable (unlike pure noise).
  """
  batch_size: int = 8
  max_num_frames: int = 48
  max_num_labels: int = 12
  feature_size: int = 80
  vocab_size: int = 32
  seed: int = 0


def synthetic_batches(config: DataConfig) -> Iterator[dict]:
  """Yields numpy batches of (frames, num_frames, labels, num_labels)."""
  rng = np.random.default_rng(config.seed)
  # A fixed random "embedding" of labels into feature space: frames around
  # a label's embedding make the mapping learnable.
  label_emb = rng.normal(
      size=(config.vocab_size + 1, config.feature_size)).astype(np.float32)
  while True:
    num_labels = rng.integers(
        1, config.max_num_labels + 1, size=(config.batch_size,))
    num_frames = np.minimum(
        num_labels + rng.integers(
            1, config.max_num_frames // 2, size=(config.batch_size,)),
        config.max_num_frames)
    labels = np.zeros((config.batch_size, config.max_num_labels), np.int32)
    frames = np.zeros(
        (config.batch_size, config.max_num_frames, config.feature_size),
        np.float32)
    for b in range(config.batch_size):
      seq = rng.integers(1, config.vocab_size + 1, size=(num_labels[b],))
      labels[b, :num_labels[b]] = seq
      # Stretch labels over the frame axis and add noise.
      positions = np.linspace(0, num_labels[b], num_frames[b],
                              endpoint=False).astype(np.int32)
      stretched = np.concatenate([[0], seq])[np.minimum(
          positions + 1, num_labels[b])]
      frames[b, :num_frames[b]] = (
          label_emb[stretched] +
          0.5 * rng.normal(size=(num_frames[b], config.feature_size)))
    yield {
        'frames': frames,
        'num_frames': num_frames.astype(np.int32),
        'labels': labels,
        'num_labels': num_labels.astype(np.int32),
    }


def train(model_config: gnat.GNATConfig,
          data_config: DataConfig,
          num_steps: int = 100,
          workdir: Optional[str] = None,
          learning_rate: float = 1e-3,
          checkpoint_every: int = 50,
          log_every: int = 10,
          eval_every: int = 0,
          model_parallel: int = 1,
          seed: int = 0,
          batch_iterator: Optional[Iterator[dict]] = None,
          prefetch: int = 2,
          log_fn=print,
          device='cuda') -> gnat.GNATTrainState:
  """Trains a GNAT model; resumes from workdir checkpoints when present.

  The step: with ``model_parallel > 1``, the tensor-parallel step over a
  ('data', 'model') mesh of the process group (``make_tp_train_step``), or
  where the lattice takes no tensor-parallel plan, ``fused='never'`` and
  ``make_sharded_train_step``; in a process group of more than one rank
  otherwise, the data-parallel step
  (``make_shard_map_train_step``); else ``gnat.train_step`` on
  ``device`` (the card unless the caller asks for 'cpu').

  Args (beyond the obvious): ``batch_iterator`` replaces the synthetic
  data source with any iterator of trainer batches, e.g.
  ``data.bucket_batches(...)`` over a real corpus (it must yield at least
  ``num_steps + 1`` batches; the first is held out for evaluation).
  ``prefetch`` stages that many upcoming batches on the device from a
  background thread while the current step computes. A resumed run skips
  the batches its restored steps consumed, so it sees the batches of a run
  that was never stopped.

  Returns the final train state.
  """
  device = torch.device(device)
  maybe_initialize_distributed(device)
  model = gnat.GNATModel(model_config, device=device)
  optimizer = gnat.make_optimizer(learning_rate=learning_rate)
  state = gnat.init_train_state(model, torch.Generator().manual_seed(seed),
                                optimizer)
  world = dist.get_world_size() if dist.is_initialized() else 1

  mesh = None
  if model_parallel > 1:
    mesh = sharding.make_mesh(model_parallel=model_parallel,
                              device_type=device.type)
    if sharded_scan.tp_plan(model.lattice, model_config.vocab_size,
                            model_parallel, device) is not None:
      # The vocab-sharded lattice loss: per-frame frame_reduce kernels on
      # each rank's head shard, the reductions gathered.
      step_fn, shard_state = sharding.make_tp_train_step(model, optimizer,
                                                         mesh)
    else:
      # Fallback, as the JAX package's: the lattice on the gathered head,
      # through its generic route.
      model.lattice.fused = 'never'
      step_fn, shard_state = sharding.make_sharded_train_step(
          model, optimizer, mesh)
    state = shard_state(state)
  elif world > 1:
    mesh = sharding.make_mesh(model_parallel=1, device_type=device.type)
    step_fn = sharding.make_shard_map_train_step(model, optimizer, mesh)
  else:
    step_fn = functools.partial(gnat.train_step, model, optimizer)
  if mesh is None:
    place = lambda b: data_lib.to_device(b, device)
  else:
    place = lambda b: data_lib.to_device(sharding.shard_batch(b, mesh),
                                         device)

  manager = None
  if workdir:
    manager = checkpoint_lib.CheckpointManager(workdir)
    latest = manager.latest_step()
    if latest is not None:
      state = manager.restore(template=state)
      log_fn(json.dumps({'event': 'restored', 'step': latest}))

  timer = profiling.StepTimer(skip_first=1)
  source = (batch_iterator if batch_iterator is not None else
            synthetic_batches(data_config))
  eval_batch = next(source)
  start = int(state.step)
  for _ in range(start):
    next(source)
  if prefetch:
    staged = data_lib.prefetch_to_device(source, size=prefetch,
                                         device=device, place=place)
  else:
    staged = (place(b) for b in source)
  try:
    for step in range(start, num_steps):
      batch = next(staged)
      with timer:
        state, loss = step_fn(state, batch['frames'], batch['num_frames'],
                              batch['labels'], batch['num_labels'])
        loss = float(loss)
      do_eval = eval_every and (step + 1) % eval_every == 0
      if ((log_every and (step + 1) % log_every == 0) or do_eval
          or step + 1 == num_steps):
        record = {
            'event': 'train',
            'step': step + 1,
            'loss': round(loss, 4),
            **{k: round(v, 2) for k, v in timer.summary().items()
               if k != 'steps'},
        }
        if do_eval:
          eval_params = (state.params if state.shard is None else
                         sharding.gather_params(state.params, mesh))
          record['eval_label_accuracy'] = round(
              label_accuracy(model, model.decode, eval_params, eval_batch), 4)
          record['eval_label_error_rate'] = round(
              label_error_rate(model, model.decode, eval_params, eval_batch),
              4)
        log_fn(json.dumps(record))
      if manager and ((checkpoint_every and
                       (step + 1) % checkpoint_every == 0)
                      or step + 1 == num_steps):
        manager.save(step + 1, state)
  finally:
    staged.close()
  if manager:
    manager.close()
  return state


def _decoded_labels(decode_fn, params, batch) -> np.ndarray:
  alignment_labels, _, _ = decode_fn(params, batch['frames'],
                                     batch['num_frames'])
  return alignment_labels.cpu().numpy()


def label_accuracy(model, decode_fn, params, batch) -> float:
  """Fraction of reference labels recovered by Viterbi decoding.

  Blank slots are stripped from the decoded alignment; the remaining
  lexical labels are compared position by position with the (unpadded)
  reference sequence.
  """
  del model
  alignment_labels = _decoded_labels(decode_fn, params, batch)
  labels = np.asarray(batch['labels'])
  num_labels = np.asarray(batch['num_labels'])
  correct, total = 0, 0
  for b in range(labels.shape[0]):
    decoded = alignment_labels[b][alignment_labels[b] > 0]
    reference = labels[b, :num_labels[b]]
    n = min(len(decoded), len(reference))
    correct += int(np.sum(decoded[:n] == reference[:n]))
    total += int(len(reference))
  return correct / max(total, 1)


def label_error_rate(model, decode_fn, params, batch) -> float:
  """Corpus label error rate (Levenshtein) of Viterbi decoding: total edit
  distance between the decoded lexical label sequences (blanks stripped)
  and the references, over total reference labels
  (``models.metrics``)."""
  del model
  alignment_labels = _decoded_labels(decode_fn, params, batch)
  batch_size, width = alignment_labels.shape
  hyp = np.zeros((batch_size, max(width, 1)), np.int32)
  num_hyp = np.zeros((batch_size,), np.int32)
  for b in range(batch_size):
    decoded = alignment_labels[b][alignment_labels[b] > 0]
    hyp[b, :len(decoded)] = decoded
    num_hyp[b] = len(decoded)
  state = metrics.update_error_rate(
      metrics.empty_error_rate_state('cpu'), torch.from_numpy(hyp),
      torch.from_numpy(num_hyp), torch.as_tensor(batch['labels']),
      torch.as_tensor(batch['num_labels']))
  return float(metrics.error_rate(state))


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('--steps', type=int, default=100)
  parser.add_argument('--workdir', type=str, default=None)
  parser.add_argument('--batch-size', type=int, default=8)
  parser.add_argument('--vocab-size', type=int, default=32)
  parser.add_argument('--context-size', type=int, default=1)
  parser.add_argument('--locally-normalized', action='store_true')
  parser.add_argument('--model-parallel', type=int, default=1)
  parser.add_argument('--learning-rate', type=float, default=1e-3)
  parser.add_argument('--eval-every', type=int, default=0,
                      help='decode the eval batch every N steps and log '
                           'label accuracy')
  parser.add_argument('--device', default='cuda',
                      help="'cuda' (default) or 'cpu'")
  args = parser.parse_args(argv)

  model_config = gnat.GNATConfig(
      feature_size=80,
      vocab_size=args.vocab_size,
      context_size=args.context_size,
      locally_normalized=args.locally_normalized)
  data_config = DataConfig(
      batch_size=args.batch_size, vocab_size=args.vocab_size)
  train(model_config, data_config, num_steps=args.steps,
        workdir=args.workdir, learning_rate=args.learning_rate,
        eval_every=args.eval_every, model_parallel=args.model_parallel,
        device=args.device)


if __name__ == '__main__':
  main()
