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
"""End-to-end training pipeline on the PyTorch port, on synthetic data.

The framework's surface in one script:

1. a length-bucketed input pipeline with device prefetch
   (``last_torch_tpu_torch.data``) over variable-length synthetic
   utterances;
2. a streaming-Conformer GNAT preset trained with warmup and gradient
   accumulation (``models.presets``, ``models.gnat``);
3. corpus label-error-rate evaluation with the batched edit distance
   (``models.metrics``), the padded final batch masked by ``valid``;
4. forced alignment of a reference (``RecognitionLattice.align``).

On the card (the default)::

    python3 examples/train_full_pipeline_torch.py

or on the CPU, at the JAX demo's sizes::

    python3 examples/train_full_pipeline_torch.py --device cpu
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from last_torch_tpu_torch import data  # noqa: E402
from last_torch_tpu_torch import risk  # noqa: E402
from last_torch_tpu_torch.models import gnat, metrics, presets  # noqa: E402

VOCAB, FEATURE = 6, 8
TEMPLATE = [1, 4, 2, 5, 3, 6]  # the synthetic "language": label k at
                               # position k, two frames per label


def synthetic_examples(rng, count=None):
  """Variable-length utterances whose frames encode their labels."""
  n = 0
  while count is None or n < count:
    num_labels = int(rng.integers(2, len(TEMPLATE) + 1))
    labels = np.asarray(TEMPLATE[:num_labels], np.int32)
    t = 2 * num_labels
    frames = np.zeros((t, FEATURE), np.float32)
    for u, y in enumerate(labels):
      frames[2 * u:2 * u + 2, y % FEATURE] = 1.0
    frames += 0.05 * rng.normal(size=frames.shape).astype(np.float32)
    yield frames, labels
    n += 1


def main(micro_steps: int = 400, device: str = 'cuda') -> float:
  """Trains for ``micro_steps`` micro-batches (2 per update) and returns
  the held-out label error rate."""
  config = presets.streaming_conformer_gnat(
      vocab_size=VOCAB, feature_size=FEATURE, encoder_size=32,
      encoder_layers=2, encoder_heads=2, encoder_ffn_size=64,
      hidden_size=32, embedding_size=32, max_expansions=1,
      locally_normalized=True, encoder_window=8, encoder_conv_kernel=3)
  model = gnat.GNATModel(config, device=device)
  optimizer = gnat.make_optimizer(learning_rate=3e-3,
                                  warmup_steps=min(20, micro_steps // 2),
                                  total_steps=micro_steps,
                                  accumulate_steps=2)
  state = gnat.init_train_state(model, torch.Generator().manual_seed(0),
                                optimizer)

  rng = np.random.default_rng(0)
  batches = data.prefetch_to_device(
      data.bucket_batches(synthetic_examples(rng), batch_size=8,
                          frame_buckets=(8, 12), label_buckets=(4, 6)),
      size=2, device=device)
  for i, batch in enumerate(batches):
    if i >= micro_steps:
      batches.close()
      break
    state, loss = gnat.train_step(model, optimizer, state, batch['frames'],
                                  batch['num_frames'], batch['labels'],
                                  batch['num_labels'])
    if (i + 1) % 80 == 0:
      print(f'micro-step {i + 1}: loss {float(loss):.3f}')

  # Corpus label error rate on held-out data, padded final batch masked.
  er_state = metrics.empty_error_rate_state(device)
  eval_rng = np.random.default_rng(1)
  for batch in data.bucket_batches(
      synthetic_examples(eval_rng, count=33), batch_size=8,
      frame_buckets=(8, 12), label_buckets=(4, 6), pad_final=True):
    alignment_labels, _, _ = model.decode(state.params, batch['frames'],
                                          batch['num_frames'])
    hyp, num_hyp = risk.labels_from_alignment(alignment_labels)
    er_state = metrics.update_error_rate(
        er_state, hyp, num_hyp, torch.as_tensor(batch['labels']),
        torch.as_tensor(batch['num_labels']),
        valid=(None if 'valid' not in batch else
               torch.as_tensor(batch['valid'])))
  ler = float(metrics.error_rate(er_state))
  print(f'eval: {int(er_state.num_sequences)} utterances, '
        f'label error rate {ler:.2%}')

  # Forced alignment of one reference: label u should sit near frame 2u+1
  # (each label spans two frames).
  frames, labels = next(synthetic_examples(np.random.default_rng(2)))
  num_frames = torch.tensor([len(frames)], device=device)
  with torch.no_grad():
    encoded = model.encoder.apply(
        state.params['encoder'], torch.from_numpy(frames)[None].to(device),
        num_frames)
    emit, scores = model.lattice.align(
        state.params['lattice'], encoded, num_frames,
        torch.from_numpy(labels)[None].to(device),
        torch.tensor([len(labels)], device=device))
  print('forced alignment (label -> frame):',
        {int(y): int(t) for y, t in zip(labels, emit[0].tolist())},
        f'score {float(scores[0]):.2f}')
  return ler


if __name__ == '__main__':
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--micro-steps', type=int, default=400)
  parser.add_argument('--device', default='cuda')
  args = parser.parse_args()
  if main(args.micro_steps, args.device) >= 0.5:
    sys.exit('training should beat chance on this synthetic task')
  print('PIPELINE OK')
