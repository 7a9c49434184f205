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

"""CTC training on the PyTorch port: the context-free corner of the GNAT
family.

``FullNGram(context_size=0)`` gives a single context state: the lattice
loses label-history conditioning and the loss specializes to a CTC-like
objective. Textbook CTC is this topology with ``FrameDependent`` alignment
(``max_expansions=0``: each frame takes exactly one arc, blank or label)
and per-frame local normalization, the ``presets.ctc_like`` corner.

With ``FrameLabelDependent(k)`` instead, a locally normalized context-free
model is probability-deficient (every emission must co-occur with that
frame's blank arc, so an emitting frame contributes at most 1/4); at
``context_size=0`` use ``FrameDependent`` (as here) or global
normalization.

Single-context-state lattices take the factorized S = 1 route of
``last_torch_tpu_torch.lattices`` (``_forward_s1``): one weight-function
application over every frame, and the string weights gathered from it.

This demo trains a small Transformer-encoder CTC model on synthetic data,
checks that the loss drops, and decodes with offline Viterbi. On the card
(the default)::

    python3 examples/train_ctc_torch.py

or on the CPU, in about a minute::

    python3 examples/train_ctc_torch.py --steps 400 --device cpu
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from last_torch_tpu_torch.models import gnat  # noqa: E402
from last_torch_tpu_torch.models import metrics  # noqa: E402

# The synthetic "language": label k at position k, two frames per label.
TEMPLATE = [1, 4, 2, 5, 3, 6]


def synthetic_batch(rng, batch, feature):
  """Variable-length template prefixes whose frames one-hot-encode the
  labels (two frames per label, light noise), as numpy arrays."""
  max_u = len(TEMPLATE)
  max_t = 2 * max_u
  num_labels = rng.integers(2, max_u + 1, size=(batch,))
  num_frames = 2 * num_labels
  labels = np.zeros((batch, max_u), np.int64)
  frames = rng.normal(size=(batch, max_t, feature)) * 0.05
  for b in range(batch):
    labels[b, :num_labels[b]] = TEMPLATE[:num_labels[b]]
    for u in range(num_labels[b]):
      frames[b, 2 * u:2 * u + 2, labels[b, u] % feature] += 1.0
  return (frames.astype(np.float32), num_frames.astype(np.int64), labels,
          num_labels.astype(np.int64))


def main(steps: int = 400, device: str = 'cuda', seed: int = 0):
  """Trains for ``steps`` steps on ``device`` and decodes held-out data.

  Returns:
    The list of per-step mean losses.
  """
  vocab, feature = 6, 8
  config = gnat.GNATConfig(
      vocab_size=vocab,
      feature_size=feature,
      context_size=0,            # CTC topology: a single context state.
      encoder_size=32,
      encoder_layers=2,
      encoder_heads=2,
      encoder_ffn_size=64,
      hidden_size=32,
      embedding_size=16,
      max_expansions=0,          # FrameDependent: one arc per frame.
      locally_normalized=True)   # classic CTC: per-frame normalization.
  model = gnat.GNATModel(config, device=device)
  optimizer = gnat.make_optimizer(learning_rate=3e-3,
                                  warmup_steps=min(20, steps // 2))
  generator = torch.Generator().manual_seed(seed)
  state = gnat.init_train_state(model, generator, optimizer)

  rng = np.random.default_rng(seed)
  losses = []
  for step in range(steps):
    batch = synthetic_batch(rng, batch=8, feature=feature)
    state, loss = gnat.train_step(model, optimizer, state, *batch)
    losses.append(float(loss))
    if step % 100 == 0:
      print(f'step {step:3d}  loss {losses[-1]:.3f}')
  print(f'loss {losses[0]:.3f} -> {losses[-1]:.3f}')

  # Offline Viterbi decode against the references, on held-out data.
  frames, num_frames, labels, num_labels = synthetic_batch(
      np.random.default_rng(seed + 1), batch=8, feature=feature)
  alignment_labels, _, _ = model.decode(state.params, frames, num_frames)
  print(f'decode route: {model.lattice.last_path}')
  # Lexical labels only (blank = 0), compacted per sequence.
  hyp = [[int(y) for y in row if y > 0] for row in alignment_labels.cpu()]
  ref = [list(map(int, labels[b, :num_labels[b]]))
         for b in range(labels.shape[0])]
  hyp_pad = np.zeros((len(hyp), max(1, max(len(h) for h in hyp))), np.int64)
  for b, h in enumerate(hyp):
    hyp_pad[b, :len(h)] = h
  er_state = metrics.update_error_rate(
      metrics.empty_error_rate_state(device), torch.from_numpy(hyp_pad),
      torch.tensor([len(h) for h in hyp]), torch.from_numpy(labels),
      torch.from_numpy(num_labels))
  print(f'label error rate: {float(metrics.error_rate(er_state)):.2f}')
  print('sample hyp vs ref:', hyp[0], 'vs', ref[0])
  return losses


if __name__ == '__main__':
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--steps', type=int, default=400)
  parser.add_argument('--device', default='cuda')
  args = parser.parse_args()
  losses = main(args.steps, args.device)
  if losses[-1] >= losses[0]:
    sys.exit('the loss did not drop')
