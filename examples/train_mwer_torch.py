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
"""MWER fine-tuning on the PyTorch port: minimize expected edit distance,
not NLL.

Train a transducer on likelihood, then fine-tune on the metric it is judged
by, the expected label error, with ``gnat.risk_train_step``: exact
posterior alignment paths from ``RecognitionLattice.sample_paths``,
scored against the reference with the batched edit distance, the REINFORCE
gradient with a leave-one-out baseline, and a small NLL term that keeps the
posterior calibrated.

The demo trains a small bigram GNAT on likelihood, measures the label error
rate, then fine-tunes with MWER and reports the Monte Carlo expected edit
distance and the Viterbi error rate on the fine-tuning data (at this toy
scale, 16 fixed batches, the held-out rate is for reference). On the card
(the default)::

    python3 examples/train_mwer_torch.py

or on the CPU, at the JAX demo's sizes::

    python3 examples/train_mwer_torch.py --device cpu
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from last_torch_tpu_torch import risk  # noqa: E402
from last_torch_tpu_torch.models import gnat  # noqa: E402
from last_torch_tpu_torch.models import metrics  # noqa: E402


def synthetic_batch(rng, batch, feature, vocab, max_u=5):
  """Noisy one-hot frames, two per label; ambiguous enough to leave errors
  for MWER to clean up (label y lights feature y-1). Numpy arrays."""
  max_t = 2 * max_u
  num_labels = rng.integers(2, max_u + 1, size=(batch,))
  num_frames = 2 * num_labels
  labels = np.zeros((batch, max_u), np.int32)
  frames = rng.normal(size=(batch, max_t, feature)) * 0.45
  for b in range(batch):
    seq = rng.integers(1, vocab + 1, size=num_labels[b])
    labels[b, :num_labels[b]] = seq
    for u, y in enumerate(seq):
      frames[b, 2 * u:2 * u + 2, y - 1] += 1.0
  return (frames.astype(np.float32), num_frames.astype(np.int32), labels,
          num_labels.astype(np.int32))


def label_error_rate(model, params, batches):
  state = metrics.empty_error_rate_state(model.device)
  for frames, num_frames, labels, num_labels in batches:
    aligned, _, _ = model.decode(params, frames, num_frames)
    hyp, num_hyp = risk.labels_from_alignment(aligned)
    state = metrics.update_error_rate(state, hyp, num_hyp,
                                      torch.from_numpy(labels),
                                      torch.from_numpy(num_labels))
  return float(metrics.error_rate(state))


def main(nll_steps: int = 300, mwer_steps: int = 300, device: str = 'cuda'):
  """Returns (expected edit distance at the first and last MWER step,
  label error rate after NLL and after MWER)."""
  vocab, feature = 6, 8
  config = gnat.GNATConfig(
      vocab_size=vocab, feature_size=feature, context_size=1,
      encoder_size=32, encoder_layers=2, encoder_heads=2,
      encoder_ffn_size=64, hidden_size=32, embedding_size=16,
      max_expansions=1, locally_normalized=True)
  model = gnat.GNATModel(config, device=device)

  rng = np.random.default_rng(0)
  train_batches = [synthetic_batch(rng, 8, feature, vocab)
                   for _ in range(16)]
  eval_batches = [synthetic_batch(np.random.default_rng(99), 16, feature,
                                  vocab)]

  # Phase 1: likelihood training.
  optimizer = gnat.make_optimizer(learning_rate=3e-3, warmup_steps=20)
  state = gnat.init_train_state(model, torch.Generator().manual_seed(0),
                                optimizer)
  for step in range(nll_steps):
    state, loss = gnat.train_step(model, optimizer, state,
                                  *train_batches[step % len(train_batches)])
  ler_nll = label_error_rate(model, state.params, train_batches)
  ler_nll_eval = label_error_rate(model, state.params, eval_batches)
  print(f'after NLL training: loss {float(loss):.3f}, label error rate '
        f'{ler_nll:.3f} (held-out {ler_nll_eval:.3f})')

  # Phase 2: MWER fine-tuning on expected edit distance, from the NLL
  # parameters with a fresh optimizer.
  ft_optimizer = gnat.make_optimizer(learning_rate=1e-3)
  ft_state = gnat.GNATTrainState(params=state.params,
                                 opt_state=ft_optimizer.init(state.params),
                                 step=0)
  generator = torch.Generator(device=device).manual_seed(1)
  first_risk = None
  for step in range(mwer_steps):
    ft_state, m = gnat.risk_train_step(
        model, ft_optimizer, ft_state,
        *train_batches[step % len(train_batches)], generator,
        num_samples=8, estimator='reinforce', nll_weight=0.1)
    if first_risk is None:
      first_risk = float(m['mean_risk'])
    if step % 50 == 0:
      print(f'mwer step {step:3d}  expected edit distance '
            f"{float(m['mean_risk']):.3f}  nll {float(m['nll']):.3f}")
  last_risk = float(m['mean_risk'])
  ler_mwer = label_error_rate(model, ft_state.params, train_batches)
  ler_mwer_eval = label_error_rate(model, ft_state.params, eval_batches)
  print(f'expected edit distance {first_risk:.3f} -> {last_risk:.3f}')
  print(f'label error rate: NLL {ler_nll:.3f} -> MWER {ler_mwer:.3f} '
        f'(held-out {ler_nll_eval:.3f} -> {ler_mwer_eval:.3f})')
  # Soft checks: a demo, whose trajectory depends on the random streams. The
  # pinned versions of these claims are in tests/test_torch_risk.py.
  if not last_risk < first_risk:
    print('WARNING: expected risk did not drop on this seed/config')
  if not ler_mwer <= ler_nll:
    print('WARNING: decode error rate regressed on this seed/config')
  return first_risk, last_risk, ler_nll, ler_mwer


if __name__ == '__main__':
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--nll-steps', type=int, default=300)
  parser.add_argument('--mwer-steps', type=int, default=300)
  parser.add_argument('--device', default='cuda')
  args = parser.parse_args()
  main(args.nll_steps, args.mwer_steps, args.device)
