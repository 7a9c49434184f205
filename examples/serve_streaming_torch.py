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
"""End-to-end demo on the PyTorch port: train a streamable GNAT, then serve
it chunk by chunk.

Trains a small causal-encoder GNAT on synthetic data whose target labels are
recoverable from the frames (``models.train.train``), then serves the
trained parameters online: the KV-cached ``StreamingEncoder`` feeds the
beam decoder one chunk at a time, printing the evolving best hypothesis. On
the card (the default)::

    python3 examples/serve_streaming_torch.py

or on the CPU, at the JAX demo's sizes::

    python3 examples/serve_streaming_torch.py --device cpu
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from last_torch_tpu_torch import streaming  # noqa: E402
from last_torch_tpu_torch.models import encoder as encoder_lib  # noqa: E402
from last_torch_tpu_torch.models import gnat  # noqa: E402
from last_torch_tpu_torch.models import train as train_lib  # noqa: E402


def main(steps: int = 150, device: str = 'cuda') -> float:
  """Trains for ``steps`` steps, serves a held-out batch in chunks of 6
  frames, and returns the label accuracy of the best hypotheses."""
  model_config = gnat.GNATConfig(
      feature_size=8, vocab_size=8, context_size=1,
      encoder_size=32, encoder_layers=2, encoder_heads=2,
      encoder_ffn_size=64, hidden_size=32, embedding_size=32,
      max_expansions=1, locally_normalized=True,
      encoder_causal=True, encoder_window=8)
  data_config = train_lib.DataConfig(
      batch_size=16, max_num_frames=24, max_num_labels=6,
      feature_size=8, vocab_size=8)

  print('training a causal GNAT on synthetic data...')
  state = train_lib.train(model_config, data_config, num_steps=steps,
                          learning_rate=3e-3, log_every=50, eval_every=50,
                          device=device)

  model = gnat.GNATModel(model_config, device=device)
  enc = encoder_lib.StreamingEncoder(model.encoder)
  dec = streaming.StreamingBeamDecoder(model.lattice, beam_size=4,
                                       max_labels=16)
  lat_params = state.params['lattice']
  cache = model.lattice.build_cache(lat_params)

  # Held-out batches from the same synthetic distribution (the label ->
  # feature embedding comes from the data seed, so it must match training;
  # skip past the batches the trainer consumed).
  data = train_lib.synthetic_batches(data_config)
  for _ in range(steps + 50):
    batch = next(data)
  frames = torch.from_numpy(batch['frames']).to(device)
  num_frames = torch.from_numpy(batch['num_frames']).to(device)
  batch_size = frames.shape[0]
  chunk = 6

  print('serving chunk by chunk (chunk =', chunk, 'frames):')
  es = enc.init_state(batch_size, device=device)
  ds = dec.init_state(batch_size, device=device)
  with torch.no_grad():
    for lo in range(0, frames.shape[1], chunk):
      es, encoded = enc.step(state.params['encoder'], es,
                             frames[:, lo:lo + chunk])
      # Per-stream validity: streams shorter than this chunk stop emitting.
      valid = torch.clamp(num_frames - lo, 0, encoded.shape[1])
      ds = dec.step(lat_params, ds, encoded, valid, cache)
      best, n, score = dec.best(ds)
      print(f'  after frame {lo + chunk:3d}: stream[0] ->',
            best[0, :int(n[0])].tolist(), f'(score {float(score[0]):.2f})')

  best, n, _ = dec.best(ds)
  hits = total = 0
  for b in range(batch_size):
    target = batch['labels'][b, :batch['num_labels'][b]].tolist()
    hyp = best[b, :int(n[b])].tolist()
    total += len(target)
    hits += sum(1 for x, y in zip(hyp, target) if x == y)
  print(f'label accuracy vs synthetic targets: {hits}/{total} '
        f'({100.0 * hits / max(total, 1):.1f}%)')
  return hits / max(total, 1)


if __name__ == '__main__':
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--steps', type=int, default=150)
  parser.add_argument('--device', default='cuda')
  args = parser.parse_args()
  main(args.steps, args.device)
