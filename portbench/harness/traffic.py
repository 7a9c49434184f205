"""The general traffic generator: a pool of padded batches made on the
device from a mix's parameters (``traffic/<mix>.json``) and ``--seed``.

Parameters a mix file gives:

- ``batch``: utterances a batch; ``pool``: batches made at set-up and cycled
  in a closed loop; ``max_frames``: the padded length T_max;
- ``lengths``: real frame counts ``low`` .. ``high`` (inclusive), ``batch``
  of them drawn uniformly once from ``draw_seed``; every batch of the pool
  holds that one set of lengths, in an order the seed shuffles, so every
  call does the same work whichever batches a window reaches;
- ``feature_scale``: features are standard normal times this, zero on
  padded frames.

Every seed thus gets the same sizes in another order: only the order and
the features depend on it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Batch:
  frames: torch.Tensor  # [B, T, F] float32
  num_frames: torch.Tensor  # [B] int64
  real_frames: int
  lengths: list[int]


def batch_lengths(mix: dict, seed: int) -> list[list[int]]:
  """The real lengths of each batch of the pool, in the seed's order."""
  spec = mix['lengths']
  low, high = spec['low'], spec['high']
  batch, pool = mix['batch'], mix['pool']
  if not 1 <= low <= high <= mix['max_frames']:
    raise ValueError(f'lengths {low}..{high} outside 1..{mix["max_frames"]}')
  one = np.random.default_rng(spec['draw_seed']).integers(low, high + 1,
                                                         size=batch)
  rng = np.random.default_rng(seed)
  return [[int(one[i]) for i in rng.permutation(batch)] for _ in range(pool)]


def make_pool(mix: dict, config: dict, seed: int, device) -> list[Batch]:
  """The pool of batches of ``mix`` for ``config`` (feature_size) from
  ``seed``, on ``device``."""
  lengths = batch_lengths(mix, seed)
  pool, batch, max_t = mix['pool'], mix['batch'], mix['max_frames']
  generator = torch.Generator(device).manual_seed(seed)
  frames = torch.randn((pool, batch, max_t, config['feature_size']),
                       generator=generator, device=device)
  frames.mul_(mix.get('feature_scale', 1.0))
  num_frames = torch.tensor(lengths, device=device)
  steps = torch.arange(max_t, device=device)
  frames.mul_((steps < num_frames[..., None])[..., None])
  return [Batch(frames[p], num_frames[p], sum(lengths[p]), lengths[p])
          for p in range(pool)]
