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

"""Time-synchronous alignment lattices, PyTorch port.

Counterpart of ``last_torch_tpu/alignments.py``: the frame-local structure
of ``FrameDependent`` and ``FrameLabelDependent`` and their per-frame DP
steps, ``forward`` and ``string_forward`` in any semiring (their values
may be tuples, as the Expectation semiring's are) and ``backward`` (arc
marginals) in the Log semiring, on tensors. ``blank`` and ``lexical`` are
sequences with one weight value per alignment state, as in the JAX package.
"""

from __future__ import annotations

from collections.abc import Sequence
from typing import Optional

import torch
from torch.utils import _pytree as pytree

from last_torch_tpu_torch import semirings


def shift_down(x, semiring: semirings.Semiring):
  """Shifts values down by 1 position along the last axis.

  Returns [batch_dims..., N] with output[..., i + 1] = x[..., i] and
  output[..., 0] = semiring zero.
  """
  zero = semirings.zeros_like(semiring, x,
                              semirings.value_shape(x)[:-1] + (1,))
  return pytree.tree_map(lambda z, leaf: torch.cat([z, leaf[..., :-1]],
                                                   dim=-1), zero, x)


def _expand(x):
  """``x[..., None]`` on every leaf of a semiring value."""
  return pytree.tree_map(lambda leaf: leaf[..., None], x)


def check_num_weights(alignment, blank: Sequence, lexical: Sequence):
  """Ensures that there are correct numbers of weight arrays."""
  num_states = alignment.num_states()
  if len(blank) != num_states:
    raise ValueError(
        f'blank should be a length {num_states} sequence of ndarrays, '
        f'but got length {len(blank)}')
  if len(lexical) != num_states:
    raise ValueError(
        f'lexical should be a length {num_states} sequence of ndarrays, '
        f'but got length {len(lexical)}')


class FrameDependent:
  """Frame dependent alignment lattice.

  Each frame is aligned to either one lexical label or one blank label.
  """

  def num_states(self) -> int:
    return 1

  def start(self) -> int:
    return 0

  def blank_next(self, state: int) -> Optional[int]:
    return 0

  def lexical_next(self, state: int) -> Optional[int]:
    return 0

  def topological_visit(self) -> list[int]:
    return [0]

  def forward(self, alpha, blank, lexical, context, semiring):
    """One frame of the forward algorithm.

    alpha, blank[0]: [batch_dims..., num_context_states]; lexical[0]:
    [batch_dims..., num_context_states, vocab_size].
    """
    check_num_weights(self, blank, lexical)
    return semiring.plus(
        semiring.times(alpha, blank[0]),
        context.forward_reduce(
            semiring.times(_expand(alpha), lexical[0]), semiring))

  def backward(self, alpha, blank, lexical, beta, log_z, context):
    """One frame of the backward algorithm (Log semiring).

    Returns (next_beta, blank_marginals, lexical_marginals), the marginals
    being exp(alpha + weight + beta - log_z).
    """
    check_num_weights(self, blank, lexical)
    blank_beta = blank[0] + beta
    lexical_beta = lexical[0] + context.backward_broadcast(beta)
    log_scale = alpha - log_z[..., None]
    blank_marginal = torch.exp(blank_beta + log_scale)
    lexical_marginal = torch.exp(lexical_beta + log_scale[..., None])
    next_beta = semirings.Log.plus(blank_beta,
                                   semirings.Log.sum(lexical_beta, axis=-1))
    return next_beta, [blank_marginal], [lexical_marginal]

  def string_forward(self, alpha, blank, lexical, semiring):
    """One frame of the forward algorithm on the intersection with a string.

    alpha, blank[0], lexical[0]: [batch_dims..., output_length + 1].
    """
    check_num_weights(self, blank, lexical)
    return semiring.plus(
        semiring.times(alpha, blank[0]),
        shift_down(semiring.times(alpha, lexical[0]), semiring))


class FrameLabelDependent:
  """k-constrained frame-label-dependent alignment lattice.

  Each frame is aligned to up to k lexical labels followed by a blank label.

  Attributes:
    max_expansions: Maximum number of lexical labels allowed per frame.
  """

  def __init__(self, max_expansions: int) -> None:
    self.max_expansions = max_expansions

  def num_states(self) -> int:
    return self.max_expansions + 1

  def start(self) -> int:
    return 0

  def blank_next(self, state: int) -> Optional[int]:
    return 0

  def lexical_next(self, state: int) -> Optional[int]:
    next_state = state + 1
    return next_state if next_state <= self.max_expansions else None

  def topological_visit(self) -> list[int]:
    return list(range(self.max_expansions + 1))

  def forward(self, alpha, blank, lexical, context, semiring):
    """One frame of the forward algorithm: up to k expansions, a blank."""
    check_num_weights(self, blank, lexical)
    terminated = [semiring.times(alpha, blank[0])]
    last = alpha
    for i in range(self.max_expansions):
      last = context.forward_reduce(
          semiring.times(_expand(last), lexical[i]), semiring)
      terminated.append(semiring.times(last, blank[i + 1]))
    return semiring.sum(semirings.stack(terminated), axis=0)

  def backward(self, alpha, blank, lexical, beta, log_z, context):
    """One frame of the backward algorithm (Log semiring)."""
    check_num_weights(self, blank, lexical)
    # The per-expansion forward weights within the frame are recomputed:
    # cheap relative to storing them across the time loop.
    lexical_alphas = [alpha]
    last = alpha
    for i in range(self.max_expansions):
      last = context.forward_reduce(last[..., None] + lexical[i],
                                    semirings.Log)
      lexical_alphas.append(last)

    blank_log_scale = beta - log_z[..., None]
    blank_marginals = [
        torch.exp(lexical_alphas[i] + blank[i] + blank_log_scale)
        for i in range(self.max_expansions + 1)
    ]
    # Walk the expansions in reverse to accumulate backward weights.
    next_beta = blank[self.max_expansions] + beta
    lexical_marginals = []
    for i in range(self.max_expansions):
      j = self.max_expansions - 1 - i
      lexical_beta = lexical[j] + context.backward_broadcast(next_beta)
      log_scale = lexical_alphas[j] - log_z[..., None]
      lexical_marginals.append(torch.exp(lexical_beta + log_scale[..., None]))
      next_beta = semirings.Log.plus(
          blank[j] + beta, semirings.Log.sum(lexical_beta, axis=-1))
    lexical_marginals.reverse()
    # The last expansion state has no lexical arc: structurally zero.
    lexical_marginals.append(torch.zeros_like(lexical[self.max_expansions]))
    return next_beta, blank_marginals, lexical_marginals

  def string_forward(self, alpha, blank, lexical, semiring):
    """One frame of the forward algorithm on the intersection with a string."""
    check_num_weights(self, blank, lexical)
    terminated = [semiring.times(alpha, blank[0])]
    last = alpha
    for i in range(self.max_expansions):
      last = shift_down(semiring.times(last, lexical[i]), semiring)
      terminated.append(semiring.times(last, blank[i + 1]))
    return semiring.sum(semirings.stack(terminated), axis=0)
