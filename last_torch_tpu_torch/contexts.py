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

"""Context dependencies (label-history DFAs), PyTorch port.

Counterpart of ``last_torch_tpu/contexts.py``: ``FullNGram`` with its
transitions, ``walk_states`` and the semiring reductions of the forward and
backward algorithms (``forward_reduce``, ``backward_broadcast``).
``NextStateTable`` is still to port (ROADMAP queue 1, "lattices.py, the
rest").
"""

from __future__ import annotations

import dataclasses

import torch

from last_torch_tpu_torch import semirings


@dataclasses.dataclass(frozen=True)
class FullNGram:
  """Full n-gram context dependency (GNAT paper Section 4.1).

  States are all n-grams of length 0..context_size over the vocabulary in
  lexicographic order: the empty n-gram is state 0, unigrams are states
  1..vocab_size, and so on. From each state there is an arc per label to
  the n-gram with the label appended, capped at context_size.

  Attributes:
    vocab_size: Lexical output vocabulary size.
    context_size: Maximum n-gram context size.
  """

  vocab_size: int
  context_size: int

  def __post_init__(self):
    if self.vocab_size <= 0:
      raise ValueError('vocab_size should be > 0, but got '
                       f'vocab_size={self.vocab_size}')
    if self.context_size < 0:
      raise ValueError('context_size should be >= 0, but got '
                       f'context_size={self.context_size}')

  def num_states(self) -> int:
    return sum(self.vocab_size**i for i in range(self.context_size + 1))

  def shape(self) -> tuple[int, int]:
    return self.num_states(), self.vocab_size

  def start(self) -> int:
    return 0

  def next_state(self, state: torch.Tensor,
                 label: torch.Tensor) -> torch.Tensor:
    """Closed-form transition; label 0 (epsilon) stays in place."""
    num_ascending = sum(self.vocab_size**i for i in range(self.context_size))
    ascend_next = state * self.vocab_size + label
    if self.context_size == 0:
      full_next = torch.zeros_like(ascend_next)
    else:
      full_next = ((state - num_ascending) %
                   (self.vocab_size**(self.context_size - 1)) *
                   self.vocab_size + num_ascending + label - 1)
    next_state = torch.where(state < num_ascending, ascend_next, full_next)
    return torch.where(label == 0, state, next_state)

  def next_state_table(self) -> torch.Tensor:
    """Densifies next_state into a [num_states, vocab_size] int32 table."""
    num_states, vocab_size = self.shape()
    return self.next_state(
        torch.arange(num_states)[:, None],
        torch.arange(vocab_size)[None, :] + 1).to(torch.int32)

  def walk_states(self, labels: torch.Tensor) -> torch.Tensor:
    """States visited while consuming each label sequence.

    Args:
      labels: [batch_dims..., num_labels] int labels in [0, vocab_size].

    Returns:
      [batch_dims..., num_labels + 1] int32 states: position 0 holds the
      start state, position i > 0 the state reached after
      labels[..., i - 1].
    """
    labels = torch.as_tensor(labels).long()
    state = torch.full(labels.shape[:-1], self.start(), dtype=torch.long,
                       device=labels.device)
    states = [state]
    for i in range(labels.shape[-1]):
      state = self.next_state(state, labels[..., i])
      states.append(state)
    return torch.stack(states, dim=-1).to(torch.int32)

  def forward_reduce(self, weights, semiring: semirings.Semiring):
    """The reduction of the forward algorithm.

    For each state q, sums over all (source state p, label y) pairs with an
    arc p --y--> q: ``result[..., q] = sum_{p-y->q} weights[..., p, y]``.
    The arc grid is block-structured in the lexicographic state numbering,
    so the reduction is a reshape and an axis sum.

    Args:
      weights: [batch_dims..., num_states, vocab_size] semiring value.
      semiring: The semiring carrying out the summation.

    Returns:
      [batch_dims..., num_states] reduced semiring value.
    """
    shape = semirings.value_shape(weights)
    if shape[-2:] != self.shape():
      raise ValueError(f'weights.shape[-2:] should be {self.shape()} but got'
                       f' {shape[-2:]}')
    batch_dims = shape[:-2]
    n, v = self.context_size, self.vocab_size
    parts = []
    if n > 0:
      # The start state has no incoming arcs.
      parts.append(semirings.zeros_like(semiring, weights,
                                        batch_dims + (1,)))
    num_into_ascending = sum(v**i for i in range(n - 1)) if n >= 1 else 0
    # Arcs from states shorter than context_size - 1 each lead to a unique
    # ascending destination, in lexicographic order.
    parts.append(weights[..., :num_into_ascending, :].reshape(
        batch_dims + (-1,)))
    # The remaining arcs lead into the block of full-order states; each
    # group of v**n consecutive (p, y) arcs covers those destinations.
    full = weights[..., num_into_ascending:, :].reshape(
        batch_dims + (-1, v**n))
    parts.append(semiring.sum(full, axis=-2))
    return torch.cat(parts, dim=-1)

  def backward_broadcast(self, weights):
    """The broadcast of the backward algorithm.

    For each arc p --y--> q: ``result[..., p, y] = weights[..., q]``.

    Args:
      weights: [batch_dims..., num_states] semiring value.

    Returns:
      [batch_dims..., num_states, vocab_size] broadcasted value.
    """
    shape = semirings.value_shape(weights)
    if shape[-1] != self.num_states():
      raise ValueError(f'weights.shape[-1] should be {self.num_states()} but '
                       f'got {shape[-1]}')
    batch_dims = shape[:-1]
    n, v = self.context_size, self.vocab_size
    if n == 0:
      return weights[..., None].expand(weights.shape + (v,))
    num_ascending = sum(v**i for i in range(n))
    # Non-start ascending states have a unique incoming arc.
    part_a = weights[..., 1:num_ascending].reshape(batch_dims + (-1, v))
    # States feeding the full-order block all see the same v**n weights.
    part_b = weights[..., None, num_ascending:].expand(
        batch_dims + (1 + v, v**n)).reshape(batch_dims + (-1, v))
    return torch.cat([part_a, part_b], dim=-2)
