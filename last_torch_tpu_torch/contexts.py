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

Counterpart of ``last_torch_tpu/contexts.py``: the ``ContextDependency``
interface with the shared ``walk_states``; ``FullNGram`` with its
closed-form transitions and the reshape-and-sum reductions of the forward
and backward algorithms (``forward_reduce``, ``backward_broadcast``); and
``NextStateTable``, any deterministic label-history automaton given as a
dense transition table, with a semiring-correct sorted segment reduction.
A ``NextStateTable`` lattice runs on the lattice's generic routes (the
bigram and trigram kernels take ``FullNGram`` alone). ``forward_reduce`` and
``backward_broadcast`` take any semiring value, tuples (the Expectation
semiring's) too, leaf by leaf.
"""

from __future__ import annotations

import abc
import dataclasses

import numpy as np
import torch
from torch.utils import _pytree as pytree

from last_torch_tpu_torch import semirings


class ContextDependency(abc.ABC):
  r"""Interface of context dependencies.

  A context dependency is a deterministic finite automaton (DFA) accepting
  $\Sigma^*$ over the lexical vocabulary, whose state ids in
  [0, num_states) encode the output history (GNAT paper, Sections 3-4).
  Every state is final. Label 0 is the epsilon / blank label and must be a
  self-loop of ``next_state``.
  """

  @abc.abstractmethod
  def shape(self) -> tuple[int, int]:
    """(num_states, vocab_size) of the DFA."""

  @abc.abstractmethod
  def start(self) -> int:
    """The start state id."""

  @abc.abstractmethod
  def next_state(self, state: torch.Tensor,
                 label: torch.Tensor) -> torch.Tensor:
    """Takes a transition: [batch_dims...] states and labels in
    [0, vocab_size] to [batch_dims...] next states; label 0 stays put."""

  @abc.abstractmethod
  def forward_reduce(self, weights, semiring: semirings.Semiring):
    """The reduction of the forward algorithm.

    For each state q, sums over all (source state p, label y) pairs with an
    arc p --y--> q: ``result[..., q] = sum_{p-y->q} weights[..., p, y]``.

    Args:
      weights: [batch_dims..., num_states, vocab_size] semiring value.
      semiring: The semiring carrying out the summation.

    Returns:
      [batch_dims..., num_states] reduced semiring value.
    """

  @abc.abstractmethod
  def backward_broadcast(self, weights):
    """The broadcast of the backward algorithm.

    For each arc p --y--> q: ``result[..., p, y] = weights[..., q]``.

    Args:
      weights: [batch_dims..., num_states] semiring value.

    Returns:
      [batch_dims..., num_states, vocab_size] broadcasted value.
    """

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
      state = self.next_state(state, labels[..., i]).long()
      states.append(state)
    return torch.stack(states, dim=-1).to(torch.int32)


def _check_reduce_shape(shape, weights):
  """The batch dimensions of forward_reduce's weights."""
  value_shape = semirings.value_shape(weights)
  if value_shape[-2:] != shape:
    raise ValueError(f'weights.shape[-2:] should be {shape} but got'
                     f' {value_shape[-2:]}')
  return value_shape[:-2]


def _check_broadcast_shape(num_states, weights):
  """The batch dimensions of backward_broadcast's weights."""
  value_shape = semirings.value_shape(weights)
  if value_shape[-1] != num_states:
    raise ValueError(f'weights.shape[-1] should be {num_states} but '
                     f'got {value_shape[-1]}')
  return value_shape[:-1]


@dataclasses.dataclass(frozen=True)
class FullNGram(ContextDependency):
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

  def walk_states(self, labels: torch.Tensor) -> torch.Tensor:
    """``ContextDependency.walk_states`` without a loop over the labels
    when context_size <= 1: the state after a prefix is its last
    lexical label (state 0 before the first, and always when
    context_size is 0)."""
    if self.context_size > 1:
      return super().walk_states(labels)
    labels = torch.as_tensor(labels).long()
    start = labels.new_zeros(labels.shape[:-1] + (1,))
    if self.context_size == 0:
      return torch.cat([start, torch.zeros_like(labels)],
                       dim=-1).to(torch.int32)
    position = torch.arange(labels.shape[-1], device=labels.device)
    last = torch.where(labels > 0, position, -1).cummax(dim=-1).values
    state = torch.gather(labels, -1, last.clamp(min=0))
    state = torch.where(last >= 0, state, 0)
    return torch.cat([start, state], dim=-1).to(torch.int32)

  def next_state_table(self) -> torch.Tensor:
    """Densifies next_state into a [num_states, vocab_size] int32 table."""
    num_states, vocab_size = self.shape()
    return self.next_state(
        torch.arange(num_states)[:, None],
        torch.arange(vocab_size)[None, :] + 1).to(torch.int32)

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
    batch_dims = _check_reduce_shape(self.shape(), weights)
    n, v = self.context_size, self.vocab_size
    parts = []
    if n > 0:
      # The start state has no incoming arcs.
      parts.append(semirings.zeros_like(semiring, weights,
                                        batch_dims + (1,)))
    num_into_ascending = sum(v**i for i in range(n - 1)) if n >= 1 else 0
    # Arcs from states shorter than context_size - 1 each lead to a unique
    # ascending destination, in lexicographic order.
    parts.append(pytree.tree_map(
        lambda w: w[..., :num_into_ascending, :].reshape(batch_dims + (-1,)),
        weights))
    # The remaining arcs lead into the block of full-order states; each
    # group of v**n consecutive (p, y) arcs covers those destinations.
    full = pytree.tree_map(
        lambda w: w[..., num_into_ascending:, :].reshape(
            batch_dims + (-1, v**n)), weights)
    parts.append(semiring.sum(full, axis=-2))
    return pytree.tree_map(lambda *xs: torch.cat(xs, dim=-1), *parts)

  def backward_broadcast(self, weights):
    """The broadcast of the backward algorithm.

    For each arc p --y--> q: ``result[..., p, y] = weights[..., q]``.

    Args:
      weights: [batch_dims..., num_states] semiring value.

    Returns:
      [batch_dims..., num_states, vocab_size] broadcasted value.
    """
    batch_dims = _check_broadcast_shape(self.num_states(), weights)
    n, v = self.context_size, self.vocab_size
    num_ascending = sum(v**i for i in range(n))

    def broadcast_leaf(w):
      if n == 0:
        return w[..., None].expand(w.shape + (v,))
      if n == 1:
        # Label y leads to state y from every state: a broadcast row.
        return w[..., None, 1:].expand(batch_dims + (1 + v, v))
      # Non-start ascending states have a unique incoming arc.
      part_a = w[..., 1:num_ascending].reshape(batch_dims + (-1, v))
      # States feeding the full-order block all see the same v**n weights.
      part_b = w[..., None, num_ascending:].expand(
          batch_dims + (1 + v, v**n)).reshape(batch_dims + (-1, v))
      return torch.cat([part_a, part_b], dim=-2)

    return pytree.tree_map(broadcast_leaf, weights)


def _as_table(table) -> torch.Tensor:
  """The transition table as a tensor. A numpy array or a nested list
  converts as ``jnp.asarray`` converts it with 64-bit types off (int64 to
  int32), so the JAX package's int32 rule sees the same types; a tensor
  keeps its device."""
  if isinstance(table, torch.Tensor):
    table = table.detach()
  else:
    table = torch.from_numpy(np.array(table))
  return table.to(torch.int32) if table.dtype == torch.int64 else table


class NextStateTable(ContextDependency):
  """Arbitrary context DFA given by a dense transition table.

  Covers any deterministic label-history automaton that FullNGram's closed
  form cannot express. The start state is 0.

  Attributes:
    next_state_table: [num_states, vocab_size] int32 tensor; row p, column
      y - 1 holds the destination of the lexical arc labeled y out of state
      p. Given as a numpy array or a tensor, on any device.
  """

  def __init__(self, next_state_table):
    next_state_table = _as_table(next_state_table)
    if next_state_table.ndim != 2:
      raise ValueError(
          'next_state_table should have shape [num_states, vocab_size], but'
          f'got shape {tuple(next_state_table.shape)}')
    if 0 in next_state_table.shape:
      raise ValueError('next_state_table should have a non-zero size, but '
                       f'got shape {tuple(next_state_table.shape)}')
    if next_state_table.dtype != torch.int32:
      raise ValueError('next_state_table should be an int32 ndarray, but '
                       f'got dtype {next_state_table.dtype}')
    self.next_state_table = next_state_table
    self._segment_plan = None
    # Device copies of the table (int64, for indexing) and of the plan.
    self._tables = {}
    self._plans = {}

  def shape(self) -> tuple[int, int]:
    return tuple(self.next_state_table.shape)

  def start(self) -> int:
    return 0

  def _table_on(self, device) -> torch.Tensor:
    device = torch.device(device)
    if device not in self._tables:
      self._tables[device] = self.next_state_table.to(device, torch.long)
    return self._tables[device]

  def next_state(self, state: torch.Tensor,
                 label: torch.Tensor) -> torch.Tensor:
    """Table lookup; lexical labels are in [1, vocab_size], label 0 (epsilon)
    stays in place."""
    state, label = torch.as_tensor(state), torch.as_tensor(label)
    is_epsilon = label == 0
    zero_based = torch.where(is_epsilon, 0, label - 1).long()
    next_state = self._table_on(state.device)[state.long(), zero_based]
    return torch.where(is_epsilon, state, next_state.to(state.dtype))

  def _reduce_plan(self) -> np.ndarray:
    """[num_states, K] int64 indices of each state's incoming arcs (K the
    largest in-degree, at least 1), padded with the dummy arc index
    num_arcs. Computed once in numpy from the table; cached as numpy."""
    if self._segment_plan is None:
      table = self.next_state_table.cpu().numpy()
      num_states, vocab_size = table.shape
      num_arcs = num_states * vocab_size
      dest = table.reshape(-1).astype(np.int64)
      counts = np.bincount(dest, minlength=num_states)
      k = max(int(counts.max()), 1)
      order = np.argsort(dest, kind='stable')
      sorted_dest = dest[order]
      starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
      pos = np.arange(num_arcs) - starts[sorted_dest]
      idx = np.full((num_states, k), num_arcs, np.int64)
      idx[sorted_dest, pos] = order
      self._segment_plan = idx
    return self._segment_plan

  def _plan_on(self, device) -> torch.Tensor:
    device = torch.device(device)
    if device not in self._plans:
      self._plans[device] = torch.from_numpy(self._reduce_plan()).to(device)
    return self._plans[device]

  def forward_reduce(self, weights, semiring: semirings.Semiring):
    """The reduction of the forward algorithm, in ``semiring``.

    Tiny DFAs (num_arcs * num_states <= 2**16) route the arcs with a dense
    one-hot mask and one masked reduction; larger ones gather each state's
    incoming arcs through ``_reduce_plan`` (padding reads a semiring-zero
    dummy arc) and fold them with ``semiring.sum``, O(S * max in-degree).
    A state with no incoming arc reduces to the semiring zero, with a zero
    gradient.

    Args:
      weights: [batch_dims..., num_states, vocab_size] semiring value.
      semiring: The semiring carrying out the summation.

    Returns:
      [batch_dims..., num_states] reduced semiring value.
    """
    batch_dims = _check_reduce_shape(self.shape(), weights)
    num_states, vocab_size = self.shape()
    num_arcs = num_states * vocab_size
    device = pytree.tree_leaves(weights)[0].device
    flat = pytree.tree_map(lambda w: w.reshape(batch_dims + (num_arcs,)),
                           weights)
    zero = semiring.zeros((), semirings.value_dtype(weights), device)
    if num_arcs * num_states <= 1 << 16:
      onehot = self._table_on(device).reshape(num_arcs, 1) == (
          torch.arange(num_states, device=device))
      masked = pytree.tree_map(
          lambda w, z: torch.where(onehot, w[..., None], z), flat, zero)
      return semiring.sum(masked, axis=-2)
    padded = pytree.tree_map(
        lambda w, z: torch.cat([w, z.expand(batch_dims + (1,))], dim=-1),
        flat, zero)
    plan = self._plan_on(device)
    return semiring.sum(pytree.tree_map(lambda w: w[..., plan], padded),
                        axis=-1)

  def backward_broadcast(self, weights):
    """The broadcast of the backward algorithm: each arc p --y--> q reads
    ``weights[..., q]``."""
    _check_broadcast_shape(self.shape()[0], weights)
    return pytree.tree_map(lambda w: w[..., self._table_on(w.device)],
                           weights)
