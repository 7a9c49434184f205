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

Counterpart of ``last_torch_tpu/contexts.py``. Only ``FullNGram``'s
structure is ported so far: the decode slice needs its shape, start state
and transitions. The semiring reductions (``forward_reduce``,
``backward_broadcast``, ``walk_states``) and ``NextStateTable`` come with
the loss slice (ROADMAP queue 1).
"""

from __future__ import annotations

import dataclasses

import torch


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
