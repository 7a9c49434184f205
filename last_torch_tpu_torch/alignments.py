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

Counterpart of ``last_torch_tpu/alignments.py``. The decode slice needs the
frame-local structure only; the per-frame semiring DP steps (``forward``,
``backward``, ``string_forward``) come with the loss slice (ROADMAP
queue 1).
"""

from __future__ import annotations

from typing import Optional


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
