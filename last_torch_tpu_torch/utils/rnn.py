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

"""Minimal explicit-parameter RNN cells, PyTorch port.

Counterpart of ``last_torch_tpu/utils/rnn.py``, used by
``weight_fns.SharedRNNCacher``. Cells follow a functional convention:

* ``cell.init(generator, device) -> params`` — a dictionary of tensors;
* ``cell.initial_state(batch_size, dtype, device) -> state`` — zero carry;
* ``cell.apply(params, inputs, state) -> (outputs, next_state)`` — one step.

The LSTM keeps the JAX package's fused layout (``w_i`` [in, 4h], ``w_h``
[h, 4h], one bias ``b``, gates i, f, g, o), so ``convert.from_jax_params``
carries its parameters across as they are; ``torch.nn.LSTMCell`` has
another layout and two biases.
"""

from __future__ import annotations

import abc
import dataclasses
import math
from typing import Any

import torch

from last_torch_tpu_torch import initializers


class RNNCellBase(abc.ABC):
  """Interface for explicit-parameter RNN cells."""

  @abc.abstractmethod
  def init(self, generator: torch.Generator, device='cuda') -> Any:
    """Creates the parameters on ``device``."""

  @abc.abstractmethod
  def initial_state(self, batch_size: int, dtype=torch.float32,
                    device='cuda') -> Any:
    """Creates the zero carry for a given batch size."""

  @abc.abstractmethod
  def apply(self, params: Any, inputs: torch.Tensor,
            state: Any) -> tuple[torch.Tensor, Any]:
    """Runs one step: (params, [batch, in], state) -> ([batch, out], state)."""


@dataclasses.dataclass(frozen=True)
class LSTMCell(RNNCellBase):
  """Standard LSTM cell with a fused 4-gate projection.

  Attributes:
    input_size: Input feature size.
    hidden_size: Hidden (and output) size.
  """

  input_size: int
  hidden_size: int

  def init(self, generator: torch.Generator, device='cuda') -> dict:
    """Uniform weights in +-1/sqrt(fan_in), zero bias, on ``device`` (the
    card unless the caller asks for 'cpu')."""
    h = self.hidden_size
    scale_i = 1.0 / math.sqrt(self.input_size)
    scale_h = 1.0 / math.sqrt(h)
    return {
        'w_i': initializers.uniform((self.input_size, 4 * h), generator,
                                    -scale_i, scale_i, device),
        'w_h': initializers.uniform((h, 4 * h), generator, -scale_h, scale_h,
                                    device),
        'b': torch.zeros((4 * h,), device=device),
    }

  def initial_state(self, batch_size: int, dtype=torch.float32,
                    device='cuda') -> tuple[torch.Tensor, torch.Tensor]:
    zeros = torch.zeros((batch_size, self.hidden_size), dtype=dtype,
                        device=device)
    return zeros, zeros.clone()

  def apply(self, params: dict, inputs: torch.Tensor, state):
    h_prev, c_prev = state
    gates = inputs @ params['w_i'] + h_prev @ params['w_h'] + params['b']
    i, f, g, o = gates.chunk(4, dim=-1)
    # Unit forget-gate bias for healthier gradients early in training.
    c = torch.sigmoid(f + 1.0) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, (h, c)
