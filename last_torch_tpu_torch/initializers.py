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

"""Parameter initializers with the distributions of ``jax.nn.initializers``.

Samples are drawn on the CPU from an explicit ``torch.Generator`` and then
moved to ``device``, so one seed gives the same parameters on every device.
They are not JAX's numbers (the generators differ); tests that compare the
two packages convert JAX's parameters instead (``convert.from_jax_params``).
"""

from __future__ import annotations

import math

import torch

# Standard deviation of a standard normal truncated to [-2, 2]; JAX divides
# by it so the truncated samples keep the requested variance.
_TRUNCATED_STD = 0.87962566103423978


def lecun_normal(shape: tuple[int, int], generator: torch.Generator,
                 device='cpu') -> torch.Tensor:
  """``jax.nn.initializers.lecun_normal`` for a [fan_in, fan_out] matrix."""
  std = math.sqrt(1.0 / shape[0]) / _TRUNCATED_STD
  out = torch.empty(shape, dtype=torch.float32)
  torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator)
  return (out * std).to(device)


def normal(shape: tuple[int, ...], generator: torch.Generator,
           device='cpu') -> torch.Tensor:
  """``jax.random.normal``: standard normal float32 samples."""
  return torch.randn(shape, generator=generator,
                     dtype=torch.float32).to(device)


def uniform(shape: tuple[int, ...], generator: torch.Generator, low: float,
            high: float, device='cpu') -> torch.Tensor:
  """``jax.random.uniform(minval=low, maxval=high)``: float32 samples."""
  out = torch.empty(shape, dtype=torch.float32)
  out.uniform_(low, high, generator=generator)
  return out.to(device)
